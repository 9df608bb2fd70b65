"""The bootstrap nulls of the port against the JAX package:
``bootstrap_mode='noise'`` (kernel K6's plain twin: Philox uniform rows,
then K4b's twin) and the block and circular resamples.

The JAX package draws its noise rows with ``jax.random`` (its TPU kernel's
``prng_seed`` has no CPU interpret mode, ops/pallas_fft.py:1333) and the
port with Philox from a ``torch.Generator``, so the draws differ: the
thresholds are compared in distribution — means over three keys each,
within 5 % (the Monte-Carlo spread of the 95th-percentile estimate at 400
draws is ~2 %; the rejected phase surrogate sat 12 % low), as
tests/test_bootstrap_noise.py compares the JAX package's two nulls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft
from pyaudiolocalization_tpu_torch.ops import noise as noise_ops

B = 400


def _mk_sigs(seed, n=2000, corr=0.5):
    rng = np.random.default_rng(seed)
    s1 = rng.normal(size=n)
    s2 = corr * s1 + rng.normal(size=n) * np.sqrt(1 - corr ** 2)
    return s1, s2


def _jax_mean(s1, s2, mode, keys):
    return float(np.mean([float(jtdoa.bootstrap_significance(
        jnp.asarray(s1), jnp.asarray(s2), jax.random.PRNGKey(k),
        num_bootstrap=B, bootstrap_mode=mode)) for k in keys]))


def _port_mean(s1, s2, mode, seeds, nfft=None):
    return float(np.mean([float(ttdoa.bootstrap_significance(
        torch.from_numpy(s1), torch.from_numpy(s2),
        torch.Generator().manual_seed(s), num_bootstrap=B,
        bootstrap_mode=mode, nfft=nfft)) for s in seeds]))


def test_noise_null_matches_jax_noise_and_permutation_nulls():
    s1, s2 = _mk_sigs(0)
    port = _port_mean(s1, s2, "noise", (1, 2, 3))
    jax_noise = _jax_mean(s1, s2, "noise", (20, 21, 22))
    jax_perm = _jax_mean(s1, s2, "permutation", (10, 11, 12))
    assert abs(port - jax_noise) / jax_noise < 0.05, (port, jax_noise)
    assert abs(port - jax_perm) / jax_perm < 0.05, (port, jax_perm)


@pytest.mark.parametrize("mode", ["block", "circular"])
def test_block_and_circular_nulls_match_jax(mode):
    s1, s2 = _mk_sigs(4)
    port = _port_mean(s1, s2, mode, (5, 6, 7))
    want = _jax_mean(s1, s2, mode, (30, 31, 32))
    assert abs(port - want) / want < 0.05, (port, want)


def test_noise_null_at_a_power_of_two_and_in_float32():
    """The physical path's shape: a power-of-two transform, float32 (K4a
    and K6 twins), against the port's own permutation null."""
    s1, s2 = (x.astype(np.float32) for x in _mk_sigs(1, n=1500))
    noise = _port_mean(s1, s2, "noise", (1, 2, 3), nfft=4096)
    perm = _port_mean(s1, s2, "permutation", (4, 5, 6), nfft=4096)
    assert abs(noise - perm) / perm < 0.05, (noise, perm)


def test_noise_mode_deterministic_per_generator_seed():
    s1, s2 = (torch.from_numpy(x) for x in _mk_sigs(1, n=800))

    def thr(seed):
        return float(ttdoa.bootstrap_significance(
            s1, s2, torch.Generator().manual_seed(seed), num_bootstrap=64,
            bootstrap_mode="noise"))

    assert thr(7) == thr(7)
    assert thr(7) != thr(8)


def test_unknown_mode_message_lists_noise():
    s1, s2 = (torch.from_numpy(x) for x in _mk_sigs(2, n=400))
    with pytest.raises(ValueError, match="noise"):
        ttdoa.bootstrap_significance(s1, s2, None, num_bootstrap=8,
                                     bootstrap_mode="bogus")


def test_noise_twin_is_k4b_on_the_drawn_rows():
    """K6's twin = K4b's twin on ``noise.uniform`` rows: the same seeds
    give the same rows, n_samp <= nfft/2 included, and the rows are the
    int32 reinterpretation of Philox's first word times 2^-32."""
    rng = np.random.default_rng(3)
    s1 = cuda_fft.fft_real(torch.from_numpy(
        rng.standard_normal((1, 900)).astype(np.float32)), 2048)[0]
    seeds = torch.tensor([[0, 0], [-1, 5], [2 ** 31 - 1, -2 ** 31]],
                         dtype=torch.int32)
    rows = noise_ops.uniform(seeds, 900)
    assert rows.dtype == torch.float32 and rows.shape == (3, 900)
    assert float(rows.min()) >= -0.5 and float(rows.max()) < 0.5
    np.testing.assert_array_equal(
        cuda_fft.noise_bootstrap_peaks(s1, seeds, 900, 2048).numpy(),
        cuda_fft.bootstrap_peaks(s1, rows, 2048).numpy())
    key = seeds.to(torch.int64) & 0xFFFFFFFF
    w0, _ = noise_ops.philox_bits(key[:, :1], key[:, 1:],
                                  torch.arange(900))
    signed = np.where(w0.numpy() >= 2 ** 31, w0.numpy() - 2 ** 32, w0.numpy())
    np.testing.assert_array_equal(
        rows.numpy(), signed.astype(np.int32).astype(np.float32)
        * np.float32(2.0 ** -32))
    # A uniform draw: mean ~0, variance ~1/12.
    many = noise_ops.uniform(torch.tensor([[11, 12]], dtype=torch.int32),
                             200_000)
    assert abs(float(many.mean())) < 5e-3
    assert abs(float(many.var()) - 1 / 12) < 2e-3


def test_resampled_rows_keep_the_samples():
    x = torch.arange(23, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    circ = ttdoa.circular_rows(x, 5, gen)
    for row in circ:
        shift = int(torch.nonzero(row == 0)[0])
        assert torch.equal(row, torch.roll(x, shift))
    blocks = ttdoa.block_rows(x, 5, gen, block_size=5)
    assert blocks.shape == (5, 23)
    # Whole blocks of x, the last one zero-padded, in some order, trimmed
    # back to 23 samples.
    whole = {tuple(range(5 * i, 5 * i + 5)) for i in range(4)}
    whole.add((20.0, 21.0, 22.0, 0.0, 0.0))
    for row in blocks.tolist():
        chunks = [tuple(row[i:i + 5]) for i in range(0, 20, 5)]
        assert all(c in whole for c in chunks)
        assert any(w[:3] == tuple(row[20:]) for w in whole - set(chunks))
