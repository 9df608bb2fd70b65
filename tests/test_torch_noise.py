"""The port's counter-based measurement noise (ops/noise.py, the plain
twin of csrc/philox.cuh): determinism, distinct streams, its
distribution, the SNR scaling on a finalized render, and the TPU kernel's
bits -> normal map."""

import math

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops import noise as nz
from pyaudiolocalization_tpu_torch.ops.delay import fade_window

SEEDS = torch.tensor([[1, 2], [1, 3], [-5, 2 ** 31 - 1]], dtype=torch.int32)


def test_same_seed_same_stream():
    a = nz.normal(SEEDS, 4, 5000)
    b = nz.normal(SEEDS.clone(), 4, 5000)
    assert a.dtype == torch.float32 and a.shape == (3, 4, 5000)
    assert torch.equal(a, b)
    # A stream does not depend on how many samples are drawn.
    assert torch.equal(nz.normal(SEEDS, 4, 100), a[..., :100])


def test_mic_and_scene_streams_are_distinct():
    z = nz.normal(SEEDS, 4, 5000).reshape(12, 5000).double()
    corr = torch.corrcoef(z)
    off = corr[~torch.eye(12, dtype=torch.bool)]
    # 5,000 independent samples: |r| ~ N(0, 1/sqrt(5000)) = 0.014.
    assert float(off.abs().max()) < 0.07
    assert len({tuple(r[:8].tolist()) for r in z}) == 12


def test_distribution_is_standard_normal():
    z = nz.normal(SEEDS, 4, 50_000).double().flatten()
    n = z.numel()                       # 600,000 samples
    mean, var = float(z.mean()), float(z.var())
    assert abs(mean) < 5 / math.sqrt(n)
    assert abs(var - 1.0) < 5 * math.sqrt(2.0 / n)
    skew = float(((z - mean) ** 3).mean()) / var ** 1.5
    kurt = float(((z - mean) ** 4).mean()) / var ** 2
    assert abs(skew) < 5 * math.sqrt(6.0 / n)
    assert abs(kurt - 3.0) < 5 * math.sqrt(24.0 / n)
    # Kolmogorov-Smirnov distance to the normal CDF (5-sigma-ish bound).
    s = torch.sort(z).values
    cdf = 0.5 * (1 + torch.erf(s / math.sqrt(2.0)))
    grid = torch.arange(1, n + 1, dtype=torch.float64) / n
    ks = float(torch.maximum((grid - cdf).abs(), (cdf - grid + 1 / n).abs())
               .max())
    assert ks < 2.0 / math.sqrt(n)


def test_bits_to_normal_is_the_tpu_formula():
    """pyaudiolocalization_tpu/ops/pallas_fft.py:1826-1829 in numpy float32
    on the same 24-bit integers, the extremes included."""
    rng = np.random.default_rng(0)
    b1 = np.concatenate([[0, 1, 2 ** 24 - 1],
                         rng.integers(0, 2 ** 24, 10_000)]).astype(np.int64)
    b2 = np.concatenate([[0, 2 ** 23, 2 ** 24 - 1],
                         rng.integers(0, 2 ** 24, 10_000)]).astype(np.int64)
    u1 = b1.astype(np.float32) * np.float32(2.0 ** -24) + \
        np.float32(2.0 ** -25)
    u2 = b2.astype(np.float32) * np.float32(2.0 ** -24)
    want = np.sqrt(np.float32(-2.0) * np.log(u1)) * np.cos(
        np.float32(2.0 * np.pi) * u2)
    got = nz.bits_to_normal(torch.from_numpy(b1), torch.from_numpy(b2))
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_philox_words_are_uint32_products():
    """_mulhilo's 16-bit split equals exact integer products."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    for m in (nz.PHILOX_M0, nz.PHILOX_M1):
        hi, lo = nz._mulhilo(m, torch.from_numpy(x.astype(np.int64)))
        full = [int(v) * m for v in x]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]


@pytest.mark.parametrize("snr_db", [10.0, 25.0])
def test_noise_scale_on_a_finalized_render(snr_db):
    """sigma = rms * 10^(-snr/20) per mic, with rms over the kept samples
    of the finalized render."""
    rng = np.random.default_rng(2)
    total, out, nfft = 3300, 3000, 4096
    base = torch.from_numpy(rng.standard_normal((2, total)))
    tau = torch.from_numpy(rng.uniform(0, 200, (2, 3, 2)))
    gains = torch.from_numpy(rng.uniform(0.3, 1.0, (2, 3, 2)))
    fade = fade_window(total, dtype=torch.float64)[:out]
    snr = torch.full((2,), snr_db, dtype=torch.float64)
    seeds = torch.tensor([[7, 8], [9, 10]], dtype=torch.int32)
    clean = cf.delay_sum(base, tau, gains, nfft, out, fade, True)
    noisy = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    rms = torch.sqrt(torch.mean(clean * clean, -1))
    sigma = rms * 10.0 ** (-snr_db / 20.0)
    z = nz.normal(seeds, 3, out).double()
    torch.testing.assert_close(noisy - clean, sigma[..., None] * z,
                               rtol=1e-6, atol=1e-9)
    measured = torch.std(noisy - clean, -1)
    torch.testing.assert_close(measured, sigma, rtol=0.05, atol=0)
