"""The port's windowed kernels' plain twins against the JAX package's Pallas
kernels in interpret mode (nfft <= 4096): K2 ``gcc_windowed`` against
``bfly_gcc_windowed``, K5 ``scene_windowed`` against
``bfly_scene_windowed``, and ``tdoa_single_from_window`` against its JAX
counterpart.

Tolerances: the JAX interpret kernels run the TPU's lane DFT as three
bf16 passes (``_LANE_BF16X3``), ~1e-6 off a float64 oracle on these
correlations, the twins' float32 ``torch.fft`` ~3e-8 off it; windows and
maxima are held to 3e-6, the means (sums of |corr|, which set the peak
threshold) to 1e-7, and the max index exactly.  K5 adds the JAX render,
whose range-reduced ramps are 5e-6..2e-5 of the peak off a float64
render: its windows are held to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu.ops import pallas_fft as pf
from pyaudiolocalization_tpu.ops.delay import fade_window as jfade
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops.delay import fade_window

WIN_TOL = 3e-6
MEAN_TOL = 1e-7


def _pairs(m):
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _check_window(got, want, win_tol=WIN_TOL):
    (gw, gs), (jw, js) = got, want
    jw, js = np.asarray(jw), np.asarray(js)
    assert gw.shape == jw.shape and gs.shape == js.shape
    np.testing.assert_allclose(gw.numpy(), jw, rtol=0, atol=win_tol)
    np.testing.assert_array_equal(gs[..., 2].numpy(), js[..., 2])
    np.testing.assert_allclose(gs[..., 1].numpy(), js[..., 1], rtol=0,
                               atol=win_tol)
    np.testing.assert_allclose(gs[..., 0].numpy(), js[..., 0], rtol=0,
                               atol=MEAN_TOL)


@pytest.mark.parametrize("m,lead,band,wq,nfft,length", [
    (4, (), (300.0, 3400.0), 3, 2048, 1500),
    (3, (2,), None, 1, 2048, 1500),
    (4, (2,), None, 2, 4096, 3000),
    (3, (), (300.0, 3400.0), 2, 1024, 1024)])
def test_gcc_windowed_twin_matches_jax(m, lead, band, wq, nfft, length):
    rng = np.random.default_rng(m * 10 + wq)
    x = rng.standard_normal(lead + (m, length)).astype(np.float32)
    pi, pj = _pairs(m)
    fs = 8000.0
    want = pf.bfly_gcc_windowed(jnp.asarray(x), np.array(pi), np.array(pj),
                                nfft, wq, band=band, fs=fs, interpret=True)
    got = cf.gcc_windowed(torch.from_numpy(x), pi, pj, nfft, wq,
                          cf.band_mask(nfft, band, fs))
    _check_window(got, want)


@pytest.mark.parametrize("m,nfft,length", [(12, 4096, 3000),
                                           (6, 1 << 18, 200000)])
def test_gcc_windowed_twin_matches_jax_on_the_spectra_routes(m, nfft,
                                                             length):
    """Shapes where K2's GCC goes through the mic rows' spectra on the card
    (``cuda_fft.gcc_route``): 12 mics at 4,096, past one block a scene
    (one block a packed cross row), and 6 mics at 2^18, past ``gcc_rows``
    (the split), one scene, the band on; the twin against
    ``bfly_gcc_windowed`` in interpret mode within the module's limits."""
    kind = cf.gcc_route(nfft, m).kind
    assert kind == (cf.ROUTE_SPECTRA_BLOCK if nfft <= 4096
                    else cf.ROUTE_SPECTRA)
    rng = np.random.default_rng(m + nfft)
    x = rng.standard_normal((m, length)).astype(np.float32)
    pi, pj = _pairs(m)
    fs, band, wq = 44100.0, (300.0, 3400.0), 2
    want = pf.bfly_gcc_windowed(jnp.asarray(x), np.array(pi), np.array(pj),
                                nfft, wq, band=band, fs=fs, interpret=True)
    got = cf.gcc_windowed(torch.from_numpy(x), pi, pj, nfft, wq,
                          cf.band_mask(nfft, band, fs))
    _check_window(got, want)


def test_gcc_windowed_refuses_a_window_past_half_the_transform():
    x = torch.zeros((2, 100))
    with pytest.raises(ValueError, match="wq"):
        cf.gcc_windowed(x, [0], [1], 512, 3, torch.ones(257))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tdoa_single_from_window_matches_jax(dtype):
    """float64 on the same window; float32 through JAX's interpret
    kernel."""
    rng = np.random.default_rng(7)
    fs, nfft, wq = 8000.0, 2048, 3
    n = 1500
    base = rng.standard_normal(n + 64)
    shifts = [0, 5, 17, 40]
    x = np.stack([base[s:s + n] for s in shifts]) + 0.05 * \
        rng.standard_normal((4, n))
    x = x.astype(dtype)
    pi, pj = _pairs(4)
    if dtype == np.float64:
        win, stats = cf.gcc_windowed(torch.from_numpy(x), pi, pj, nfft, wq,
                                     cf.band_mask(nfft, None, fs,
                                                  dtype=torch.float64))
        jwin, jstats = jnp.asarray(win.numpy()), jnp.asarray(stats.numpy())
    else:
        jwin, jstats = pf.bfly_gcc_windowed(jnp.asarray(x), np.array(pi),
                                            np.array(pj), nfft, wq, fs=fs,
                                            interpret=True)
        win = torch.from_numpy(np.array(jwin))
        stats = torch.from_numpy(np.array(jstats))
    want = np.asarray(jtdoa.tdoa_single_from_window(jwin, jstats, wq, nfft,
                                                    fs, 0.01))
    got = ttdoa.tdoa_single_from_window(win, stats, wq, nfft, fs, 0.01)
    assert np.any(want != 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tdoa_window_fallback_boundary_decode():
    """No candidate -> the global argmax, with natural index nfft/2 decoded
    as lag -nfft/2 (the cases of the JAX package's test of the same
    name)."""
    nfft, fs, wq = 1024, 1000.0, 1
    win = torch.zeros((1, 2 * wq * 128), dtype=torch.float64)
    stats = torch.tensor([[1.0, 5.0, float(nfft // 2)]], dtype=torch.float64)
    d = ttdoa.tdoa_single_from_window(win, stats, wq, nfft, fs, 0.01)
    assert float(d[0]) == -(nfft // 2) / fs
    stats = torch.tensor([[1.0, 5.0, float(nfft // 2 - 1)]],
                         dtype=torch.float64)
    d = ttdoa.tdoa_single_from_window(win, stats, wq, nfft, fs, 0.01)
    assert float(d[0]) == (nfft // 2 - 1) / fs
    with pytest.raises(ValueError, match="threshold_multiplier"):
        ttdoa.tdoa_single_from_window(win, stats, wq, nfft, fs, 0.01,
                                      threshold_multiplier=1.5)


@pytest.mark.parametrize("fs,nfft,total,out,m,paths,pairs,wq", [
    (8000.0, 2048, 1800, 1500, 3, 2, ([0, 0, 1], [1, 2, 2]), 3),
    (8000.0, 1024, 1024, 1024, 2, 2, ([0], [1]), 2)])
def test_scene_windowed_twin_matches_jax(fs, nfft, total, out, m, paths,
                                         pairs, wq):
    """The shapes of the JAX package's two-kernel-path and full-length-block
    scene-kernel tests, without noise (the TPU's in-kernel noise does not
    lower in interpret mode)."""
    rng = np.random.default_rng(nfft)
    base = np.zeros(total, np.float32)
    base[:min(out, 1500)] = rng.standard_normal(min(out, 1500))
    d = rng.uniform(0, 0.02 if nfft > 1024 else 0.01,
                    (m, paths)).astype(np.float32)
    g = rng.uniform(0.3, 1.0, (m, paths)).astype(np.float32)
    band = (300.0, 3400.0) if m == 3 else None
    pi, pj = pairs
    want = pf.bfly_scene_windowed(
        jnp.asarray(base), jnp.asarray(d), jnp.asarray(g), np.array(pi),
        np.array(pj), fs, nfft, out, wq, band=band,
        fade=jfade(total, dtype=jnp.float32)[:out], interpret=True)
    fade = fade_window(total, dtype=torch.float32)[:out]
    tau = torch.from_numpy(d * np.float32(fs))
    got = cf.scene_windowed(torch.from_numpy(base), tau, torch.from_numpy(g),
                            pi, pj, nfft, out, wq, fade,
                            cf.band_mask(nfft, band, fs))
    _check_window(got, want, win_tol=1e-5)


def test_scene_windowed_twin_with_noise_is_the_split_twins():
    """With noise, K5's twin is K2's twin of K3's twin on the same seeds
    (the fused-vs-split contract)."""
    rng = np.random.default_rng(3)
    scenes, m, total, out, nfft, wq = 3, 4, 1700, 1600, 2048, 2
    base = torch.from_numpy(rng.standard_normal((scenes, total)))
    tau = torch.from_numpy(rng.uniform(0, 90, (scenes, m, 2)))
    gains = torch.from_numpy(rng.uniform(0.2, 1.0, (scenes, m, 2)))
    snr = torch.tensor([20.0, 30.0, 40.0], dtype=torch.float64)
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (scenes, 2),
                                          dtype=np.int32))
    fade = fade_window(total, dtype=torch.float64)[:out]
    mask = cf.band_mask(nfft, (300.0, 3400.0), 16000.0, dtype=torch.float64)
    pi, pj = _pairs(m)
    fused = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq, fade,
                              mask, snr, seeds)
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    quiet = cf.delay_sum(base, tau, gains, nfft, out, fade, True)
    split = cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask)
    assert float((sigs - quiet).abs().max()) > 1e-3   # noise was added
    for a, b in zip(fused, split):
        assert torch.equal(a, b)
