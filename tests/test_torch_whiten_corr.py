"""The single-pair correlation and the unfused whitening against the JAX
package: the plain twins of kernels K7 (``cuda_fft.whiten``) and K9
(``cuda_fft.whitened_corr``) against the TPU kernels in Pallas interpret
mode (float32), ``phat_correlation`` and ``get_time_delays_phat`` in
float64, the route each length takes, and the exact-length real
transforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu.ops import pallas_fft as pf
from pyaudiolocalization_tpu.ops import pallas_kernels as pk
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft
from pyaudiolocalization_tpu_torch.ops import fftutils as tfft
from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc


@pytest.fixture(scope="module")
def rng():
    """This module's own generator, seeded as the conftest's session-wide
    one: drawing from that one would move the inputs of every later test
    file in the same worker (``test_pallas_fft.py``'s among them)."""
    return np.random.default_rng(1234)


FS = 8000.0


def _pair(rng, n1=1500, n2=1500, lag=9):
    """Two noisy copies of one broadband signal, the second ``lag`` samples
    later."""
    base = rng.standard_normal(max(n1, n2) + lag)
    a = base[lag:lag + n1] + 0.1 * rng.standard_normal(n1)
    b = base[:n2] + 0.1 * rng.standard_normal(n2)
    return a, b


@pytest.mark.parametrize("rows,bins", [(1, 1500), (3, 1025), (8, 640)])
def test_whiten_plain_matches_tpu_kernel_interpret(rng, rows, bins):
    """K7's twin against phat_whiten_planes (float32, 1e-6 relative)."""
    re = rng.standard_normal((rows, bins)).astype(np.float32)
    im = rng.standard_normal((rows, bins)).astype(np.float32)
    re[0, :3] = 0.0
    im[0, :2] = 0.0                               # silent and real bins
    wr, wi = pk.phat_whiten_planes(jnp.asarray(re), jnp.asarray(im),
                                   interpret=True)
    got = cuda_fft.whiten(torch.complex(torch.from_numpy(re),
                                        torch.from_numpy(im)))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_whiten_plain_matches_jax_whiten_float64(rng):
    spec = rng.standard_normal((2, 300)) + 1j * rng.standard_normal((2, 300))
    want = np.asarray(jgcc._whiten(jnp.asarray(spec), 1e-10))
    got = cuda_fft.whiten(torch.from_numpy(spec), inplace=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("nfft,band", [(2048, (300.0, 3400.0)),
                                       (4096, None), (4096, (500.0, 2500.0))])
def test_whitened_corr_plain_matches_tpu_kernel_interpret(rng, nfft, band):
    """K9's twin against bfly_whitened_corr on bfly_fft_real spectra and
    bfly_band_plane, all in interpret mode (float32, 5e-6 absolute on
    correlations bounded by 1); three row pairs."""
    n = nfft - 300
    a = rng.standard_normal((3, n)).astype(np.float32)
    b = rng.standard_normal((3, n)).astype(np.float32)
    pad = ((0, 0), (0, nfft - n))
    ar, ai = pf.bfly_fft_real(jnp.asarray(np.pad(a, pad)), interpret=True)
    br, bi = pf.bfly_fft_real(jnp.asarray(np.pad(b, pad)), interpret=True)
    plane = jnp.asarray(pf.bfly_band_plane(nfft, band, FS))
    want = np.asarray(pf.bfly_whitened_corr(ar, ai, br, bi, plane,
                                            interpret=True))
    spec = cuda_fft.fft_real(torch.from_numpy(np.concatenate([a, b])), nfft)
    mask = cuda_fft.band_mask(nfft, band, FS)
    got = cuda_fft.whitened_corr(spec[:3], spec[3:], mask, nfft)
    assert got.shape == (3, nfft)
    assert float(np.max(np.abs(got.numpy() - want))) < 5e-6


@pytest.mark.parametrize("weighting", ["phat", "scot", "roth", "cc", "ml"])
@pytest.mark.parametrize("n1,n2,nfft", [(1500, 1500, None), (1500, 1200, None),
                                        (1500, 1500, 4096), (1500, 900, 1024)])
def test_phat_correlation_matches_jax(rng, weighting, n1, n2, nfft):
    """float64: the unfused branch (K7's twin for PHAT) at the exact
    length, a longer power of two, and a truncating one."""
    a, b = _pair(rng, n1, n2)
    want = jgcc.phat_correlation(jnp.asarray(a), jnp.asarray(b), nfft=nfft,
                                 weighting=weighting)
    got = tgcc.phat_correlation(torch.from_numpy(a), torch.from_numpy(b),
                                nfft=nfft, weighting=weighting)
    assert got.shape == want.shape and got.dtype == torch.float64
    scale = float(np.max(np.abs(np.asarray(want))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10 * scale)


def test_phat_correlation_float32_kernel_route_matches_jax(rng):
    """float32 at a power of two no shorter than both signals: K4a + K9
    (twins on the CPU), with leading axes broadcast and unequal lengths."""
    a = rng.standard_normal((2, 1500)).astype(np.float32)
    b = rng.standard_normal(1200).astype(np.float32)
    want = np.asarray(jgcc.phat_correlation(jnp.asarray(a), jnp.asarray(b),
                                            nfft=4096))
    got = tgcc.phat_correlation(torch.from_numpy(a), torch.from_numpy(b),
                                nfft=4096)
    assert got.shape == (2, 4096) and got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < 5e-6


def test_phat_correlation_routes(monkeypatch, rng):
    """Which kernel each length reaches: K4a + K9 at a power of two, K7
    otherwise (and for float64); never K1."""
    calls = []
    for name in ("fft_real", "whitened_corr", "whiten", "gcc_all_pairs"):
        real = getattr(cuda_fft, name)
        monkeypatch.setattr(
            cuda_fft, name,
            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in _pair(rng))
    tgcc.phat_correlation(a, b, nfft=2048)
    assert calls == ["fft_real", "whitened_corr"]
    calls.clear()
    tgcc.phat_correlation(a, b)                  # exact length 2999
    tgcc.phat_correlation(a, b, nfft=1024)       # shorter than the signals
    tgcc.phat_correlation(a.double(), b.double(), nfft=2048)
    assert calls == ["whiten"] * 3
    calls.clear()
    tgcc.phat_correlation(a, b, nfft=2048, weighting="scot")
    assert calls == []


@pytest.mark.parametrize("nfft", [None, 4096, 2048])
@pytest.mark.parametrize("threshold", ["median", "adaptive"])
def test_get_time_delays_phat_matches_jax(rng, nfft, threshold):
    a, b = _pair(rng, lag=13)
    want = jtdoa.get_time_delays_phat(jnp.asarray(a), jnp.asarray(b), FS,
                                      threshold_method=threshold,
                                      lag_mode="physical", nfft=nfft)
    got = ttdoa.get_time_delays_phat(torch.from_numpy(a), torch.from_numpy(b),
                                     FS, threshold_method=threshold,
                                     lag_mode="physical", nfft=nfft)
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.time_lags.numpy(),
                               np.asarray(want.time_lags), rtol=0, atol=1e-15)
    assert abs(float(got.delays[0]) * FS + 13) < 1e-9
    # The default lag mode is the reference's (parity mode): the same
    # delays as the JAX package's default, to rounding.
    want = jtdoa.get_time_delays_phat(jnp.asarray(a), jnp.asarray(b), FS,
                                      threshold_method=threshold, nfft=nfft)
    got = ttdoa.get_time_delays_phat(torch.from_numpy(a), torch.from_numpy(b),
                                     FS, threshold_method=threshold,
                                     nfft=nfft)
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("n", [1024, 1023, 3000])
@pytest.mark.parametrize("bins", [300, 513, 700])
def test_exact_length_transforms_follow_numpy(rng, n, bins):
    """irfft_n pads or truncates the half spectrum and ignores the
    imaginary parts of DC and (even n) Nyquist, as numpy does; rfft_n pads
    or truncates the signal."""
    spec = rng.standard_normal(bins) + 1j * rng.standard_normal(bins)
    got = tfft.irfft_n(torch.from_numpy(spec), n).numpy()
    np.testing.assert_allclose(got, np.fft.irfft(spec, n), rtol=0,
                               atol=1e-12)
    x = rng.standard_normal(bins)
    np.testing.assert_allclose(tfft.rfft_n(torch.from_numpy(x), n).numpy(),
                               np.fft.rfft(x, n), rtol=0, atol=1e-10)
    spec_t = torch.from_numpy(spec)
    before = spec_t.clone()
    tfft.irfft_n(spec_t, n)
    assert torch.equal(spec_t, before)            # the input is not written

