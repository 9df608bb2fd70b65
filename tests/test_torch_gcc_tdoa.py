"""The port's front end, GCC and TDOA stages against the JAX package:
Butterworth filtering, all-pairs GCC-PHAT, the physical 'gaussian' ladder,
the correlation metrics and the bootstrap null (float64, rtol 1e-7), and
the plain twins of kernels K1 and K4a/K4b against the TPU kernels run in
Pallas interpret mode (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu.ops import filters as jfilt
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu.ops import pallas_fft as pf
from pyaudiolocalization_tpu.utils.config import DEFAULT_CONFIG
from pyaudiolocalization_tpu.utils.materials import MaterialTable
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft
from pyaudiolocalization_tpu_torch.ops import filters as tfilt
from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc
from pyaudiolocalization_tpu_torch.ops import peaks as tpeaks


@pytest.fixture(scope="module")
def rng():
    """This module's own generator, seeded as the conftest's session-wide
    one: drawing from that one would move the inputs of every later test
    file in the same worker (``test_pallas_fft.py``'s among them)."""
    return np.random.default_rng(1234)


F64 = torch.float64
FS = 8000.0
BAND = (300.0, 3400.0)
MICS = np.array(DEFAULT_CONFIG["mic_positions"], float)


def _close(got, want, rtol=1e-7, atol_scale=1e-9):
    want = np.asarray(want)
    atol = atol_scale * max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def _pairs(m):
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _scene(src=(0.2, 0.6, 0.4), kind="chirp"):
    """Filtered float64 mic signals of a multipath scene (JAX side)."""
    table = MaterialTable.from_dict({
        "air": {"absorption": 0.01, "freq": 1e-6},
        "wood": {"absorption": 0.05, "freq": 2e-6},
        "metal": {"absorption": 0.1, "freq": 1e-6}})
    planes = np.array([[1, 0, 0, -5], [0, 1, 0, -5], [0, 0, 1, -5.0]])
    sigs = jsim.simulate_signals_fast(
        list(src), MICS, FS, 343.0, 0.25, kind, 700.0, planes,
        np.array([1, 2, 1]), table.absorption, table.freq, 1, 0.01,
        key=jax.random.PRNGKey(0), dtype=jnp.float64)
    return np.array(jfilt.noise_reduction(sigs, FS))


def test_butterworth_design_and_filter_match_jax(rng):
    sos = tfilt.butter_bandpass_sos(5, 300 / 4000, 3400 / 4000)
    assert sos == jfilt.butter_bandpass_sos(5, 300 / 4000, 3400 / 4000)
    assert tfilt.sos_impulse_response(sos) == jfilt.sos_impulse_response(sos)
    x = rng.standard_normal((3, 2000))
    for fs in (8000.0, 44100.0):
        _close(tfilt.noise_reduction(torch.from_numpy(x), fs),
               jfilt.noise_reduction(jnp.asarray(x), fs))
    with pytest.raises(ValueError, match="Unknown filter method"):
        tfilt.noise_reduction(torch.from_numpy(x), FS, method="bogus")


@pytest.mark.parametrize("m,band", [(4, BAND), (4, None), (3, BAND)])
def test_gcc_phat_all_pairs_matches_jax(m, band):
    """Odd pair counts (3 mics) exercise the half-empty packed couple."""
    sig = _scene()[:m]
    pi, pj = _pairs(m)
    want = jgcc.gcc_phat_all_pairs(jnp.asarray(sig), np.array(pi),
                                   np.array(pj), nfft=4096, band=band, fs=FS)
    got = tgcc.gcc_phat_all_pairs(torch.from_numpy(sig), pi, pj, nfft=4096,
                                  band=band, fs=FS)
    assert got.shape == (len(pi), 4096)
    _close(got, want)
    np.testing.assert_array_equal(tgcc.lags_physical(2000, 4096),
                                  jgcc.lags_physical(2000, 4096))


def test_gcc_plain_matches_tpu_kernel_interpret(rng):
    """K1's plain twin against bfly_gcc_all_pairs in interpret mode (f32,
    1e-5 absolute on correlations bounded by 1)."""
    sig = rng.standard_normal((3, 1500)).astype(np.float32)
    pi, pj = _pairs(3)
    want = np.asarray(pf.bfly_gcc_all_pairs(
        jnp.asarray(sig), np.array(pi), np.array(pj), 2048, band=BAND,
        fs=FS, interpret=True))
    mask = cuda_fft.band_mask(2048, BAND, FS)
    got = cuda_fft.gcc_all_pairs(torch.from_numpy(sig), pi, pj, 2048, mask)
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-5


@pytest.mark.parametrize("m,nfft,length", [(12, 4096, 3000),
                                           (6, 1 << 18, 200000)])
def test_gcc_plain_matches_tpu_kernel_on_the_spectra_routes(m, nfft,
                                                            length):
    """K1's plain twin against bfly_gcc_all_pairs in interpret mode at
    shapes where K1 goes through the mic rows' spectra on the card
    (``gcc_route``): 12 mics at 4,096 (one block a packed cross row) and
    6 mics at 2^18 (the split past ``gcc_rows``), the band on (f32, 1e-5
    absolute on correlations bounded by 1)."""
    kind = cuda_fft.gcc_route(nfft, m).kind
    assert kind == (cuda_fft.ROUTE_SPECTRA_BLOCK if nfft <= 4096
                    else cuda_fft.ROUTE_SPECTRA)
    sig = np.random.default_rng(m + nfft).standard_normal(
        (m, length)).astype(np.float32)
    pi, pj = _pairs(m)
    want = np.asarray(pf.bfly_gcc_all_pairs(
        jnp.asarray(sig), np.array(pi), np.array(pj), nfft, band=BAND,
        fs=44100.0, interpret=True))
    mask = cuda_fft.band_mask(nfft, BAND, 44100.0)
    got = cuda_fft.gcc_all_pairs(torch.from_numpy(sig), pi, pj, nfft, mask)
    assert got.shape == (len(pi), nfft)
    assert float(np.max(np.abs(got.numpy() - want))) < 1e-5


@pytest.mark.parametrize("src,max_delay", [((0.2, 0.6, 0.4), 0.05),
                                           ((0.5, 0.5, 0.5), 0.05),
                                           ((0.9, 0.1, 0.3), 0.0005)])
def test_time_delays_from_corr_matches_jax(src, max_delay):
    """The tight window (0.5 ms) pushes some rows to the alt threshold or
    the argmax fallback."""
    sig = _scene(src)
    pi, pj = _pairs(4)
    corr = np.array(jgcc.gcc_phat_all_pairs(
        jnp.asarray(sig), np.array(pi), np.array(pj), nfft=4096, band=BAND,
        fs=FS))
    want = jtdoa.time_delays_from_corr(
        jnp.asarray(corr), 2000, 2000, FS, num_peaks=1,
        threshold_method="gaussian", max_expected_delay=max_delay,
        lag_mode="physical")
    got = ttdoa.time_delays_from_corr(
        torch.from_numpy(corr), 2000, 2000, FS, num_peaks=1,
        threshold_method="gaussian", max_expected_delay=max_delay,
        lag_mode="physical")
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    _close(got.corr, want.corr)
    # Parity mode on the same correlations: the reference lag axis, no
    # centring, plateau peaks, the exact median (delays equal to rounding).
    want = jtdoa.time_delays_from_corr(
        jnp.asarray(corr), 2000, 2000, FS, threshold_method="median",
        max_expected_delay=max_delay, lag_mode="reference")
    got = ttdoa.time_delays_from_corr(
        torch.from_numpy(corr), 2000, 2000, FS, threshold_method="median",
        max_expected_delay=max_delay, lag_mode="reference")
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    _close(got.corr, want.corr)


def test_peak_selection_matches_jax(rng):
    from pyaudiolocalization_tpu.ops import peaks as jpeaks
    x = rng.standard_normal((5, 700))
    x[:, 100:103] = 2.0          # a plateau is not a strict maximum
    thr_a = np.full((5, 1), 0.5)
    thr_b = np.full((5, 1), 1.0)
    want = jpeaks.select_peaks_two(jnp.asarray(x), jnp.asarray(thr_a),
                                   jnp.asarray(thr_b), 9, 64)
    got = tpeaks.select_peaks_two(torch.from_numpy(x),
                                  torch.from_numpy(thr_a),
                                  torch.from_numpy(thr_b), 9, 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tpeaks.local_maxima(torch.from_numpy(x)).numpy(),
        np.asarray(jpeaks.local_maxima(jnp.asarray(x))))


def test_correlation_metrics_match_jax(rng):
    sig = _scene()
    pi, pj = _pairs(4)
    corr = np.asarray(jgcc.gcc_phat_all_pairs(
        jnp.asarray(sig), np.array(pi), np.array(pj), nfft=4096, band=BAND,
        fs=FS))
    corr = np.concatenate([corr, np.zeros((1, 4096))])  # a silent row
    for name in ("correlation_snr", "peak_to_peak_ratio"):
        want = np.asarray(getattr(jtdoa, name)(jnp.asarray(corr)))
        got = getattr(ttdoa, name)(torch.from_numpy(corr)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        _close(got[fin], want[fin])
    snr = rng.uniform(1.0, 50.0, 6)
    _close(ttdoa.compute_weights(torch.from_numpy(snr)),
           jtdoa.compute_weights(jnp.asarray(snr)))


def test_bootstrap_threshold_matches_jax():
    """The permuted rows come from the JAX side: the same draws, so the
    thresholds agree to float64 rounding."""
    sig = _scene()
    key = jax.random.PRNGKey(5)
    num, chunk, nfft = 40, 64, 4096
    want = jtdoa.bootstrap_significance(
        jnp.asarray(sig[0]), jnp.asarray(sig[3]), key, num_bootstrap=num,
        nfft=nfft, chunk=chunk)
    # bootstrap_significance's own draws (models/tdoa.py of the JAX package).
    keys = jax.random.split(key, chunk)[:num]
    rows = np.array(jax.vmap(
        lambda k: jax.random.permutation(k, jnp.asarray(sig[3])))(keys))
    got = ttdoa.bootstrap_threshold(torch.from_numpy(sig[0]),
                                    torch.from_numpy(rows), nfft)
    _close(got, want)


def test_permuted_rows_are_permutations():
    x = torch.arange(50, dtype=F64)
    rows = ttdoa.permuted_rows(x, 7, torch.Generator().manual_seed(0))
    assert rows.shape == (7, 50)
    assert torch.equal(torch.sort(rows, -1).values, x.expand(7, 50))
    assert not torch.equal(rows[0], rows[1])
    with pytest.raises(ValueError, match="noise"):
        ttdoa.bootstrap_significance(x, x, None, 4, bootstrap_mode="bogus")


def test_bootstrap_plain_matches_tpu_kernels_interpret(rng):
    """K4a/K4b plain twins against bfly_fft_real + bfly_bootstrap_peaks in
    interpret mode (f32, odd row count, 5e-6 absolute on peaks <= 1)."""
    n, n_samp = 2048, 1800
    sig1 = rng.standard_normal(n_samp).astype(np.float32)
    rows = rng.standard_normal((5, n_samp)).astype(np.float32)
    s1r, s1i = pf.bfly_fft_real(
        jnp.asarray(np.pad(sig1, (0, n - n_samp)))[None], interpret=True)
    want = np.asarray(pf.bfly_bootstrap_peaks(
        (s1r[0], s1i[0]), jnp.asarray(rows), interpret=True))
    s1 = cuda_fft.fft_real(torch.from_numpy(sig1)[None], n)
    assert s1.shape == (1, n // 2 + 1)
    got = cuda_fft.bootstrap_peaks(s1[0], torch.from_numpy(rows), n)
    assert float(np.max(np.abs(got.numpy() - want))) < 5e-6
    # The natural-order spectrum is the TPU plane layout, un-permuted.
    spec = np.fft.fft(np.pad(sig1, (0, n - n_samp)).astype(np.float64))
    t_nat = pf._bitrev_perm(n // 128)
    k = np.arange(128)[None, :] * (n // 128) + t_nat[:, None]
    plane = np.asarray(s1r[0]) + 1j * np.asarray(s1i[0])
    half = k <= n // 2
    np.testing.assert_allclose(s1[0].numpy()[k[half]], plane[half],
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(plane, spec[k], atol=2e-3, rtol=0)
