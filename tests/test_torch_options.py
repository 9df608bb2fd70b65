"""The physical-mode options of the port against the JAX package: the
order statistics, the 'median' / 'adaptive' ladders and the whole-row
ladder of ``max_expected_delay=None``, every GCC weighting of the unfused
branch, the FIR and Wiener front ends, DBSCAN, the robust LM, L-BFGS-B,
differential evolution, and ``localize_sound_source`` with each option
set (float64, small size: 8 kHz, 0.25 s, one reflection order)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.models import solver as jsol
from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu.ops import filters as jfilt
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu.ops import peaks as jpeaks
from pyaudiolocalization_tpu.ops import quantile as jq
from pyaudiolocalization_tpu.utils.config import DEFAULT_CONFIG
from pyaudiolocalization_tpu.utils.materials import MaterialTable
from pyaudiolocalization_tpu_torch.models import cluster as tcl
from pyaudiolocalization_tpu_torch.models import solver as tsol
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import filters as tfilt
from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc
from pyaudiolocalization_tpu_torch.ops import peaks as tpeaks
from pyaudiolocalization_tpu_torch.ops import quantile as tq


@pytest.fixture(scope="module")
def rng():
    """This module's own generator, seeded as the conftest's session-wide
    one: drawing from that one would move the inputs of every later test
    file in the same worker (``test_pallas_fft.py``'s among them)."""
    return np.random.default_rng(1234)


FS = 8000.0
BAND = (300.0, 3400.0)
MICS = np.array(DEFAULT_CONFIG["mic_positions"], float)
PI = [0, 0, 0, 1, 1, 2]
PJ = [1, 2, 3, 2, 3, 3]
C = 343.2


def _close(got, want, rtol=1e-10, atol_scale=1e-10):
    want = np.asarray(want)
    atol = atol_scale * max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def _scene(src=(0.2, 0.6, 0.4), kind="chirp", filtered=True):
    """float64 mic signals of a multipath scene (JAX side)."""
    table = MaterialTable.from_dict({
        "air": {"absorption": 0.01, "freq": 1e-6},
        "wood": {"absorption": 0.05, "freq": 2e-6},
        "metal": {"absorption": 0.1, "freq": 1e-6}})
    planes = np.array([[1, 0, 0, -5], [0, 1, 0, -5], [0, 0, 1, -5.0]])
    sigs = jsim.simulate_signals_fast(
        list(src), MICS, FS, 343.0, 0.25, kind, 700.0, planes,
        np.array([1, 2, 1]), table.absorption, table.freq, 1, 0.01,
        key=jax.random.PRNGKey(0), dtype=jnp.float64)
    if filtered:
        sigs = jfilt.noise_reduction(sigs, FS)
    return np.array(sigs)


def _tdoas(src, noise=0.0, seed=0):
    d = np.linalg.norm(np.asarray(src)[None] - MICS, axis=-1)
    td = (d[PJ] - d[PI]) / C
    return td + noise * np.random.default_rng(seed).standard_normal(len(PI))


# ---------------------------------------------------------------------------
# Order statistics and the ladders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001, 1000])
def test_median_nonneg_matches_jax_exactly(rng, n):
    x = np.abs(rng.standard_normal((3, n)))
    x[0, : n // 2] = 0.25                         # ties
    want = np.asarray(jq.median_nonneg(jnp.asarray(x)))
    got = tq.median_nonneg(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.median(x, -1))
    for k in (1, (n + 1) // 2, n):
        np.testing.assert_array_equal(
            tq.kth_smallest_nonneg(torch.from_numpy(x), k),
            np.asarray(jq.kth_smallest_nonneg(jnp.asarray(x), k)))


@pytest.mark.parametrize("threshold,max_delay,nfft", [
    ("median", 0.05, 4096), ("median", None, 4096), ("median", None, 2048),
    ("adaptive", 0.05, 4096), ("adaptive", None, 4096),
    ("gaussian", None, 4096), ("median", 0.0005, 2048),
    ("bogus", None, 4096)])
def test_ladders_match_jax(threshold, max_delay, nfft):
    """The 'median' (prime-stride subsample), 'adaptive' and whole-row
    ladders; 2048 is a circular transform, 4096 alias-free; an unknown
    method falls back to 'median' as in the reference."""
    sig = _scene()
    corr = np.array(jgcc.gcc_phat_all_pairs(
        jnp.asarray(sig), np.array(PI), np.array(PJ), nfft=nfft, band=BAND,
        fs=FS))
    corr = np.concatenate([corr, np.zeros((1, nfft))])     # a silent row
    args = (2000, 2000, FS)
    kw = dict(num_peaks=2, threshold_method=threshold,
              max_expected_delay=max_delay, lag_mode="physical")
    want = jtdoa.time_delays_from_corr(jnp.asarray(corr), *args, **kw)
    got = ttdoa.time_delays_from_corr(torch.from_numpy(corr), *args, **kw)
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_select_peaks_matches_jax(rng):
    x = rng.standard_normal((4, 900))
    thr = np.full((4, 1), 0.8)
    window = np.abs(np.arange(900) - 450) <= 60
    for mask in (None, window):
        want = jpeaks.select_peaks(jnp.asarray(x), jnp.asarray(thr), 9, 32,
                                   window_mask=None if mask is None
                                   else jnp.asarray(mask))
        got = tpeaks.select_peaks(torch.from_numpy(x), torch.from_numpy(thr),
                                  9, 32, None if mask is None
                                  else torch.from_numpy(mask))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# GCC weightings and front ends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighting", ["phat", "scot", "roth", "cc", "ml"])
@pytest.mark.parametrize("nfft,band", [(4096, BAND), (3999, None),
                                       (2048, None)])
def test_gcc_weightings_match_jax(weighting, nfft, band):
    """The unfused branch (use_pallas='never'), float64, 1e-10."""
    sig = _scene()
    want = jgcc.gcc_phat_all_pairs(jnp.asarray(sig), np.array(PI),
                                   np.array(PJ), nfft=nfft, band=band, fs=FS,
                                   use_pallas="never", weighting=weighting)
    got = tgcc.gcc_phat_all_pairs(torch.from_numpy(sig), PI, PJ, nfft=nfft,
                                  band=band, fs=FS, use_pallas="never",
                                  weighting=weighting)
    assert got.shape == (6, nfft)
    _close(got, want)


def test_gcc_branches_agree_and_refuse(monkeypatch):
    """PHAT through K1's twin equals the unfused branch; leading axes take
    K1 too (its scene axis, see test_torch_srp); odd lengths take the
    unfused branch; unknown weightings raise."""
    sig = torch.from_numpy(_scene())
    fused = tgcc.gcc_phat_all_pairs(sig, PI, PJ, nfft=4096, band=BAND, fs=FS)
    plain = tgcc.gcc_phat_all_pairs(sig, PI, PJ, nfft=4096, band=BAND, fs=FS,
                                    use_pallas="never")
    _close(fused, plain)
    batched = tgcc.gcc_phat_all_pairs(sig[None], PI, PJ, nfft=4096,
                                      band=BAND, fs=FS)
    assert torch.equal(batched[0], fused)
    from pyaudiolocalization_tpu_torch.ops import cuda_fft
    monkeypatch.setattr(cuda_fft, "gcc_all_pairs",
                        lambda *a, **k: pytest.fail("K1 off its shapes"))
    tgcc.gcc_phat_all_pairs(sig, PI, PJ, nfft=3000)        # not a power of 2
    tgcc.gcc_phat_all_pairs(sig, PI, PJ, nfft=1024)        # shorter than N
    with pytest.raises(ValueError, match="weighting"):
        tgcc.gcc_phat_all_pairs(sig, PI, PJ, nfft=4096, weighting="bogus")
    with pytest.raises(ValueError, match="fs"):
        tgcc.gcc_phat_all_pairs(sig, PI, PJ, nfft=4096, band=BAND)


@pytest.mark.parametrize("method", ["fir", "wiener", "butterworth"])
@pytest.mark.parametrize("fs", [8000.0, 44100.0])
def test_front_ends_match_jax(rng, method, fs):
    x = rng.standard_normal((3, 2000))
    x[2] = 0.0                                    # silent row (Wiener 0/0)
    want = jfilt.noise_reduction(jnp.asarray(x), fs, method=method)
    got = tfilt.noise_reduction(torch.from_numpy(x), fs, method=method)
    _close(got, want)


def test_fir_design_and_refusals():
    assert (tfilt.firwin_bandpass(101, 300 / 4000, 3400 / 4000)
            == jfilt.firwin_bandpass(101, 300 / 4000, 3400 / 4000))
    taps = (0.2, 0.5, 0.3)
    assert tfilt.lfilter_zi(taps, (1.0,)) == pytest.approx(
        jfilt.lfilter_zi(taps, (1.0,)), rel=1e-12)
    short = torch.zeros(300)
    with pytest.raises(ValueError, match="padlen"):
        tfilt.noise_reduction(short, FS, method="fir")
    with pytest.raises(ValueError, match="Unknown filter method"):
        tfilt.noise_reduction(short, FS, method="bogus")
    # The IIR filtfilt, once refused here, now runs (tests/test_torch_iir.py
    # holds every IIR filter): equal to the JAX package's within 1e-10.
    x = np.random.default_rng(3).standard_normal(100)
    np.testing.assert_allclose(
        tfilt.filtfilt((1.0, 0.5), (1.0, -0.5), torch.tensor(x)).numpy(),
        np.asarray(jfilt.filtfilt((1.0, 0.5), (1.0, -0.5), jnp.asarray(x))),
        rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# Clustering and solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps,min_samples", [(0.3, 2), (0.3, 3), (0.05, 2),
                                             (2.0, 1)])
def test_dbscan_labels_match_jax(rng, eps, min_samples):
    x = np.concatenate([rng.normal(0, 0.1, (5, 3)), rng.normal(2, 0.1, (4, 3)),
                        rng.normal(-3, 1.0, (3, 3))])
    valid = np.ones(12, bool)
    valid[4] = False
    want = jcl.dbscan(jnp.asarray(x), eps, min_samples, jnp.asarray(valid))
    got = tcl.dbscan(torch.from_numpy(x), eps, min_samples,
                     torch.from_numpy(valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.num_clusters) == int(want.num_clusters)
    batched = tcl.dbscan(torch.from_numpy(np.stack([x, x[::-1].copy()])),
                         eps, min_samples)
    np.testing.assert_array_equal(
        batched.labels[0].numpy(),
        np.asarray(jcl.dbscan(jnp.asarray(x), eps, min_samples).labels))


@pytest.mark.parametrize("src,noise", [([0.2, 0.6, 0.4], 2e-5),
                                       ([0.5, 0.5, 0.5], 0.0),
                                       ([2.0, -1.0, 0.7], 1e-4)])
@pytest.mark.parametrize("eps", [0.001, 0.2])
def test_dbscan_initial_guesses_match_jax(src, noise, eps):
    td = _tdoas(src, noise)
    want = jsol.heuristic_initial_guesses(
        jnp.asarray(MICS), np.array(PI), np.array(PJ), jnp.asarray(td), C,
        jax.random.PRNGKey(0), clustering_method="dbscan", eps=eps)
    got = tsol.heuristic_initial_guesses(
        torch.from_numpy(MICS), PI, PJ, torch.from_numpy(td), C,
        clustering_method="dbscan", eps=eps)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    other = tsol.heuristic_initial_guesses(
        torch.from_numpy(MICS), PI, PJ, torch.from_numpy(td), C,
        clustering_method="bogus")
    assert other[0].shape == (2, 3) and other[1].tolist() == [True, False]


@pytest.mark.parametrize("outlier", [0.0, 4e-4])
def test_multi_start_lm_robust_matches_jax(rng, outlier):
    """Same guesses, one corrupted pair (a reflection-like TDOA error):
    1e-6 m."""
    td = _tdoas([0.3, 0.7, 0.2], noise=2e-6, seed=2)
    td[4] += outlier
    w = rng.uniform(0.5, 1.5, 6)
    guesses = np.concatenate([rng.uniform(-1, 2, (4, 3)),
                              MICS.mean(0)[None]])
    lower, upper = jsol.dynamic_bounds(jnp.asarray(MICS), jnp.asarray(td), C)
    want = jsol.multi_start_lm_robust(
        jnp.asarray(guesses), jnp.asarray(MICS), np.array(PI), np.array(PJ),
        jnp.asarray(td), C, jnp.asarray(w), lower, upper)
    got = tsol.multi_start_lm_robust(
        torch.from_numpy(guesses), torch.from_numpy(MICS), PI, PJ,
        torch.from_numpy(td), C, torch.from_numpy(w),
        torch.tensor(np.asarray(lower)), torch.tensor(np.asarray(upper)))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5,
                               atol=1e-15)
    if outlier:
        assert np.linalg.norm(got.x.numpy() - [0.3, 0.7, 0.2]) < 0.02


def test_lbfgsb_quadratic_matches_jax():
    a_np = np.diag([1.0, 10.0, 100.0])
    b_np = np.array([1.0, -2.0, 3.0])
    a_t, b_t = torch.from_numpy(a_np), torch.from_numpy(b_np)
    for lo, hi in (([-5.0] * 3, [5.0] * 3), ([-0.5, -5.0, 0.0],
                                              [5.0, 0.1, 5.0])):
        want = jsol.lbfgsb_minimize(
            lambda x: 0.5 * x @ jnp.asarray(a_np) @ x + jnp.asarray(b_np) @ x,
            jnp.zeros(3), jnp.asarray(lo), jnp.asarray(hi))
        got = tsol.lbfgsb_minimize(lambda x: 0.5 * x @ a_t @ x + b_t @ x,
                                   torch.zeros(3, dtype=torch.float64),
                                   torch.tensor(lo, dtype=torch.float64),
                                   torch.tensor(hi, dtype=torch.float64))
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   atol=1e-8)
        assert float(got.fun) == pytest.approx(float(want.fun), abs=1e-10)
    np.testing.assert_allclose(got.x.numpy()[1], 0.1)    # the active bound


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lbfgsb_tdoa_cost_matches_jax(seed):
    """The polish use: a start near the optimum of the TDOA cost."""
    rng = np.random.default_rng(seed)
    mics = rng.uniform(0, 1, (4, 3))
    src = rng.uniform(0.2, 0.8, 3)
    d = np.linalg.norm(mics - src[None], axis=1)
    td = (d[PJ] - d[PI]) / 343.0
    x0 = src + rng.uniform(-0.08, 0.08, 3)
    lo, hi = np.full(3, -0.5), np.full(3, 1.5)
    want = jsol.lbfgsb_minimize(
        lambda x: jnp.sum(jsol.tdoa_residuals(
            x, jnp.asarray(mics), np.array(PI), np.array(PJ),
            jnp.asarray(td), 343.0, jnp.ones(6)) ** 2),
        jnp.asarray(x0), jnp.asarray(lo), jnp.asarray(hi), maxiter=200)
    m_t, td_t = torch.from_numpy(mics), torch.from_numpy(td)
    ones = torch.ones(6, dtype=torch.float64)
    got = tsol.lbfgsb_minimize(
        lambda x: torch.sum(tsol.tdoa_residuals(x, m_t, PI, PJ, td_t, 343.0,
                                                ones) ** 2, -1),
        torch.from_numpy(x0), torch.from_numpy(lo), torch.from_numpy(hi),
        maxiter=200)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6)
    assert float(got.fun) <= 10.0 * float(want.fun) + 1e-12


def test_differential_evolution_reaches_the_jax_minimum():
    """Draws differ, so outcomes are compared: both land on the TDOA
    cost's minimum within 1e-4 m (polished by L-BFGS-B, tol 1e-6)."""
    src = np.array([0.4, 0.7, 0.3])
    td = _tdoas(src)
    lower, upper = MICS.min(0) - 1.0, MICS.max(0) + 1.0

    def jobj(x):
        r = jsol.tdoa_residuals(x, jnp.asarray(MICS), np.array(PI),
                                np.array(PJ), jnp.asarray(td), C, jnp.ones(6))
        return jnp.sum(r * r)

    want = jsol.differential_evolution(
        jobj, jnp.asarray(lower), jnp.asarray(upper), jax.random.PRNGKey(2),
        polish_fn=lambda x: tuple(jsol.lbfgsb_minimize(
            jobj, x, jnp.asarray(lower), jnp.asarray(upper))))
    m_t, td_t = torch.from_numpy(MICS), torch.from_numpy(td)
    lo_t, hi_t = torch.from_numpy(lower), torch.from_numpy(upper)
    ones = torch.ones(6, dtype=torch.float64)

    def tobj(x):
        return torch.sum(tsol.tdoa_residuals(x, m_t, PI, PJ, td_t, C,
                                             ones) ** 2, -1)

    got = tsol.differential_evolution(
        tobj, lo_t, hi_t, torch.Generator().manual_seed(2),
        polish_fn=lambda x: tuple(tsol.lbfgsb_minimize(tobj, x, lo_t, hi_t)))
    assert np.linalg.norm(np.asarray(want.x) - src) < 1e-4
    assert np.linalg.norm(got.x.numpy() - np.asarray(want.x)) < 1e-4
    assert float(got.energy) < 1e-9        # pgtol 1e-5 on a quadratic bowl


def test_differential_evolution_seeded_population():
    lower = torch.full((3,), -2.0, dtype=torch.float64)
    upper = torch.full((3,), 2.0, dtype=torch.float64)
    target = torch.tensor([0.7, -0.3, 1.1], dtype=torch.float64)

    def obj(x):
        return torch.sum((x - target) ** 2, -1)

    res = tsol.differential_evolution(
        obj, lower, upper, torch.Generator().manual_seed(0), maxiter=200,
        init=target[None] + 0.01)
    assert float(res.energy) < 1e-6
    again = tsol.differential_evolution(
        obj, lower, upper, torch.Generator().manual_seed(0), maxiter=200,
        init=target[None] + 0.01)
    assert torch.equal(res.x, again.x)


# ---------------------------------------------------------------------------
# localize_sound_source with the options
# ---------------------------------------------------------------------------

def _config(source=(0.2, 0.6, 0.4), signal_type="chirp", **loc):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=list(source),
               signal_type=signal_type)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               max_reflections=1, num_bootstrap=64,
                               visualize_correlation=False)
    cfg["localization"].update(loc)
    return cfg


OPTION_SETS = {
    "noise_null": dict(bootstrap_mode="noise"),
    "weighted": dict(gcc_weighting="scot", threshold_method="median",
                     filter_method="fir", clustering_method="dbscan",
                     solver="lm-robust", analyze_correlation=False),
    "no_gate": dict(max_expected_delay=None, threshold_method="adaptive",
                    filter_method="wiener"),
    "block_roth": dict(bootstrap_mode="block", gcc_weighting="roth",
                       phat_band=None),
    "circular_cc_median": dict(bootstrap_mode="circular", gcc_weighting="cc",
                               threshold_method="median",
                               filter_method="fir"),
}

CALIBRATION = [{"delay": d, "snr": 30.0}
               for d in (0.0, 1.25e-4, -5e-5, 2e-4)]


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
@pytest.mark.parametrize("scene", ["off_centre", "demo"])
def test_options_match_jax_end_to_end(monkeypatch, tmp_path, name, scene):
    """Identical TDOAs and positions within 1e-6 m (float64); the no-gate
    set also carries calibration delays.  The nulls draw from different
    generators, so 'significant' is compared only where the peak is clear
    of the port's threshold by 10 % (the two nulls' thresholds lie within
    a few per cent of each other, test_torch_noise_bootstrap)."""
    src, kind = (((0.2, 0.6, 0.4), "chirp") if scene == "off_centre"
                 else ((0.5, 0.5, 0.5), "sine"))
    monkeypatch.chdir(tmp_path)   # visualize_correlation saves figures
    cfg = _config(src, kind, visualize_correlation=True, **OPTION_SETS[name])
    calib = CALIBRATION if name == "no_gate" else None
    null = ttdoa.bootstrap_significance
    thresholds = []
    monkeypatch.setattr(ttdoa, "bootstrap_significance",
                        lambda *a, **k: thresholds.append(null(*a, **k))
                        or thresholds[-1])
    want = jpkg.localize_sound_source(cfg, calibration_data=calib,
                                      show_plots=False, dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, calibration_data=calib,
                                     device="cpu", dtype=torch.float64)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-6)
    assert got["cost"] == pytest.approx(want["cost"], rel=1e-6, abs=1e-12)
    assert (got["uncertainty"]["heuristic"]
            == want["uncertainty"]["heuristic"] is False)
    _close(got["correlation_matrix"], want["correlation_matrix"])
    if want["correlation_metrics"] is None:
        assert got["correlation_metrics"] is None and not thresholds
        return
    assert list(got["correlation_metrics"]) == list(want["correlation_metrics"])
    assert len(thresholds) == len(PI)
    compared = 0
    for (pair, w), thr in zip(want["correlation_metrics"].items(),
                              thresholds):
        g = got["correlation_metrics"][pair]
        np.testing.assert_allclose(g["snr"], w["snr"], rtol=1e-9)
        peak = got["correlation_matrix"][pair]
        if abs(peak - float(thr)) >= 0.1 * float(thr):
            assert g["significant"] == w["significant"], pair
            compared += 1
    assert compared >= 3


def _jax_and_port_tdoas(cfg, data):
    want = jpkg.localize_sound_source(cfg, calibration_data=data,
                                      show_plots=False, dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, calibration_data=data, device="cpu",
                                     dtype=torch.float64)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-6)
    assert got["calibration_data"] is data
    return got


def test_calibration_gate_and_entry_count():
    """Delays move the TDOAs by d_j - d_i; a worst SNR below 20, or the
    wrong number of entries, leaves them out (physical mode); entries
    without an SNR are trusted as given.  Each case through both
    packages."""
    cfg = _config(analyze_correlation=False)
    plain = _jax_and_port_tdoas(cfg, None)
    calibrated = _jax_and_port_tdoas(cfg, CALIBRATION)
    d = np.array([c["delay"] for c in CALIBRATION])
    np.testing.assert_allclose(calibrated["tdoas"],
                               plain["tdoas"] - (d[PJ] - d[PI]), atol=1e-15)
    gated = [dict(c, snr=19.0 if i == 2 else 30.0)
             for i, c in enumerate(CALIBRATION)]
    unsure = [{"delay": c["delay"]} for c in CALIBRATION]
    for data, moved in ((gated, False), (CALIBRATION[:3], False),
                        (unsure, True)):
        res = _jax_and_port_tdoas(cfg, data)
        want = calibrated if moved else plain
        np.testing.assert_allclose(res["tdoas"], want["tdoas"], atol=1e-15)


def test_de_fallback_matches_jax(monkeypatch):
    """An LM that returns no finite cost (patched inside this test in both
    packages) sends both to differential evolution + L-BFGS-B; the draws
    differ, the fixes agree, and the uncertainty is flagged heuristic.
    The unusual max_expected_delay keeps the patched JAX core from
    reusing a compiled graph of another test."""
    monkeypatch.setattr(jsol, "multi_start_lm", lambda g, *a, **k: jsol.LMResult(
        g[0], jnp.asarray(jnp.inf, g.dtype)))
    monkeypatch.setattr(tsol, "multi_start_lm", lambda g, *a, **k: tsol.LMResult(
        g[0], torch.tensor(float("inf"), dtype=g.dtype)))
    cfg = _config(max_expected_delay=0.00413, analyze_correlation=False)
    want = jpkg.localize_sound_source(cfg, show_plots=False,
                                      dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, device="cpu", dtype=torch.float64)
    assert not np.isfinite(got["cost"]) and not np.isfinite(want["cost"])
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], atol=1e-12)
    assert np.linalg.norm(got["estimated_position"]
                          - want["estimated_position"]) < 1e-3
    assert got["uncertainty"]["heuristic"] and want["uncertainty"]["heuristic"]


@pytest.mark.parametrize("key,value,match", [
    ("solver", "bogus", "Unknown solver"),
    ("gcc_weighting", "ml", "Unknown gcc_weighting"),
    ("bootstrap_mode", "bogus", "bootstrap_mode"),
    ("filter_method", "bogus", "Unknown filter method")])
def test_option_value_errors_match_jax(key, value, match):
    cfg = _config(**{key: value})
    with pytest.raises(ValueError, match=match):
        jpkg.localize_sound_source(cfg, show_plots=False, dtype=jnp.float64)
    with pytest.raises(ValueError, match=match):
        tpkg.localize_sound_source(cfg, device="cpu", dtype=torch.float64)
