"""Parity mode of the port against the JAX package, module by module and end
to end (float64, small sizes: 8 kHz, 0.25 s, 64 bootstrap draws): the
reference lag axis, scipy's plateau peaks, the reference ladder, the
exact-length bootstrap, the exact and pow2 renders, ``simulate_signals``,
``simulate_signals_with_multipath``, pink noise and synthetic speech on
JAX-drawn draws, the plotting copy, ``localize_sound_source`` with the
pre-sync and the JAX package's calibration data, and the command-line
demo.  Tolerances are stated per test: float64 transforms of different
libraries agree to ~1e-13 of the signal scale."""

import copy
import inspect
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu.ops import delay as jdelay
from pyaudiolocalization_tpu.ops import fftutils as jfft
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu.ops import peaks as jpeaks
from pyaudiolocalization_tpu.ops import signal as jsig
from pyaudiolocalization_tpu.utils import plotting as jplot
from pyaudiolocalization_tpu_torch import __main__ as tmain
from pyaudiolocalization_tpu_torch import api as tapi
from pyaudiolocalization_tpu_torch.models import simulator as tsim
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft
from pyaudiolocalization_tpu_torch.ops import delay as tdelay
from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc
from pyaudiolocalization_tpu_torch.ops import peaks as tpeaks
from pyaudiolocalization_tpu_torch.ops import signal as tsig
from pyaudiolocalization_tpu_torch.utils import plotting as tplot

F64 = torch.float64
FS = 8000.0


def _close(got, want, rtol=1e-9, atol_scale=1e-12):
    """Within rtol, or atol_scale of the largest |want|."""
    want = np.asarray(want)
    atol = atol_scale * max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def _pairs(m):
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _config(source=(0.2, 0.6, 0.4), signal_type="sine", lag_mode="reference",
            **loc):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=list(source),
               signal_type=signal_type)
    cfg["localization"].update(dict(dict(num_bootstrap=64, lag_mode=lag_mode,
                                         visualize_correlation=False), **loc))
    return cfg


# ---------------------------------------------------------------------------
# ops/gccphat: the lag axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["reference", "compat", "physical"])
@pytest.mark.parametrize("n1,n2,n", [(2000, 2000, 3999), (100, 37, 136),
                                     (44100, 44100, 65536), (5, 9, 16)])
def test_lag_axes_equal_jax(mode, n1, n2, n):
    """Integer lag axes: equal exactly."""
    np.testing.assert_array_equal(tgcc.lag_axis(mode, n1, n2, n),
                                  jgcc.lag_axis(mode, n1, n2, n))
    np.testing.assert_array_equal(tgcc.lags_reference(n1, n2, n),
                                  jgcc.lags_reference(n1, n2, n))


def test_lag_axis_refuses_unknown_modes():
    with pytest.raises(ValueError, match="unknown lag mode"):
        tgcc.lag_axis("circular", 4, 4, 7)


# ---------------------------------------------------------------------------
# ops/peaks: scipy's plateau peaks
# ---------------------------------------------------------------------------

def _plateau_rows(seed):
    """Rows with flat runs, ties and edge plateaus: small integers, plus
    hand-made runs at both edges and a plateau at the maximum."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (6, 41)).astype(float)
    x[0, :4] = 3.0                  # a plateau at the left edge
    x[1, -5:] = 3.0                 # ... and at the right edge
    x[2] = 1.0                      # a constant row
    x[3, 10:16] = 5.0               # a wide plateau, even length
    x[4, 20:23] = 5.0               # odd length, and an equal peak elsewhere
    x[4, 30] = 5.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("plateaus", [True, False])
def test_local_maxima_match_jax(seed, plateaus):
    """Boolean masks: equal exactly (midpoint (left + right) // 2)."""
    x = _plateau_rows(seed)
    want = np.asarray(jpeaks.local_maxima(jnp.asarray(x), plateaus=plateaus))
    got = tpeaks.local_maxima(torch.tensor(x), plateaus=plateaus).numpy()
    np.testing.assert_array_equal(got, want)
    for n in (1, 2, 3):
        np.testing.assert_array_equal(
            tpeaks.local_maxima(torch.tensor(x[:, :n]), plateaus).numpy(),
            np.asarray(jpeaks.local_maxima(jnp.asarray(x[:, :n]),
                                           plateaus=plateaus)))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("windowed", [False, True])
def test_select_peaks_with_plateaus_matches_jax(seed, windowed):
    """Candidates, heights and survivors: equal exactly (the same stable
    order of equal heights)."""
    x = _plateau_rows(seed)
    thr = np.full((6, 1), 1.0)
    mask = np.zeros(41, bool)
    mask[8:30] = True
    kw = dict(window_mask=jnp.asarray(mask)) if windowed else {}
    want = jpeaks.select_peaks(jnp.asarray(x), jnp.asarray(thr), 3, 8,
                               plateaus=True, **kw)
    got = tpeaks.select_peaks(torch.tensor(x), torch.tensor(thr), 3, 8,
                              torch.tensor(mask) if windowed else None,
                              plateaus=True)
    keep = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), keep)
    np.testing.assert_array_equal(got[0].numpy()[keep],
                                  np.asarray(want[0])[keep])
    np.testing.assert_array_equal(got[1].numpy()[keep],
                                  np.asarray(want[1])[keep])


# ---------------------------------------------------------------------------
# models/tdoa: the reference ladder and the exact-length bootstrap
# ---------------------------------------------------------------------------

def _exact_corr(seed=0, n=1500, lag=17):
    """JAX-made exact-length PHAT correlations of three pairs of noise with
    known lags."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n + 64)
    sigs = np.stack([base[32:32 + n], base[32 + lag:32 + lag + n],
                     base[32 - lag // 2:32 - lag // 2 + n]])
    sigs = sigs + 0.3 * rng.standard_normal(sigs.shape)
    pi, pj = _pairs(3)
    corr = np.array(jgcc.gcc_phat_all_pairs(
        jnp.asarray(sigs), np.array(pi), np.array(pj), nfft=2 * n - 1))
    return corr, n


@pytest.mark.parametrize("method", ["median", "gaussian", "adaptive"])
@pytest.mark.parametrize("max_delay", [None, 0.05, 0.004])
def test_reference_ladder_matches_jax(method, max_delay):
    """The reference ladder (positional lag axis, no centring, plateau
    peaks, exact median) on JAX-made correlations: delays equal to 1e-12 s
    (the same lag-axis sample), valid flags and correlations equal."""
    corr, n = _exact_corr()
    want = jtdoa.time_delays_from_corr(
        jnp.asarray(corr), n, n, FS, num_peaks=2, threshold_method=method,
        max_expected_delay=max_delay, lag_mode="reference")
    got = ttdoa.time_delays_from_corr(
        torch.tensor(corr), n, n, FS, num_peaks=2, threshold_method=method,
        max_expected_delay=max_delay, lag_mode="reference")
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.corr.numpy(), corr)
    np.testing.assert_allclose(got.time_lags.numpy(),
                               np.asarray(want.time_lags), rtol=0, atol=1e-15)


def test_reference_ladder_falls_back_to_the_argmax():
    """Rows with no local maximum in the window (a ramp) take the argmax
    on the reference axis, as in the JAX package."""
    corr, n = _exact_corr(1)
    corr[1] = np.linspace(-1.0, 1.0, corr.shape[-1])
    for med in (None, 0.01):
        want = jtdoa.time_delays_from_corr(jnp.asarray(corr), n, n, FS,
                                           max_expected_delay=med,
                                           lag_mode="reference")
        got = ttdoa.time_delays_from_corr(torch.tensor(corr), n, n, FS,
                                          threshold_method="median",
                                          max_expected_delay=med,
                                          lag_mode="reference")
        np.testing.assert_allclose(got.delays.numpy(),
                                   np.asarray(want.delays), rtol=0,
                                   atol=1e-12)


def _jax_permuted_rows(key, sig2, num, chunk=64):
    """The rows JAX's permutation null draws: draw d permutes sig2 with
    key d of split(key, chunks * chunk) (models/tdoa.py:376-379 there)."""
    num_chunks = -(-num // chunk)
    keys = jax.random.split(key, num_chunks * chunk)
    return np.stack([np.asarray(jax.random.permutation(keys[d],
                                                       jnp.asarray(sig2)))
                     for d in range(num)])


@pytest.mark.parametrize("n1,nfft", [(700, 1399), (700, 1500), (900, 1000)])
def test_exact_length_bootstrap_matches_jax(n1, nfft):
    """JAX's XLA branch (a length its kernel does not take) against the
    port's exact-length route on the same JAX-drawn rows: thresholds equal
    to 1e-12 (float64 transforms of two libraries)."""
    rng = np.random.default_rng(n1)
    sig1 = rng.standard_normal(n1)
    sig2 = np.roll(sig1, 9) + 0.5 * rng.standard_normal(n1)
    key = jax.random.PRNGKey(5)
    want = jtdoa.bootstrap_significance(jnp.asarray(sig1), jnp.asarray(sig2),
                                        key, num_bootstrap=70, nfft=nfft)
    rows = _jax_permuted_rows(key, sig2, 70)
    got = ttdoa.bootstrap_threshold(torch.tensor(sig1), torch.tensor(rows),
                                    nfft)
    assert abs(float(got) - float(want)) < 1e-12


def test_exact_length_bootstrap_never_reaches_the_kernels(monkeypatch):
    """The route follows from the length: at 2n - 1 no K4a / K4b / K6
    wrapper is called, and the chunks (BOOT_CHUNK rows each) give the same
    peaks as one batch; at a power of two the kernels' wrappers are."""
    called = []
    for name in ("fft_real", "bootstrap_peaks", "noise_bootstrap_peaks"):
        fn = getattr(cuda_fft, name)
        monkeypatch.setattr(cuda_fft, name, lambda *a, _f=fn, _n=name, **k:
                            called.append(_n) or _f(*a, **k))
    monkeypatch.setattr(ttdoa, "BOOT_CHUNK", 16)
    gen = torch.Generator().manual_seed(1)
    sig1 = torch.randn(500, generator=gen, dtype=F64)
    sig2 = torch.randn(500, generator=gen, dtype=F64)
    for mode in ("permutation", "block", "circular", "noise"):
        ttdoa.bootstrap_significance(sig1, sig2, gen, 40,
                                     bootstrap_mode=mode, nfft=999)
    assert called == []
    rows = ttdoa.permuted_rows(sig2, 40, gen)
    chunked = ttdoa.exact_null_peaks(sig1, rows, 999)
    monkeypatch.setattr(ttdoa, "BOOT_CHUNK", 256)
    np.testing.assert_array_equal(chunked.numpy(),
                                  ttdoa.exact_null_peaks(sig1, rows,
                                                         999).numpy())
    ttdoa.bootstrap_significance(sig1, sig2, gen, 8, nfft=1024)
    ttdoa.bootstrap_significance(sig1, sig2, gen, 8, nfft=1024,
                                 bootstrap_mode="noise")
    assert called == ["fft_real", "bootstrap_peaks", "fft_real",
                      "noise_bootstrap_peaks"]


def test_exact_length_noise_null_uses_the_kernel_draws():
    """At a length the kernels do not take, the noise null correlates the
    same Philox uniforms K6 draws (ops/noise.uniform), to 1e-12."""
    gen = torch.Generator().manual_seed(2)
    sig1 = torch.randn(400, generator=gen, dtype=F64)
    sig2 = torch.randn(300, generator=gen, dtype=F64)
    got = ttdoa.noise_null_peaks(sig1, sig2, torch.Generator().manual_seed(7),
                                 33, 699)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (33, 2),
                          generator=torch.Generator().manual_seed(7),
                          dtype=torch.int32)
    rows = ttdoa.noise_ops.uniform(seeds, 300).to(F64)
    s1 = np.fft.rfft(sig1.numpy(), 699)
    r = s1 * np.conj(np.fft.rfft(rows.numpy(), 699))
    want = np.fft.irfft(r / (np.abs(r) + 1e-10), 699).max(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_get_time_delays_phat_reference_mode_matches_jax():
    """The single pair at the exact length with the default (reference)
    lag mode: delays equal to 1e-12 s."""
    corr, n = _exact_corr(2)
    rng = np.random.default_rng(2)
    a = rng.standard_normal(800)
    b = np.roll(a, 11) + 0.2 * rng.standard_normal(800)
    want = jtdoa.get_time_delays_phat(jnp.asarray(a), jnp.asarray(b), FS,
                                      num_peaks=3)
    got = ttdoa.get_time_delays_phat(torch.tensor(a), torch.tensor(b), FS,
                                     num_peaks=3)
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


# ---------------------------------------------------------------------------
# ops/delay and models/simulator: the exact renders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "pow2", "pow2-circular"])
@pytest.mark.parametrize("fade", [True, False])
def test_delay_and_sum_matches_jax(mode, fade):
    """Renders within 1e-12 of the waveform's peak."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal(1200)
    delays = rng.uniform(0.0, 0.05, (4, 5))
    gains = rng.uniform(0.1, 1.0, (4, 5))
    want = jdelay.delay_and_sum(jnp.asarray(base), jnp.asarray(delays),
                                jnp.asarray(gains), FS, apply_fade=fade,
                                pad_mode=mode)
    got = tdelay.delay_and_sum(torch.tensor(base), torch.tensor(delays),
                               torch.tensor(gains), FS, apply_fade=fade,
                               pad_mode=mode)
    _close(got, want, rtol=0, atol_scale=1e-12)


def test_exact_render_scene_matches_jax():
    """render_scene(pad_mode='exact'), finalized and raw: within 1e-12."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal(1000)
    delays = rng.uniform(0.001, 0.01, (3, 4))
    gains = rng.uniform(0.1, 1.0, (3, 4))
    for finalize in (True, False):
        want = jsim.render_scene(jnp.asarray(base), jnp.asarray(delays),
                                 jnp.asarray(gains), FS, 1100, 1000,
                                 pad_mode="exact", finalize=finalize)
        got = tsim.render_scene(torch.tensor(base), torch.tensor(delays),
                                torch.tensor(gains), FS, 1100, 1000,
                                pad_mode="exact", finalize=finalize)
        _close(got, want, rtol=0, atol_scale=1e-12)
    with pytest.raises(ValueError, match="pad_mode"):
        tsim.render_scene(torch.tensor(base), torch.tensor(delays),
                          torch.tensor(gains), FS, 1100, 1000,
                          pad_mode="pow2-circular")


@pytest.mark.parametrize("signal_type", ["sine", "chirp"])
@pytest.mark.parametrize("trim", [True, False])
@pytest.mark.parametrize("reflections", [0, 3])
def test_simulate_signals_matches_jax(signal_type, trim, reflections):
    """The reference's padding rule gives the same length, the renders
    agree within 1e-11 of their peak (1 after finalizing: the log
    compression steepens float64 rounding near zero crossings)."""
    scene = jpkg.SceneConfig.from_dict(_config(signal_type=signal_type))
    args = (scene.source_position, scene.mic_positions, FS, 343.6, 0.25,
            signal_type, 1000.0, scene.plane_coeffs,
            scene.plane_material_ids)
    want = jsim.simulate_signals(
        *args, jnp.asarray(scene.materials.absorption),
        jnp.asarray(scene.materials.freq), reflections, 0.01,
        trim_to_duration=trim, dtype=jnp.float64)
    got = tsim.simulate_signals(
        *args, scene.materials.absorption, scene.materials.freq,
        reflections, 0.01, trim_to_duration=trim, dtype=F64)
    assert got.shape == want.shape
    _close(got, want, rtol=0, atol_scale=1e-11)


def test_simulate_signals_with_multipath_matches_jax():
    """The public wrapper: a list of numpy arrays, as the JAX package's,
    within 1e-11; a material name outside the table raises as there."""
    planes = [{"plane": [1, 0, 0, -3], "material": "wood"},
              {"plane": [0, 1, 0, -4]}]
    props = {"air": {"absorption": 0.01, "freq": 1e-6},
             "wood": {"absorption": 0.05, "freq": 2e-6}}
    mics = np.array(jpkg.DEFAULT_CONFIG["mic_positions"], float)
    kw = dict(duration=0.25, signal_type="chirp", freq=700.0,
              reflective_planes=planes, material_properties=props,
              max_reflections=2, absorption_threshold=1e-4)
    want = jpkg.simulate_signals_with_multipath([0.3, 0.7, 0.4], mics, FS,
                                                343.6, dtype=jnp.float64,
                                                **kw)
    got = tpkg.simulate_signals_with_multipath([0.3, 0.7, 0.4], mics, FS,
                                               343.6, dtype=F64,
                                               device="cpu", **kw)
    assert isinstance(got, list) and len(got) == 4
    assert all(isinstance(g, np.ndarray) for g in got)
    _close(np.stack(got), np.stack(want), rtol=0, atol_scale=1e-11)
    bad = [{"plane": [1, 0, 0, -3], "material": "glass"}]
    with pytest.raises((KeyError, ValueError)):
        tpkg.simulate_signals_with_multipath([0.3, 0.7, 0.4], mics, FS,
                                             343.6, reflective_planes=bad,
                                             material_properties=props,
                                             device="cpu")


# ---------------------------------------------------------------------------
# ops/signal: pink noise and synthetic speech on JAX-drawn draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2000, 1999])
def test_pink_noise_matches_jax_on_its_draw(n):
    """The shaping after the white draw, within 1e-12."""
    key = jax.random.PRNGKey(3)
    white = np.asarray(jax.random.normal(key, (n,), jnp.float64))
    want = jsig.pink_noise(key, FS, n, jnp.float64)
    got = tsig._pink_from_white(torch.tensor(white), FS)
    _close(got, want, rtol=0, atol_scale=1e-12)


@pytest.mark.parametrize("duration", [0.25, 1.0])
def test_realistic_speech_matches_jax_on_its_draws(duration):
    """The JAX package's draws (starts, bursts, then the pink noise's white
    draw, from split(key, 3)) through the port's shaping, within 1e-12."""
    key = jax.random.PRNGKey(11)
    n = int(FS * duration)
    length = int(0.01 * FS)
    count = int(duration * 5)
    k_start, k_noise, k_pink = jax.random.split(key, 3)
    starts = np.asarray(jax.random.randint(k_start, (count,), 0,
                                           n - length))
    bursts = np.asarray(jax.random.normal(k_noise, (count, length),
                                          jnp.float64))
    white = np.asarray(jax.random.normal(k_pink, (n,), jnp.float64))
    want = jsig.realistic_speech(key, FS, n, duration, jnp.float64)
    got = tsig._speech_from_draws(FS, n, torch.tensor(starts),
                                  torch.tensor(bursts), torch.tensor(white))
    _close(got, want, rtol=0, atol_scale=1e-12)


def test_speech_draws_in_the_jax_order():
    """realistic_speech draws starts, then bursts, then the white noise,
    from its generator; generate_signal('speech') is that signal."""
    n, duration = 2000, 0.25
    got = tsig.generate_signal("speech", FS, duration, 1000.0,
                               generator=torch.Generator().manual_seed(4),
                               dtype=F64)
    gen = torch.Generator().manual_seed(4)
    starts = torch.randint(0, n - 80, (1,), generator=gen)
    bursts = torch.randn((1, 80), generator=gen, dtype=F64)
    white = torch.randn(n, generator=gen, dtype=F64)
    np.testing.assert_array_equal(
        got.numpy(), tsig._speech_from_draws(FS, n, starts, bursts,
                                             white).numpy())
    assert float(got.abs().max()) == pytest.approx(1.0)
    pink = tsig.pink_noise(torch.Generator().manual_seed(9), FS, n, F64)
    np.testing.assert_array_equal(
        pink.numpy(), tsig._pink_from_white(torch.randn(
            n, generator=torch.Generator().manual_seed(9), dtype=F64),
            FS).numpy())


# ---------------------------------------------------------------------------
# utils/plotting: the copy
# ---------------------------------------------------------------------------

PLOTS = ("plot_correlation_heatmap", "plot_correlation_3d",
         "plot_localization_3d", "plot_calibration_results", "_plt")


@pytest.mark.parametrize("name", PLOTS)
def test_plotting_copy_equals_the_jax_module(name):
    """Every function of the copy is the JAX module's, to the character."""
    assert inspect.getsource(getattr(tplot, name)) == inspect.getsource(
        getattr(jplot, name))
    assert sorted(n for n in vars(tplot) if not n.startswith("__")) == \
        sorted(n for n in vars(jplot) if not n.startswith("__"))


def _draw_all(module, path):
    mics = np.array(jpkg.DEFAULT_CONFIG["mic_positions"], float)
    corr = np.random.default_rng(0).standard_normal((6, 65))
    module.plot_correlation_heatmap(np.eye(4), mics, show_plot=False,
                                    save_path=str(path / "heatmap.png"))
    module.plot_correlation_3d(list(corr), [(0, 1)] * 6, FS,
                               show_plot=False,
                               save_path=str(path / "c3d.png"))
    module.plot_localization_3d(mics, [0.5, 0.5, 0.5], [0.4, 0.5, 0.6],
                                show_plot=False,
                                save_path=str(path / "loc.png"))
    module.plot_calibration_results([{"delay": 0.01, "amplitude": 2.0}] * 4,
                                    show_plot=False,
                                    save_path=str(path / "cal.png"))
    return sorted(p.name for p in path.iterdir())


def test_plotting_copy_writes_the_same_files(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _draw_all(jplot, tmp_path / "jax")
    got = _draw_all(tplot, tmp_path / "torch")
    assert got == want == ["c3d.png", "cal.png", "heatmap.png", "loc.png"]
    assert all((tmp_path / "torch" / f).stat().st_size > 0 for f in got)


def test_parity_run_without_matplotlib_warns_and_writes_nothing(
        tmp_path, monkeypatch, caplog):
    """The figure is the one divergence: without matplotlib a headless run
    logs one warning naming it and writes no file; show_plots=True raises
    ImportError."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = _config(num_bootstrap=8)
    cfg["localization"]["analyze_correlation"] = False
    with caplog.at_level(logging.WARNING, logger=tapi.logger.name):
        tpkg.localize_sound_source(cfg, device="cpu", dtype=F64)
    warned = [r for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warned) == 1 and list(tmp_path.iterdir()) == []
    with pytest.raises(ImportError):
        tpkg.localize_sound_source(cfg, device="cpu", dtype=F64,
                                   show_plots=True)


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

def _margins(res_corr, n, lag_mode, max_delay):
    """Each pair's chosen in-window peak over its runner-up, relative."""
    corr = res_corr.numpy()
    nfft = corr.shape[-1]
    shift = n - 1
    if lag_mode == "physical":
        shift = n - 1 if nfft >= 2 * n - 1 else nfft // 2
        corr = np.roll(corr, shift, -1)
    lags = (np.arange(nfft) - shift) / FS
    lm = tpeaks.local_maxima(torch.tensor(corr),
                             plateaus=lag_mode != "physical").numpy()
    out = []
    for row, mask in zip(corr, lm & (np.abs(lags) <= max_delay)):
        h = np.sort(row[mask])[::-1]
        out.append((h[0] - h[1]) / abs(h[0]))
    return np.array(out)


@pytest.mark.parametrize("case", ["parity_sine", "parity_chirp",
                                  "default_demo"])
def test_parity_mode_matches_jax_end_to_end(case, tmp_path, monkeypatch):
    """localize_sound_source with the pre-sync and the JAX package's
    calibration data: parity mode (lag_mode='reference', calibration
    applied verbatim) on off-centre scenes, and the default demo's
    configuration (the physical lag axis with the reference pre-sync,
    calibration behind the SNR gate).  Every pair's peak is clear of its
    runner-up (checked), so TDOAs must be equal (1e-12 s: the same lag
    sample) and positions within 1e-6 m; 'significant' is compared where
    the peak is 10 % clear of the port's threshold (different
    generators).  The figure goes to a temporary directory."""
    monkeypatch.chdir(tmp_path)
    source, kind, lag_mode = {
        "parity_sine": ((0.2, 0.6, 0.4), "sine", "reference"),
        "parity_chirp": ((0.7, 0.3, 0.2), "chirp", "reference"),
        "default_demo": ((0.2, 0.6, 0.4), "chirp", "physical")}[case]
    cfg = _config(source, kind, lag_mode)
    calibration, _, _ = jpkg.run_calibration(cfg, dtype=jnp.float64)
    seen = {}
    core = tapi._estimation_core
    monkeypatch.setattr(tapi, "_estimation_core", lambda *a, **k: seen.update(
        n=a[0].shape[-1], out=core(*a, **k)) or seen["out"])
    null = ttdoa.bootstrap_significance
    thresholds = []
    monkeypatch.setattr(ttdoa, "bootstrap_significance",
                        lambda *a, **k: thresholds.append(null(*a, **k))
                        or thresholds[-1])
    want = jpkg.localize_sound_source(cfg, calibration_data=calibration,
                                      show_plots=False, dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, calibration_data=calibration,
                                     device="cpu", dtype=F64)
    margins = _margins(seen["out"]["corr"], seen["n"], lag_mode, 0.05)
    assert margins.min() > 1e-3, margins
    assert set(got) == set(want)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-6)
    assert got["uncertainty"]["heuristic"] == want["uncertainty"]["heuristic"]
    if lag_mode == "reference":
        assert (tmp_path / "localization_result.png").stat().st_size > 0
    for k, pair in enumerate(sorted(want["correlation_metrics"])):
        peak = float(seen["out"]["corr"][k].max())
        if abs(peak - float(thresholds[k])) > 0.1 * float(thresholds[k]):
            assert (got["correlation_metrics"][pair]["significant"]
                    == want["correlation_metrics"][pair]["significant"])


def test_parity_mode_refuses_what_jax_refuses():
    cfg = _config()
    cfg["absorption_mode"] = "per-bin"
    with pytest.raises(ValueError, match="absorption_mode"):
        tpkg.localize_sound_source(cfg, device="cpu", dtype=F64)
    cfg = _config(solver="srp")
    with pytest.raises(ValueError, match="physical-mode extensions"):
        tpkg.localize_sound_source(cfg, device="cpu", dtype=F64)


def test_demo_runs_the_default_demo_on_the_cpu(tmp_path, monkeypatch,
                                               caplog):
    """``python -m pyaudiolocalization_tpu_torch --device cpu`` on a small
    config: the calibration's per-mic and average log lines, then the
    localization; its figure goes to the working directory."""
    monkeypatch.chdir(tmp_path)
    small = copy.deepcopy(tmain.DEFAULT_CONFIG)
    small.update(fs=8000, duration=0.25)
    small["localization"].update(num_bootstrap=16,
                                 visualize_correlation=False)
    monkeypatch.setattr(tmain, "DEFAULT_CONFIG", small)
    with caplog.at_level(logging.INFO, logger="pyaudiolocalization_tpu_torch"):
        assert tmain.main(["--device", "cpu", "--no-plots"]) == 0
    text = caplog.text
    for line in ("Microphone 1: delay", "Microphone 4: delay",
                 "Average delay", "Average amplitude", "Signals synchronized",
                 "Estimated position"):
        assert line in text
    with caplog.at_level(logging.INFO, logger="pyaudiolocalization_tpu_torch"):
        assert tmain.main(["--device", "cpu", "--no-plots",
                           "--no-calibration", "--physical"]) == 0
