"""The port's windowed fast path and batched sweep against the JAX package
(small sizes: 8-16 kHz, 0.1-0.25 s): the api's fast core and its dispatch,
``localize_batch``, the scene render, the batched solver tail and
covariance, the sweep's statistics, its spec, its refusals, and the entry
points' device rule."""

import copy
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu import api as japi
from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.models import solver as jsol
from pyaudiolocalization_tpu.models import uncertainty as junc
from pyaudiolocalization_tpu.parallel import sweep as jsw
from pyaudiolocalization_tpu_torch import api as tapi
from pyaudiolocalization_tpu_torch.models import solver as tsol
from pyaudiolocalization_tpu_torch.models import uncertainty as tunc
from pyaudiolocalization_tpu_torch.models.simulator import render_scene
from pyaudiolocalization_tpu_torch.parallel import sweep as tsw

REPO = Path(__file__).resolve().parents[1]
SPEC_ARGS = dict(fs=16000.0, duration=0.1, signal_type="noise",
                 source_box_lo=(0.2, 0.2, 0.2), source_box_hi=(0.8, 0.8, 0.8),
                 snr_db=(25.0, 35.0))
SPEC = tsw.SweepSpec(**SPEC_ARGS)
MULTIPATH = dict(SPEC_ARGS, plane_coeffs=((1.0, 0.0, 0.0, -5.0),
                                          (0.0, 1.0, 0.0, -5.0)),
                 plane_material_ids=(1, 2), max_reflections=2)
F64 = torch.float64


def _builder():
    spec = importlib.util.spec_from_file_location(
        "torch_sweep_golden", REPO / "tools" / "torch_sweep_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scenes(num, fs, duration, seed=0):
    return _builder().batch_scenes(seed, num, fs, duration,
                                   SPEC.mic_positions, SPEC.speed_of_sound,
                                   SPEC.source_box_lo, SPEC.source_box_hi)


def _jax_seed_indices(mics, td, key):
    """The k-means++ seed indices the JAX package draws for ``key`` on
    the pair guesses of ``td``."""
    pi, pj = (np.asarray(p, np.int32) for p in SPEC.pairs)
    points, valid = jsol.pair_guesses(jnp.asarray(mics), pi, pj,
                                      jnp.asarray(td), SPEC.speed_of_sound)
    points = np.asarray(points)
    seeds = np.asarray(jcl.kmeans(jnp.asarray(points), 5, key, iters=0,
                                  valid=valid).centers)
    return [int(np.flatnonzero(np.all(points == s, -1))[0]) for s in seeds]


# ---------------------------------------------------------------------------
# The api's windowed fast path
# ---------------------------------------------------------------------------

def _fast_config(**loc):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=[0.7, 0.3, 0.55],
               signal_type="noise")
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               analyze_correlation=False,
                               visualize_correlation=False,
                               max_expected_delay=0.05)
    cfg["localization"].update(loc)
    return cfg


@pytest.fixture
def jax_fast_interpret():
    assert not japi._FAST_INTERPRET
    japi._FAST_INTERPRET = True
    try:
        yield
    finally:
        japi._FAST_INTERPRET = False


def test_fast_path_matches_the_jax_fast_core(jax_fast_interpret):
    """Same injected signals: the port's fast path and the JAX package's
    windowed core (Pallas interpret mode) find the same lags, and the
    position within 1e-4 m (their k-means seeds differ)."""
    cfg = _fast_config()
    sigs, _ = _scenes(1, 8000.0, 0.25, seed=4)
    sigs = sigs[0]
    loc = jpkg.SceneConfig.from_dict(cfg).localization
    assert japi._fast_path_eligible(loc, 4096, 4, jnp.float32, 8000.0)
    assert tapi._fast_path_eligible(
        tpkg.SceneConfig.from_dict(cfg).localization, 4096, torch.float32,
        8000.0)
    want = jpkg.localize_sound_source(cfg, use_simulation=False,
                                      show_plots=False, signals=sigs,
                                      key=jax.random.PRNGKey(3),
                                      dtype=jnp.float32)
    got = tpkg.localize_sound_source(cfg, use_simulation=False, signals=sigs,
                                     device="cpu", dtype=torch.float32)
    assert np.any(np.abs(want["tdoas"]) > 0)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-4)
    assert got["correlation_metrics"] is None


@pytest.mark.parametrize("loc,dtype,nfft", [
    ({}, "float32", 4096), ({}, "float64", 4096), ({}, "float32", 65536),
    ({"analyze_correlation": True}, "float32", 4096),
    ({"visualize_correlation": True}, "float32", 4096),
    ({"solver": "srp"}, "float32", 4096),
    ({"gcc_weighting": "scot"}, "float32", 4096),
    ({"threshold_method": "median"}, "float32", 4096),
    ({"lag_mode": "reference"}, "float32", 4096),
    ({"max_expected_delay": None}, "float32", 4096),
    ({"max_expected_delay": 0.25}, "float32", 4096),
    ({"max_expected_delay": 0.3}, "float32", 4096),
    ({"filter_method": "wiener"}, "float32", 4096)])
def test_fast_path_dispatch_matches_jax(jax_fast_interpret, loc, dtype,
                                        nfft):
    cfg = _fast_config(**loc)
    jloc = jpkg.SceneConfig.from_dict(cfg).localization
    tloc = tpkg.SceneConfig.from_dict(cfg).localization
    want = japi._fast_path_eligible(jloc, nfft, 4, getattr(jnp, dtype),
                                    8000.0)
    got = tapi._fast_path_eligible(tloc, nfft, getattr(torch, dtype), 8000.0)
    assert got == want


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def test_sweep_spec_copy_equals_jax():
    tf = {f.name: f.default for f in dataclasses.fields(tsw.SweepSpec)}
    jf = {f.name: f.default for f in dataclasses.fields(jsw.SweepSpec)}
    assert tf == jf
    for args in ({}, SPEC_ARGS, MULTIPATH, dict(mic_jitter=0.01, fs=8000.0),
                 dict(delay_budget_s=0.01, nfft_mode="pow2")):
        t, j = tsw.SweepSpec(**args), jsw.SweepSpec(**args)
        for prop in ("num_mics", "num_samples", "pairs", "nfft",
                     "speed_of_sound", "max_tdoa", "delay_budget",
                     "total_samples"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert tsw._tdoa_window_wq(t) == jsw._tdoa_window_wq(j)
    with pytest.raises(dataclasses.FrozenInstanceError):
        SPEC.fs = 1.0


def test_localize_batch_matches_jax():
    """3 numpy-built scenes; the JAX package takes its full-correlation
    ladder on the CPU, the port its windowed one: the same lags, and with
    the JAX-drawn k-means seeds the same positions (its own draws land
    within 1e-4 m of them)."""
    spec = tsw.SweepSpec(**dict(SPEC_ARGS, duration=0.15))
    sigs, sources = _scenes(3, spec.fs, spec.duration, seed=2)
    sigs = sigs.astype(np.float64)
    key = jax.random.PRNGKey(5)
    jspec = jsw.SweepSpec(**dict(SPEC_ARGS, duration=0.15))
    mics = np.asarray(spec.mic_positions)
    west, _, wtd = jsw.localize_batch(jspec, jnp.asarray(sigs),
                                      jnp.asarray(mics), key)
    keys = jax.random.split(key, 3)
    idx = torch.tensor([_jax_seed_indices(mics, np.asarray(wtd)[b], keys[b])
                        for b in range(3)])
    est, _, td = tsw._estimate(spec, torch.tensor(sigs),
                               torch.tensor(mics).expand(3, 4, 3),
                               spec.speed_of_sound, None, seed_indices=idx)
    plain, _, td2 = tsw.localize_batch(spec, sigs, mics, 0, dtype=F64,
                                       device="cpu")
    assert torch.equal(td, td2)
    np.testing.assert_allclose(plain.numpy(), est.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(wtd), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(est.numpy(), np.asarray(west), rtol=0,
                               atol=1e-4)
    assert np.max(np.linalg.norm(est.numpy() - sources, axis=-1)) < 0.05


def test_scene_render_matches_jax_render_source():
    """JAX-drawn sources and mics, the JAX base: the port's batched image
    sources, paths and K3 render (no noise) equal JAX's _render_source."""
    tspec, jspec = tsw.SweepSpec(**MULTIPATH), jsw.SweepSpec(**MULTIPATH)
    c = jspec.speed_of_sound
    want, srcs, mics_all, bases = [], [], [], []
    for seed in (0, 1):
        k_scene, k_sig = jax.random.split(jax.random.PRNGKey(seed))
        sources, mics, _ = jsw._random_scene(jspec, k_scene, jnp.float64)
        want.append(np.asarray(jsw._render_source(
            jspec, sources[0], mics, c, jspec.freq, k_sig, jnp.float64,
            finalize=True)))
        bases.append(np.asarray(jpkg.ops.signal.generate_signal(
            jspec.signal_type, jspec.fs, jspec.duration, jspec.freq,
            key=k_sig, dtype=jnp.float64)))
        srcs.append(np.asarray(sources[0]))
        mics_all.append(np.asarray(mics))
    src_t = torch.tensor(np.stack(srcs))
    mics_t = torch.tensor(np.stack(mics_all))
    paths = tsw._source_paths(tspec, src_t, mics_t, c)
    assert paths.delays.shape == (2, 4, 1 + 4)  # direct + 2 + 2 images
    got = render_scene(torch.tensor(np.stack(bases)), paths.delays,
                       paths.gains, tspec.fs, tspec.total_samples,
                       tspec.num_samples, finalize=True)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0,
                               atol=1e-6)


def test_fused_and_split_paths_give_the_same_scene():
    """run_scene takes the fused path for this spec; the split path on the
    same draws gives the same scenes."""
    assert tsw._mono_scene_eligible(SPEC)
    public = tsw.run_scene(SPEC, 3, 4, device="cpu")
    for fused in (True, False):
        got = tsw._run_scenes(SPEC, torch.Generator().manual_seed(3), 4,
                              torch.float32, fused)
        for a, b in zip(got, public):
            assert torch.equal(a, b)


def test_sweep_single_device():
    """The thresholds of the JAX package's test of the same name."""
    s = tsw.monte_carlo_sweep(SPEC, 0, 8, device="cpu")
    assert s.results.estimate.shape == (8, 3)
    assert float(s.rmse) < 0.5
    assert float(s.hit_rate) > 0.5
    np.testing.assert_allclose(
        float(s.rmse), float(torch.sqrt(torch.mean(s.results.error ** 2))),
        rtol=1e-5)
    cov = s.results.covariance.double().numpy()
    assert cov.shape == (8, 3, 3) and np.all(np.isfinite(cov))
    np.testing.assert_allclose(cov, np.swapaxes(cov, -1, -2), rtol=1e-6)
    assert np.all(np.einsum("bii->bi", cov) > 0)
    again = tsw.monte_carlo_sweep(SPEC, 0, 8, device="cpu")
    assert torch.equal(again.results.estimate, s.results.estimate)


def test_sweep_multipath_scenes():
    """Reflective planes + image sources (the split path: the render
    length exceeds the correlation's transform)."""
    spec = tsw.SweepSpec(**MULTIPATH)
    assert not tsw._mono_scene_eligible(spec)
    s = tsw.monte_carlo_sweep(spec, 7, 4, device="cpu")
    assert np.all(np.isfinite(s.results.estimate.numpy()))
    assert float(s.rmse) < 1.0


@pytest.mark.parametrize("change", [
    dict(solver="de"), dict(solver="lm-robust"),
    dict(num_sources=2, solver="music"), dict(solver="beam"),
    dict(num_sources=2, solver="capon"), dict(filter_method="wiener"),
    dict(solver="music")])
def test_unsupported_specs_raise(change):
    """Once refused, now ported: each spec's localize_batch on numpy-built
    scenes (two noise sources summed for the multi-source specs) against
    the JAX package's.  The TDOA modes run with the JAX-drawn k-means seeds
    (the same lags, fixes to 1e-6 m; 'de' draws its own population, 1e-4
    m); the narrowband solvers return zero TDOAs and their fixes to 1e-6 m.
    The sweep itself then runs the spec on the CPU."""
    args = dict(SPEC_ARGS, **change)
    spec, jspec = tsw.SweepSpec(**args), jsw.SweepSpec(**args)
    sigs, _ = _scenes(2, spec.fs, spec.duration, seed=6)
    if spec.num_sources > 1:
        sigs = sigs + _scenes(2, spec.fs, spec.duration, seed=7)[0]
    sigs = sigs.astype(np.float64)
    mics = np.asarray(spec.mic_positions)
    key = jax.random.PRNGKey(5)
    west, _, wtd = jsw.localize_batch(jspec, jnp.asarray(sigs),
                                      jnp.asarray(mics), key)
    if spec.solver in ("music", "capon", "beam"):
        est, _, td = tsw.localize_batch(spec, sigs, mics, 0, dtype=F64,
                                        device="cpu")
        assert torch.all(td == 0)
        tol = 1e-6
    else:
        keys = jax.random.split(key, 2)
        idx = torch.tensor([_jax_seed_indices(mics, np.asarray(wtd)[b],
                                              keys[b]) for b in range(2)])
        est, _, td = tsw._estimate(spec, torch.tensor(sigs),
                                   torch.tensor(mics).expand(2, 4, 3),
                                   spec.speed_of_sound, None,
                                   seed_indices=idx)
        tol = 1e-4 if spec.solver == "de" else 1e-6
    np.testing.assert_allclose(td.numpy(), np.asarray(wtd), atol=1e-12)
    np.testing.assert_allclose(est.numpy(), np.asarray(west), atol=tol)
    s = tsw.monte_carlo_sweep(spec, 0, 2, device="cpu")
    assert np.all(np.isfinite(s.results.estimate.numpy()))


def test_sweep_refusals():
    with pytest.raises(TypeError, match="mesh"):
        tsw.monte_carlo_sweep(SPEC, 0, 8, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="gcc_weighting"):
        tsw.run_scene(tsw.SweepSpec(gcc_weighting="ml"), 0, device="cpu")


# ---------------------------------------------------------------------------
# The batched solver tail
# ---------------------------------------------------------------------------

def _scene_problems(num=4, seed=0):
    rng = np.random.default_rng(seed)
    mics = np.asarray(SPEC.mic_positions)[None] + 0.01 * \
        rng.standard_normal((num, 4, 3))
    src = rng.uniform(0.1, 0.9, (num, 3))
    pi, pj = (np.asarray(p) for p in SPEC.pairs)
    d = np.linalg.norm(src[:, None] - mics, axis=-1)
    td = (d[:, pj] - d[:, pi]) / SPEC.speed_of_sound
    return mics, td + 2e-6 * rng.standard_normal(td.shape)


def test_batched_solver_tail_equals_per_scene_calls():
    mics, td = _scene_problems()
    c = SPEC.speed_of_sound
    pi, pj = SPEC.pairs
    seeds = torch.tensor([[0, 1, 2, 3, 4], [5, 4, 3, 2, 1], [2, 0, 4, 1, 3],
                          [1, 1, 1, 1, 1]])
    m_t, td_t = torch.tensor(mics), torch.tensor(td)
    g, gv = tsol.heuristic_initial_guesses(m_t, pi, pj, td_t, c,
                                           seed_indices=seeds)
    lo, hi = tsol.dynamic_bounds(m_t, td_t, c)
    g = torch.clamp(g, lo[:, None], hi[:, None])
    w = torch.ones_like(td_t)
    best = tsol.multi_start_lm(g, m_t, pi, pj, td_t, c, w, lo, hi)
    cov = tunc.position_covariance(best.x, m_t, pi, pj, td_t, c)
    for b in range(len(mics)):
        g1, gv1 = tsol.heuristic_initial_guesses(m_t[b], pi, pj, td_t[b], c,
                                                 seed_indices=seeds[b])
        lo1, hi1 = tsol.dynamic_bounds(m_t[b], td_t[b], c)
        g1 = torch.clamp(g1, lo1[None], hi1[None])
        one = tsol.multi_start_lm(g1, m_t[b], pi, pj, td_t[b], c, w[b], lo1,
                                  hi1)
        assert torch.equal(g[b], g1) and torch.equal(gv[b], gv1)
        assert torch.equal(lo[b], lo1) and torch.equal(hi[b], hi1)
        assert torch.equal(best.x[b], one.x)
        assert torch.equal(best.cost[b], one.cost)
        # The covariance is not part of the tail; its batched 3x3 products
        # may sum in another order.
        torch.testing.assert_close(cov[b], tunc.position_covariance(
            one.x, m_t[b], pi, pj, td_t[b], c), rtol=1e-12, atol=0)


def test_batched_initial_guesses_match_jax_with_jax_seeds():
    mics, td = _scene_problems(3, seed=1)
    c = SPEC.speed_of_sound
    pi, pj = SPEC.pairs
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    idx = torch.tensor([_jax_seed_indices(mics[b], td[b], keys[b])
                        for b in range(3)])
    got, gvalid = tsol.heuristic_initial_guesses(
        torch.tensor(mics), pi, pj, torch.tensor(td), c, seed_indices=idx)
    for b in range(3):
        want, wvalid = jsol.heuristic_initial_guesses(
            jnp.asarray(mics[b]), np.asarray(pi), np.asarray(pj),
            jnp.asarray(td[b]), c, keys[b])
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-7, atol=1e-12)
        np.testing.assert_array_equal(gvalid[b].numpy(), np.asarray(wvalid))


def test_position_covariance_matches_jax():
    mics, td = _scene_problems(5, seed=2)
    rng = np.random.default_rng(3)
    x = rng.uniform(0.1, 0.9, (5, 3))
    c = SPEC.speed_of_sound
    pi, pj = (np.asarray(p, np.int32) for p in SPEC.pairs)
    want = jax.vmap(lambda xx, mm, tt: junc.position_covariance(
        xx, mm, pi, pj, tt, c))(jnp.asarray(x), jnp.asarray(mics),
                                jnp.asarray(td))
    got = tunc.position_covariance(torch.tensor(x), torch.tensor(mics),
                                   list(pi), list(pj), torch.tensor(td), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-18)
    short = tunc.position_covariance(torch.tensor(x), torch.tensor(mics),
                                     [0, 0, 1], [1, 2, 2],
                                     torch.tensor(td[:, :3]), c)
    assert short.shape == (5, 3, 3) and bool(torch.isnan(short).all())


# ---------------------------------------------------------------------------
# Device rule of the entry points
# ---------------------------------------------------------------------------

def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _fast_config()
    calls = [
        lambda: tpkg.localize_sound_source(cfg),
        lambda: tsw.localize_batch(SPEC, np.zeros((1, 4, 1600)),
                                   SPEC.mic_positions),
        lambda: tsw.run_scene(SPEC, 0),
        lambda: tsw.monte_carlo_sweep(SPEC, 0, 2),
        lambda: tpkg.localize_sound_source(cfg, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[0]()
