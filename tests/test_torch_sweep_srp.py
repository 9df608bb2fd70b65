"""The port's full-correlation sweep branch, its SRP solvers and its
multi-source scenes against the JAX package (small sizes: 16 kHz, 0.0625-
0.125 s, float64 on JAX-drawn signals), the fused-path gate, the api's
'srp' / 'srp+lm' solvers and their CLI flag, and the golden answers that
``chip_smoke.py`` holds the card to (tests/data/torch_srp_golden.json).

TDOAs are held to 1e-12 s.  Positions of the LM tail are held to 1e-6 m
with the JAX package's k-means seeds.  SRP positions are held to 1e-9 m
where the pooled coarse map's top two cells differ by more than 1e-9
relative; where they tie (max-pooled plateaus, broken by rounding in
either summation order), to a third of a coarse cell: the fine stage
around either tied cell settles on the same peak."""

import copy
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.models import solver as jsol
from pyaudiolocalization_tpu.models import srp as jsrp
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu.ops import pallas_fft
from pyaudiolocalization_tpu.parallel import sweep as jsw
from pyaudiolocalization_tpu_torch import __main__ as tmain
from pyaudiolocalization_tpu_torch import api as tapi
from pyaudiolocalization_tpu_torch.parallel import sweep as tsw

GOLDEN = json.loads((Path(__file__).resolve().parent / "data"
                     / "torch_srp_golden.json").read_text())
SPEC_ARGS = dict(fs=16000.0, duration=0.0625, signal_type="noise",
                 source_box_lo=(0.2, 0.2, 0.2), source_box_hi=(0.8, 0.8, 0.8),
                 snr_db=(25.0, 35.0))
MICS8 = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
         (1.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))
MULTI_ARGS = dict(fs=16000.0, duration=0.125, signal_type="noise",
                  mic_positions=MICS8, solver="srp", num_sources=2,
                  source_min_separation=0.4, source_box_lo=(0.1, 0.1, 0.1),
                  source_box_hi=(0.9, 0.9, 0.9), snr_db=(25.0, 35.0))
F64 = torch.float64


def _jax_signals(jspec, num, seed):
    """JAX-drawn scenes (sources, render, noise) in float64: signals
    (B, M, N), sources (B, K, 3)."""
    c = jspec.speed_of_sound
    sigs, srcs = [], []
    for b in range(num):
        k_scene, k_sim = jax.random.split(jax.random.PRNGKey(seed + b))
        sources, mics, snr = jsw._random_scene(jspec, k_scene, jnp.float64)
        sigs.append(np.asarray(jsw._simulate(jspec, sources, mics, c, snr,
                                             k_sim, jnp.float64)))
        srcs.append(np.asarray(sources))
    return np.stack(sigs), np.stack(srcs)


def _jax_seed_indices(spec, mics, td, key):
    """The k-means++ seed indices the JAX package draws for ``key`` on
    the pair guesses of ``td``."""
    pi, pj = (np.asarray(p, np.int32) for p in spec.pairs)
    points, valid = jsol.pair_guesses(jnp.asarray(mics), pi, pj,
                                      jnp.asarray(td), spec.speed_of_sound)
    points = np.asarray(points)
    seeds = np.asarray(jcl.kmeans(jnp.asarray(points), 5, key, iters=0,
                                  valid=valid).centers)
    return [int(np.flatnonzero(np.all(points == s, -1))[0]) for s in seeds]


def _coarse_clear(jspec, signals):
    """Per scene: whether the pooled coarse SRP map's top two cells differ
    by more than 1e-9 relative (the JAX package's map, float64)."""
    pi, pj = (np.asarray(p, np.int32) for p in jspec.pairs)
    blo, bhi = jsw._srp_box(jspec)
    pool = jsrp._resolve_pool(None, blo, bhi, 24, jspec.fs,
                              jspec.speed_of_sound)
    ml = int(np.ceil(jspec.max_tdoa * jspec.fs)) + 2
    pts = jsrp._grid_points(jnp.asarray(blo), jnp.asarray(bhi), 24,
                            jnp.float64)
    out = []
    for sig in signals:
        corr = jgcc.gcc_phat_all_pairs(jnp.asarray(sig), pi, pj,
                                       nfft=jspec.nfft,
                                       band=(jspec.lowcut, jspec.highcut),
                                       fs=jspec.fs)
        vals = np.sort(np.asarray(jsrp.srp_map(
            jsrp._pooled_window(corr, ml, pool), pts,
            jnp.asarray(jspec.mic_positions), pi, pj, jspec.fs,
            jspec.speed_of_sound, max_lag=ml, pre_windowed=True)))
        out.append(vals[-1] - vals[-2] > 1e-9 * abs(vals[-1]))
    return out


def _tie_tolerance(spec):
    blo, bhi = tsw._srp_box(spec)
    return float(np.max(bhi - blo)) / 24 / 3


# ---------------------------------------------------------------------------
# localize_batch against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [
    dict(solver="srp"), dict(solver="srp+lm"),
    dict(threshold_method="median"), dict(threshold_method="adaptive"),
    dict(gcc_weighting="scot"), dict(gcc_weighting="roth"),
    dict(gcc_weighting="cc", threshold_method="median")])
def test_localize_batch_full_correlation_branch_matches_jax(change):
    args = dict(SPEC_ARGS, **change)
    spec, jspec = tsw.SweepSpec(**args), jsw.SweepSpec(**args)
    assert not tsw._use_windowed(spec)
    sigs, sources = _jax_signals(jspec, 3, seed=10)
    mics = np.asarray(spec.mic_positions)
    key = jax.random.PRNGKey(5)
    west, wcost, wtd = (np.asarray(a) for a in jsw.localize_batch(
        jspec, jnp.asarray(sigs), jnp.asarray(mics), key))
    mics_t = torch.tensor(mics).expand(3, 4, 3)
    if spec.solver == "lm":
        keys = jax.random.split(key, 3)
        idx = torch.tensor([_jax_seed_indices(spec, mics, wtd[b], keys[b])
                            for b in range(3)])
        est, cost, td = tsw._estimate(spec, torch.tensor(sigs), mics_t,
                                      spec.speed_of_sound, None,
                                      seed_indices=idx)
        np.testing.assert_allclose(est.numpy(), west, rtol=0, atol=1e-6)
    else:
        est, cost, td = tsw.localize_batch(spec, sigs, mics, 0, dtype=F64,
                                           device="cpu")
        for b, clear in enumerate(_coarse_clear(jspec, sigs)):
            gap = np.linalg.norm(est[b].numpy() - west[b])
            assert gap < (1e-9 if clear else _tie_tolerance(spec)), (b, gap)
            if clear:
                np.testing.assert_allclose(float(cost[b]), wcost[b],
                                           rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(td.numpy(), wtd, rtol=0, atol=1e-12)
    assert np.max(np.linalg.norm(est.numpy() - sources[:, 0], axis=-1)) < 0.1


@pytest.mark.parametrize("suppression", ["spatial", "claim"])
def test_localize_batch_multi_source_matches_jax(suppression):
    args = dict(MULTI_ARGS, suppression=suppression)
    spec, jspec = tsw.SweepSpec(**args), jsw.SweepSpec(**args)
    sigs, sources = _jax_signals(jspec, 2, seed=20)
    mics = np.asarray(spec.mic_positions)
    west, wcost, wtd = (np.asarray(a) for a in jsw.localize_batch(
        jspec, jnp.asarray(sigs), jnp.asarray(mics), jax.random.PRNGKey(0)))
    est, cost, td = tsw.localize_batch(spec, sigs, mics, dtype=F64,
                                       device="cpu")
    assert est.shape == (2, 2, 3) and cost.shape == (2, 2)
    assert td.shape == (2, 28)
    np.testing.assert_allclose(td.numpy(), wtd, rtol=0, atol=1e-12)
    for b, clear in enumerate(_coarse_clear(jspec, sigs)):
        gap = np.max(np.linalg.norm(est[b].numpy() - west[b], axis=-1))
        assert gap < (1e-9 if clear else _tie_tolerance(spec)), (b, gap)
    for b in range(2):   # both sources found, in either order
        d = np.linalg.norm(est[b].numpy()[:, None] - sources[b][None],
                           axis=-1)
        assert min(d[0, 0] + d[1, 1], d[0, 1] + d[1, 0]) / 2 < 0.05


def test_over_wide_lag_gate_runs_the_capped_window():
    """fs 44.1 kHz x 10 ms: the lag gate outgrows K2's window, which is
    capped at nfft/2 as in the JAX package; the answers equal JAX's."""
    args = dict(SPEC_ARGS, fs=44100.0, duration=0.01)
    spec, jspec = tsw.SweepSpec(**args), jsw.SweepSpec(**args)
    assert tsw._use_windowed(spec)
    assert tsw._tdoa_window_wq(spec) == spec.nfft // 256
    sigs, sources = _jax_signals(jspec, 3, seed=30)
    mics = np.asarray(spec.mic_positions)
    key = jax.random.PRNGKey(7)
    west, _, wtd = (np.asarray(a) for a in jsw.localize_batch(
        jspec, jnp.asarray(sigs), jnp.asarray(mics), key))
    keys = jax.random.split(key, 3)
    idx = torch.tensor([_jax_seed_indices(spec, mics, wtd[b], keys[b])
                        for b in range(3)])
    est, _, td = tsw._estimate(spec, torch.tensor(sigs),
                               torch.tensor(mics).expand(3, 4, 3),
                               spec.speed_of_sound, None, seed_indices=idx)
    np.testing.assert_allclose(td.numpy(), wtd, rtol=0, atol=1e-12)
    np.testing.assert_allclose(est.numpy(), west, rtol=0, atol=1e-6)
    s = tsw.monte_carlo_sweep(spec, 0, 4, device="cpu")
    assert bool(torch.isfinite(s.results.estimate).all())


# ---------------------------------------------------------------------------
# run_scene: multi-source scenes, SRP scenes, the spec's refusals
# ---------------------------------------------------------------------------

def test_multi_source_scene_shapes_and_assignment():
    spec = tsw.SweepSpec(**MULTI_ARGS)
    res = tsw.run_scene(spec, 0, 4, dtype=F64, device="cpu")
    assert res.estimate.shape == res.source.shape == (4, 2, 3)
    assert res.error.shape == res.cost.shape == (4, 2)
    assert res.tdoas.shape == (4, 28)
    assert bool(torch.isnan(res.covariance).all())
    assert res.covariance.shape == (4, 3, 3)
    est, src = res.estimate.numpy(), res.source.numpy()
    np.testing.assert_allclose(res.error.numpy(),
                               np.linalg.norm(est - src, axis=-1), rtol=1e-12)
    # The kept assignment is the best of the two.
    swapped = np.linalg.norm(est[:, ::-1] - src, axis=-1).mean(-1)
    assert np.all(res.error.numpy().mean(-1) <= swapped)
    assert float(res.error.max()) < 0.1
    gaps = np.linalg.norm(src[:, 0] - src[:, 1], axis=-1)
    assert np.all(gaps >= spec.source_min_separation - 1e-9)
    assert np.all(res.cost.numpy() < 0)      # negated SRP powers
    again = tsw.run_scene(spec, 0, 4, dtype=F64, device="cpu")
    assert torch.equal(again.estimate, res.estimate)


@pytest.mark.parametrize("k,sep", [(3, 0.0), (3, 5.0)])
def test_source_draws(k, sep):
    """Without a separation every source takes its first candidate; with
    one that no candidate meets, candidate 0 (the soft constraint)."""
    spec = tsw.SweepSpec(**dict(MULTI_ARGS, num_sources=k,
                                source_min_separation=sep))
    gen = torch.Generator().manual_seed(3)
    got = tsw._draw_sources(spec, gen, 5, F64, torch.device("cpu"))
    cands = 0.1 + 0.8 * torch.rand((5, k, 16, 3),
                                   generator=torch.Generator().manual_seed(3),
                                   dtype=F64)
    assert torch.equal(got, cands[:, :, 0])


def test_source_draws_place_greedily():
    spec = tsw.SweepSpec(**dict(MULTI_ARGS, num_sources=3,
                                source_min_separation=0.5))
    got = tsw._draw_sources(spec, torch.Generator().manual_seed(4), 64, F64,
                            torch.device("cpu")).numpy()
    cands = (0.1 + 0.8 * torch.rand(
        (64, 3, 16, 3), generator=torch.Generator().manual_seed(4),
        dtype=F64)).numpy()
    for b in range(64):
        placed = []
        for k in range(3):
            ok = [all(np.linalg.norm(c - p) >= 0.5 for p in placed)
                  for c in cands[b, k]]
            placed.append(cands[b, k, ok.index(True) if any(ok) else 0])
        np.testing.assert_array_equal(got[b], np.stack(placed))


@pytest.mark.parametrize("solver", ["srp", "srp+lm"])
def test_srp_sweep_scenes(solver):
    """The reverberant regime at a small size: two planes at order 2."""
    spec = tsw.SweepSpec(**dict(
        SPEC_ARGS, duration=0.125, solver=solver,
        plane_coeffs=((1.0, 0.0, 0.0, -5.0), (0.0, 1.0, 0.0, -5.0)),
        plane_material_ids=(1, 2), max_reflections=2))
    assert not tsw._mono_scene_eligible(spec)
    s = tsw.monte_carlo_sweep(spec, 2, 6, device="cpu")
    assert float(s.hit_rate) >= 5 / 6
    cov = s.results.covariance.double().numpy()
    assert cov.shape == (6, 3, 3) and np.all(np.isfinite(cov))
    if solver == "srp":
        assert np.all(s.results.cost.numpy() < 0)


@pytest.mark.parametrize("change,match", [
    (dict(solver="lm"), "solver='srp'"),
    (dict(signal_type="sine"), "source_freqs"),
    (dict(num_sources=7), "num_sources"),
    (dict(source_freqs=(500.0,)), "num_sources entries")])
def test_multi_source_spec_validation_matches_jax(change, match):
    args = dict(MULTI_ARGS, **change)
    with pytest.raises(ValueError, match=match):
        jsw._check_spec(jsw.SweepSpec(**args))
    with pytest.raises(ValueError, match=match):
        tsw.run_scene(tsw.SweepSpec(**args), 0, device="cpu")


@pytest.fixture
def pallas_on_tpu(monkeypatch):
    """The JAX package's gate as it reads on a TPU host."""
    monkeypatch.setattr(pallas_fft, "available", lambda: True)


@pytest.mark.parametrize("change", [
    {}, dict(solver="srp"), dict(solver="srp+lm"), dict(solver="lm-robust"),
    dict(solver="de"), dict(solver="beam"), dict(num_sources=2, solver="srp"),
    dict(threshold_method="median"), dict(threshold_method="adaptive"),
    dict(gcc_weighting="scot"), dict(gcc_weighting="cc"),
    dict(filter_method="fir"), dict(filter_method="wiener"),
    dict(plane_coeffs=((1.0, 0.0, 0.0, -5.0),), plane_material_ids=(1,),
         max_reflections=2),
    dict(nfft_mode="pow2")])
def test_mono_scene_gate_equals_jax(pallas_on_tpu, change):
    args = dict(SPEC_ARGS, duration=0.1, **change)
    assert tsw._mono_scene_eligible(tsw.SweepSpec(**args)) == \
        jsw._mono_scene_eligible(jsw.SweepSpec(**args), jnp.float32)


# ---------------------------------------------------------------------------
# The api's SRP solvers
# ---------------------------------------------------------------------------

def _config(solver, **loc):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=[0.2, 0.6, 0.4],
               signal_type="chirp")
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               max_reflections=1, num_bootstrap=64,
                               visualize_correlation=False, solver=solver)
    cfg["localization"].update(loc)
    return cfg


@pytest.mark.parametrize("solver", ["srp", "srp+lm"])
@pytest.mark.parametrize("analyze", [True, False])
def test_api_srp_matches_jax(solver, analyze):
    cfg = _config(solver, analyze_correlation=analyze)
    want = jpkg.localize_sound_source(cfg, show_plots=False,
                                      dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, device="cpu", dtype=F64)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-9,
                               atol=1e-20)
    assert got["uncertainty"]["heuristic"] == want["uncertainty"]["heuristic"]
    assert got["uncertainty"]["heuristic"] == (solver == "srp")
    np.testing.assert_allclose(got["uncertainty"]["std"],
                               want["uncertainty"]["std"], rtol=1e-6,
                               atol=1e-12)
    assert (got["correlation_metrics"] is None) == (not analyze)


def test_api_srp_nfft_rule_matches_jax():
    """A wide array (3 m edges) and a 10 ms gate on 1,958 samples: the
    LM's window fits the circular 2,048 transform, SRP's diameter bound
    plus pool width does not, so SRP takes 4,096; the JAX package's
    answers follow the same rule."""
    assert tapi._physical_nfft(1958, 8000.0, 0.002) == 2048
    assert tapi._physical_nfft(1958, 8000.0, 0.002, 114) == 4096
    cfg = _config("srp", max_expected_delay=0.002, analyze_correlation=False)
    cfg.update(duration=1958 / 8000.0, source_position=[1.2, 2.1, 0.9],
               mic_positions=[[3.0 * v for v in m]
                              for m in cfg["mic_positions"]])
    scene = tpkg.SceneConfig.from_dict(cfg)
    blo, bhi, pool, max_lag = tapi._srp_grid_knobs(scene, scene.localization,
                                                   8000.0, 343.62)
    assert max_lag + pool + 3 > 90
    want = jpkg.localize_sound_source(cfg, show_plots=False,
                                      dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, device="cpu", dtype=F64)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0, atol=1e-9)


def test_cli_runs_the_srp_solvers(monkeypatch):
    seen = []

    def fake(config, **kw):
        seen.append(config["localization"]["solver"])
        return {"estimated_position": np.zeros(3),
                "actual_position": np.zeros(3)}

    monkeypatch.setattr(tmain, "localize_sound_source", fake)
    for solver in ("srp", "srp+lm"):
        assert tmain.main(["--solver", solver, "--no-calibration",
                           "--no-plots", "--device", "cpu"]) == 0
    assert seen == ["srp", "srp+lm"]


# ---------------------------------------------------------------------------
# The golden answers of the card's smoke test, on the CPU
# ---------------------------------------------------------------------------

def test_localize_batch_srp_matches_the_golden():
    """float32, as on the card: TDOAs within 0.05 samples on every scene;
    positions within 5 mm on every scene whose coarse margin (the map's
    maximum against its best cell more than one cell away) exceeds 1e-3
    relative, and within a coarse cell on the others."""
    case = GOLDEN["localize_batch"]
    spec = tsw.SweepSpec(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in case["spec"].items()})
    builder = Path(__file__).resolve().parents[1] / "tools" \
        / "torch_sweep_golden.py"
    mod_spec = importlib.util.spec_from_file_location("torch_sweep_golden",
                                                      builder)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    sigs, _ = module.batch_scenes(case["seed"], case["num_scenes"], spec.fs,
                                  spec.duration, spec.mic_positions,
                                  spec.speed_of_sound, spec.source_box_lo,
                                  spec.source_box_hi)
    est, _, td = tsw.localize_batch(spec, sigs, spec.mic_positions,
                                    device="cpu")
    np.testing.assert_allclose(td.numpy(), case["tdoas"], rtol=0,
                               atol=0.05 / spec.fs)
    clear = np.asarray(case["coarse_margin"]) > 1e-3
    assert clear.sum() >= 8
    gap = np.linalg.norm(est.numpy() - np.asarray(case["estimates"]), axis=-1)
    assert np.all(gap[clear] < 5e-3), gap
    assert np.all(gap < 3 * _tie_tolerance(spec)), gap


@pytest.mark.parametrize("name", ["off_centre/srp", "off_centre/srp+lm"])
def test_api_srp_scenes_match_the_golden(name):
    scene, solver = name.split("/")
    want = GOLDEN["scenes"][name]
    cfg = copy.deepcopy(tpkg.DEFAULT_CONFIG)
    cfg.update(source_position=want["source_position"],
               signal_type=want["signal_type"])
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               solver=solver, num_bootstrap=64)
    got = tpkg.localize_sound_source(cfg, device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=0.05 / cfg["fs"])
    assert np.linalg.norm(got["estimated_position"]
                          - np.asarray(want["estimated_position"])) < 5e-3
    assert got["uncertainty"]["heuristic"] == want["heuristic"]
