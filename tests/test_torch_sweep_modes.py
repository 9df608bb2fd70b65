"""The sweep's remaining modes against the JAX package (small sizes: 16 kHz
x 0.1-0.25 s): the front end ``_prefilter`` (Wiener really runs, with no
band), the robust LM and differential evolution batched over scenes
(``multi_start_lm_robust``, ``differential_evolution_batched``,
``lbfgsb_minimize_batched``), and ``localize_batch`` with 'lm-robust',
'de', Wiener, and the narrowband 'beam' / 'music' / 'capon', single- and
multi-source.

The TDOA solvers are held with the JAX-drawn k-means seeds
(``seed_indices``) to 1e-6 m; DE draws differ, so its fixes are held to
1e-4 m on well-posed scenes and its cost to JAX's + 1e-10 where the
TDOAs are consistent (zero residual): the L-BFGS-B polish stops at a
projected gradient of 1e-5 (scipy's pgtol), which leaves costs of
1e-11 to 1e-10 that differ with the start."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.models import solver as jsol
from pyaudiolocalization_tpu.parallel import sweep as jsw
from pyaudiolocalization_tpu_torch.models import solver as tsol
from pyaudiolocalization_tpu_torch.parallel import sweep as tsw

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64
SPEC_ARGS = dict(fs=16000.0, duration=0.15, signal_type="noise",
                 source_box_lo=(0.2, 0.2, 0.2), source_box_hi=(0.8, 0.8, 0.8),
                 snr_db=(25.0, 35.0))
CUBE8 = tuple((x, y, z) for x in (0.0, 1.0) for y in (0.0, 1.0)
              for z in (0.0, 1.0))
TRIO = dict(fs=16000.0, duration=0.25, signal_type="sine", freq=800.0,
            mic_positions=CUBE8, source_box_lo=(0.2, 0.2, 0.2),
            source_box_hi=(0.8, 0.8, 0.8), snr_db=(25.0, 35.0))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def noise_scenes(num, seed, **args):
    spec = tsw.SweepSpec(**dict(SPEC_ARGS, **args))
    sigs, src = _load("torch_sweep_golden").batch_scenes(
        seed, num, spec.fs, spec.duration, spec.mic_positions,
        spec.speed_of_sound, spec.source_box_lo, spec.source_box_hi)
    return sigs.astype(np.float64), src


def tone_scenes(num, seed, **args):
    spec = tsw.SweepSpec(**dict(TRIO, **args))
    sigs, src = _load("torch_narrowband_golden").tone_scenes(
        seed, num, spec.fs, spec.duration, spec.mic_positions,
        spec.speed_of_sound, spec.source_box_lo, spec.source_box_hi,
        spec.freq)
    return sigs.astype(np.float64), src


def jax_seed_indices(spec, mics, td, key):
    """The k-means++ seed indices the JAX package draws for ``key`` on the
    pair guesses of ``td``."""
    pi, pj = (np.asarray(p, np.int32) for p in spec.pairs)
    points, valid = jsol.pair_guesses(jnp.asarray(mics), pi, pj,
                                      jnp.asarray(td), spec.speed_of_sound)
    points = np.asarray(points)
    seeds = np.asarray(jcl.kmeans(jnp.asarray(points), 5, key, iters=0,
                                  valid=valid).centers)
    return [int(np.flatnonzero(np.all(points == s, -1))[0]) for s in seeds]


def jax_batch(spec_args, sigs, key=5):
    jspec = jsw.SweepSpec(**spec_args)
    mics = np.asarray(jspec.mic_positions)
    return jsw.localize_batch(jspec, jnp.asarray(sigs), jnp.asarray(mics),
                              jax.random.PRNGKey(key))


def port_with_jax_seeds(spec_args, sigs, wtd, key=5):
    """The port's _estimate with the k-means seeds JAX drew per scene."""
    spec = tsw.SweepSpec(**spec_args)
    mics = np.asarray(spec.mic_positions)
    keys = jax.random.split(jax.random.PRNGKey(key), len(sigs))
    idx = torch.tensor([jax_seed_indices(spec, mics, np.asarray(wtd)[b],
                                         keys[b]) for b in range(len(sigs))])
    return tsw._estimate(spec, torch.tensor(sigs),
                         torch.tensor(mics).expand(len(sigs), *mics.shape),
                         spec.speed_of_sound, None, seed_indices=idx)


def assert_narrowband_batch(spec_args, sigs, margins=None):
    """localize_batch of a narrowband spec: the fixes within 1e-6 m of
    JAX's (where the coarse map's top is clear, when margins are given),
    the costs to 1e-6 relative, zero TDOAs."""
    west, wcost, wtd = jax_batch(spec_args, sigs)
    spec = tsw.SweepSpec(**spec_args)
    est, cost, td = tsw.localize_batch(spec, sigs, spec.mic_positions, 0,
                                       dtype=F64, device="cpu")
    assert est.shape == np.asarray(west).shape
    assert torch.all(td == 0) and np.all(np.asarray(wtd) == 0)
    keep = (np.ones(len(sigs), bool) if margins is None
            else np.asarray(margins) > 1e-9)
    np.testing.assert_allclose(est.numpy()[keep], np.asarray(west)[keep],
                               atol=1e-6)
    np.testing.assert_allclose(cost.numpy()[keep], np.asarray(wcost)[keep],
                               rtol=1e-6)
    return est


# ---------------------------------------------------------------------------
# The front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["butterworth", "fir", "wiener"])
def test_prefilter_matches_jax(method):
    """LTI front ends are not run (the band mask replaces them); Wiener
    really runs and whitens every bin."""
    sigs, _ = noise_scenes(2, 1)
    args = dict(SPEC_ARGS, filter_method=method)
    want, wband = jsw._prefilter(jsw.SweepSpec(**args), jnp.asarray(sigs))
    got, band = tsw._prefilter(tsw.SweepSpec(**args), torch.tensor(sigs))
    assert band == wband == (None if method == "wiener" else (300.0, 3400.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert (method == "wiener") == (not np.array_equal(got.numpy(), sigs))


# ---------------------------------------------------------------------------
# The batched solvers
# ---------------------------------------------------------------------------

MICS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, 0.0, 1.0]])
PI, PJ = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)
C = 343.0


def _problems(num, seed, noise=0.0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.2, 0.8, (num, 3))
    d = np.linalg.norm(src[:, None] - MICS[None], axis=-1)
    td = (d[:, PJ] - d[:, PI]) / C + noise * rng.standard_normal((num, 6))
    mics = np.broadcast_to(MICS, (num, 4, 3)).copy()
    lo, hi = (t.numpy() for t in tsol.dynamic_bounds(
        torch.tensor(mics), torch.tensor(td), C))
    return src, td, mics, lo, hi


def _batched_objective(mics, td):
    m_t, td_t = torch.tensor(mics), torch.tensor(td)
    w = torch.ones_like(td_t)

    def objective(x):
        one = x.dim() == 2
        xs = x[:, None] if one else x
        r = tsol.tdoa_residuals(xs, m_t[:, None], PI, PJ, td_t[:, None], C,
                                w[:, None])
        e = torch.sum(r * r, -1)
        return e[:, 0] if one else e

    return objective


def _jax_objective(td):
    def objective(x):
        r = jsol.tdoa_residuals(x, jnp.asarray(MICS), np.array(PI),
                                np.array(PJ), jnp.asarray(td), C,
                                jnp.ones(6))
        return jnp.sum(r * r)
    return objective


def test_lbfgsb_batched_matches_jax_per_scene():
    """Four problems in lock-step, each equal to JAX's own run (1e-8)."""
    src, td, mics, lo, hi = _problems(4, 0, noise=2e-6)
    x0 = src + np.random.default_rng(1).uniform(-0.08, 0.08, src.shape)
    got = tsol.lbfgsb_minimize_batched(_batched_objective(mics, td),
                                       torch.tensor(x0), torch.tensor(lo),
                                       torch.tensor(hi))
    for b in range(4):
        want = jsol.lbfgsb_minimize(_jax_objective(td[b]), jnp.asarray(x0[b]),
                                    jnp.asarray(lo[b]), jnp.asarray(hi[b]))
        np.testing.assert_allclose(got.x[b].numpy(), np.asarray(want.x),
                                   atol=1e-8)
        np.testing.assert_allclose(float(got.fun[b]), float(want.fun),
                                   rtol=1e-6, atol=1e-15)


def test_de_batched_reaches_the_jax_minimum():
    """Consistent TDOAs (zero residual), each population seeded with the
    mic centroid as the sweep seeds it with the clustered guesses: every
    scene's DE + L-BFGS-B fix within 1e-4 m of JAX's (its draws differ)
    and of the source, and its cost at most JAX's + 1e-10 (the polish's
    stopping precision; module docstring)."""
    src, td, mics, lo, hi = _problems(3, 2)
    init = np.broadcast_to(MICS.mean(0), (3, 1, 3)).copy()
    got = tsol.differential_evolution_batched(
        _batched_objective(mics, td), torch.tensor(lo), torch.tensor(hi),
        torch.Generator().manual_seed(0), maxiter=200,
        init=torch.tensor(init),
        polish_fn=lambda x: tuple(tsol.lbfgsb_minimize_batched(
            _batched_objective(mics, td), x, torch.tensor(lo),
            torch.tensor(hi))))
    for b in range(3):
        obj = _jax_objective(td[b])
        lo_j, hi_j = jnp.asarray(lo[b]), jnp.asarray(hi[b])
        want = jsol.differential_evolution(
            obj, lo_j, hi_j, jax.random.PRNGKey(b), maxiter=200,
            init=jnp.asarray(init[b]),
            polish_fn=lambda x: tuple(jsol.lbfgsb_minimize(obj, x, lo_j,
                                                           hi_j)))
        assert np.linalg.norm(got.x[b].numpy() - np.asarray(want.x)) < 1e-4
        assert np.linalg.norm(got.x[b].numpy() - src[b]) < 1e-4
        assert float(got.energy[b]) <= float(want.energy) + 1e-10


def test_de_batched_freezes_a_converged_scene():
    """Scene 0's population starts converged (std of its energies below
    1e-8 + tol |mean|), though a trial could still lower it: it must stop
    at generation 0 and return its best seeded member; scene 1 runs on to
    its own minimum."""
    target = torch.tensor([[0.0, 0.0, 0.0], [0.7, -0.3, 1.1]], dtype=F64)

    def objective(x):
        sq = torch.sum((x - target[:, None]) ** 2, -1)
        flat = 1.0 + 1e-12 * sq[0]
        return torch.stack([flat, sq[1]])

    lower = torch.full((2, 3), -2.0, dtype=F64)
    upper = torch.full((2, 3), 2.0, dtype=F64)
    init = torch.rand((2, 45, 3), generator=torch.Generator().manual_seed(3),
                      dtype=F64) * 4.0 - 2.0
    res = tsol.differential_evolution_batched(
        objective, lower, upper, torch.Generator().manual_seed(0),
        maxiter=300, init=init)
    best0 = init[0, torch.argmin(torch.sum(init[0] ** 2, -1))]
    assert torch.equal(res.x[0], best0)
    assert float(torch.linalg.norm(res.x[1] - target[1])) < 1e-3


def test_robust_lm_batched_equals_per_scene_calls():
    src, td, mics, lo, hi = _problems(3, 4, noise=2e-6)
    td[1, 4] += 4e-4                                  # one corrupted pair
    rng = np.random.default_rng(5)
    g = np.concatenate([rng.uniform(-1, 2, (3, 4, 3)),
                        np.broadcast_to(MICS.mean(0), (3, 1, 3))], 1)
    w = torch.ones((3, 6), dtype=F64)
    batch = tsol.multi_start_lm_robust(torch.tensor(g), torch.tensor(mics),
                                       PI, PJ, torch.tensor(td), C, w,
                                       torch.tensor(lo), torch.tensor(hi))
    for b in range(3):
        one = tsol.multi_start_lm_robust(
            torch.tensor(g[b]), torch.tensor(MICS), PI, PJ,
            torch.tensor(td[b]), C, w[b], torch.tensor(lo[b]),
            torch.tensor(hi[b]))
        assert torch.equal(batch.x[b], one.x)
    assert np.linalg.norm(batch.x[1].numpy() - src[1]) < 0.02


# ---------------------------------------------------------------------------
# localize_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [dict(solver="lm-robust"),
                                    dict(filter_method="wiener")])
def test_tdoa_modes_match_jax_with_jax_seeds(change):
    """The same lags as JAX's (K2's window here, its full ladder there) and,
    with the JAX-drawn k-means seeds, the same fixes to 1e-6 m."""
    args = dict(SPEC_ARGS, **change)
    sigs, src = noise_scenes(3, 2)
    west, _, wtd = jax_batch(args, sigs)
    est, _, td = port_with_jax_seeds(args, sigs, wtd)
    np.testing.assert_allclose(td.numpy(), np.asarray(wtd), atol=1e-12)
    np.testing.assert_allclose(est.numpy(), np.asarray(west), atol=1e-6)
    assert np.max(np.linalg.norm(est.numpy() - src, axis=-1)) < 0.05


def test_de_mode_matches_jax():
    """'de': the same lags; the fixes within 1e-4 m of JAX's (its draws
    differ) on these well-posed scenes, and both costs below 1e-9 (the
    lags' whole-sample residual, polished to L-BFGS-B's pgtol, 1e-5)."""
    args = dict(SPEC_ARGS, solver="de")
    sigs, src = noise_scenes(3, 2)
    west, wcost, wtd = jax_batch(args, sigs)
    spec = tsw.SweepSpec(**args)
    est, cost, td = tsw.localize_batch(spec, sigs, spec.mic_positions, 0,
                                       dtype=F64, device="cpu")
    np.testing.assert_allclose(td.numpy(), np.asarray(wtd), atol=1e-12)
    np.testing.assert_allclose(est.numpy(), np.asarray(west), atol=1e-4)
    assert np.all(cost.numpy() < 1e-9) and np.all(np.asarray(wcost) < 1e-9)


@pytest.mark.parametrize("solver", ["beam", "music", "capon"])
def test_narrowband_localize_batch_matches_jax(solver):
    """The trio spec's tones on the 8-mic cube, two scenes."""
    sigs, src = tone_scenes(2, 3)
    est = assert_narrowband_batch(dict(TRIO, solver=solver), sigs)
    assert np.max(np.linalg.norm(est.numpy() - src, axis=-1)) < 0.02


@pytest.mark.parametrize("solver", ["music", "capon"])
def test_narrowband_multi_source_localize_batch_matches_jax(solver):
    """Two tones a scene (600 + 950 Hz), two scenes: (B, 2, 3) fixes in
    coarse extraction order, as JAX's."""
    a, sa = tone_scenes(2, 4, freq=600.0)
    b, sb = tone_scenes(2, 5, freq=950.0)
    args = dict(TRIO, solver=solver, num_sources=2,
                source_freqs=(600.0, 950.0), source_min_separation=0.35)
    est = assert_narrowband_batch(args, a + b)
    assert est.shape == (2, 2, 3)


def test_narrowband_scene_chunks_do_not_change_the_answer(monkeypatch):
    """A chunk budget of one scene gives the one-chunk answers."""
    sigs, _ = tone_scenes(3, 6)
    spec = tsw.SweepSpec(**dict(TRIO, solver="capon"))
    whole = tsw.localize_batch(spec, sigs, spec.mic_positions, 0, dtype=F64,
                               device="cpu")
    monkeypatch.setattr(tsw, "NB_CHUNK_BYTES", 1)
    assert tsw._nb_chunk(spec, 8) == 1
    chunked = tsw.localize_batch(spec, sigs, spec.mic_positions, 0,
                                 dtype=F64, device="cpu")
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)


@pytest.mark.parametrize("solver", ["lm-robust", "de", "beam"])
def test_sweep_runs_each_mode(solver):
    """monte_carlo_sweep end to end: finite fixes near the sources; the
    narrowband covariance is NaN (no TDOAs), the TDOA solvers' finite."""
    args = (dict(TRIO, solver=solver, duration=0.1) if solver == "beam"
            else dict(SPEC_ARGS, solver=solver, duration=0.1))
    spec = tsw.SweepSpec(**args)
    assert tsw._mono_scene_eligible(spec) == (solver != "beam")
    s = tsw.monte_carlo_sweep(spec, 0, 4, device="cpu")
    assert float(s.hit_rate) == 1.0
    cov = s.results.covariance
    assert bool(torch.isnan(cov).all()) == (solver == "beam")
