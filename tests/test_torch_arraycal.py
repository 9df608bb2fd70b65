"""The port's array-geometry calibration (models/arraycal.py) against the
JAX package in float64 on the CPU, with the tetrahedron and the events of
tests/test_arraycal.py: the block Gauss-Newton refinement (exact and noisy
TDOAs, the anchor), the joint Jacobian against ``jax.jacfwd``, joint
self-calibration with the JAX package's k-means seeds, and the
signal-level wrapper at the exact length and at a power-of-two nfft."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import arraycal as jcal
from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.models import solver as jsol
from pyaudiolocalization_tpu.models.simulator import simulate_signals_fast
from pyaudiolocalization_tpu_torch.models import arraycal as tcal

MICS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.5, 1.0, 0.0],
                 [0.5, 0.5, 1.0]])
SOURCES = np.array([
    [0.2, 0.3, 0.6], [0.9, 0.8, 0.4], [0.1, 0.9, 0.9],
    [0.8, 0.1, 0.8], [0.5, 0.6, 0.2], [0.3, 0.2, 1.1],
    [1.1, 0.5, 0.7], [0.6, 1.0, 1.0],
])
MICS6 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                  [0.0, 0.0, 1.0], [1.0, 1.0, 0.0], [0.5, 0.5, 1.2]])
SOURCES12 = np.vstack([SOURCES, [[0.9, 0.2, 0.2], [0.2, 0.8, 0.3],
                                 [0.7, 0.7, 1.1], [0.4, 0.1, 0.9]]])
C = 343.0
FS = 48000.0


def _pairs(m):
    p = np.array([(i, j) for i in range(m) for j in range(i + 1, m)])
    return p[:, 0], p[:, 1]


def _true_mics(seed, nominal=MICS, scale=0.03):
    r = np.random.default_rng(seed)
    return nominal + r.uniform(-scale, scale, nominal.shape)


def _tdoas(mics, sources):
    pi, pj = _pairs(len(mics))
    d = np.linalg.norm(sources[:, None, :] - mics[None, :, :], axis=-1)
    return (d[:, pj] - d[:, pi]) / C


def _mm(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_event_seeds(td, mics, key=None):
    """(K, 5) k-means++ seed indices that the JAX package's
    ``self_calibrate_array`` draws for each event at ``mics``."""
    pi, pj = _pairs(len(mics))
    keys = jax.random.split(jax.random.PRNGKey(0) if key is None else key,
                            td.shape[0])
    rows = []
    for k in range(td.shape[0]):
        points, valid = jsol.pair_guesses(jnp.asarray(mics), pi, pj,
                                          jnp.asarray(td[k]), C)
        points = np.asarray(points)
        seeds = np.asarray(jcl.kmeans(jnp.asarray(points), 5, keys[k],
                                      iters=0,
                                      valid=jnp.asarray(valid)).centers)
        rows.append([int(np.flatnonzero(np.all(points == s, -1))[0])
                     for s in seeds])
    return np.asarray(rows)


@pytest.mark.parametrize("noise", [0.0, 10e-6])
def test_refine_matches_jax(noise):
    true = _true_mics(77 if noise == 0.0 else 78)
    pi, pj = _pairs(4)
    td = _tdoas(true, SOURCES)
    td = td + np.random.default_rng(178).normal(scale=noise, size=td.shape)
    w = np.random.default_rng(5).uniform(0.5, 1.5, td.shape)
    want = jcal.refine_mic_positions(td, SOURCES, MICS, pi, pj, C,
                                     weights=w)
    got = tcal.refine_mic_positions(td, SOURCES, MICS, pi, pj, C, weights=w,
                                    device="cpu")
    assert got.mic_positions.dtype == torch.float64
    np.testing.assert_allclose(_mm(got.mic_positions),
                               _mm(want.mic_positions), rtol=0, atol=1e-9)
    for g, wv in ((got.cost, want.cost), (got.initial_cost,
                                          want.initial_cost)):
        np.testing.assert_allclose(_mm(g), _mm(wv), rtol=1e-9, atol=1e-30)
    if noise == 0.0:
        err = np.linalg.norm(_mm(got.mic_positions) - true, axis=-1)
        assert err.max() < 1e-4


def test_refine_with_the_anchor_matches_jax():
    """The Tikhonov prior pulls toward its positions: the same refinement
    with a prior away from the init, few sweeps and a tight trust region."""
    true = _true_mics(81, MICS6)
    pi, pj = _pairs(6)
    td = _tdoas(true, SOURCES12)
    prior = _true_mics(9, MICS6, 0.01)
    kw = dict(sweeps=12, max_step=0.01, prior_positions=prior,
              prior_weight=0.05, lam0=0.1)
    want = jcal.refine_mic_positions(td, SOURCES12, MICS6, pi, pj, C, **kw)
    got = tcal.refine_mic_positions(td, SOURCES12, MICS6, pi, pj, C,
                                    device="cpu", **kw)
    np.testing.assert_allclose(_mm(got.mic_positions),
                               _mm(want.mic_positions), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_mm(got.cost), _mm(want.cost), rtol=1e-9)
    free = tcal.refine_mic_positions(td, SOURCES12, MICS6, pi, pj, C,
                                     device="cpu", **dict(kw, prior_weight=0))
    assert not np.allclose(_mm(free.mic_positions), _mm(got.mic_positions),
                           atol=1e-9)


def test_joint_jacobian_matches_jacfwd():
    rng = np.random.default_rng(12)
    mics = _true_mics(81, MICS6)
    src = SOURCES12 + rng.normal(scale=0.01, size=SOURCES12.shape)
    pi, pj = _pairs(6)
    td = _tdoas(_true_mics(3, MICS6), SOURCES12)
    w = rng.uniform(0.5, 1.5, td.shape)
    aw = 1e-3
    m, k = len(mics), len(src)

    def resid(x):
        mm, ss = x[:3 * m].reshape(m, 3), x[3 * m:].reshape(k, 3)
        r, _ = jcal._residuals(mm, ss, jnp.asarray(pi), jnp.asarray(pj),
                               jnp.asarray(td), C, jnp.asarray(w))
        return jnp.concatenate([r.ravel(), (aw * (mm - MICS6)).ravel()])

    want = jax.jacfwd(resid)(jnp.concatenate([jnp.asarray(mics).ravel(),
                                              jnp.asarray(src).ravel()]))
    t = torch.from_numpy
    got = tcal.joint_jacobian(t(mics), t(src), t(pi), t(pj), t(td), C, t(w),
                              aw)
    assert got.shape == (k * len(pi) + 3 * m, 3 * (m + k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)


def test_self_calibrate_matches_jax_with_its_seeds():
    true = _true_mics(81, MICS6)
    pi, pj = _pairs(6)
    td = _tdoas(true, SOURCES12)
    want = jcal.self_calibrate_array(td, MICS6, pi, pj, C)
    got = tcal.self_calibrate_array(td, MICS6, pi, pj, C,
                                    seed_indices=_jax_event_seeds(td, MICS6),
                                    device="cpu")
    np.testing.assert_allclose(_mm(got.mic_positions),
                               _mm(want.mic_positions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_mm(got.source_positions),
                               _mm(want.source_positions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_mm(got.initial_cost), _mm(want.initial_cost),
                               rtol=1e-6)
    assert float(got.cost) < 1e-6 * float(got.initial_cost)
    assert float(got.cost) <= max(float(want.cost) * (1 + 1e-6), 1e-26)


def test_self_calibrate_with_a_generator_is_repeatable():
    """The generator's state is restored before every localization: two
    runs from equal generators agree, and the shape is recovered."""
    true = _true_mics(81, MICS6)
    pi, pj = _pairs(6)
    td = _tdoas(true, SOURCES12)
    runs = [tcal.self_calibrate_array(
        td, MICS6, pi, pj, C, generator=torch.Generator().manual_seed(4),
        device="cpu") for _ in range(2)]
    assert torch.equal(runs[0].mic_positions, runs[1].mic_positions)
    mics = _mm(runs[0].mic_positions)
    iu = np.triu_indices(6, 1)
    shape = np.linalg.norm(mics[:, None] - mics[None], axis=-1)[iu]
    truth = np.linalg.norm(true[:, None] - true[None], axis=-1)[iu]
    assert np.abs(shape - truth).max() < 1e-4


def test_self_calibrate_rejects_4_mics():
    pi, pj = _pairs(4)
    td = _tdoas(_true_mics(80), SOURCES)
    with pytest.raises(ValueError, match="5 microphones"):
        tcal.self_calibrate_array(td, MICS, pi, pj, C, device="cpu")


def _events(true, sources, key0):
    return np.stack([np.array(simulate_signals_fast(
        sources[k], true, FS, C, 0.1, "noise", 500.0, None, None,
        jnp.asarray([0.01]), jnp.asarray([1e-6]), 0, 1e-4,
        key=jax.random.PRNGKey(key0 + k))) for k in range(len(sources))])


@pytest.fixture(scope="module")
def tetra_events():
    true = _true_mics(79)
    return true, _events(true, SOURCES, 100)


@pytest.fixture(scope="module")
def six_mic_events():
    true = _true_mics(81, MICS6)
    return true, _events(true, SOURCES12, 300)


def _spy(monkeypatch, module, name, sink):
    inner = getattr(module, name)

    def spy(*args, **kwargs):
        sink["weights"] = _mm(kwargs["weights"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("nfft", [None, 16384])
def test_calibrate_array_geometry_matches_jax(monkeypatch, tetra_events,
                                              nfft):
    true, sigs = tetra_events
    seen_j, seen_t = {}, {}
    _spy(monkeypatch, jcal, "refine_mic_positions", seen_j)
    _spy(monkeypatch, tcal, "refine_mic_positions", seen_t)
    want = jcal.calibrate_array_geometry(sigs, SOURCES, MICS, FS, C,
                                         nfft=nfft, max_expected_delay=0.02)
    got = tcal.calibrate_array_geometry(sigs, SOURCES, MICS, FS, C,
                                        nfft=nfft, max_expected_delay=0.02,
                                        device="cpu")
    assert got.tdoas.shape == (8, 6)
    np.testing.assert_allclose(_mm(got.tdoas), _mm(want.tdoas), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(seen_t["weights"], seen_j["weights"],
                               rtol=1e-9)
    np.testing.assert_allclose(_mm(got.mic_positions),
                               _mm(want.mic_positions), rtol=0, atol=1e-9)
    err = np.linalg.norm(_mm(got.mic_positions) - true, axis=-1)
    assert err.max() < 0.008


@pytest.mark.parametrize("nfft", [None, 16384])
def test_calibrate_array_geometry_self_cal_matches_jax(
        monkeypatch, six_mic_events, nfft):
    true, sigs = six_mic_events
    seen_j, seen_t = {}, {}
    _spy(monkeypatch, jcal, "self_calibrate_array", seen_j)
    _spy(monkeypatch, tcal, "self_calibrate_array", seen_t)
    want = jcal.calibrate_array_geometry(sigs, None, MICS6, FS, C,
                                         nfft=nfft, max_expected_delay=0.02)
    td = _mm(want.tdoas)
    got = tcal.calibrate_array_geometry(
        sigs, None, MICS6, FS, C, nfft=nfft, max_expected_delay=0.02,
        seed_indices=_jax_event_seeds(td, MICS6), device="cpu")
    assert isinstance(got, tcal.SelfCalResult)
    np.testing.assert_allclose(_mm(got.tdoas), td, rtol=0, atol=1e-12)
    np.testing.assert_allclose(seen_t["weights"], seen_j["weights"],
                               rtol=1e-9)
    for g, w in ((got.mic_positions, want.mic_positions),
                 (got.source_positions, want.source_positions)):
        np.testing.assert_allclose(_mm(g), _mm(w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_mm(got.cost), _mm(want.cost), rtol=1e-6)
