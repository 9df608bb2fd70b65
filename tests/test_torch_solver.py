"""The port's solver stack against the JAX package: silhouette, k-means
(seed indices drawn on the JAX side), clustered initial guesses, bounds,
the multi-start LM (position 1e-6 m from the same initial guesses) and the
Gauss-Markov uncertainty (float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.models import solver as jsol
from pyaudiolocalization_tpu.models import uncertainty as junc
from pyaudiolocalization_tpu.utils.config import DEFAULT_CONFIG
from pyaudiolocalization_tpu_torch.models import cluster as tcl
from pyaudiolocalization_tpu_torch.models import solver as tsol
from pyaudiolocalization_tpu_torch.models import uncertainty as tunc


@pytest.fixture(scope="module")
def rng():
    """This module's own generator, seeded as the conftest's session-wide
    one: drawing from that one would move the inputs of every later test
    file in the same worker (``test_pallas_fft.py``'s among them)."""
    return np.random.default_rng(1234)


MICS = np.array(DEFAULT_CONFIG["mic_positions"], float)
PI = [0, 0, 0, 1, 1, 2]
PJ = [1, 2, 3, 2, 3, 3]
C = 343.2


def _close(got, want, rtol=1e-7, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tdoas(src, noise=0.0, seed=0):
    d = np.linalg.norm(np.asarray(src)[None] - MICS, axis=-1)
    td = (d[PJ] - d[PI]) / C
    return td + noise * np.random.default_rng(seed).standard_normal(len(PI))


def _jax_seed_indices(points, valid, k, key):
    """The k-means++ seed indices the JAX package draws for ``key``."""
    seeds = np.asarray(jcl.kmeans(jnp.asarray(points), k, key, iters=0,
                                  valid=jnp.asarray(valid)).centers)
    return torch.as_tensor([int(np.flatnonzero(
        np.all(points == s, -1))[0]) for s in seeds])


def test_silhouette_matches_jax(rng):
    x = rng.standard_normal((12, 3))
    labels = rng.integers(0, 4, 12)
    labels[0] = 3  # keep cluster 3 populated
    valid = np.ones(12, bool)
    valid[5] = False
    want = jcl.silhouette_score(jnp.asarray(x), jnp.asarray(labels), 4,
                                jnp.asarray(valid))
    got = tcl.silhouette_score(torch.from_numpy(x), torch.from_numpy(labels),
                               4, torch.from_numpy(valid))
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_matches_jax_given_seed_indices(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 0.1, (4, 3)),
                        rng.normal(2, 0.1, (3, 3))])
    valid = np.ones(7, bool)
    valid[-1] = False
    key = jax.random.PRNGKey(seed)
    idx = _jax_seed_indices(x, valid, 5, key)
    want = jcl.kmeans_multi(jnp.asarray(x), 5, key, iters=10,
                            valid=jnp.asarray(valid))
    got = tcl.kmeans_multi(torch.from_numpy(x), 5, iters=10,
                           valid=torch.from_numpy(valid), seed_indices=idx)
    for a, b in zip(got, want):
        _close(a, b)
    want1 = jcl.kmeans(jnp.asarray(x), 5, key, valid=jnp.asarray(valid))
    got1 = tcl.kmeans(torch.from_numpy(x), 5, valid=torch.from_numpy(valid),
                      seed_indices=idx)
    for a, b in zip(got1, want1):
        _close(a, b)


def test_kmeanspp_seeds_are_distinct_valid_points():
    x = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5],
                      [9, 9, 9]], dtype=torch.float64)
    valid = torch.tensor([True, True, True, True, False])
    idx = tcl.kmeanspp_seeds(x, 4, torch.Generator().manual_seed(0), valid)
    assert sorted(idx.tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("src", [[0.2, 0.6, 0.4], [0.5, 0.5, 0.5],
                                 [2.0, -1.0, 0.7]])
def test_initial_guesses_and_bounds_match_jax(src):
    td = _tdoas(src, noise=2e-5)
    key = jax.random.PRNGKey(3)
    points, pvalid = jsol.pair_guesses(jnp.asarray(MICS), np.array(PI),
                                       np.array(PJ), jnp.asarray(td), C)
    idx = _jax_seed_indices(np.asarray(points), np.asarray(pvalid), 5, key)
    want = jsol.heuristic_initial_guesses(jnp.asarray(MICS), np.array(PI),
                                          np.array(PJ), jnp.asarray(td), C,
                                          key)
    got = tsol.heuristic_initial_guesses(
        torch.from_numpy(MICS), PI, PJ, torch.from_numpy(td), C,
        seed_indices=idx)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, b in zip(tsol.dynamic_bounds(torch.from_numpy(MICS),
                                        torch.from_numpy(td), C),
                    jsol.dynamic_bounds(jnp.asarray(MICS), jnp.asarray(td),
                                        C)):
        _close(a, b)


@pytest.mark.parametrize("src", [[0.2, 0.6, 0.4], [2.0, -1.0, 0.7]])
def test_multi_start_lm_matches_jax(src, rng):
    td = _tdoas(src, noise=3e-6, seed=1)
    w = rng.uniform(0.5, 1.5, 6)
    guesses = np.concatenate([rng.uniform(-1, 2, (5, 3)),
                              MICS.mean(0)[None]])
    lower, upper = jsol.dynamic_bounds(jnp.asarray(MICS), jnp.asarray(td), C)
    want = jsol.multi_start_lm(jnp.asarray(guesses), jnp.asarray(MICS),
                               np.array(PI), np.array(PJ), jnp.asarray(td),
                               C, jnp.asarray(w), lower, upper)
    got = tsol.multi_start_lm(torch.from_numpy(guesses),
                              torch.from_numpy(MICS), PI, PJ,
                              torch.from_numpy(td), C, torch.from_numpy(w),
                              torch.tensor(np.asarray(lower)),
                              torch.tensor(np.asarray(upper)))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-6,
                               rtol=0)
    _close(got.cost, want.cost, rtol=1e-6, atol=1e-15)
    x = torch.from_numpy(guesses[0])
    r, jac = tsol.tdoa_residuals_and_jac(x, torch.from_numpy(MICS), PI, PJ,
                                         torch.from_numpy(td), C,
                                         torch.from_numpy(w))
    rj, jj = jsol.tdoa_residuals_and_jac(jnp.asarray(guesses[0]),
                                         jnp.asarray(MICS), np.array(PI),
                                         np.array(PJ), jnp.asarray(td), C,
                                         jnp.asarray(w))
    _close(r, rj)
    _close(jac, jj)


def test_uncertainty_matches_jax(rng):
    x = np.array([0.21, 0.59, 0.41])
    td = _tdoas([0.2, 0.6, 0.4], noise=1e-5)
    snr = rng.uniform(5, 50, 6)
    np.testing.assert_array_equal(tunc.weights_from_snr(snr),
                                  junc.weights_from_snr(snr))
    want = junc.position_uncertainty(x, MICS, PI, PJ, td, C,
                                     weights=junc.weights_from_snr(snr))
    got = tunc.position_uncertainty(x, MICS, PI, PJ, td, C,
                                    weights=tunc.weights_from_snr(snr))
    assert set(got) == set(want)
    for k in ("covariance", "std", "ellipsoid_radii", "sigma_td"):
        _close(got[k], want[k])
    assert tunc.position_uncertainty(x, MICS, PI[:3], PJ[:3], td[:3],
                                     C) is None
