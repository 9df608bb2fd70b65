"""The port's Welch-averaged GCC (``ops/gccphat.gcc_phat_streaming``,
``tdoa_from_streaming``) and moving render
(``models/simulator.simulate_moving_source``) against the JAX package on
the CPU in float64: correlations and renders within 1e-10 relative.  The
render is held on a noise base drawn on the JAX side (fed to the port's
``_render_moving``, the counterpart of the JAX package's
``_base_signal`` kept apart for this) and on a chirp end to end."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu_torch.models import simulator as tsim
from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc
from pyaudiolocalization_tpu_torch.ops import signal as tsig

FS = 16000.0
C = 343.0
TETRA = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [1.5, 3.0, 0.0],
                  [1.5, 1.5, 2.0]])
START, VEL = np.array([0.8, 1.2, 0.7]), np.array([1.5, 0.4, 0.0])
RTOL = 1e-10


def _rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def _delayed(seed, m=4, n=24000, shifts=(0, 7, -13, 22)):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n + 64)
    return np.stack([base[32 + s:32 + s + n] for s in shifts[:m]]) \
        + 0.3 * rng.standard_normal((m, n))


@pytest.mark.parametrize("window", ["hann", "rect"])
@pytest.mark.parametrize("weighting", ["phat", "scot", "roth", "cc", "ml"])
def test_streaming_gcc_matches_jax(weighting, window):
    x = _delayed(0)
    pi, pj = np.triu_indices(4, 1)
    want, want_lags = jgcc.gcc_phat_streaming(
        jnp.asarray(x), pi, pj, frame=1024, weighting=weighting,
        window=window)
    got, lags = tgcc.gcc_phat_streaming(x, pi, pj, frame=1024,
                                        weighting=weighting, window=window,
                                        device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_array_equal(lags, want_lags)
    assert _rel(got, want) < RTOL
    tdoa = tgcc.tdoa_from_streaming(got, lags, FS)
    want_tdoa = jgcc.tdoa_from_streaming(want, want_lags, FS)
    np.testing.assert_allclose(tdoa.numpy(), np.asarray(want_tdoa), rtol=0,
                               atol=1e-12 / FS)


def test_streaming_gcc_recovers_the_shifts_with_leading_axes():
    """Two captures along a leading axis, a hop and a lag bound of their
    own: each pair's peak at the injected shift (lag = -(d_j - d_i)),
    equal to JAX per capture."""
    x = np.stack([_delayed(1), _delayed(2, shifts=(0, -5, 9, 30))])
    pi, pj = np.triu_indices(4, 1)
    got, lags = tgcc.gcc_phat_streaming(x, pi, pj, frame=2048, hop=512,
                                        max_lag=100, device="cpu")
    assert got.shape == (2, 6, 201)
    for b, shifts in enumerate([(0, 7, -13, 22), (0, -5, 9, 30)]):
        want, _ = jgcc.gcc_phat_streaming(jnp.asarray(x[b]), pi, pj,
                                          frame=2048, hop=512, max_lag=100)
        assert _rel(got[b], want) < RTOL
        tdoa = tgcc.tdoa_from_streaming(got[b], lags, FS).numpy() * FS
        expect = [shifts[j] - shifts[i] for i, j in zip(pi, pj)]
        np.testing.assert_allclose(tdoa, expect, atol=0.05)


def test_streaming_gcc_validation():
    x = np.zeros((4, 3000))
    pi, pj = np.triu_indices(4, 1)
    for kw in (dict(frame=1000), dict(frame=1024, max_lag=512),
               dict(frame=1024, max_lag=0), dict(frame=1024, window="tri"),
               dict(frame=1024, weighting="hb"), dict(frame=4096)):
        with pytest.raises(ValueError):
            tgcc.gcc_phat_streaming(x, pi, pj, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgcc.gcc_phat_streaming(x, pi, pj, frame=1024)


# ---------------------------------------------------------------------------
# The moving render
# ---------------------------------------------------------------------------

def test_moving_render_on_the_jax_base_matches_jax():
    """The WOLA render of the base JAX draws for a key (noise), finalized:
    every frame through one delay_and_sum over a frame axis, fold for the
    overlap-add."""
    key = jax.random.PRNGKey(4)
    want = jsim.simulate_moving_source(START, VEL, TETRA, FS, C,
                                       duration=0.3, signal_type="noise",
                                       frame=512, key=key)
    budget, lead = tsim._moving_margins(START, VEL, TETRA, FS, C, 0.3, 512)
    base = jsim._base_signal(key, jnp.asarray(1000.0), signal_type="noise",
                             fs=FS, duration=0.3 + 2.0 * lead / FS,
                             dtype=jnp.float64)
    raw = tsim._render_moving(torch.as_tensor(np.array(base)), START, VEL,
                              TETRA, FS, C, 512, budget, lead, 1000.0, 0.01,
                              1e-6)
    got = tsig.dynamic_range_compression(tsig.normalize_signal(raw))
    assert got.shape == want.shape == (4, 4800)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("frame,finalize", [(512, True), (1024, False)])
def test_moving_chirp_matches_jax(frame, finalize):
    want = jsim.simulate_moving_source(START, VEL, TETRA, FS, C,
                                       duration=0.25, signal_type="chirp",
                                       freq=400.0, frame=frame,
                                       finalize=finalize,
                                       dtype=jnp.float64)
    got = tsim.simulate_moving_source(START, VEL, TETRA, FS, C,
                                      duration=0.25, signal_type="chirp",
                                      freq=400.0, frame=frame,
                                      finalize=finalize,
                                      dtype=torch.float64, device="cpu")
    assert got.shape == want.shape
    assert _rel(got, want) < RTOL


def test_moving_render_noise_and_a_still_source():
    """snr_db adds white noise at that per-mic SNR from the generator (its
    draws are the port's own); a zero velocity renders the static scene's
    delays: the inter-mic lag of the still source's GCC peak."""
    gen = torch.Generator().manual_seed(0)
    clean = tsim.simulate_moving_source(START, VEL, TETRA, FS, C, 0.25,
                                        "chirp", freq=400.0,
                                        dtype=torch.float64, device="cpu")
    noisy = tsim.simulate_moving_source(START, VEL, TETRA, FS, C, 0.25,
                                        "chirp", freq=400.0, generator=gen,
                                        snr_db=20.0, dtype=torch.float64,
                                        device="cpu")
    resid = noisy - clean
    snr = 10 * torch.log10(torch.mean(clean ** 2, -1)
                           / torch.mean(resid ** 2, -1))
    assert torch.all(torch.abs(snr - 20.0) < 0.5), snr
    gen = torch.Generator().manual_seed(1)
    still = tsim.simulate_moving_source(START, np.zeros(3), TETRA, FS, C,
                                        0.5, "noise", generator=gen,
                                        dtype=torch.float64, device="cpu")
    pi, pj = np.array([0]), np.array([1])
    corr, lags = tgcc.gcc_phat_streaming(still, pi, pj, frame=2048,
                                         device="cpu")
    d = np.linalg.norm(START - TETRA, axis=-1)
    want = -(d[1] - d[0]) / C
    got = float(tgcc.tdoa_from_streaming(corr, lags, FS)[0])
    assert abs(got - want) * FS < 0.3


def test_moving_render_validation():
    for kw in (dict(frame=63), dict(frame=513)):
        with pytest.raises(ValueError, match="frame"):
            tsim.simulate_moving_source(START, VEL, TETRA, FS, C, 0.25,
                                        "chirp", device="cpu", **kw)
    with pytest.raises(ValueError, match="too distant"):
        tsim.simulate_moving_source(START, VEL, TETRA * 200.0, FS, C, 0.25,
                                    "chirp", device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tsim.simulate_moving_source(START, VEL, TETRA, FS, C, 0.25, "noise",
                                    device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tsim.simulate_moving_source(START, VEL, TETRA, FS, C, 0.25, "chirp",
                                    snr_db=10.0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.simulate_moving_source(START, VEL, TETRA, FS, C, 0.25, "chirp")
