"""The port's SRP-PHAT pieces against the JAX package (small sizes, 8-16
kHz): K1 ``gcc_all_pairs`` over a scene axis (its plain twin against
``bfly_gcc_all_pairs`` in interpret mode, float32, 1e-5 absolute: the
interpret kernel's bf16x3 lane DFT sits ~1e-6 off a float64 oracle),
``gcc_phat_all_pairs`` over leading axes, the TDOA ladder over (B, P, n)
against JAX's vmapped ladder, and every function of ``models/srp.py``
against its JAX counterpart in float64 (1e-9), the windowed map's two-tap
sum against the hat kernel it replaces included.

Coarse SRP maps are max-pooled, so cells whose every pair reads a pooled
plateau hold the same sum up to rounding: two summation orders may break
such a tie differently.  Searches are held to JAX where the map's top two
cells differ by more than 1e-9 relative; where they tie, the port's coarse
cell must be one of JAX's tied cells."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import srp as jsrp
from pyaudiolocalization_tpu.models import tdoa as jtdoa
from pyaudiolocalization_tpu.models.simulator import simulate_signals_fast
from pyaudiolocalization_tpu.ops import gccphat as jgcc
from pyaudiolocalization_tpu.ops import pallas_fft as pf
from pyaudiolocalization_tpu_torch.models import srp as tsrp
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc

FS = 16000.0
C = 331.0 + 0.6 * 20.0 + 0.0124 * 50.0   # speed_of_sound(20, 50)
MICS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, 0.0, 1.0]])
PI = np.array([0, 0, 0, 1, 1, 2], np.int32)
PJ = np.array([1, 2, 3, 2, 3, 3], np.int32)
TOL = 1e-9


def _pairs(m):
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _delayed_scenes(num, m, n, seed, fs=FS):
    """(num, m, n) float64 white noise with per-mic integer delays and a
    little independent noise: correlations with clear peaks."""
    rng = np.random.default_rng(seed)
    out = np.empty((num, m, n))
    for b in range(num):
        base = rng.standard_normal(n + 64)
        for i in range(m):
            d = rng.integers(0, 40)
            out[b, i] = base[d:d + n] + 0.2 * rng.standard_normal(n)
    return out


def _corr(num, seed, n=2000, nfft=4096):
    sigs = _delayed_scenes(num, 4, n, seed)
    return cf.gcc_all_pairs_plain(torch.tensor(sigs), PI, PJ, nfft,
                                  cf.band_mask(nfft, None, None,
                                               dtype=torch.float64))


# ---------------------------------------------------------------------------
# K1 over a scene axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 700), (2, 5, 1000)])
def test_gcc_all_pairs_scene_axis_matches_the_pallas_kernel(shape):
    """Odd M with odd P (3 mics, 3 pairs) and with even P (5 mics, 10
    pairs), packed across scenes; the band mask."""
    sigs = _delayed_scenes(shape[0], shape[1], shape[2], seed=shape[1])
    sigs = sigs.astype(np.float32)
    nfft = 2048
    pi, pj = _pairs(shape[1])
    band = (300.0, 3400.0)
    want = np.asarray(pf.bfly_gcc_all_pairs(
        jnp.asarray(sigs), np.asarray(pi), np.asarray(pj), nfft, band=band,
        fs=8000.0, interpret=True))
    got = cf.gcc_all_pairs(torch.tensor(sigs), pi, pj, nfft,
                           cf.band_mask(nfft, band, 8000.0))
    assert got.shape == want.shape == (shape[0], len(pi), nfft)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_gcc_phat_over_leading_axes_equals_per_scene_calls():
    sigs = torch.tensor(_delayed_scenes(6, 3, 900, seed=4)).reshape(
        2, 3, 3, 900)
    pi, pj = _pairs(3)
    got = tgcc.gcc_phat_all_pairs(sigs, pi, pj, nfft=2048,
                                  band=(300.0, 3400.0), fs=FS)
    assert got.shape == (2, 3, 3, 2048)
    for a in range(2):
        for b in range(3):
            one = tgcc.gcc_phat_all_pairs(sigs[a, b], pi, pj, nfft=2048,
                                          band=(300.0, 3400.0), fs=FS)
            assert torch.equal(got[a, b], one)


@pytest.mark.parametrize("scenes,mics,num_pairs,want", [
    (256, 4, 6, 256), (10000, 8, 28, 65535 // 14 - 1),
    (200000, 2, 1, 65534), (70000, 3, 3, 32766),
    (21845, 4, 6, 21845), (21846, 4, 6, 21844), (21846, 4, 0, 21844),
    (5000, 8, 0, 4680), (100, 3, 40, 100), (70000, 3, 40, 3276)])
def test_scene_chunk_keeps_every_grid_within_its_limit(scenes, mics,
                                                       num_pairs, want):
    """One chunk rule for K1, K2, K3 and K5: the couples of the larger of
    the given pairs and all M (M - 1) / 2 pairs (K3 passes none), every
    grid's y extent within 65,535, and an even chunk short of the batch
    (at 4,096 points, one block a scene, no scratch caps the chunk)."""
    chunk = cf.scene_chunk(scenes, mics, num_pairs, 4096)
    assert chunk == want
    couples = (max(num_pairs, mics * (mics - 1) // 2) + 1) // 2
    assert (chunk * mics + 1) // 2 <= 65535 and chunk * couples <= 65535
    assert (chunk + 1) // 2 <= 65535 and chunk <= 65535
    assert chunk == scenes or chunk % 2 == 0


# ---------------------------------------------------------------------------
# The TDOA ladder over (B, P, n)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gaussian", "median", "adaptive"])
@pytest.mark.parametrize("med", [0.004, None])
def test_time_delays_from_corr_over_scenes_matches_jax_vmap(method, med):
    corr = _corr(3, seed=7).numpy()
    # A ramp row has no local maximum: the argmax fallback.
    corr[2, 5] = np.linspace(-1.0, 1.0, corr.shape[-1])
    n = 2000
    got = ttdoa.time_delays_from_corr(torch.tensor(corr), n, n, FS,
                                      threshold_method=method,
                                      max_expected_delay=med)
    want = jax.vmap(jax.vmap(lambda c: jtdoa.time_delays_from_corr(
        c, n, n, FS, threshold_method=method, max_expected_delay=med,
        lag_mode="physical")))(jnp.asarray(corr))
    assert got.delays.shape == (3, 6, 1)
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


# ---------------------------------------------------------------------------
# models/srp.py
# ---------------------------------------------------------------------------

def test_grids_match_jax():
    lo, hi = np.array([-0.2, 0.1, 0.3]), np.array([1.1, 0.9, 1.7])
    want = np.asarray(jsrp._grid_points(jnp.asarray(lo), jnp.asarray(hi), 5,
                                        jnp.float64))
    got = tsrp._grid_points(torch.tensor(lo), torch.tensor(hi), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    both = tsrp._grid_points(torch.tensor(np.stack([lo, lo + 1])),
                             torch.tensor(np.stack([hi, hi + 1])), 5)
    assert torch.equal(both[0], got)
    np.testing.assert_array_equal(
        tsrp._axis_grid(torch.tensor(lo), torch.tensor(hi), 4).numpy().T,
        np.stack([np.asarray(jsrp._axis_grid(lo[d], hi[d], 4, jnp.float64))
                  for d in range(3)], -1))


def test_quadratic_peak_offset_matches_jax():
    rng = np.random.default_rng(3)
    n = 6
    vals = rng.standard_normal((5, n ** 3))
    ks = np.array([np.argmax(v) for v in vals[:4]] + [0])
    spacing = rng.uniform(0.01, 0.1, (5, 3))
    got = tsrp.quadratic_peak_offset(torch.tensor(vals), torch.tensor(ks), n,
                                     torch.tensor(spacing))
    for b in range(5):
        want = jsrp.quadratic_peak_offset(jnp.asarray(vals[b]), int(ks[b]), n,
                                          jnp.asarray(spacing[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-15)


def _smooth(centres):
    """A tie-free map with one peak per scene at ``centres`` (B, 3) and a
    second, lower one."""
    def fn_t(p):
        c = torch.tensor(centres)[:, None, :]
        return (-torch.sum((p - c) ** 2, -1)
                + 0.5 * torch.exp(-20.0 * torch.sum((p - c + 0.4) ** 2, -1)))

    def fn_j(b):
        c = jnp.asarray(centres[b])[None, :]
        return lambda p: (-jnp.sum((p - c) ** 2, -1) + 0.5 * jnp.exp(
            -20.0 * jnp.sum((p - c + 0.4) ** 2, -1)))
    return fn_t, fn_j


def test_search_machinery_matches_jax():
    centres = np.array([[0.43, 0.61, 0.37], [0.2, 0.8, 0.55]])
    fn_t, fn_j = _smooth(centres)
    lo, hi = np.zeros(3), np.ones(3)
    pos, power, center, cell = tsrp.two_stage_search(
        fn_t, fn_t, torch.tensor(lo), torch.tensor(hi), 8, 6)
    multi, powers = tsrp.suppressed_multi_search(
        fn_t, fn_t, torch.tensor(lo), torch.tensor(hi), 8, 6, 2, None)
    for b in range(2):
        f = fn_j(b)
        want = jsrp.two_stage_search(f, f, jnp.asarray(lo), jnp.asarray(hi),
                                     8, 6, jnp.float64)
        for g, w in zip((pos[b], power[b], center[b], cell),
                        (want[0], want[1], want[2], want[3])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=TOL)
        wm, wp = jsrp.suppressed_multi_search(f, f, jnp.asarray(lo),
                                              jnp.asarray(hi), 8, 6, 2, None,
                                              jnp.float64)
        np.testing.assert_allclose(multi[b].numpy(), np.asarray(wm), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(powers[b].numpy(), np.asarray(wp), rtol=0,
                                   atol=TOL)


def _hat_map(corr, points, mics, max_lag, fs, c):
    """The JAX package's windowed map written out in torch: the hat kernel
    (G, P, 2L+1) against the centred window."""
    d = torch.linalg.norm(points[:, None, :] - mics[None], dim=-1)
    lag = -(d[:, list(PJ)] - d[:, list(PI)]) / c * fs
    win = torch.cat([corr[..., -max_lag:], corr[..., :max_lag + 1]], -1)
    ells = torch.arange(2 * max_lag + 1, dtype=corr.dtype)
    w = torch.clamp(1.0 - torch.abs(lag[..., None] + max_lag - ells), min=0)
    return torch.sum(w * win[None], (-2, -1))


@pytest.mark.parametrize("max_lag", [None, 60, 900, 2100])
def test_srp_map_matches_jax_and_the_hat_kernel(max_lag):
    """Windowed (the two-tap sum), its pre-windowed form, and the circular
    gather (no bound, or a window longer than the transform); points and
    mics with a scene axis."""
    corr = _corr(2, seed=11)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.5, 1.5, (2, 40, 3))
    mics = MICS[None] + 0.01 * rng.standard_normal((2, 4, 3))
    got = tsrp.srp_map(corr, torch.tensor(pts), torch.tensor(mics), PI, PJ,
                       FS, C, max_lag=max_lag)
    for b in range(2):
        want = jsrp.srp_map(jnp.asarray(corr[b].numpy()), jnp.asarray(pts[b]),
                            jnp.asarray(mics[b]), PI, PJ, FS, C,
                            max_lag=max_lag)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
        if max_lag is not None and 2 * max_lag + 1 <= corr.shape[-1]:
            hat = _hat_map(corr[b], torch.tensor(pts[b]),
                           torch.tensor(mics[b]), max_lag, FS, C)
            np.testing.assert_allclose(got[b].numpy(), hat.numpy(), rtol=TOL,
                                       atol=TOL)
            win = tsrp._center_window(corr, max_lag)
            pre = tsrp.srp_map(win, torch.tensor(pts), torch.tensor(mics),
                               PI, PJ, FS, C, max_lag=max_lag,
                               pre_windowed=True)
            assert torch.equal(pre, got)
    with pytest.raises(ValueError, match="max_lag"):
        tsrp.srp_map(corr, torch.tensor(pts), torch.tensor(mics), PI, PJ, FS,
                     C, max_lag=0)


@pytest.mark.parametrize("w", [0, 1, 4])
def test_pooling_and_windows_match_jax(w):
    corr = _corr(2, seed=13)
    jc = jnp.asarray(corr.numpy())
    for got, want in (
            (tsrp.max_pool_corr(corr, w), jsrp.max_pool_corr(jc, w)),
            (tsrp._center_window(corr, 50), jsrp._center_window(jc, 50)),
            (tsrp._pooled_window(corr, 50, w),
             jsrp._pooled_window(jc, 50, w))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolvers_match_jax():
    lo, hi = np.array([0.0, -0.5, 0.2]), np.array([1.0, 1.5, 0.9])
    for fs in (8000.0, 44100.0):
        assert tsrp._resolve_max_lag(None, MICS, fs, C) == \
            jsrp._resolve_max_lag(None, MICS, fs, C)
        assert tsrp._resolve_max_lag(17, MICS, fs, C) == \
            jsrp._resolve_max_lag(17, MICS, fs, C)
        for coarse_n in (12, 24):
            assert tsrp._resolve_pool(None, torch.tensor(lo),
                                      torch.tensor(hi), coarse_n, fs, C) == \
                jsrp._resolve_pool(None, jnp.asarray(lo), jnp.asarray(hi),
                                   coarse_n, fs, C)
    assert tsrp._resolve_pool(3, lo, hi, 24, FS, C) == 3
    # A scene axis: the widest array bounds every scene's lags.
    wide = np.stack([MICS, 2.0 * MICS])
    assert tsrp._resolve_max_lag(None, wide, FS, C) == \
        jsrp._resolve_max_lag(None, 2.0 * MICS, FS, C)


def _coarse_top(corr, lo, hi, w, ml):
    pts = jsrp._grid_points(jnp.asarray(lo), jnp.asarray(hi), 24,
                            jnp.float64)
    vals = np.asarray(jsrp.srp_map(jsrp._pooled_window(
        jnp.asarray(corr), ml, w), pts, jnp.asarray(MICS), PI, PJ, FS, C,
        max_lag=ml, pre_windowed=True))
    return vals, np.asarray(pts)


def test_srp_phat_locate_matches_jax():
    """Six scenes, batched; refine on and off.  A scene whose pooled
    coarse map ties may take another of the tied cells."""
    corr = _corr(6, seed=17, n=2000, nfft=4096)
    lo, hi = np.zeros(3), np.ones(3)
    got = tsrp.srp_phat_locate(corr, torch.tensor(MICS), PI, PJ, FS, C, lo,
                               hi)
    plain = tsrp.srp_phat_locate(corr, torch.tensor(MICS), PI, PJ, FS, C, lo,
                                 hi, refine=False)
    w = tsrp._resolve_pool(None, lo, hi, 24, FS, C)
    ml = tsrp._resolve_max_lag(None, MICS, FS, C)
    clear = 0
    for b in range(6):
        args = (jnp.asarray(corr[b].numpy()), jnp.asarray(MICS), PI, PJ, FS,
                C, jnp.asarray(lo), jnp.asarray(hi))
        want = jsrp.srp_phat_locate(*args)
        want_plain = jsrp.srp_phat_locate(*args, refine=False)
        vals, pts = _coarse_top(corr[b].numpy(), lo, hi, w, ml)
        top = np.sort(vals)[-2:]
        if (top[1] - top[0]) > 1e-9 * abs(top[1]):
            clear += 1
            for g, wnt in ((got, want), (plain, want_plain)):
                for field in range(3):
                    np.testing.assert_allclose(
                        g[field][b].numpy(), np.asarray(wnt[field]), rtol=0,
                        atol=TOL)
        else:
            tied = pts[vals >= top[1] * (1 - 1e-9)]
            assert np.min(np.abs(tied - got.coarse[b].numpy()).sum(-1)) \
                < 1e-12
        one = tsrp.srp_phat_locate(corr[b], torch.tensor(MICS), PI, PJ, FS,
                                   C, lo, hi)
        for field in range(3):
            assert torch.equal(one[field], got[field][b])
    assert clear >= 2


def _ghost_scene():
    """The ghost-prone two-talker scene of tests/test_srp.py: a 4-mic
    tetra, two noise sources, 10 % white noise, 16 kHz x 0.128 s."""
    tetra = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [1.5, 3.0, 0.0],
                      [1.5, 1.5, 2.0]])
    pa = np.array([2.051, 2.454, 1.48])
    pb = np.array([1.027, 2.829, 1.07])
    dur = 0.128
    sig = 0.0
    for i, p in enumerate((pa, pb)):
        x = simulate_signals_fast(p, tetra, FS, C, dur, "noise", 500.0, None,
                                  None, jnp.asarray([0.01]),
                                  jnp.asarray([1e-6]), 0, 1e-4,
                                  key=jax.random.PRNGKey(2018 + i))
        sig = sig + np.asarray(x)
    rng = np.random.default_rng(77)
    rms = np.sqrt((sig ** 2).mean())
    sig = (sig + rng.normal(size=sig.shape) * rms * 0.1)[:, :int(dur * FS)]
    corr = np.asarray(jgcc.gcc_phat_all_pairs(jnp.asarray(sig), PI, PJ,
                                              nfft=2048, fs=FS))
    return corr, tetra, pa, pb


@pytest.mark.parametrize("suppression", ["spatial", "claim"])
def test_srp_phat_locate_multi_matches_jax_on_the_ghost_scene(suppression):
    corr, tetra, pa, pb = _ghost_scene()
    lo, hi = tetra.min(0) - 0.1, tetra.max(0) + 0.1
    want = jsrp.srp_phat_locate_multi(
        jnp.asarray(corr), jnp.asarray(tetra), PI, PJ, FS, C,
        jnp.asarray(lo), jnp.asarray(hi), num_sources=2, coarse_n=28,
        fine_n=12, suppression=suppression)
    both = torch.tensor(np.stack([corr, corr]))
    got = tsrp.srp_phat_locate_multi(both, torch.tensor(tetra), PI, PJ, FS, C,
                                     lo, hi, num_sources=2, coarse_n=28,
                                     fine_n=12, suppression=suppression)
    assert got.positions.shape == (2, 2, 3) and got.powers.shape == (2, 2)
    for b in range(2):
        np.testing.assert_allclose(got.positions[b].numpy(),
                                   np.asarray(want.positions), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got.powers[b].numpy(),
                                   np.asarray(want.powers), rtol=TOL, atol=0)
    d = got.positions[0].numpy()
    m = np.stack([np.linalg.norm(d - pa, axis=-1),
                  np.linalg.norm(d - pb, axis=-1)])
    err = min(m[0, 0] + m[1, 1], m[0, 1] + m[1, 0]) / 2
    # tests/test_srp.py: claiming recovers both talkers, the spatial ball
    # locks onto the ghost.
    assert (err < 0.05) if suppression == "claim" else (err > 0.3)
    with pytest.raises(ValueError, match="suppression"):
        tsrp.srp_phat_locate_multi(both, torch.tensor(tetra), PI, PJ, FS, C,
                                   lo, hi, num_sources=2, suppression="nms")
