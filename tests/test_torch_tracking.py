"""The port's tracking (models/tracking.py) against the JAX package on the
CPU, float64, at small sizes (a 1.2 m 4-mic tetrahedron, 16 kHz, a
fraction of a second): the Kalman/RTS smoother, ``localize_trajectory``
with every method x smoother x motion, ``track_multiple`` static and
compensated at K = 2 on crossing walkers, ``associate_detections`` at K =
1-3, the validation errors, and the three faults of the JAX package that
the port repairs (each test names the JAX line).

Coarse SRP maps are max-pooled: neighbouring cells whose every pair reads
the pooled plateau hold the same sum up to rounding, and two summation
orders may break such a tie differently: the fine stage then searches
around another tied cell, and the fixes may differ by up to about a
coarse cell.  Every coarse map the port's searches evaluate is recorded
(``margins``: the relative gap of its top two cells, per segment; the
port's maps equal JAX's to ~1e-14).  Positions are held to 1e-9 m on
every segment, except that a segment whose map ties (gap below 1e-9) may
differ by less than two coarse-cell diagonals; most segments must agree to
1e-9.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.models import srp as jsrp
from pyaudiolocalization_tpu.models import tracking as jtr
from pyaudiolocalization_tpu_torch.models import capon as tcapon
from pyaudiolocalization_tpu_torch.models import music as tmusic
from pyaudiolocalization_tpu_torch.models import srp as tsrp
from pyaudiolocalization_tpu_torch.models import tracking as ttr

FS = 16000.0
C = 343.0
MICS = np.array([[0.0, 0.0, 0.0], [1.2, 0.0, 0.0], [0.6, 1.2, 0.0],
                 [0.6, 0.6, 1.0]])          # tetrahedral: no mirror ghost
LOWER = np.zeros(3)
UPPER = np.array([1.2, 1.2, 1.0])
CUBE = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
                 [1, 0, 1], [0, 1, 1], [1, 1, 1]], float)
START, VEL = np.array([0.3, 0.4, 0.3]), np.array([0.8, 0.2, 0.0])
START_B, VEL_B = np.array([0.9, 0.4, 0.7]), np.array([-0.8, 0.2, 0.0])
POS_TOL = 1e-9
CLEAR = 1e-9


def _moving(start, vel, mics, duration, key, kind="noise", freq=1000.0):
    return np.asarray(jsim.simulate_moving_source(
        start, vel, mics, FS, C, duration, kind, freq=freq, frame=512,
        key=jax.random.PRNGKey(key)))


_CACHE = {}


def _capture(name):
    if name not in _CACHE:
        if name == "single":
            _CACHE[name] = _moving(START, VEL, MICS, 0.5, 0)
        elif name == "walkers":
            dur = 8 * 1024 / FS
            _CACHE[name] = (_moving(START, VEL, MICS, dur, 11)
                            + _moving(START_B, VEL_B, MICS, dur, 22))
        elif name == "tone":
            _CACHE[name] = _moving(np.array([0.3, 0.4, 0.35]),
                                   np.array([0.4, 0.2, 0.05]), CUBE, 0.4, 0,
                                   "sine", 800.0)
    return _CACHE[name]


def _gap(vals: torch.Tensor) -> np.ndarray:
    top = torch.topk(vals, 2, -1)[0]
    return ((top[..., 0] - top[..., 1])
            / torch.clamp(torch.abs(top[..., 0]), min=1e-300)).numpy()


@pytest.fixture
def margins(monkeypatch):
    """Relative top-two gap of every coarse map the port's searches
    evaluate (each extraction round of a suppression search its own), one
    array per map with the segment axis first."""
    record = []
    two = tsrp.two_stage_search
    multi = tsrp.suppressed_multi_search

    def two_stage(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n):
        record.append(_gap(coarse_fn(tsrp._grid_points(lower, upper,
                                                       coarse_n))))
        return two(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n)

    def suppressed(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n,
                   num_sources, min_separation):
        pts = tsrp._grid_points(lower, upper, coarse_n)
        vals = coarse_fn(pts)
        cell = (upper - lower) / coarse_n
        radius = (3.0 * torch.amax(cell, -1)[..., None]
                  if min_separation is None else float(min_separation))
        for _ in range(num_sources):
            record.append(_gap(vals))
            center = tsrp._take_point(pts, torch.argmax(vals, -1))
            close = torch.linalg.norm(pts - center[..., None, :],
                                      dim=-1) <= radius
            vals = torch.where(close, torch.full_like(vals, -np.inf), vals)
        return multi(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n,
                     num_sources, min_separation)

    for mod in (tsrp, tmusic, tcapon):
        monkeypatch.setattr(mod, "two_stage_search", two_stage)
        monkeypatch.setattr(mod, "suppressed_multi_search", suppressed)
    return record


def _tied(record, segments):
    """Segments where any recorded coarse map ties at 1e-9 relative."""
    tied = np.zeros(segments, bool)
    for gap in record:
        tied |= (gap.reshape(segments, -1) <= CLEAR).any(1)
    return tied


def _held(got, want, tied, cell, tol=POS_TOL):
    """Per-segment fixes equal to ``tol``, except at a tied segment, where
    they lie within two diagonals of a coarse ``cell``; returns the
    segments that agree to ``tol``, most of them."""
    spacing = 2.0 * np.sqrt(3.0) * cell
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want).reshape(got.shape[0], -1).max(1)
    exact = diff <= tol
    assert np.all(exact | tied), (diff, tied)
    assert np.all(diff <= spacing), diff
    assert exact.mean() >= 0.5, diff
    return exact


def _close(got, want, tol=POS_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# The Kalman/RTS smoother
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,use_powers,meas_std", [
    (12, True, None), (12, False, None), (3, True, None), (9, False, 0.05),
    (1, True, None)])
def test_kalman_rts_smooth_matches_jax(s, use_powers, meas_std):
    rng = np.random.default_rng(s)
    t = np.arange(s)[:, None] * 0.1
    z = 0.3 + 0.8 * t * np.array([1.0, -0.4, 0.2]) \
        + 0.02 * rng.standard_normal((s, 3))
    p = rng.uniform(0.5, 3.0, s) if use_powers else None
    ws, wv = jtr.kalman_rts_smooth(jnp.asarray(z), 0.1,
                                   None if p is None else jnp.asarray(p),
                                   accel_std=0.7, meas_std=meas_std)
    gs, gv = ttr.kalman_rts_smooth(torch.as_tensor(z), 0.1,
                                   None if p is None else torch.as_tensor(p),
                                   accel_std=0.7, meas_std=meas_std)
    _close(gs, ws)
    _close(gv, wv)


def test_kalman_rts_smooth_takes_a_track_axis():
    """Leading axes are independent tracks: two tracks at once equal each
    smoothed alone, the measurement noise estimated per track."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 10, 3)) * np.array([[[0.01]], [[0.1]]])
    p = rng.uniform(0.5, 2.0, (2, 10))
    both, vel = ttr.kalman_rts_smooth(torch.as_tensor(z), 0.05,
                                      torch.as_tensor(p))
    for k in range(2):
        want, want_v = jtr.kalman_rts_smooth(jnp.asarray(z[k]), 0.05,
                                             jnp.asarray(p[k]))
        _close(both[k], want)
        _close(vel[k], want_v)


# ---------------------------------------------------------------------------
# localize_trajectory
# ---------------------------------------------------------------------------

TRAJ = dict(segment=2048, coarse_n=16, fine_n=8, max_speed=3.0)


@pytest.mark.parametrize("motion", ["static", "compensated"])
@pytest.mark.parametrize("smoother", ["ema", "kalman"])
def test_srp_trajectory_matches_jax(margins, motion, smoother):
    sigs = _capture("single")
    want = jtr.localize_trajectory(
        jnp.asarray(sigs), jnp.asarray(MICS), FS, C, jnp.asarray(LOWER),
        jnp.asarray(UPPER), smoother=smoother, motion=motion, **TRAJ)
    got = ttr.localize_trajectory(sigs, MICS, FS, C, LOWER, UPPER,
                                  smoother=smoother, motion=motion,
                                  device="cpu", **TRAJ)
    s = got.positions.shape[0]
    exact = _held(got.positions, want.positions, _tied(margins, s),
                  1.2 / TRAJ["coarse_n"])
    _close(got.times, want.times, 1e-12)
    _close(got.powers.numpy()[exact], np.asarray(want.powers)[exact], 1e-9)
    # The smoothing stage on JAX's own fixes.
    raw = torch.as_tensor(np.array(want.positions))
    if smoother == "kalman":
        smooth, _ = ttr.kalman_rts_smooth(
            raw, TRAJ["segment"] / 2 / FS,
            torch.as_tensor(np.array(want.powers)))
    else:
        smooth = ttr._ema(raw, 0.6)
    _close(smooth, want.smoothed)
    if exact.all():
        _close(got.smoothed, want.smoothed)
    if motion == "compensated":
        _close(got.velocities.numpy()[exact],
               np.asarray(want.velocities)[exact], 1e-9)
    else:
        assert got.velocities is None


def test_compensated_stages_match_jax():
    """The subframe windows (K1's twin over segments x subframes), the
    rate fit, the aligned correlation and the velocity solve, on the same
    segments."""
    sigs = _capture("single")
    segs, _ = ttr._segments(torch.as_tensor(np.array(sigs)), 2048, 1024)
    pi, pj = ttr._pairs(4)
    _, nfft_f, w_half, s_max = ttr._compensated_sizes(MICS, FS, C, 2048, 8,
                                                      3.0)
    pit, pjt = tuple(map(int, pi)), tuple(map(int, pj))
    wn = w_half + s_max
    win = ttr._subframe_windows(segs, pi, pj, FS, (300.0, 6000.0), "phat",
                                8, wn, nfft_f)
    win_j = jtr._subframe_windows(jnp.asarray(segs.numpy()), pit, pjt, FS,
                                  (300.0, 6000.0), "phat", 8, wn, nfft_f)
    _close(win, win_j, 1e-12)
    got = ttr._motion_compensated_corr(segs, pi, pj, FS, None, "phat", 8,
                                       w_half, s_max, nfft_f)
    want = jtr._motion_compensated_corr(jnp.asarray(segs.numpy()), pit, pjt,
                                        FS, None, "phat", 8, w_half, s_max,
                                        nfft_f)
    scale = float(np.max(np.abs(np.asarray(want[0]))))
    _close(got[0], want[0], 1e-10 * scale)
    _close(got[1], want[1], 1e-12)
    _close(got[2], want[2], 1e-10 * float(np.max(np.asarray(want[2]))))
    pos = np.array([[0.4, 0.5, 0.3], [0.7, 0.2, 0.6]])
    tau_dot = got[1][:2]
    w = got[2][:2]
    vel = ttr._velocity_lsq(torch.as_tensor(pos), torch.as_tensor(MICS),
                            pi, pj, C, tau_dot, w)
    for k in range(2):
        want_v = jtr._velocity_lsq(jnp.asarray(pos[k]), jnp.asarray(MICS),
                                   pi, pj, C, jnp.asarray(tau_dot[k].numpy()),
                                   jnp.asarray(w[k].numpy()))
        _close(vel[k], want_v, 1e-9)


@pytest.mark.parametrize("method", ["capon", "music"])
def test_narrowband_trajectory_matches_jax(margins, method):
    """A moving 800 Hz tone on the 1 m cube: the per-segment Capon / MUSIC
    scans over the segment axis, with the Kalman smoother."""
    sigs = _capture("tone")
    kw = dict(segment=2048, coarse_n=12, fine_n=8, method=method,
              smoother="kalman")
    want = jtr.localize_trajectory(jnp.asarray(sigs), jnp.asarray(CUBE), FS,
                                   C, jnp.zeros(3), jnp.ones(3), **kw)
    got = ttr.localize_trajectory(sigs, CUBE, FS, C, np.zeros(3), np.ones(3),
                                  device="cpu", **kw)
    assert not _tied(margins, got.positions.shape[0]).any()
    _close(got.positions, want.positions)
    _close(got.smoothed, want.smoothed)
    _close(got.powers, want.powers,
           1e-9 * float(np.max(np.asarray(want.powers))))


@pytest.mark.parametrize("weighting", ["scot", "cc"])
def test_weighted_trajectory_takes_the_unfused_gcc(margins, weighting):
    sigs = _capture("single")
    want = jtr.localize_trajectory(
        jnp.asarray(sigs), jnp.asarray(MICS), FS, C, jnp.asarray(LOWER),
        jnp.asarray(UPPER), weighting=weighting, smoothing=0.0, **TRAJ)
    got = ttr.localize_trajectory(sigs, MICS, FS, C, LOWER, UPPER,
                                  weighting=weighting, smoothing=0.0,
                                  device="cpu", **TRAJ)
    _held(got.positions, want.positions,
          _tied(margins, got.positions.shape[0]), 1.2 / TRAJ["coarse_n"])


def test_trajectory_validation():
    sigs = np.zeros((4, 3000))
    bad = [dict(method="beam"), dict(weighting="ml"),
           dict(weighting="scot", method="capon"), dict(smoother="rts"),
           dict(motion="fast"), dict(motion="compensated", method="music"),
           dict(segment=4096), dict(motion="compensated",
                                    motion_subframes=64),
           dict(motion="compensated", segment=1024, max_speed=200.0)]
    for kw in bad:
        with pytest.raises(ValueError):
            ttr.localize_trajectory(sigs, MICS, FS, C, LOWER, UPPER,
                                    device="cpu", **{"segment": 2048, **kw})
    # Without ``device`` the card is the default, and there is none here.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.localize_trajectory(sigs, MICS, FS, C, LOWER, UPPER,
                                segment=2048)


# ---------------------------------------------------------------------------
# Association
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_associate_detections_matches_jax(k):
    """Fixed detections of k walkers whose extraction order is shuffled
    every segment, with a wild fix beyond the gate: the same reordering,
    gate flags and powers."""
    rng = np.random.default_rng(k)
    s = 10
    t = np.arange(s)[:, None, None] * 0.1
    starts = rng.uniform(0.2, 1.0, (1, k, 3))
    vels = rng.uniform(-1.0, 1.0, (1, k, 3))
    dets = starts + t * vels + 0.01 * rng.standard_normal((s, k, 3))
    powers = rng.uniform(0.5, 2.0, (s, k))
    for i in range(s):
        perm = rng.permutation(k)
        dets[i], powers[i] = dets[i, perm], powers[i, perm]
    dets[6, 0] += 2.0
    want = jtr.associate_detections(jnp.asarray(dets), jnp.asarray(powers),
                                    0.1, 0.35)
    got = ttr.associate_detections(torch.as_tensor(dets),
                                   torch.as_tensor(powers), 0.1, 0.35)
    _close(got[0], want[0], 0.0)
    _close(got[1], want[1], 0.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2].numpy().all()


def test_association_step_enumerates_every_assignment():
    """K = 3: the cost of every one of the 3! assignments is considered,
    and the update moves only the gated tracks."""
    pos = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [0.0, 1, 0]],
                       dtype=torch.float64)
    vel = torch.zeros_like(pos)
    det = pos[[2, 0, 1]] + torch.tensor([[0.01, 0, 0], [0, 0.01, 0],
                                         [5.0, 0, 0]], dtype=torch.float64)
    pw = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    (pos_new, vel_new), (z, zp, ok) = ttr.association_step(pos, vel, det,
                                                           pw, 0.1, 0.5)
    want = jtr.association_step(jnp.asarray(pos.numpy()),
                                jnp.asarray(vel.numpy()),
                                jnp.asarray(det.numpy()),
                                jnp.asarray(pw.numpy()), 0.1, 0.5)
    for g, w in zip((pos_new, vel_new, z, zp), (*want[0], *want[1][:2])):
        _close(g, w, 1e-15)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[1][2]))
    assert ok.tolist() == [True, False, True]
    assert len(list(itertools.permutations(range(3)))) == 6


# ---------------------------------------------------------------------------
# track_multiple
# ---------------------------------------------------------------------------

MULTI = dict(num_sources=2, segment=1024, hop=1024, coarse_n=24, fine_n=10,
             max_speed=2.0)


@pytest.mark.parametrize("suppression", ["spatial", "claim"])
def test_track_multiple_static_matches_jax(margins, suppression):
    """Two walkers crossing, segment-static K-source SRP (K1 over the
    segments), association and per-track smoothing."""
    sigs = _capture("walkers")
    want = jtr.track_multiple(jnp.asarray(sigs), jnp.asarray(MICS), FS, C,
                              jnp.asarray(LOWER), jnp.asarray(UPPER),
                              suppression=suppression, **MULTI)
    got = ttr.track_multiple(sigs, MICS, FS, C, LOWER, UPPER,
                             suppression=suppression, device="cpu", **MULTI)
    exact = _held(got.positions, want.positions,
                  _tied(margins, got.positions.shape[0]),
                  1.2 / MULTI["coarse_n"])
    _close(got.times, want.times, 1e-12)
    if exact.all():      # the smoother couples every segment
        for name in ("smoothed", "velocities"):
            _close(getattr(got, name), getattr(want, name))
        _close(got.powers, want.powers, 1e-9)
        np.testing.assert_array_equal(got.associated.numpy(),
                                      np.asarray(want.associated))


def _walker_errors(track, times):
    pos = track.positions.numpy()
    ta = START + times[:, None] * VEL
    tb = START_B + times[:, None] * VEL_B
    ia = int(np.argmin(np.linalg.norm(pos[0] - ta[0], axis=-1)))
    return (np.linalg.norm(pos[:, ia] - ta, axis=-1),
            np.linalg.norm(pos[:, 1 - ia] - tb, axis=-1))


def test_track_multiple_compensated_matches_jax(margins, monkeypatch):
    """The compensated two passes (the rate bank with lag claiming, then
    the rate-steered refinement) through the crossing, with the rate
    bank's pool set to the JAX package's traced fallback of 2 samples
    (tracking.py:465 there; the port's own pool is the next test's): every
    position, power and velocity equal, identities held, and the raw
    detections within a few centimetres of the truth."""
    monkeypatch.setattr(ttr, "_rate_bank_pool", lambda *args: 2)
    sigs = _capture("walkers")
    kw = dict(MULTI, coarse_n=25, motion="compensated")
    want = jtr.track_multiple(jnp.asarray(sigs), jnp.asarray(MICS), FS, C,
                              jnp.asarray(LOWER), jnp.asarray(UPPER), **kw)
    got = ttr.track_multiple(sigs, MICS, FS, C, LOWER, UPPER, device="cpu",
                             **kw)
    s = got.positions.shape[0]
    tied = _tied(margins, s)
    _close(got.times, want.times, 1e-12)
    # A tie in either pass moves that segment's fix by up to a fine cell of
    # its grid, and the smoother carries a part of it to the neighbours,
    # which the refinement reads: segments without ties agree to 1e-9
    # where every segment does, and within 5 mm otherwise.
    diff = np.abs(got.positions.numpy() - np.asarray(want.positions)).max(
        (1, 2))
    assert np.all((diff <= POS_TOL) | tied) or diff.max() <= 5e-3, diff
    if (diff <= POS_TOL).all():
        for name in ("smoothed", "velocities"):
            _close(getattr(got, name), getattr(want, name))
    err_a, err_b = _walker_errors(got, got.times.numpy())
    assert err_a.mean() < 0.05 and err_b.mean() < 0.05, (err_a, err_b)


# ---------------------------------------------------------------------------
# The three faults of the JAX package that the port repairs
# ---------------------------------------------------------------------------

def test_rate_bank_pools_on_the_host_not_at_two_samples():
    """pyaudiolocalization_tpu/models/tracking.py:465: the rate bank's
    SRP runs inside a jit with traced bounds, so its coarse pool falls back
    to 2 samples whatever the grid.  On a 3.2 m box at coarse_n = 10 a
    cell spans 13 samples of lag: JAX's coarse stage misses the peak on
    the first two segments (2.5 m and 0.9 m off), the port's host pool of
    13 finds it; with a pool of 2 the port gives JAX's answers."""
    mics = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [1.5, 3.0, 0.0],
                     [1.5, 1.5, 2.0]])
    lower, upper = np.zeros(3), np.array([3.2, 3.2, 2.2])
    start, vel = np.array([0.8, 1.2, 0.7]), np.array([1.5, 0.4, 0.0])
    sigs = np.asarray(jsim.simulate_moving_source(
        start, vel, mics, FS, C, 0.5, "noise", frame=512,
        key=jax.random.PRNGKey(3)))
    kw = dict(num_sources=1, segment=2048, hop=2048, coarse_n=10, fine_n=8,
              max_speed=3.0, motion="compensated", motion_iterations=0)
    assert ttr._rate_bank_pool(lower, upper, 10, FS, C) == 13
    want = jtr.track_multiple(jnp.asarray(sigs), jnp.asarray(mics), FS, C,
                              jnp.asarray(lower), jnp.asarray(upper), **kw)
    got = ttr.track_multiple(sigs, mics, FS, C, lower, upper, device="cpu",
                             **kw)
    truth = start + got.times.numpy()[:, None] * vel
    err_jax = np.linalg.norm(np.asarray(want.positions)[:, 0] - truth,
                             axis=-1)
    err_port = np.linalg.norm(got.positions.numpy()[:, 0] - truth, axis=-1)
    assert err_jax[0] > 2.0 and err_jax[1] > 0.5, err_jax
    assert err_port.max() < 0.25, err_port
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "_rate_bank_pool", lambda *args: 2)
        two = ttr.track_multiple(sigs, mics, FS, C, lower, upper,
                                 device="cpu", **kw)
    _close(two.positions[:2], np.asarray(want.positions)[:2])


DATA = Path(__file__).resolve().parent / "data"
SERVING_TOOL = DATA.parents[1] / "tools" / "torch_serving_golden.py"


def _serving_mix(name):
    """The float32 capture of ``name`` ('walkers' or 'walkers3') in
    tests/data/torch_serving_bases.npz, rendered by the port as chip_smoke
    phase 11 renders it (``_render_moving`` of each JAX-drawn base, then
    the finalize), with the golden's mics and movers."""
    from pyaudiolocalization_tpu_torch.models import simulator as tsim
    from pyaudiolocalization_tpu_torch.ops import signal as tsig
    spec = importlib.util.spec_from_file_location("serving_golden",
                                                  SERVING_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    golden = json.loads((DATA / "torch_serving_golden.json").read_text())
    g = golden[name]
    duration = tool.NUM_SEG * tool.SEGMENT / tool.FS
    mix = 0.0
    with np.load(DATA / "torch_serving_bases.npz") as bases:
        for k, w in enumerate(g["walkers"]):
            budget, lead = tool.moving_margins(w["start"], w["velocity"],
                                               g["mics"], duration, 1024)
            out = tsim._render_moving(
                torch.as_tensor(bases[f"{name}_{k}"]), w["start"],
                w["velocity"], g["mics"], tool.FS, tool.C, 1024, budget,
                lead, 1000.0, 0.01, 1e-6)
            mix = mix + tsig.dynamic_range_compression(
                tsig.normalize_signal(out))
    return tool, g, mix


@pytest.mark.parametrize("name", ["walkers", "walkers3"])
def test_rate_bank_pool_holds_the_crossing_walkers(name):
    """The rate bank's pool on EVALUATION.md's crossing walkers (4-mic
    tetra, 3.2 m box, coarse_n 32) and three walkers on the 8-mic room
    array, float32 on the CPU: the covering radius (4.04 samples) less the
    envelope peak's half-width is a pool of 4; the compensated detections
    stay within 0.035 m of each walker on average (the full radius's pool
    of 5 read 0.055 / 0.066 m on the two walkers), and every track ends on
    the walker it started on."""
    tool, g, mix = _serving_mix(name)
    lower, upper = tool.ROOM_BOX
    assert ttr._rate_bank_pool(lower, upper, tool.MULTI["coarse_n"],
                               tool.FS, tool.C) == 4
    mt = ttr.track_multiple(mix, g["mics"], tool.FS, tool.C, lower, upper,
                            num_sources=len(g["walkers"]),
                            motion="compensated", device="cpu", **tool.MULTI)
    assert mt.positions.dtype == torch.float32
    pos = mt.positions.numpy()
    truth = tool.walker_truth(g["walkers"], mt.times.numpy())
    k = len(g["walkers"])
    first = [int(np.argmin(np.linalg.norm(pos[0] - truth[0, j], axis=-1)))
             for j in range(k)]
    last = [int(np.argmin(np.linalg.norm(pos[-1] - truth[-1, j], axis=-1)))
            for j in range(k)]
    assert sorted(first) == list(range(k)) and first == last, (first, last)
    err = np.stack([np.linalg.norm(pos[:, first[j]] - truth[:, j], axis=-1)
                    for j in range(k)], 1)
    assert err.mean(0).max() <= 0.035, err.mean(0)


def test_refinement_pools_without_wrapping_the_lag_window():
    """pyaudiolocalization_tpu/models/tracking.py:542: the refinement pools
    its linear +-w_half window with the circular ``max_pool_corr``, so
    past the 12-lag margin of w_half its two ends reach into each other.
    At 48 kHz with a gate of 0.8 m, pool_w = 17: a peak at lag +w_half
    shows at physically reachable negative lags (down to -w_half + 16) in
    JAX's pooled window, not in the port's, which pools the real lags
    beyond the window."""
    fs, gate = 48000.0, 0.8
    pool_w = max(1, int(np.ceil(0.866 * (2.0 * gate / 12) * fs / C)))
    assert pool_w == 17
    w_half, s_max = 180, 20
    wn = w_half + s_max
    comp_wide = np.zeros((1, 2 * wn + 1))
    ell = np.arange(-wn, wn + 1)
    comp_wide[0, ell == w_half] = 1.0           # the +w_half end
    comp_wide[0, ell == -w_half - 2] = 0.25     # a lag beyond -w_half
    comp = comp_wide[:, s_max:s_max + 2 * w_half + 1]
    jax_pooled = np.asarray(jsrp.max_pool_corr(jnp.asarray(comp), pool_w))
    port = ttr._pooled_linear_window(torch.as_tensor(comp_wide), s_max,
                                     w_half, pool_w).numpy()
    lags = np.arange(-w_half, w_half + 1)
    reach = lags == -w_half + 14                   # |lag| <= w_half - 12
    assert jax_pooled[0, reach] == 1.0            # the wrapped peak
    assert port[0, reach] == 0.25                 # the true neighbourhood
    # Where no wrap reaches, the two pools agree.
    inner = np.abs(lags) <= w_half - pool_w
    np.testing.assert_array_equal(port[0, inner], jax_pooled[0, inner])
    # Beyond the drift margin (pool_w > s_max) the window pads with zeros.
    edge = ttr._pooled_linear_window(torch.as_tensor(comp_wide), 5,
                                     w_half + 15, pool_w)
    assert edge.shape == (1, 2 * (w_half + 15) + 1)


def test_compensated_flags_describe_the_refined_detections(monkeypatch):
    """pyaudiolocalization_tpu/models/tracking.py:895: after the
    compensated refinement, ``MultiTrack.associated`` still holds the
    first pass's gate flags; each refined detection is its track's by
    construction, so the port flags them all True.  With a tight gate the
    first pass gates some detections out: JAX reports False there, for the
    same positions."""
    monkeypatch.setattr(ttr, "_rate_bank_pool", lambda *args: 2)
    sigs = _capture("walkers")
    kw = dict(MULTI, coarse_n=25, motion="compensated", gate=0.02,
              motion_iterations=1)
    want = jtr.track_multiple(jnp.asarray(sigs), jnp.asarray(MICS), FS, C,
                              jnp.asarray(LOWER), jnp.asarray(UPPER), **kw)
    got = ttr.track_multiple(sigs, MICS, FS, C, LOWER, UPPER, device="cpu",
                             **kw)
    assert not np.asarray(want.associated).all()
    assert got.associated.dtype == torch.bool and got.associated.all()
    static = ttr.track_multiple(sigs, MICS, FS, C, LOWER, UPPER,
                                device="cpu", **dict(kw, motion="static"))
    assert not static.associated.all()   # the static flags stay the gate's


def test_track_multiple_validation():
    sigs = np.zeros((4, 3000))
    for kw in (dict(num_sources=0), dict(num_sources=6),
               dict(num_sources=2, weighting="ml"),
               dict(num_sources=2, motion="fast"),
               dict(num_sources=2, segment=4096)):
        with pytest.raises(ValueError):
            ttr.track_multiple(sigs, MICS, FS, C, LOWER, UPPER,
                               device="cpu", **{"segment": 1024, **kw})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.track_multiple(sigs, MICS, FS, C, LOWER, UPPER, num_sources=2,
                           segment=1024)
