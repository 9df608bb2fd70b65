"""The port's online localization (models/online.py) against the JAX
package on the CPU.  The state is float32 in both packages, so positions
are held to 1e-3 m: ``StreamingLocalizer`` with 'srp' for one talker and
for two ('spatial' and 'claim' suppression), the 'ml' and 'scot'
weightings, 'capon' and 'music' for one and two tones, ``motion=
'compensated'`` under ``OnlineTracker``, ``step`` against ``run``, the
validation errors, and the one fault of the JAX package the port repairs
(``suppression='claim'`` with a narrowband method, online.py:185 there).

The SRP coarse maps are max-pooled, and in float32 neighbouring cells tie
to ~1e-7 relative: every coarse map the port evaluates is recorded, and a
hop whose map ties (top two within 1e-5 relative) may differ by up to two
coarse-cell diagonals; every other hop agrees to 1e-3 m, and at least a
quarter of the hops must."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import online as jon
from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu_torch.models import online as ton
from pyaudiolocalization_tpu_torch.models import srp as tsrp
from pyaudiolocalization_tpu_torch.models import tracking as ttr

FS = 16000.0
C = 343.0
M4 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
               [0.0, 0.0, 1.0]])
CUBE = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
                 [1, 0, 1], [0, 1, 1], [1, 1, 1]], float)
TETRA = np.array([[0.0, 0.0, 0.0], [1.2, 0.0, 0.0], [0.6, 1.2, 0.0],
                  [0.6, 0.6, 1.0]])
BOX = (np.zeros(3), np.ones(3))
TOL = 1e-3
TIE = 1e-5


def _scene(src, mics, kind="noise", freq=500.0, key=0, dur=0.4):
    return np.asarray(jsim.simulate_signals(
        src, mics, FS, C, duration=dur, signal_type=kind, freq=freq,
        key=jax.random.PRNGKey(key)))


_CACHE = {}


def _capture(name):
    if name not in _CACHE:
        if name == "one":
            _CACHE[name] = _scene([0.35, 0.55, 0.45], M4)
        elif name == "two":
            _CACHE[name] = (_scene([0.3, 0.7, 0.4], CUBE, key=1)
                            + _scene([0.7, 0.25, 0.6], CUBE, key=2))
        elif name == "tones":
            _CACHE[name] = (_scene([0.3, 0.7, 0.35], CUBE, "sine", 600.0)
                            + _scene([0.7, 0.25, 0.6], CUBE, "sine", 850.0))
        elif name == "walkers":
            dur = 8 * 1024 / FS
            _CACHE[name] = sum(np.asarray(jsim.simulate_moving_source(
                s, v, TETRA, FS, C, dur, "noise", frame=512,
                key=jax.random.PRNGKey(k))) for s, v, k in (
                (np.array([0.3, 0.4, 0.3]), np.array([0.8, 0.2, 0.0]), 11),
                (np.array([0.9, 0.4, 0.7]), np.array([-0.8, 0.2, 0.0]), 22)))
    return _CACHE[name]


@pytest.fixture
def margins(monkeypatch):
    """The relative top-two gap of every coarse map the port's searches
    evaluate (each extraction round its own), in order."""
    record = []
    two = tsrp.two_stage_search
    multi = tsrp.suppressed_multi_search

    def gap(vals):
        top = torch.topk(vals, 2, -1)[0]
        return float(torch.min((top[..., 0] - top[..., 1])
                               / torch.abs(top[..., 0])))

    def two_stage(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n):
        record.append(gap(coarse_fn(tsrp._grid_points(lower, upper,
                                                      coarse_n))))
        return two(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n)

    def suppressed(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n,
                   num_sources, min_separation):
        pts = tsrp._grid_points(lower, upper, coarse_n)
        vals = coarse_fn(pts)
        radius = 3.0 * float(torch.max((upper - lower) / coarse_n))
        for _ in range(num_sources):
            record.append(gap(vals))
            center = pts[torch.argmax(vals)]
            close = torch.linalg.norm(pts - center, dim=-1) <= radius
            vals = torch.where(close, torch.full_like(vals, -np.inf), vals)
        return multi(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n,
                     num_sources, min_separation)

    for mod in (tsrp, ton):
        monkeypatch.setattr(mod, "two_stage_search", two_stage)
    monkeypatch.setattr(tsrp, "suppressed_multi_search", suppressed)
    return record


def _held(got, want, record, loc, tol=TOL):
    """Per-hop estimates within ``tol``, except on a hop whose coarse map
    tied, where they lie within two coarse-cell diagonals; a quarter of
    the hops or more agree to ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    hops = got.shape[0]
    tied = np.zeros(hops, bool)
    if record:
        gaps = np.asarray(record).reshape(-1, len(record) // (
            hops + loc.frame // loc.hop - 1))[loc.frame // loc.hop - 1:]
        tied = (gaps <= TIE).any(1)
    diff = np.abs(got - want).reshape(hops, -1).max(1)
    cell = float(np.max(np.asarray(loc.upper.cpu()) - np.asarray(
        loc.lower.cpu()))) / loc.coarse_n
    assert np.all((diff <= tol) | tied), (diff, tied)
    assert np.all(diff <= 2.0 * np.sqrt(3.0) * cell), diff
    assert (diff <= tol).mean() >= 0.25, diff
    return diff <= tol


CASES = {
    "srp": ("one", M4, dict(frame=2048, hop=512, band=(300.0, 3400.0))),
    "ml": ("one", M4, dict(frame=2048, hop=512, weighting="ml")),
    "scot": ("one", M4, dict(frame=2048, hop=512, weighting="scot")),
    "two_spatial": ("two", CUBE, dict(frame=2048, hop=512, num_sources=2)),
    "two_claim": ("two", CUBE, dict(frame=2048, hop=512, num_sources=2,
                                    suppression="claim")),
    "capon": ("tones", CUBE, dict(frame=2048, hop=512, method="capon")),
    "music": ("tones", CUBE, dict(frame=2048, hop=512, method="music",
                                  band=(300.0, 3400.0))),
    "capon_two": ("tones", CUBE, dict(frame=2048, hop=512, method="capon",
                                      num_sources=2)),
    "music_two": ("tones", CUBE, dict(frame=2048, hop=512, method="music",
                                      num_sources=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_localizer_matches_jax(margins, case):
    name, mics, kw = CASES[case]
    sigs = _capture(name)
    want_p, want_w = jon.StreamingLocalizer(mics, FS, C, *BOX, **kw).run(
        sigs)
    loc = ton.StreamingLocalizer(mics, FS, C, *BOX, device="cpu", **kw)
    got_p, got_w = loc.run(sigs)
    assert got_p.dtype == np.float32 and got_p.shape == want_p.shape
    agree = _held(got_p, want_p, margins, loc)
    # The map's value at fixes 1e-3 m apart on a peak a few mm wide.
    scale = np.abs(want_w).max()
    assert np.max(np.abs(got_w - want_w)[agree]) < 5e-2 * scale


def test_step_equals_run_and_keeps_float32_state():
    """Driving ``step`` hop by hop gives ``run``'s estimates exactly; the
    state stays float32 and the EMA planes are the EMA of the frames'
    cross-spectra (the whitening works on a new tensor)."""
    sigs = _capture("one")
    loc = ton.StreamingLocalizer(M4, FS, C, *BOX, frame=2048, hop=512,
                                 device="cpu")
    run_p, run_w = loc.run(sigs)
    state = loc.init_state()
    got = []
    cross = torch.zeros_like(state.cross_r, dtype=torch.complex64)
    for s in range(sigs.shape[1] // 512):
        out = loc.step(state, sigs[:, s * 512:(s + 1) * 512])
        state = out.state
        spec = torch.fft.rfft(state.buffer * loc._window)
        cross = 0.7 * cross + 0.3 * (spec[loc._pi] * spec[loc._pj].conj())
        got.append(out.position.numpy())
    np.testing.assert_array_equal(np.stack(got)[3:], run_p)
    assert all(t.dtype == torch.float32 for t in state[:4])
    assert int(state.count) == sigs.shape[1] // 512
    np.testing.assert_allclose(state.cross_r.numpy(), cross.real.numpy(),
                               rtol=1e-4, atol=1e-4 * float(
                                   cross.abs().max()))
    np.testing.assert_allclose(state.cross_i.numpy(), cross.imag.numpy(),
                               rtol=1e-4, atol=1e-4 * float(
                                   cross.abs().max()))


def test_online_tracker_static_talkers_matches_jax(margins):
    sigs = _capture("two")
    kw = dict(frame=2048, hop=512, num_sources=2)
    want = jon.OnlineTracker(jon.StreamingLocalizer(CUBE, FS, C, *BOX,
                                                    **kw)).run(sigs)
    loc = ton.StreamingLocalizer(CUBE, FS, C, *BOX, device="cpu", **kw)
    got = ton.OnlineTracker(loc).run(sigs)
    agree = _held(got[0], want[0], margins, loc)
    np.testing.assert_array_equal(got[2][agree], want[2][agree])


def test_online_tracker_compensated_matches_jax(margins):
    """Crossing walkers, causal: the rate bank on the live frame every hop
    (K1 over the frame's subframes) with the JAX package's pool of 2 (its
    traced fallback, tracking.py:465 there; the port's own pool is
    ``_rate_bank_pool``'s), then the momentum-gated association."""
    sigs = _capture("walkers")
    kw = dict(frame=1024, hop=512, ema=0.4, num_sources=2, coarse_n=25,
              fine_n=10, motion="compensated", max_speed=2.0)
    lower, upper = np.zeros(3), np.array([1.2, 1.2, 1.0])
    want = jon.OnlineTracker(jon.StreamingLocalizer(
        TETRA, FS, C, lower, upper, **kw), max_speed=2.0).run(sigs)
    loc = ton.StreamingLocalizer(TETRA, FS, C, lower, upper, device="cpu",
                                 **kw)
    assert loc.pool == ttr._rate_bank_pool(lower, upper, 25, FS, C) == 2
    got = ton.OnlineTracker(loc, max_speed=2.0).run(sigs)
    agree = _held(got[0], want[0], margins, loc)
    np.testing.assert_array_equal(got[2][agree], want[2][agree])
    # The single-talker compensated step: the rate bank's first extraction.
    single = ton.StreamingLocalizer(TETRA, FS, C, lower, upper, device="cpu",
                                    **dict(kw, num_sources=1))
    pos, _ = single.run(sigs)
    assert pos.shape == (got[0].shape[0], 3)


@pytest.mark.parametrize("method", ["capon", "music"])
def test_claim_with_a_narrowband_method_raises(method):
    """pyaudiolocalization_tpu/models/online.py:185: the JAX package takes
    ``suppression='claim'`` with a narrowband method and ignores it (its
    bins are claimed by ``_claimed_multi_search`` instead); the port
    raises, as it does for ``motion='compensated'`` there."""
    jon.StreamingLocalizer(CUBE, FS, C, *BOX, method=method, num_sources=2,
                           suppression="claim")
    with pytest.raises(ValueError, match="claim"):
        ton.StreamingLocalizer(CUBE, FS, C, *BOX, method=method,
                               num_sources=2, suppression="claim",
                               device="cpu")
    ton.StreamingLocalizer(CUBE, FS, C, *BOX, method=method, num_sources=2,
                           device="cpu")


def test_streaming_validation_and_short_captures():
    bad = [dict(frame=3000), dict(frame=2048, hop=700),
           dict(nb_frame=300), dict(method="beam"), dict(weighting="hb"),
           dict(weighting="scot", method="capon"), dict(num_sources=0),
           dict(method="music", num_sources=4), dict(suppression="ball"),
           dict(motion="fast"), dict(motion="compensated", method="capon"),
           dict(motion="compensated", weighting="ml"),
           dict(motion="compensated", frame=256, hop=256)]
    for kw in bad:
        with pytest.raises(ValueError):
            ton.StreamingLocalizer(M4, FS, C, *BOX, device="cpu", **kw)
    loc = ton.StreamingLocalizer(M4, FS, C, *BOX, frame=2048, hop=512,
                                 device="cpu")
    with pytest.raises(ValueError, match="block"):
        loc.step(loc.init_state(), np.zeros((4, 100)))
    pos, pw = loc.run(np.zeros((4, 1000)))
    assert pos.shape == (0, 3) and pw.shape == (0,)
    multi = ton.StreamingLocalizer(M4, FS, C, *BOX, frame=2048, hop=512,
                                   num_sources=2, device="cpu")
    with pytest.raises(ValueError):
        ton.OnlineTracker(loc)
    pos, pw, ok = ton.OnlineTracker(multi).run(np.zeros((4, 1000)))
    assert pos.shape == (0, 2, 3) and ok.shape == (0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ton.StreamingLocalizer(M4, FS, C, *BOX)
