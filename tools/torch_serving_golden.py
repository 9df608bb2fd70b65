"""Write tests/data/torch_serving_golden.json and
tests/data/torch_serving_bases.npz: the JAX package's answers on the
serving and tracking path, which ``chip_smoke.py`` (phase 11,
``serving_phase``) holds the PyTorch port to on the card.

The moving renders' bases are drawn by the JAX package (its
``_base_signal`` for a key, float32) and saved in the ``.npz``; the card
renders the same bases.  The static streams' captures are numpy-only
(``static_capture``: fractional delays by phase ramps at the next power of
two, a seeded base), so ``chip_smoke.py`` rebuilds them from the seed;
this module imports jax only inside ``main``.

* ``moving`` — ``simulate_moving_source`` on the tetrahedral array of
  examples/track_moving_source.py (16 kHz, 2.0 s, 1.5 m/s, frame 512): the
  noise base of key 0 and a 1 kHz chirp, rendered in float64 from the
  float32 base; 64 probe samples a channel and each channel's norm;
* ``trajectory`` — ``localize_trajectory`` on that noise capture (float32
  render and tracking, as the card runs them), segment 4096, coarse_n 32,
  fine_n 12, the Kalman smoother, static and compensated (max_speed 3),
  with each segment's coarse margin (the relative gap between the pooled
  coarse map's maximum and its largest value more than one cell away);
* ``walkers`` — ``track_multiple`` on EVALUATION.md's crossing walkers
  (12 x 128 ms segments, the 4-mic tetra, 1.2 m/s, keys 11 and 22),
  static and compensated, float32; ``walkers3`` — three walkers on an
  8-mic room array (28 pairs), compensated;
* ``stream`` — ``StreamingLocalizer.run`` (float32 by construction):
  examples/online_localization.py's configuration (frame 4096, hop 1024,
  band 300-3400 Hz) on a 10 s capture; two talkers on the 1 m 8-mic cube
  with 'spatial' and 'claim' suppression; 'music' and 'capon' on two tones
  (600 and 850 Hz) at frame 2048, hop 512; and ``OnlineTracker`` over a
  compensated stream on the crossing walkers.

Runs on the CPU in a few minutes:

    JAX_PLATFORMS=cpu python tools/torch_serving_golden.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_serving_golden.json"
BASES = REPO / "tests" / "data" / "torch_serving_bases.npz"

FS = 16000.0
C = 343.0
TETRA = [[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [1.5, 3.0, 0.0], [1.5, 1.5, 2.0]]
ROOM_BOX = ([0.0, 0.0, 0.0], [3.2, 3.2, 2.2])
# An 8-mic room array: the corners of a 2.4 x 2.4 x 1.6 m box inside the
# search box (a 3.75 m diameter keeps the compensated alignment window of
# 128 ms segments within its 512-point subframe transform).
ROOM8 = [[x, y, z] for x in (0.4, 2.8) for y in (0.4, 2.8) for z in (0.3, 1.9)]
CUBE = [[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)]
UNIT4 = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]

MOVING = dict(start=[0.8, 1.2, 0.7], velocity=[1.5, 0.4, 0.0], duration=2.0,
              frame=512, key=0, chirp_freq=1000.0)
TRAJECTORY = dict(segment=4096, coarse_n=32, fine_n=12, smoother="kalman",
                  max_speed=3.0)
SEGMENT = 2048
WALKERS = [dict(start=[0.7, 1.0, 0.6], velocity=[1.2, 0.3, 0.0], key=11),
           dict(start=[2.26, 1.0, 1.1], velocity=[-1.2, 0.3, 0.0], key=22)]
WALKERS3 = WALKERS + [dict(start=[1.2, 2.6, 0.9], velocity=[0.3, -1.0, 0.0],
                           key=33)]
NUM_SEG = 12
MULTI = dict(segment=SEGMENT, hop=SEGMENT, coarse_n=32, fine_n=12,
             max_speed=3.0)
STREAMS = {
    "srp": dict(mics="unit4", capture="one", kw=dict(
        frame=4096, hop=1024, band=(300.0, 3400.0))),
    "two_spatial": dict(mics="cube", capture="two", kw=dict(
        frame=4096, hop=1024, num_sources=2)),
    "two_claim": dict(mics="cube", capture="two", kw=dict(
        frame=4096, hop=1024, num_sources=2, suppression="claim")),
    "music": dict(mics="cube", capture="tones", kw=dict(
        frame=2048, hop=512, method="music", num_sources=2)),
    "capon": dict(mics="cube", capture="tones", kw=dict(
        frame=2048, hop=512, method="capon", num_sources=2)),
}
CAPTURES = {
    "one": dict(seed=0, mics="unit4", seconds=10.0,
                sources=[([0.35, 0.55, 0.45], "noise", 0.0)]),
    "two": dict(seed=1, mics="cube", seconds=2.0,
                sources=[([0.3, 0.7, 0.4], "noise", 0.0),
                         ([0.7, 0.25, 0.6], "noise", 0.0)]),
    "tones": dict(seed=2, mics="cube", seconds=1.0,
                  sources=[([0.3, 0.7, 0.35], "sine", 600.0),
                           ([0.7, 0.25, 0.6], "sine", 850.0)]),
}
TRACKER = dict(frame=2048, hop=1024, ema=0.4, num_sources=2, coarse_n=32,
               fine_n=12, motion="compensated", max_speed=3.0)
MIC_SETS = {"tetra": TETRA, "room8": ROOM8, "cube": CUBE, "unit4": UNIT4}


def static_capture(name: str) -> np.ndarray:
    """(M, seconds * FS) float32 capture of ``CAPTURES[name]``: each
    source's base (seeded white noise, or a unit sine) delayed to every
    mic by a phase ramp at the next power of two, scaled by 1 / distance,
    summed over sources, plus white noise 40 dB below the first source's
    mean power."""
    spec = CAPTURES[name]
    mics = np.asarray(MIC_SETS[spec["mics"]], float)
    n = int(spec["seconds"] * FS)
    nfft = 1 << int(np.ceil(np.log2(n + 256)))
    rng = np.random.default_rng(spec["seed"])
    out = np.zeros((mics.shape[0], n))
    freqs = np.fft.rfftfreq(nfft, 1.0 / FS)
    for src, kind, freq in spec["sources"]:
        if kind == "noise":
            base = rng.standard_normal(nfft)
        else:
            base = np.sin(2.0 * np.pi * freq * np.arange(nfft) / FS)
        d = np.linalg.norm(np.asarray(src) - mics, axis=-1)
        ramp = np.exp(-2j * np.pi * freqs[None, :] * (d / C)[:, None])
        out += np.fft.irfft(np.fft.rfft(base)[None] * ramp, nfft)[:, :n] \
            / d[:, None]
    sigma = np.sqrt(np.mean(out[0] ** 2)) * 1e-2
    out += sigma * rng.standard_normal(out.shape)
    return out.astype(np.float32)


def moving_margins(start, velocity, mics, duration: float, frame: int):
    """(budget, lead) of the moving render (models/simulator.py:402-418 of
    the JAX package; the port's ``_moving_margins``), on the host."""
    from pyaudiolocalization_tpu_torch.models.simulator import \
        _moving_margins
    return _moving_margins(start, velocity, mics, FS, C, duration, frame)


def walker_truth(walkers, times) -> np.ndarray:
    """(S, K, 3) true positions at ``times``."""
    return np.stack([np.asarray(w["start"]) + np.asarray(times)[:, None]
                     * np.asarray(w["velocity"]) for w in walkers], 1)


def coarse_margin(vals, n: int) -> float:
    cells = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    k = int(np.argmax(vals))
    far = np.max(np.abs(cells - cells[k]), -1) > 1
    return float((vals[k] - vals[far].max()) / abs(vals[k]))


def _margins(jnp, corrs, mics, lower, upper, n):
    from pyaudiolocalization_tpu.models import srp
    pi, pj = np.triu_indices(len(mics), 1)
    mics_j = jnp.asarray(mics, jnp.float32)
    ml = srp._resolve_max_lag(None, mics_j, FS, C)
    pool = srp._resolve_pool(None, jnp.asarray(lower), jnp.asarray(upper), n,
                             FS, C)
    pts = srp._grid_points(jnp.asarray(lower, jnp.float32),
                           jnp.asarray(upper, jnp.float32), n, jnp.float32)
    out = []
    for corr in corrs:
        vals = np.asarray(srp.srp_map(srp._pooled_window(corr, ml, pool),
                                      pts, mics_j, pi, pj, FS, C,
                                      max_lag=ml, pre_windowed=True))
        out.append(coarse_margin(vals, n))
    return out


def _base(jax, jnp, sim, mover, mics, duration, frame):
    _, lead = moving_margins(mover["start"], mover["velocity"], mics,
                             duration, frame)
    return np.asarray(sim._base_signal(
        jax.random.PRNGKey(mover["key"]), jnp.asarray(1000.0, jnp.float32),
        signal_type="noise", fs=FS, duration=duration + 2.0 * lead / FS,
        dtype=jnp.float32))


def _render(jax, jnp, sim, mover, mics, duration, frame, dtype, kind="noise",
            freq=1000.0):
    return sim.simulate_moving_source(
        mover["start"], mover["velocity"], mics, FS, C, duration, kind,
        freq=freq, frame=frame, key=jax.random.PRNGKey(mover.get("key", 0)),
        dtype=dtype)


def _probes(x, idx):
    x = np.asarray(x, np.float64)
    return {"probes": x[:, idx].tolist(),
            "norms": np.linalg.norm(x, axis=-1).tolist()}


def _track_dict(track):
    out = {k: np.asarray(getattr(track, k)).tolist()
           for k in ("times", "positions", "smoothed", "powers")}
    if getattr(track, "velocities", None) is not None:
        out["velocities"] = np.asarray(track.velocities).tolist()
    if hasattr(track, "associated"):
        out["associated"] = np.asarray(track.associated).tolist()
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from pyaudiolocalization_tpu.models import online, tracking
    from pyaudiolocalization_tpu.models import simulator as sim
    from pyaudiolocalization_tpu.ops import gccphat

    golden, bases = {}, {}
    t0 = time.time()
    mv = dict(start=MOVING["start"], velocity=MOVING["velocity"],
              key=MOVING["key"])
    dur, frame = MOVING["duration"], MOVING["frame"]
    bases["moving"] = _base(jax, jnp, sim, mv, TETRA, dur, frame)
    n_out = int(dur * FS)
    idx = np.linspace(0, n_out - 1, 64).astype(int)
    capture32 = np.asarray(_render(jax, jnp, sim, mv, TETRA, dur, frame,
                                   jnp.float32))
    budget, lead = moving_margins(mv["start"], mv["velocity"], TETRA, dur,
                                  frame)
    golden["moving"] = {
        **MOVING, "mics": TETRA, "fs": FS, "c": C, "budget": budget,
        "lead": lead, "probe_index": idx.tolist(),
        "noise": _probes(_render_from_base(jax, jnp, sim, bases["moving"],
                                           mv, TETRA, dur, frame), idx),
        "chirp": _probes(_render(jax, jnp, sim, mv, TETRA, dur, frame,
                                 jnp.float64, "chirp",
                                 MOVING["chirp_freq"]), idx),
        "noise_float32": _probes(capture32, idx)}
    print(f"moving render: {time.time() - t0:.1f} s", flush=True)

    lower, upper = ROOM_BOX
    golden["trajectory"] = {}
    for motion in ("static", "compensated"):
        tr = tracking.localize_trajectory(
            jnp.asarray(capture32), jnp.asarray(TETRA, jnp.float32), FS, C,
            jnp.asarray(lower, jnp.float32), jnp.asarray(upper, jnp.float32),
            motion=motion, **TRAJECTORY)
        seg = TRAJECTORY["segment"]
        starts = np.arange(tr.positions.shape[0]) * (seg // 2)
        segs = np.stack([capture32[:, s:s + seg] for s in starts])
        pi, pj = np.triu_indices(4, 1)
        if motion == "static":
            corrs = [gccphat.gcc_phat_all_pairs(jnp.asarray(s), pi, pj,
                                                nfft=seg) for s in segs]
        else:
            mics_np = np.asarray(TETRA)
            diam = float(np.max(np.linalg.norm(
                mics_np[:, None] - mics_np[None], axis=-1)))
            w_half = int(np.ceil(diam * FS / C)) + 12
            s_max = int(np.ceil(2.0 * TRAJECTORY["max_speed"] / C * seg
                                / 2.0)) + 2
            circ, _, _ = tracking._motion_compensated_corr(
                jnp.asarray(segs), tuple(map(int, pi)), tuple(map(int, pj)),
                FS, None, "phat", 8, w_half, s_max,
                1 << int(np.ceil(np.log2(2 * seg // 8))))
            corrs = list(circ)
        golden["trajectory"][motion] = {
            **_track_dict(tr),
            "margins": _margins(jnp, corrs, TETRA, lower, upper,
                                TRAJECTORY["coarse_n"])}
    print(f"trajectory: {time.time() - t0:.1f} s", flush=True)

    walk_dur = NUM_SEG * SEGMENT / FS
    for name, walkers, mics, motions in (
            ("walkers", WALKERS, TETRA, ("static", "compensated")),
            ("walkers3", WALKERS3, ROOM8, ("compensated",))):
        mix = 0.0
        for k, w in enumerate(walkers):
            bases[f"{name}_{k}"] = _base(jax, jnp, sim, w, mics, walk_dur,
                                         1024)
            mix = mix + np.asarray(_render(jax, jnp, sim, w, mics, walk_dur,
                                           1024, jnp.float32))
        golden[name] = {"mics": mics, "walkers": walkers}
        for motion in motions:
            mt = tracking.track_multiple(
                jnp.asarray(mix), jnp.asarray(mics, jnp.float32), FS, C,
                jnp.asarray(lower, jnp.float32),
                jnp.asarray(upper, jnp.float32), num_sources=len(walkers),
                motion=motion, **MULTI)
            golden[name][motion] = _track_dict(mt)
        if name == "walkers":
            trk = online.OnlineTracker(online.StreamingLocalizer(
                np.asarray(mics), FS, C, np.asarray(lower),
                np.asarray(upper), **TRACKER), max_speed=3.0)
            pos, pw, ok = trk.run(mix)
            golden["tracker"] = {"positions": pos.tolist(),
                                 "associated": ok.tolist(), **TRACKER}
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)

    golden["stream"] = {}
    captures = {name: static_capture(name) for name in CAPTURES}
    for case, spec in STREAMS.items():
        loc = online.StreamingLocalizer(
            np.asarray(MIC_SETS[spec["mics"]]), FS, C, np.zeros(3),
            np.ones(3), **spec["kw"])
        pos, pw = loc.run(captures[spec["capture"]])
        golden["stream"][case] = {"positions": pos.tolist(),
                                  "powers": pw.tolist(), **spec}
        print(f"stream {case}: {time.time() - t0:.1f} s", flush=True)

    golden["captures"] = CAPTURES
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    np.savez_compressed(BASES, **{k: v.astype(np.float32)
                                  for k, v in bases.items()})
    print(f"wrote {GOLDEN} and {BASES} in {time.time() - t0:.1f} s")
    return 0


def _render_from_base(jax, jnp, sim, base, mover, mics, duration, frame):
    """The JAX package's moving render of a given float32 base, in
    float64: ``simulate_moving_source`` with its base draw replaced by
    ``base`` (the key's own float64 draw would be another signal)."""
    original = sim._base_signal
    sim._base_signal = lambda *args, **kwargs: jnp.asarray(base, jnp.float64)
    try:
        return _render(jax, jnp, sim, mover, mics, duration, frame,
                       jnp.float64)
    finally:
        sim._base_signal = original


if __name__ == "__main__":
    sys.exit(main())
