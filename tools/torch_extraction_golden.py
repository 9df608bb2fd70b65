"""Write tests/data/torch_extraction_golden.json and
tests/data/torch_extraction_bases.npz: the JAX package's answers on
beamformed extraction and array-geometry calibration, which
``chip_smoke.py`` (phase 12, ``extraction_calibration_mesh_phase``) holds
the PyTorch port to on the card.

Every noise base is drawn by the JAX package (``generate_signal`` for a
key, float32) and saved in the ``.npz``; both sides render the same bases
through the free-field scene (direct path, 1/d gain, finalized: the
render of ``simulate_signals_fast`` with no planes), the golden in
float64 and the card in float32 through K3.  The 1 kHz sine is each
side's own ``generate_signal``.  This module imports jax only inside
``main``; its constants and numpy helpers are what ``chip_smoke.py``
loads.

* ``extraction`` — EVALUATION.md's protocol (tools/eval_sweep.py's
  extraction section) on the 8-mic cube at 16 kHz, frame 256, hop 64:
  three scenes (positions from seed 500, target keys 5000 + i, interferer
  keys 6000 + i), a white-noise and a 1 kHz sine interferer at 0.25 s and
  1.0 s, each scaled to the target's variance; delay-and-sum SIR, and
  MVDR (taps 1, loading 0.3) and LCMV (taps 3, loading 0.3) SIR and
  target gain, with weights adapted on the mix and applied to each
  component;
* ``calibration`` — examples/calibrate_array_geometry.py's scene: the
  tetrahedron jittered by 3 cm (seed 11), 8 noise events at 48 kHz x 0.1 s
  (keys 100 + k), ``calibrate_array_geometry`` at ``nfft=None`` and at
  16,384, with every event's TDOA margins; then the 6-mic array (the same
  generator's next draw), 12 events (keys 300 + k), joint
  self-calibration with the JAX package's k-means seeds at the survey
  (``seed_indices``), both lengths, and the same self-calibration in
  float32 with its greatest mic offset from float64.

Runs on the CPU in about a minute:

    JAX_PLATFORMS=cpu python tools/torch_extraction_golden.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_extraction_golden.json"
BASES = REPO / "tests" / "data" / "torch_extraction_bases.npz"

# Extraction.
X_FS = 16000.0
X_C = 343.0
CUBE = [[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0) for z in (0.0, 1.0)]
FRAME, HOP = 256, 64
X_SCENES = 3
X_DURATIONS = (0.25, 1.0)
INTERFERERS = (("noise", 500.0), ("sine", 1000.0))
TAPS_LOADING = {1: 0.3, 3: 0.3}

# Calibration.
C_FS = 48000.0
C_DURATION = 0.1
TETRA = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.5, 1.0, 0.0], [0.5, 0.5, 1.0]]
SOURCES = [[0.2, 0.3, 0.6], [0.9, 0.8, 0.4], [0.1, 0.9, 0.9],
           [0.8, 0.1, 0.8], [0.5, 0.6, 0.2], [0.3, 0.2, 1.1],
           [1.1, 0.5, 0.7], [0.6, 1.0, 1.0]]
MICS6 = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
         [0.0, 0.0, 1.0], [1.0, 1.0, 0.0], [0.5, 0.5, 1.2]]
SOURCES12 = SOURCES + [[0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.7, 0.7, 1.1],
                       [0.4, 0.1, 0.9]]
MAX_DELAY = 0.02
C_NFFTS = (None, 16384)
# Free-field render: no planes, the air table of simulate_signals_fast's
# callers (absorption 0.01 at 1e-6 Hz), no reflections.
FREE_FIELD = dict(absorption=[0.01], freq_table=[1e-6], threshold=1e-4)


def extraction_scenes():
    """Target and interferer positions of the three scenes (seed 500;
    the interferer at least 0.5 m from the target)."""
    rng = np.random.default_rng(500)
    out = []
    for _ in range(X_SCENES):
        ps = rng.uniform(0.15, 0.85, 3)
        pi = rng.uniform(0.15, 0.85, 3)
        while np.linalg.norm(pi - ps) < 0.5:
            pi = rng.uniform(0.15, 0.85, 3)
        out.append((ps, pi))
    return out


def true_geometries():
    """(tetra, 6-mic) true positions: the surveys plus U(-3, 3) cm from
    one generator of seed 11, as the example draws them."""
    rng = np.random.default_rng(11)
    tetra = np.asarray(TETRA) + rng.uniform(-0.03, 0.03, (4, 3))
    six = np.asarray(MICS6) + rng.uniform(-0.03, 0.03, (6, 3))
    return tetra, six


def pairs(m: int):
    p = np.array([(i, j) for i in range(m) for j in range(i + 1, m)])
    return p[:, 0], p[:, 1]


def pairwise(mics) -> np.ndarray:
    mics = np.asarray(mics, float)
    iu = np.triu_indices(len(mics), 1)
    return np.linalg.norm(mics[:, None] - mics[None], axis=-1)[iu]


def tdoa_margins(corr, n: int, fs: float) -> np.ndarray:
    """Relative gap between each row's tallest correlation sample within
    the ±MAX_DELAY lag window and its tallest sample more than one lag
    away: (K, P, nfft) circular correlations of N-sample signals ->
    (K, P).  A small margin is a near-tie that float32 may break the
    other way."""
    corr = np.asarray(corr, np.float64)
    nfft = corr.shape[-1]
    shift = n - 1 if nfft >= 2 * n - 1 else nfft // 2
    lin = np.roll(corr, shift, axis=-1)
    lags = np.arange(nfft) - shift
    w = int(round(MAX_DELAY * fs))
    win = lin[..., (lags >= -w) & (lags <= w)]
    top = np.argmax(win, -1)
    peak = np.take_along_axis(win, top[..., None], -1)[..., 0]
    idx = np.arange(win.shape[-1])
    far = np.abs(idx - top[..., None]) > 1
    runner = np.max(np.where(far, win, -np.inf), -1)
    return (peak - runner) / np.abs(peak)


# ---------------------------------------------------------------------------
# The JAX side (main only)
# ---------------------------------------------------------------------------

def _render(jnp, sim, base, source, mics, fs, c, duration):
    """The free-field render of ``base`` (float64)."""
    delays, gains, _, _ = sim._scene_geometry(
        jnp.asarray(source, jnp.float64), jnp.asarray(mics, jnp.float64),
        jnp.zeros((0, 4)), jnp.zeros((0,), jnp.int32),
        jnp.asarray(FREE_FIELD["absorption"]),
        jnp.asarray(FREE_FIELD["freq_table"]), jnp.asarray(500.0),
        jnp.asarray(c), max_reflections=0,
        absorption_threshold=FREE_FIELD["threshold"])
    budget = sim.static_delay_budget(np.asarray(source), mics,
                                     np.zeros((0, 4)), 0, fs)
    out = int(duration * fs)
    total = out + int(np.ceil(budget * fs))
    return np.asarray(sim.render_scene(jnp.asarray(base, jnp.float64),
                                       delays, gains, fs, total, out,
                                       pad_mode="pow2"))


def _noise_base(jax, jnp, sig_ops, key, fs, duration):
    return np.asarray(sig_ops.generate_signal(
        "noise", fs, duration, 500.0, key=jax.random.PRNGKey(key),
        dtype=jnp.float32))


def _extraction(jax, jnp, sim, sig_ops, bf, bases):
    out = {}
    for duration in X_DURATIONS:
        for kind, freq in INTERFERERS:
            name = f"{kind}_{duration:g}s"
            rows = []
            for i, (ps, pi) in enumerate(extraction_scenes()):
                tkey = f"target_{duration:g}s_{i}"
                bases.setdefault(tkey, _noise_base(jax, jnp, sig_ops,
                                                   5000 + i, X_FS, duration))
                if kind == "noise":
                    ikey = f"interferer_{duration:g}s_{i}"
                    bases.setdefault(ikey, _noise_base(
                        jax, jnp, sig_ops, 6000 + i, X_FS, duration))
                    ibase = bases[ikey]
                else:
                    ibase = np.asarray(sig_ops.generate_signal(
                        "sine", X_FS, duration, freq, dtype=jnp.float64))
                s_only = _render(jnp, sim, bases[tkey], ps, CUBE, X_FS, X_C,
                                 duration)
                i_only = _render(jnp, sim, ibase, pi, CUBE, X_FS, X_C,
                                 duration)
                i_only = i_only * np.sqrt(np.var(s_only) / np.var(i_only))
                rows.append(_sirs(jax, jnp, bf, s_only, i_only, ps))
            out[name] = {
                "per_scene": rows,
                "das_sir_db": _db([r["das_ratio"] for r in rows]),
                **{f"taps{t}_sir_db": _db([r[f"taps{t}_ratio"]
                                           for r in rows])
                   for t in TAPS_LOADING},
                **{f"taps{t}_gain": float(np.mean([r[f"taps{t}_gain"]
                                                   for r in rows]))
                   for t in TAPS_LOADING}}
            print(f"extraction {name}: das {out[name]['das_sir_db']:.2f} dB, "
                  f"taps1 {out[name]['taps1_sir_db']:.2f} dB gain "
                  f"{out[name]['taps1_gain']:.3f}, taps3 "
                  f"{out[name]['taps3_sir_db']:.2f} dB gain "
                  f"{out[name]['taps3_gain']:.3f}", flush=True)
    return out


def _db(ratios) -> float:
    return float(10.0 * np.log10(np.mean(ratios)))


def _sirs(jax, jnp, bf, s_only, i_only, ps):
    """tools/eval_sweep.py's extraction protocol for one scene."""
    s_al = bf.align_to_position(jnp.asarray(s_only), CUBE, ps, X_FS, X_C)
    i_al = bf.align_to_position(jnp.asarray(i_only), CUBE, ps, X_FS, X_C)
    tau0 = jnp.zeros((len(CUBE),), s_al.dtype)
    ds = np.asarray(bf.extract_source(jnp.asarray(s_only), CUBE, ps, X_FS,
                                      X_C))
    di = np.asarray(bf.extract_source(jnp.asarray(i_only), CUBE, ps, X_FS,
                                      X_C))
    row = {"das_ratio": float(np.var(ds) / np.var(di))}
    for taps, loading in TAPS_LOADING.items():
        wr, wi = bf.mvdr_weights(
            bf.stack_taps(bf.stft_analysis(s_al + i_al, FRAME, HOP), taps,
                          True), tau0, X_FS, FRAME, loading=loading,
            taps=taps)

        def apply(al):
            spec = bf.stack_taps(bf.stft_analysis(al, FRAME, HOP), taps,
                                 False)
            xr, xi = jnp.real(spec), jnp.imag(spec)
            y = jax.lax.complex(
                jnp.einsum("mf,mtf->tf", wr, xr)
                + jnp.einsum("mf,mtf->tf", wi, xi),
                jnp.einsum("mf,mtf->tf", wr, xi)
                - jnp.einsum("mf,mtf->tf", wi, xr))
            return np.asarray(bf.wola_synthesis(y, FRAME, HOP,
                                                s_only.shape[-1]))

        so, io = apply(s_al), apply(i_al)
        row[f"taps{taps}_ratio"] = float(np.var(so) / np.var(io))
        row[f"taps{taps}_gain"] = float(np.var(so) / np.var(ds))
    return row


def _jax_event_seeds(jax, jnp, jsol, jcl, td, mics, c):
    """(K, 5) k-means++ seed indices the JAX package draws for each
    event at ``mics`` (self_calibrate_array's default key)."""
    pi, pj = pairs(len(mics))
    keys = jax.random.split(jax.random.PRNGKey(0), td.shape[0])
    rows = []
    for k in range(td.shape[0]):
        points, valid = jsol.pair_guesses(jnp.asarray(mics), pi, pj,
                                          jnp.asarray(td[k]), c)
        points = np.asarray(points)
        seeds = np.asarray(jcl.kmeans(jnp.asarray(points), 5, keys[k],
                                      iters=0,
                                      valid=jnp.asarray(valid)).centers)
        rows.append([int(np.flatnonzero(np.all(points == s, -1))[0])
                     for s in seeds])
    return rows


def _calibration(jax, jnp, sim, sig_ops, cal, gcc, jsol, jcl, c, bases):
    tetra_true, six_true = true_geometries()
    out = {"c": c, "fs": C_FS, "duration": C_DURATION,
           "max_expected_delay": MAX_DELAY,
           "tetra_true": tetra_true.tolist(), "six_true": six_true.tolist()}
    for name, true, survey, sources, key0 in (
            ("tetra", tetra_true, TETRA, SOURCES, 100),
            ("six", six_true, MICS6, SOURCES12, 300)):
        events = []
        for k, src in enumerate(sources):
            bkey = f"{name}_event_{k}"
            bases[bkey] = _noise_base(jax, jnp, sig_ops, key0 + k, C_FS,
                                      C_DURATION)
            events.append(_render(jnp, sim, bases[bkey], src, true, C_FS, c,
                                  C_DURATION))
        events = np.stack(events)
        n = events.shape[-1]
        pi, pj = pairs(len(survey))
        for nfft in C_NFFTS:
            tag = f"{name}_{nfft or 'exact'}"
            corr = gcc.gcc_phat_all_pairs(jnp.asarray(events), pi, pj,
                                          nfft=nfft)
            margins = tdoa_margins(corr, n, C_FS)
            if name == "tetra":
                res = cal.calibrate_array_geometry(
                    events, np.asarray(sources), np.asarray(survey), C_FS, c,
                    nfft=nfft, max_expected_delay=MAX_DELAY)
                mics = np.asarray(res.mic_positions)
                entry = {"worst_mic_error": float(np.linalg.norm(
                    mics - true, axis=-1).max())}
            else:
                td0 = np.asarray(cal.calibrate_array_geometry(
                    events, np.asarray(sources), np.asarray(survey), C_FS, c,
                    nfft=nfft, max_expected_delay=MAX_DELAY,
                    sweeps=0).tdoas)
                seeds = _jax_event_seeds(jax, jnp, jsol, jcl, td0,
                                         np.asarray(survey), c)
                res = cal.calibrate_array_geometry(
                    events, None, np.asarray(survey), C_FS, c, nfft=nfft,
                    max_expected_delay=MAX_DELAY)
                mics = np.asarray(res.mic_positions)
                # The same self-calibration in float32: its absolute
                # positions keep the rigid, data-null part that only the
                # weak anchor pins, and float32 moves it.
                res32 = cal.calibrate_array_geometry(
                    events.astype(np.float32), None,
                    np.asarray(survey, np.float32), C_FS, c, nfft=nfft,
                    max_expected_delay=MAX_DELAY)
                mics32 = np.asarray(res32.mic_positions)
                assert mics32.dtype == np.float32, mics32.dtype
                entry = {"seed_indices": seeds,
                         "float32_mic_positions": mics32.tolist(),
                         "float32_offset": float(np.linalg.norm(
                             mics32 - mics, axis=-1).max()),
                         "source_positions": np.asarray(
                             res.source_positions).tolist(),
                         "worst_shape_error": float(np.abs(
                             pairwise(mics) - pairwise(true)).max())}
            out[tag] = {"tdoas": np.asarray(res.tdoas).tolist(),
                        "margins": margins.tolist(),
                        "mic_positions": mics.tolist(),
                        "cost": float(res.cost),
                        "initial_cost": float(res.initial_cost), **entry}
            print(f"calibration {tag}: "
                  + (f"worst mic {entry['worst_mic_error'] * 1e3:.2f} mm"
                     if name == "tetra" else
                     f"worst shape {entry['worst_shape_error'] * 1e3:.2f} "
                     f"mm, float32 {entry['float32_offset'] * 1e3:.2f} mm "
                     "from float64")
                  + f", least TDOA margin {margins.min():.2e}", flush=True)
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from pyaudiolocalization_tpu.models import arraycal as cal
    from pyaudiolocalization_tpu.models import beamformer as bf
    from pyaudiolocalization_tpu.models import cluster as jcl
    from pyaudiolocalization_tpu.models import simulator as sim
    from pyaudiolocalization_tpu.models import solver as jsol
    from pyaudiolocalization_tpu.models.acoustics import speed_of_sound
    from pyaudiolocalization_tpu.ops import gccphat as gcc
    from pyaudiolocalization_tpu.ops import signal as sig_ops

    t0 = time.time()
    # The render from a given base is simulate_signals_fast's.
    key = jax.random.PRNGKey(7)
    base = sig_ops.generate_signal("noise", C_FS, C_DURATION, 500.0, key=key,
                                   dtype=jnp.float64)
    want = np.asarray(sim.simulate_signals_fast(
        SOURCES[0], TETRA, C_FS, 343.0, C_DURATION, "noise", 500.0, None,
        None, jnp.asarray([0.01]), jnp.asarray([1e-6]), 0, 1e-4, key=key))
    got = _render(jnp, sim, np.asarray(base), SOURCES[0], TETRA, C_FS, 343.0,
                  C_DURATION)
    assert np.allclose(got, want, rtol=0, atol=1e-12), np.abs(got - want).max()
    bases = {}
    golden = {
        "extraction": _extraction(jax, jnp, sim, sig_ops, bf, bases),
        "calibration": _calibration(jax, jnp, sim, sig_ops, cal, gcc, jsol,
                                    jcl, float(speed_of_sound(20.0, 50.0)),
                                    bases)}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    np.savez(BASES, **bases)
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} B) and {BASES} "
          f"({BASES.stat().st_size} B) in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
