"""Write tests/data/torch_narrowband_golden.json: the JAX package's answers
for the narrowband solvers, per-bin absorption and the sweep's lm-robust,
DE and Wiener modes, which ``chip_smoke.py`` (phase 9) holds the PyTorch
port to.  Everything runs on the CPU in float32, the card's type.

* ``scenes`` — ``localize_sound_source`` in physical mode with ``solver``
  'beam', 'music' and 'capon' on the demo scene (``DEFAULT_CONFIG``) and
  the off-centre chirp scene (source [0.2, 0.6, 0.4]): the position, the
  TDOAs, the group-jackknife ``std`` and the coarse map's margin (the
  relative gap between its maximum and its largest value more than one
  cell away; a near-tie may resolve the other way in another summation
  order).  The bootstrap null runs 64 draws: it decides ``significant``
  only;
* ``per_bin`` — the demo scene with ``absorption_mode='per-bin'`` and
  ``solver='lm'`` (the default material table: SURVEY.md Q2's per-Hz
  coefficients, which leave the band near-DC only, and a warning), and the
  off-centre chirp scene with the physically scaled ``PHYSICAL`` table:
  TDOAs and position;
* ``trio`` / ``two_tone`` — ``monte_carlo_sweep`` statistics at
  EVALUATION.md's narrowband trio spec (tools/eval_sweep.py:247-267:
  800 Hz sine, the 8-mic 1 m cube, 16 kHz x 0.25 s, SNR 25-35 dB, sources
  in [0.2, 0.8]^3) over 128 scenes (8 keys x 16) for each solver, and its
  two-tone spec (600 + 950 Hz, separation 0.35 m, [0.15, 0.85]^3) over 64
  scenes for 'music' and 'capon';
* ``localize_batch`` — ``localize_batch`` at the trio spec on the 32 tone
  scenes of ``tone_scenes(seed=3, ...)`` for each solver, with each
  scene's coarse margin;
* ``modes`` — ``monte_carlo_sweep`` statistics over 128 scenes at
  ``bench.py``'s ``bench_full_sweep`` spec (4 mics, 44.1 kHz x 1 s, noise,
  SNR 20-40 dB) with ``solver='lm-robust'``, ``solver='de'`` and
  ``filter_method='wiener'``.

``tone_scenes`` is numpy only and importable without jax: ``chip_smoke``
rebuilds the same scenes from the same seed on a machine that has no jax.
Runs on the CPU in chunks of 16 scenes, in about twenty minutes:

    JAX_PLATFORMS=cpu python tools/torch_narrowband_golden.py
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "torch_narrowband_golden.json"
CUBE8 = tuple((x, y, z) for x in (0.0, 1.0) for y in (0.0, 1.0)
              for z in (0.0, 1.0))
# EVALUATION.md's narrowband trio and its two-tone row, as SweepSpec
# keyword arguments (tools/eval_sweep.py:247-267).
TRIO = dict(fs=16000.0, duration=0.25, signal_type="sine", freq=800.0,
            mic_positions=CUBE8, source_box_lo=(0.2, 0.2, 0.2),
            source_box_hi=(0.8, 0.8, 0.8), snr_db=(25.0, 35.0))
TWO_TONE = dict(fs=16000.0, duration=0.25, signal_type="sine",
                mic_positions=CUBE8, num_sources=2,
                source_freqs=(600.0, 950.0), source_min_separation=0.35,
                source_box_lo=(0.15, 0.15, 0.15),
                source_box_hi=(0.85, 0.85, 0.85), snr_db=(25.0, 35.0))
# bench.py's bench_full_sweep spec.
FULL = dict(fs=44100.0, duration=1.0, signal_type="noise",
            source_box_lo=(0.1, 0.1, 0.1), source_box_hi=(0.9, 0.9, 0.9),
            snr_db=(20.0, 40.0))
# Physically scaled frequency coefficients (per Hz * m) for the per-bin
# render: air, wood, metal.
PHYSICAL = {"air": {"absorption": 0.01, "freq": 2e-6},
            "wood": {"absorption": 0.05, "freq": 3e-5},
            "metal": {"absorption": 0.1, "freq": 1e-5}}
SOLVERS = ("beam", "music", "capon")
BATCH_SEED = 3
BATCH_SCENES = 32
CHUNK = 16


def tone_scenes(seed: int, num_scenes: int, fs: float, duration: float,
                mic_positions, c: float, box_lo, box_hi, freq: float,
                snr_db: float = 30.0):
    """Free-field tone scenes made with numpy alone: per scene (in order) a
    source uniform in the box and a phase uniform in [0, 2 pi); each mic
    receives sin(2 pi freq (t - d / c) + phase) / d, d its distance to the
    source, plus white noise at ``snr_db``.  Returns (signals (B, M, N)
    float32, sources (B, 3)); the first k scenes do not depend on
    ``num_scenes``."""
    rng = np.random.default_rng(seed)
    mics = np.asarray(mic_positions, float)
    t = np.arange(int(fs * duration)) / fs
    lo = np.asarray(box_lo, float)
    hi = np.asarray(box_hi, float)
    signals = np.empty((num_scenes, len(mics), t.size), np.float32)
    sources = np.empty((num_scenes, 3))
    for b in range(num_scenes):
        src = lo + (hi - lo) * rng.random(3)
        phase = 2.0 * np.pi * rng.random()
        d = np.linalg.norm(src[None] - mics, axis=-1)
        sig = np.sin(2.0 * np.pi * freq * (t[None] - d[:, None] / c)
                     + phase) / np.maximum(d, 0.1)[:, None]
        rms = np.sqrt(np.mean(sig * sig, -1, keepdims=True))
        sig = sig + rms * 10.0 ** (-snr_db / 20.0) * rng.standard_normal(
            sig.shape)
        signals[b] = sig
        sources[b] = src
    return signals, sources


def scene_configs(default_config, solver: str):
    """The demo and off-centre scenes of chip_smoke.py with ``solver``."""
    base = copy.deepcopy(default_config)
    base["localization"].update(lag_mode="physical", sync_mode="none",
                                solver=solver, visualize_correlation=False,
                                num_bootstrap=64)
    off = copy.deepcopy(base)
    off["source_position"] = [0.2, 0.6, 0.4]
    off["signal_type"] = "chirp"
    return {"default": base, "off_centre": off}


def _coarse_values(jnp, solver, sig, mics, fs, c, lo, hi, band, nfft):
    """The coarse (24^3) map of ``solver`` over [lo, hi] on one scene's
    (M, N) signals, as its locate function builds it."""
    from pyaudiolocalization_tpu.models import beamformer, capon, music, srp
    pts = srp._grid_points(jnp.asarray(lo, jnp.float32),
                           jnp.asarray(hi, jnp.float32), 24, jnp.float32)
    mics = jnp.asarray(mics, jnp.float32)
    sig = jnp.asarray(sig, jnp.float32)
    if solver == "beam":
        spectra = jnp.fft.rfft(sig, n=nfft)
        idx, w = beamformer.select_bins(spectra, fs, nfft, 12, band)
        return np.asarray(beamformer.steered_power_map(
            spectra, idx, w, pts, mics, fs, nfft, c))
    snaps = music.snapshot_frames(sig, 256)
    idx, w = beamformer.select_bins(jnp.mean(jnp.abs(snaps), axis=1), fs,
                                    256, 8, band)
    omega = music.refine_bin_freqs(snaps, idx, fs, 256, 128)
    if solver == "music":
        subs = music._noise_subspaces(snaps, idx, 1)
        return np.asarray(music.music_map(subs, omega, w, pts, mics, c))
    inv = capon._loaded_inverses(snaps, idx, 1e-3)
    return np.asarray(capon.capon_map(inv, omega, w, pts, mics, c))


def coarse_margin(vals) -> float:
    """Relative gap between a coarse map's maximum and its largest value
    more than one cell away from the maximum's cell."""
    cells = np.stack(np.meshgrid(*[np.arange(24)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    k = int(np.argmax(vals))
    far = np.max(np.abs(cells - cells[k]), -1) > 1
    return float((vals[k] - vals[far].max()) / abs(vals[k]))


def _scenes(jax, jnp):
    from pyaudiolocalization_tpu import DEFAULT_CONFIG, api, \
        localize_sound_source
    from pyaudiolocalization_tpu.models.simulator import \
        simulate_signals_fast
    from pyaudiolocalization_tpu.ops import filters
    from pyaudiolocalization_tpu.utils.config import SceneConfig
    out = {}
    for solver in SOLVERS:
        for name, cfg in scene_configs(DEFAULT_CONFIG, solver).items():
            res = localize_sound_source(cfg, show_plots=False,
                                        dtype=jnp.float32)
            scene = SceneConfig.from_dict(cfg)
            loc = scene.localization
            c = api.acoustics.speed_of_sound_host(scene.celsius,
                                                  scene.humidity)
            sigs = simulate_signals_fast(
                scene.source_position, scene.mic_positions, scene.fs, c,
                scene.duration, scene.signal_type, scene.freq,
                scene.plane_coeffs, scene.plane_material_ids,
                scene.materials.absorption, scene.materials.freq,
                loc.max_reflections, loc.absorption_threshold,
                key=api._seed_keys(scene.seed)[0], dtype=jnp.float32)
            filtered = filters.noise_reduction(sigs, scene.fs,
                                               method=loc.filter_method)
            lo, hi, _, _ = api._srp_grid_knobs(scene, loc,
                                               scene.mic_positions,
                                               scene.fs, c)
            nfft = 1 << int(np.ceil(np.log2(sigs.shape[-1])))
            vals = _coarse_values(jnp, solver, filtered, scene.mic_positions,
                                  scene.fs, c, lo, hi,
                                  api._resolve_phat_band(loc), nfft)
            out[f"{name}/{solver}"] = {
                "source_position": cfg["source_position"],
                "signal_type": cfg["signal_type"],
                "estimated_position": [float(v)
                                       for v in res["estimated_position"]],
                "tdoas": [float(v) for v in res["tdoas"]],
                "std": [float(v) for v in res["uncertainty"]["std"]],
                "coarse_margin": coarse_margin(vals)}
    return out


def per_bin_cases(default_config):
    """(name, config dict, material table entries or None) of the per-bin
    cases."""
    base = copy.deepcopy(default_config)
    base["absorption_mode"] = "per-bin"
    base["localization"].update(lag_mode="physical", sync_mode="none",
                                visualize_correlation=False,
                                num_bootstrap=64)
    off = copy.deepcopy(base)
    off["source_position"] = [0.2, 0.6, 0.4]
    off["signal_type"] = "chirp"
    return (("default", base, None), ("off_centre_physical", off, PHYSICAL))


def _per_bin(jnp):
    import warnings
    from pyaudiolocalization_tpu import DEFAULT_CONFIG, localize_sound_source
    from pyaudiolocalization_tpu.utils.config import SceneConfig
    from pyaudiolocalization_tpu.utils.materials import MaterialTable
    out = {}
    for name, cfg, table in per_bin_cases(DEFAULT_CONFIG):
        scene = (cfg if table is None else SceneConfig.from_dict(
            cfg, materials=MaterialTable.from_dict(table)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = localize_sound_source(scene, show_plots=False,
                                        dtype=jnp.float32)
        out[name] = {"source_position": cfg["source_position"],
                     "materials": table,
                     "estimated_position": [float(v) for v in
                                            res["estimated_position"]],
                     "tdoas": [float(v) for v in res["tdoas"]]}
    return out


def _stats(err):
    err = np.asarray(err).ravel()
    return {"num_errors": int(err.size), "hit_threshold_m": 0.1,
            "hit_rate": float(np.mean(err < 0.1)),
            "median_error_m": float(np.median(err)),
            "rmse_m": float(np.sqrt(np.mean(err * err)))}


def _sweep(jax, spec_args, keys: int):
    from pyaudiolocalization_tpu.parallel import SweepSpec, monte_carlo_sweep
    spec = SweepSpec(**spec_args)
    errors = [np.asarray(monte_carlo_sweep(spec, jax.random.PRNGKey(i),
                                           CHUNK).results.error).ravel()
              for i in range(keys)]
    return dict(spec=spec_args, num_scenes=keys * CHUNK,
                **_stats(np.concatenate(errors)))


def _localize_batch(jax, jnp):
    from pyaudiolocalization_tpu.parallel import SweepSpec, localize_batch
    from pyaudiolocalization_tpu.parallel import sweep
    spec = SweepSpec(**TRIO)
    signals, sources = tone_scenes(
        BATCH_SEED, BATCH_SCENES, spec.fs, spec.duration, spec.mic_positions,
        spec.speed_of_sound, spec.source_box_lo, spec.source_box_hi,
        spec.freq)
    mics = np.asarray(spec.mic_positions, np.float32)
    blo, bhi = sweep._srp_box(spec)
    out = {"seed": BATCH_SEED, "num_scenes": BATCH_SCENES, "spec": TRIO,
           "sources": sources.tolist()}
    for solver in SOLVERS:
        s = SweepSpec(**dict(TRIO, solver=solver))
        est = np.concatenate([np.asarray(localize_batch(
            s, jnp.asarray(signals[i:i + CHUNK]), jnp.asarray(mics),
            jax.random.PRNGKey(i))[0]) for i in range(0, BATCH_SCENES,
                                                     CHUNK)])
        margins = [coarse_margin(_coarse_values(
            jnp, solver, sig, mics, s.fs, s.speed_of_sound, blo, bhi,
            (s.lowcut, s.highcut), s.nfft)) for sig in signals]
        out[solver] = {"estimates": est.tolist(), "coarse_margin": margins,
                       "max_error_m": float(np.max(np.linalg.norm(
                           est - sources, axis=-1)))}
    return out


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    golden = {"source": "pyaudiolocalization_tpu (JAX %s, CPU, float32)"
                        % jax.__version__}
    steps = [("scenes", lambda: _scenes(jax, jnp)),
             ("per_bin", lambda: _per_bin(jnp)),
             ("localize_batch", lambda: _localize_batch(jax, jnp))]
    steps += [(f"trio/{s}", lambda s=s: _sweep(jax, dict(TRIO, solver=s), 8))
              for s in SOLVERS]
    steps += [(f"two_tone/{s}",
               lambda s=s: _sweep(jax, dict(TWO_TONE, solver=s), 4))
              for s in ("music", "capon")]
    steps += [("modes/lm-robust",
               lambda: _sweep(jax, dict(FULL, solver="lm-robust"), 8)),
              ("modes/de", lambda: _sweep(jax, dict(FULL, solver="de"), 8)),
              ("modes/wiener",
               lambda: _sweep(jax, dict(FULL, filter_method="wiener"), 8))]
    for name, fn in steps:
        start = time.perf_counter()
        golden[name] = fn()
        summary = {k: v for k, v in golden[name].items()
                   if not isinstance(v, (list, dict)) or len(v) <= 6}
        print(f"{name}: {time.perf_counter() - start:.1f} s  {summary}",
              flush=True)
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
