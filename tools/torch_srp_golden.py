"""Write tests/data/torch_srp_golden.json: the JAX package's answers for
the SRP-PHAT solvers and the multi-source sweep, which ``chip_smoke.py``
(phase 6) and ``tests/test_torch_sweep_srp.py`` hold the PyTorch port to.

* ``scenes`` — ``localize_sound_source`` in physical mode with
  ``solver='srp'`` and ``'srp+lm'`` on the demo scene (``DEFAULT_CONFIG``)
  and the off-centre chirp scene (source [0.2, 0.6, 0.4]), float32.  The
  bootstrap null runs 64 draws here: it decides ``significant`` only, not
  the TDOAs or the fix, which are what the golden holds;
* ``localize_batch`` — ``localize_batch`` with ``solver='srp'`` on the 32
  scenes of ``torch_sweep_golden.batch_scenes(seed=2, ...)`` (4 mics,
  16 kHz x 0.25 s, sources in [0.2, 0.8]^3), float32, with each scene's
  coarse SRP margin: the relative gap between the pooled coarse map's
  maximum and its largest value more than one cell away.  Max-pooled maps
  tie exactly over neighbouring cells (every pair reads a pooled plateau),
  and another summation order breaks such a tie another way; a tie between
  adjacent cells moves the fine lattice by whole fine steps and leaves the
  answer, a tie farther apart may move it;
* ``reverberant`` / ``reverberant_lm`` — ``monte_carlo_sweep``
  statistics over 128 scenes (8 keys x 16) at ``bench.py``'s
  ``bench_reverberant_sweep`` spec (six planes at order 2, 37 paths a mic,
  ``solver='srp'``), and the same spec with ``solver='srp+lm'``;
* ``multi_spatial`` / ``multi_claim`` — the same over 64 scenes (4 keys x
  16) at ``bench_multi_source``'s spec (8-mic cube, 2 sources), with
  spatial and claim suppression; the statistics run over every source of
  every scene.

Runs on the CPU in a few minutes:

    JAX_PLATFORMS=cpu python tools/torch_srp_golden.py
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "torch_srp_golden.json"
MICS8 = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
         (1.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))
# bench.py's specs, as SweepSpec keyword arguments.
REVERBERANT = dict(fs=16000.0, duration=0.25, signal_type="noise",
                   source_box_lo=(0.2, 0.2, 0.2),
                   source_box_hi=(0.8, 0.8, 0.8), snr_db=(10.0, 25.0),
                   solver="srp",
                   plane_coeffs=((1.0, 0, 0, 0.5), (1.0, 0, 0, -5.5),
                                 (0, 1.0, 0, 0.5), (0, 1.0, 0, -6.5),
                                 (0, 0, 1.0, 0.5), (0, 0, 1.0, -3.0)),
                   plane_material_ids=(1, 1, 2, 2, 1, 1), max_reflections=2)
MULTI = dict(fs=16000.0, duration=0.25, signal_type="noise",
             mic_positions=MICS8, solver="srp", num_sources=2,
             source_min_separation=0.4, source_box_lo=(0.1, 0.1, 0.1),
             source_box_hi=(0.9, 0.9, 0.9), snr_db=(20.0, 40.0))
BATCH = dict(fs=16000.0, duration=0.25, signal_type="noise",
             source_box_lo=(0.2, 0.2, 0.2), source_box_hi=(0.8, 0.8, 0.8),
             solver="srp")
BATCH_SEED = 2
BATCH_SCENES = 32
CHUNK = 16


def _sweep_builder():
    spec = importlib.util.spec_from_file_location(
        "torch_sweep_golden", REPO / "tools" / "torch_sweep_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scene_configs(default_config, solver: str):
    """The demo and off-centre scenes of chip_smoke.py with ``solver``."""
    base = copy.deepcopy(default_config)
    base["localization"].update(lag_mode="physical", sync_mode="none",
                                solver=solver, visualize_correlation=False)
    off = copy.deepcopy(base)
    off["source_position"] = [0.2, 0.6, 0.4]
    off["signal_type"] = "chirp"
    return {"default": base, "off_centre": off}


def _scenes(jnp):
    from pyaudiolocalization_tpu import DEFAULT_CONFIG, localize_sound_source
    out = {}
    for solver in ("srp", "srp+lm"):
        for name, cfg in scene_configs(DEFAULT_CONFIG, solver).items():
            cfg["localization"]["num_bootstrap"] = 64
            res = localize_sound_source(cfg, show_plots=False,
                                        dtype=jnp.float32)
            out[f"{name}/{solver}"] = {
                "source_position": cfg["source_position"],
                "signal_type": cfg["signal_type"],
                "estimated_position": [float(v)
                                       for v in res["estimated_position"]],
                "tdoas": [float(v) for v in res["tdoas"]],
                "heuristic": bool(res["uncertainty"]["heuristic"])}
    return out


def coarse_margins(jnp, spec, signals):
    """Per scene, the relative gap between the maximum of the pooled
    coarse SRP map (as the sweep's SRP search builds it) and its largest
    value more than one cell away from the maximum's cell."""
    from pyaudiolocalization_tpu.models import srp
    from pyaudiolocalization_tpu.ops import gccphat
    from pyaudiolocalization_tpu.parallel import sweep
    pi, pj = (np.asarray(p, np.int32) for p in spec.pairs)
    blo, bhi = sweep._srp_box(spec)
    pool = srp._resolve_pool(None, blo, bhi, 24, spec.fs,
                             spec.speed_of_sound)
    ml = int(np.ceil(spec.max_tdoa * spec.fs)) + 2
    pts = srp._grid_points(jnp.asarray(blo, jnp.float32),
                           jnp.asarray(bhi, jnp.float32), 24, jnp.float32)
    mics = jnp.asarray(spec.mic_positions, jnp.float32)
    cells = np.stack(np.meshgrid(*[np.arange(24)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    out = []
    for sig in signals:
        corr = gccphat.gcc_phat_all_pairs(
            jnp.asarray(sig), pi, pj, nfft=spec.nfft,
            band=(spec.lowcut, spec.highcut), fs=spec.fs)
        vals = np.asarray(srp.srp_map(srp._pooled_window(corr, ml, pool),
                                      pts, mics, pi, pj, spec.fs,
                                      spec.speed_of_sound, max_lag=ml,
                                      pre_windowed=True))
        k = int(np.argmax(vals))
        far = np.max(np.abs(cells - cells[k]), -1) > 1
        out.append(float((vals[k] - vals[far].max()) / abs(vals[k])))
    return out


def _localize_batch(jax, jnp, spec):
    from pyaudiolocalization_tpu.parallel import localize_batch
    signals, sources = _sweep_builder().batch_scenes(
        BATCH_SEED, BATCH_SCENES, spec.fs, spec.duration,
        spec.mic_positions, spec.speed_of_sound, spec.source_box_lo,
        spec.source_box_hi)
    mics = jnp.asarray(spec.mic_positions, jnp.float32)
    est, tds = [], []
    for i in range(0, BATCH_SCENES, CHUNK):
        e, _, td = localize_batch(spec, jnp.asarray(signals[i:i + CHUNK]),
                                  mics, jax.random.PRNGKey(i))
        est.append(np.asarray(e))
        tds.append(np.asarray(td))
    est = np.concatenate(est)
    return {"seed": BATCH_SEED, "num_scenes": BATCH_SCENES, "spec": BATCH,
            "sources": sources.tolist(), "estimates": est.tolist(),
            "tdoas": np.concatenate(tds).tolist(),
            "coarse_margin": coarse_margins(jnp, spec, signals),
            "max_error_m": float(np.max(np.linalg.norm(est - sources,
                                                       axis=-1)))}


def _sweep(jax, spec_args, keys: int):
    from pyaudiolocalization_tpu.parallel import SweepSpec, monte_carlo_sweep
    spec = SweepSpec(**spec_args)
    errors = [np.asarray(monte_carlo_sweep(spec, jax.random.PRNGKey(i),
                                           CHUNK).results.error).ravel()
              for i in range(keys)]
    err = np.concatenate(errors)
    return {"spec": spec_args, "num_scenes": keys * CHUNK,
            "num_errors": int(err.size), "hit_threshold_m": 0.1,
            "hit_rate": float(np.mean(err < 0.1)),
            "median_error_m": float(np.median(err)),
            "rmse_m": float(np.sqrt(np.mean(err * err)))}


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    from pyaudiolocalization_tpu.parallel import SweepSpec
    golden = {"source": "pyaudiolocalization_tpu (JAX %s, CPU, float32)"
                        % jax.__version__}
    for name, fn in (
            ("scenes", lambda: _scenes(jnp)),
            ("localize_batch",
             lambda: _localize_batch(jax, jnp, SweepSpec(**BATCH))),
            ("reverberant", lambda: _sweep(jax, REVERBERANT, 8)),
            ("reverberant_lm",
             lambda: _sweep(jax, dict(REVERBERANT, solver="srp+lm"), 8)),
            ("multi_spatial",
             lambda: _sweep(jax, dict(MULTI, suppression="spatial"), 4)),
            ("multi_claim",
             lambda: _sweep(jax, dict(MULTI, suppression="claim"), 4))):
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
