"""Write tests/data/torch_sweep_golden.json: the JAX package's answers for
the windowed fast path and the batched sweep, which ``chip_smoke.py`` holds
the PyTorch port to on the card.

* ``fast_path`` — ``DEFAULT_CONFIG`` in physical mode with
  ``analyze_correlation=False``: the JAX package's windowed fast core
  (``api._estimation_core_fast``, its Pallas kernel in interpret mode on
  the CPU, float32);
* ``localize_batch`` — ``localize_batch`` on the first 64 scenes of
  ``batch_scenes(seed=1, ...)`` at ``bench.py``'s ``bench_localize`` spec
  (4 mics, 44.1 kHz x 1 s, noise, sources in [0.1, 0.9]^3); on the CPU the
  JAX package takes its full-correlation ladder, which agrees with the
  window;
* ``sweep`` — ``monte_carlo_sweep`` statistics over 128 scenes (8 keys x 16)
  at ``bench_full_sweep``'s spec (the same, SNR 20-40 dB).

``batch_scenes`` is numpy only and importable without jax: ``chip_smoke``
rebuilds the same scenes from the same seed on a machine that has no jax.
Runs on the CPU in chunks of 16 scenes (memory stays near a gigabyte), in
about ten minutes:

    JAX_PLATFORMS=cpu python tools/torch_sweep_golden.py
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
OUT = REPO / "tests" / "data" / "torch_sweep_golden.json"
MICS = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
# bench.py's sweep specs, as SweepSpec keyword arguments.
SPEC_ARGS = dict(fs=44100.0, duration=1.0, signal_type="noise",
                 source_box_lo=(0.1, 0.1, 0.1), source_box_hi=(0.9, 0.9, 0.9),
                 snr_db=(20.0, 40.0))
BATCH_SEED = 1
BATCH_SCENES = 64
SWEEP_KEYS = 8
SWEEP_CHUNK = 16
CHUNK = 16


def batch_scenes(seed: int, num_scenes: int, fs: float, duration: float,
                 mic_positions, c: float, box_lo, box_hi,
                 snr_db: float = 30.0):
    """Free-field scenes made with numpy alone: per scene (in order) a
    source uniform in the box, a white-noise base, each mic's copy delayed
    by its exact propagation time (a frequency-domain fractional delay at
    the next power of two that holds the delays) and white noise at
    ``snr_db``.  Returns (signals (B, M, N) float32, sources (B, 3)); the
    first k scenes do not depend on ``num_scenes``."""
    rng = np.random.default_rng(seed)
    mics = np.asarray(mic_positions, float)
    n = int(fs * duration)
    lo = np.asarray(box_lo, float)
    hi = np.asarray(box_hi, float)
    reach = np.linalg.norm(np.maximum(np.abs(hi), np.abs(lo))) + np.max(
        np.linalg.norm(mics, axis=-1))
    nfft = 1 << int(np.ceil(np.log2(n + reach / c * fs + 2)))
    k = np.arange(nfft // 2 + 1)
    signals = np.empty((num_scenes, len(mics), n), np.float32)
    sources = np.empty((num_scenes, 3))
    for b in range(num_scenes):
        src = lo + (hi - lo) * rng.random(3)
        base = rng.standard_normal(n)
        delays = np.linalg.norm(src[None] - mics, axis=-1) / c * fs
        spec = np.fft.rfft(base, nfft)
        sig = np.fft.irfft(spec[None] * np.exp(
            -2j * np.pi * k[None] * delays[:, None] / nfft), nfft)[:, :n]
        rms = np.sqrt(np.mean(sig * sig, -1, keepdims=True))
        sig = sig + rms * 10.0 ** (-snr_db / 20.0) * rng.standard_normal(
            sig.shape)
        signals[b] = sig
        sources[b] = src
    return signals, sources


def speed_of_sound(temperature: float = 20.0, humidity: float = 50.0):
    """SweepSpec.speed_of_sound at its defaults."""
    return 331.0 + 0.6 * temperature + 0.0124 * humidity


def _fast_path(jax, jnp):
    from pyaudiolocalization_tpu import DEFAULT_CONFIG, api
    from pyaudiolocalization_tpu import localize_sound_source
    from pyaudiolocalization_tpu.utils.config import SceneConfig
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               analyze_correlation=False,
                               visualize_correlation=False)
    scene = SceneConfig.from_dict(cfg)
    api._FAST_INTERPRET = True
    try:
        if not api._fast_path_eligible(scene.localization, 65536,
                                       scene.num_mics, jnp.float32,
                                       scene.fs):
            raise SystemExit("the fast-path scene does not dispatch the "
                             "fast core")
        res = localize_sound_source(cfg, show_plots=False,
                                    dtype=jnp.float32)
    finally:
        api._FAST_INTERPRET = False
    return {"config": "DEFAULT_CONFIG, lag_mode='physical', "
                      "sync_mode='none', analyze_correlation=False",
            "source_position": cfg["source_position"],
            "estimated_position": [float(v)
                                   for v in res["estimated_position"]],
            "tdoas": [float(v) for v in res["tdoas"]]}


def _localize_batch(jax, jnp, spec):
    from pyaudiolocalization_tpu.parallel import localize_batch
    signals, sources = batch_scenes(
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
    return {"seed": BATCH_SEED, "num_scenes": BATCH_SCENES,
            "sources": sources.tolist(),
            "estimates": est.tolist(),
            "tdoas": np.concatenate(tds).tolist(),
            "max_error_m": float(np.max(np.linalg.norm(est - sources,
                                                       axis=-1)))}


def _sweep(jax, spec):
    from pyaudiolocalization_tpu.parallel import monte_carlo_sweep
    errors = []
    for i in range(SWEEP_KEYS):
        s = monte_carlo_sweep(spec, jax.random.PRNGKey(i), SWEEP_CHUNK)
        errors.append(np.asarray(s.results.error))
    err = np.concatenate(errors)
    return {"num_scenes": int(err.size), "hit_threshold_m": 0.1,
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
    spec = SweepSpec(**SPEC_ARGS)
    if spec.speed_of_sound != speed_of_sound():
        raise SystemExit("speed_of_sound drifted from SweepSpec's")
    golden = {"source": "pyaudiolocalization_tpu (JAX %s, CPU, float32)"
                        % jax.__version__, "spec": SPEC_ARGS}
    for name, fn in (("fast_path", lambda: _fast_path(jax, jnp)),
                     ("localize_batch",
                      lambda: _localize_batch(jax, jnp, spec)),
                     ("sweep", lambda: _sweep(jax, spec))):
        start = time.perf_counter()
        golden[name] = fn()
        summary = {k: v for k, v in golden[name].items()
                   if not isinstance(v, list) or len(v) <= 6}
        print(f"{name}: {time.perf_counter() - start:.1f} s  {summary}",
              flush=True)
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
