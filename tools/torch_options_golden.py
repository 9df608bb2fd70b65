"""Write tests/data/torch_options_golden.json: the JAX package's answers for
the physical-mode option cases that ``chip_smoke.py`` runs through the
PyTorch port on the card (its options path, cases 2-4).

* ``weighted`` — the off-centre chirp scene (1→5 kHz at (0.2, 0.6, 0.4))
  with SCOT weighting, the 'median' ladder, the FIR front end, DBSCAN
  initial guesses, the robust LM and ``analyze_correlation=False``;
* ``no_gate`` — the demo scene (1 kHz sine at the array centre) with
  ``max_expected_delay=None`` (the alias-free 131,072-point transform),
  the 'adaptive' ladder, the Wiener front end, and four calibration
  entries (SNR 30, above the gate) whose delays move the fix to
  ``CALIBRATION_TARGET``: a mic delayed by d_m shifts every TDOA it enters,
  and d_m = (|centre - mic_m| - |target - mic_m|) / c makes the corrected
  TDOAs those of the target;
* ``single_pair`` — ``models.tdoa.get_time_delays_phat(mic0, mic1, fs,
  lag_mode='physical')`` on the rendered signals of the demo and the
  off-centre scenes, at the exact length and at nfft 65,536.

Full width (4 mics, 44.1 kHz × 1 s), DEFAULT_CONFIG otherwise, JAX on the
CPU in float32 (its default precision), a few minutes in all:

    JAX_PLATFORMS=cpu python tools/torch_options_golden.py
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from pyaudiolocalization_tpu import DEFAULT_CONFIG, localize_sound_source  # noqa: E402
from pyaudiolocalization_tpu.models import acoustics, tdoa  # noqa: E402
from pyaudiolocalization_tpu.models.simulator import simulate_signals_fast  # noqa: E402
from pyaudiolocalization_tpu.utils.config import SceneConfig  # noqa: E402

OUT = REPO / "tests" / "data" / "torch_options_golden.json"
CALIBRATION_TARGET = (0.3, 0.6, 0.45)
CALIBRATION_SNR = 30.0


def _physical(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               visualize_correlation=False)
    return cfg


def demo_config():
    return _physical(DEFAULT_CONFIG)


def off_centre_config():
    cfg = demo_config()
    cfg["source_position"] = [0.2, 0.6, 0.4]
    cfg["signal_type"] = "chirp"
    return cfg


def weighted_config():
    cfg = off_centre_config()
    cfg["localization"].update(gcc_weighting="scot", threshold_method="median",
                               filter_method="fir", clustering_method="dbscan",
                               solver="lm-robust", analyze_correlation=False)
    return cfg


def no_gate_config():
    cfg = demo_config()
    cfg["localization"].update(max_expected_delay=None,
                               threshold_method="adaptive",
                               filter_method="wiener")
    return cfg


def calibration_data(cfg, target=CALIBRATION_TARGET, snr=CALIBRATION_SNR):
    """Per-mic delays that move the demo scene's fix to ``target``."""
    mics = np.asarray(cfg["mic_positions"], float)
    c = acoustics.speed_of_sound_host(cfg["celsius"], cfg["humidity"])
    centre = np.asarray(cfg["source_position"], float)
    d = (np.linalg.norm(centre - mics, axis=1)
         - np.linalg.norm(np.asarray(target) - mics, axis=1)) / c
    return [{"delay": float(v), "snr": snr} for v in d]


def rendered(cfg):
    """The scene's mic signals as the physical path renders them."""
    scene = SceneConfig.from_dict(cfg)
    loc = scene.localization
    c = acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    return np.asarray(simulate_signals_fast(
        scene.source_position, scene.mic_positions, scene.fs, c,
        scene.duration, scene.signal_type, scene.freq, scene.plane_coeffs,
        scene.plane_material_ids, scene.materials.absorption,
        scene.materials.freq, loc.max_reflections, loc.absorption_threshold,
        key=jax.random.PRNGKey(0), absorption_mode=scene.absorption_mode))


def _answer(cfg, res):
    return {"config": cfg,
            "estimated_position": [float(v)
                                   for v in res["estimated_position"]],
            "tdoas": [float(v) for v in res["tdoas"]]}


def main() -> int:
    golden = {"source": "pyaudiolocalization_tpu (JAX %s, CPU, float32)"
                        % jax.__version__, "cases": {}}
    start = time.perf_counter()
    cfg = weighted_config()
    golden["cases"]["weighted"] = _answer(
        cfg, localize_sound_source(cfg, show_plots=False))
    cfg = no_gate_config()
    calib = calibration_data(cfg)
    golden["cases"]["no_gate"] = dict(
        _answer(cfg, localize_sound_source(cfg, calibration_data=calib,
                                           show_plots=False)),
        calibration_data=calib, calibration_target=list(CALIBRATION_TARGET))
    single = {}
    for name, scene in (("default", demo_config()),
                        ("off_centre", off_centre_config())):
        sigs = rendered(scene)
        single[name] = {"config": scene, "delays": {
            f"nfft_{nfft or 'exact'}": float(tdoa.get_time_delays_phat(
                sigs[0], sigs[1], scene["fs"], lag_mode="physical",
                nfft=nfft).delays[0])
            for nfft in (None, 65536)}}
    golden["cases"]["single_pair"] = single
    print(f"{time.perf_counter() - start:.1f} s", json.dumps(golden["cases"]),
          flush=True)
    if not any(abs(v) > 0 for v in single["off_centre"]["delays"].values()):
        raise SystemExit("off_centre single pair is degenerate (delay 0)")
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
