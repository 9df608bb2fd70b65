"""``python -m pyaudiolocalization_tpu_torch`` — the command-line demo of
the PyTorch port (counterpart of ``python -m pyaudiolocalization_tpu``; the
reference's ``__main__`` block, main.py:335-347).

With no flags it runs the default demo in parity mode: the chirp
calibration, its per-mic delays and amplitudes and their averages in the
log, then the localization of the default simulated scene with the
calibration delays applied.  The JAX package's flags keep their meanings:

  --no-calibration   skip the calibration
  --physical         the physically correct lag and sync modes instead of
                     the reference's (parity mode)
  --no-plots         save figures instead of showing them
  --seed N           the scene's seed
  --solver NAME      physical-mode estimator (lm / lm-robust / srp /
                     srp+lm / beam / music / capon); implies --physical
  --device DEV       torch device; the default is ``cuda``, and without a
                     card the demo runs on the CPU only with ``--device
                     cpu``
"""

from __future__ import annotations

import argparse
import copy
import logging

import numpy as np
import torch

from . import localize_sound_source, run_calibration
from .utils.config import DEFAULT_CONFIG
from .utils.device import resolve_device

logger = logging.getLogger("pyaudiolocalization_tpu_torch")


def _device(requested):
    try:
        return resolve_device(requested)
    except RuntimeError as err:
        raise SystemExit(f"{err} (--device cpu on the command line)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pyaudiolocalization_tpu_torch",
        description="Sound-source localization demo (PyTorch / CUDA port)")
    parser.add_argument("--no-calibration", action="store_true")
    parser.add_argument("--physical", action="store_true")
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--solver", default=None,
        choices=("lm", "lm-robust", "srp", "srp+lm", "beam", "music",
                 "capon"),
        help="physical-mode estimator (implies --physical)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda when available)")
    args = parser.parse_args(argv)

    device = _device(args.device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    config = copy.deepcopy(DEFAULT_CONFIG)
    config["seed"] = args.seed
    if args.physical or args.solver:
        config["localization"]["lag_mode"] = "physical"
        config["localization"]["sync_mode"] = "none"
    if args.solver:
        config["localization"]["solver"] = args.solver

    calibration_data = None
    if not args.no_calibration:
        # main.py:338-344: run the calibration, log each mic's result and
        # the averages.
        calibration_data, _sig, _rec = run_calibration(
            config, dtype=torch.float32, device=device)
        for i, res in enumerate(calibration_data):
            logger.info("Microphone %d: delay = %.6f s, amplitude = %.2f",
                        i + 1, res["delay"], res["amplitude"])
        avg_delay = float(np.mean([r["delay"] for r in calibration_data]))
        avg_amp = float(np.mean([r["amplitude"] for r in calibration_data]))
        logger.info("Average delay: %.6f s", avg_delay)
        logger.info("Average amplitude: %.2f", avg_amp)

    result = localize_sound_source(
        config, calibration_data=calibration_data, use_simulation=True,
        show_plots=not args.no_plots, device=device, dtype=torch.float32)
    est = result["estimated_position"]
    act = result["actual_position"]
    logger.info("Estimated position: %s", np.round(est, 4).tolist())
    if act is not None:
        err = float(np.linalg.norm(np.asarray(est) - np.asarray(act)))
        logger.info("Actual position: %s, error: %.4f m",
                    np.asarray(act).tolist(), err)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
