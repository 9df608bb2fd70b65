"""``python -m pyaudiolocalization_tpu_torch`` — the command-line demo of
the PyTorch port (counterpart of ``python -m pyaudiolocalization_tpu``).

Takes the same flags as the JAX package's demo.  This slice runs only the
physical-mode path without calibration, so it requires
``--physical --no-calibration --no-plots``:

    python -m pyaudiolocalization_tpu_torch --physical --no-calibration --no-plots

It runs on ``cuda`` when a card is present; without one it runs on the CPU
only when ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import logging

import numpy as np
import torch

from . import localize_sound_source
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

    physical = args.physical or args.solver is not None
    if not (physical and args.no_calibration and args.no_plots):
        raise SystemExit(
            "this port runs only the physical-mode path without calibration "
            "or plots so far: pass --physical --no-calibration --no-plots")
    if args.solver in ("beam", "music", "capon"):
        raise SystemExit(f"--solver {args.solver} is not ported yet; 'lm', "
                         "'lm-robust', 'srp' and 'srp+lm' run")
    device = _device(args.device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    config = copy.deepcopy(DEFAULT_CONFIG)
    config["seed"] = args.seed
    config["localization"]["lag_mode"] = "physical"
    config["localization"]["sync_mode"] = "none"
    if args.solver:
        config["localization"]["solver"] = args.solver

    result = localize_sound_source(config, use_simulation=True,
                                   show_plots=False, device=device,
                                   dtype=torch.float32)
    est = result["estimated_position"]
    act = result["actual_position"]
    logger.info("Estimated position: %s", np.round(est, 4).tolist())
    err = float(np.linalg.norm(np.asarray(est) - np.asarray(act)))
    logger.info("Actual position: %s, error: %.4f m",
                np.asarray(act).tolist(), err)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
