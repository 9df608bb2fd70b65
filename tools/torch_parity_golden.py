"""Write tests/data/torch_parity_golden.json: the JAX package's answers for
the full-size scenes that ``chip_smoke.py``'s parity phase runs through the
PyTorch port on the card, with the calibration data both are given.

* ``calibration_data`` — ``run_calibration(DEFAULT_CONFIG)`` of the JAX
  package (float64).  With the default materials the recordings hold no
  signal (SURVEY.md Q2), so these delays are noise artifacts that no other
  generator reproduces; the port is handed these.
* ``cases`` — ``localize_sound_source(config, calibration_data=...)`` on
  ``DEFAULT_CONFIG`` (44.1 kHz x 1 s, 4 mics, 3 reflection orders,
  Butterworth, 1000 permutation draws a pair):
  - ``parity``: ``lag_mode='reference'`` (parity mode: the reference's
    exact-length simulation, pre-sync, exact 2n - 1 transform, positional
    lag axis with plateau peaks, calibration applied verbatim).  Its
    source is equidistant from the four mics, so after the sync the four
    signals are one and every pair's peak is a near-tie of rounding noise;
  - ``parity_off_centre``: the same with the source at (0.2, 0.6, 0.4),
    whose pairs' peaks are clear, so the TDOAs and the position can be
    held;
  - ``demo``: the config as it is, which is what ``python -m
    pyaudiolocalization_tpu`` runs: ``LocalizationConfig``'s default
    ``lag_mode='physical'`` with the reference pre-sync, and the
    calibration behind physical mode's SNR gate.

  Each case in float64 and float32: the sync shifts before rounding and
  the left pads they give, the TDOAs, each pair's peak margin (the chosen
  in-window peak over the runner-up, relative to the chosen; a near-tie
  can flip between float64 and float32) and neighbour gap (the chosen
  sample over the larger adjacent one: a gap below float32's resolution
  lets the argmax move one sample; the file written before this field
  lacks it), the position, cost and
  ``uncertainty['heuristic']`` (true where the DE fallback ran), and per
  pair ``significant``, the peak and the bootstrap threshold (recomputed
  with the run's own keys).

No signals are stored.  Runs on the CPU in a few minutes, in a temporary
working directory (parity mode saves ``localization_result.png``):

    JAX_PLATFORMS=cpu python tools/torch_parity_golden.py
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from pyaudiolocalization_tpu import DEFAULT_CONFIG, api  # noqa: E402
from pyaudiolocalization_tpu import run_calibration  # noqa: E402
from pyaudiolocalization_tpu.models import sync as sync_ops  # noqa: E402
from pyaudiolocalization_tpu.models import tdoa as tdoa_ops  # noqa: E402
from pyaudiolocalization_tpu.ops import filters, peaks  # noqa: E402
from pyaudiolocalization_tpu.utils.config import SceneConfig  # noqa: E402

OUT = REPO / "tests" / "data" / "torch_parity_golden.json"


def case_configs():
    demo = copy.deepcopy(DEFAULT_CONFIG)
    demo["localization"]["visualize_correlation"] = False
    parity = copy.deepcopy(demo)
    parity["localization"]["lag_mode"] = "reference"
    off = copy.deepcopy(parity)
    off["source_position"] = [0.2, 0.6, 0.4]
    return {"parity": parity, "parity_off_centre": off, "demo": demo}


def peak_margins(corr: np.ndarray, lag_mode: str, n: int, fs: float,
                 max_delay: float) -> list:
    """Per row: (tallest in-window local maximum - the runner-up) / |the
    tallest|, on the mode's lag axis with the mode's local maxima (the
    ladder's candidates: the tallest in-window candidate above the
    threshold is the one chosen)."""
    nfft = corr.shape[-1]
    if lag_mode == "physical":
        shift = n - 1 if nfft >= 2 * n - 1 else nfft // 2
        corr = np.roll(corr, shift, -1)
        lags = np.arange(nfft) - shift
    else:
        lags = np.arange(nfft) - (n - 1)
    lm = np.asarray(peaks.local_maxima(jnp.asarray(corr),
                                       plateaus=lag_mode != "physical"))
    inwin = np.abs(lags / fs) <= max_delay
    out = []
    for row, mask in zip(corr, lm & inwin):
        h = np.sort(row[mask])[::-1]
        out.append(float((h[0] - h[1]) / abs(h[0])) if len(h) > 1 else 1.0)
    return out


def neighbour_gaps(corr: np.ndarray, lag_mode: str, n: int, fs: float,
                   measured: np.ndarray) -> list:
    """Per row: (the chosen lag's sample - the larger of its two adjacent
    samples) / |the chosen|.  Where this is below float32's resolution of
    the correlation, another precision's argmax may move one sample even
    though the peak is clear of every other local maximum."""
    nfft = corr.shape[-1]
    if lag_mode == "physical":
        shift = n - 1 if nfft >= 2 * n - 1 else nfft // 2
        corr = np.roll(corr, shift, -1)
        lags = np.arange(nfft) - shift
    else:
        lags = np.arange(nfft) - (n - 1)
    out = []
    for row, lag in zip(corr, np.asarray(measured) * fs):
        k = int(np.argmin(np.abs(lags - lag)))
        side = max(row[k - 1], row[(k + 1) % nfft])
        out.append(float((row[k] - side) / abs(row[k])))
    return out


def run_case(cfg, calibration, dtype):
    """One localize_sound_source call with its stages recorded."""
    seen = {}
    core_fn, sync_fn = api._estimation_core, api.synchronize_signals

    def core(*args, **kw):
        out = core_fn(*args, **kw)
        seen.update(signals=args[0], corr=np.asarray(out["corr"]), kw=kw,
                    key=args[4], measured=np.asarray(out["measured_delays"]))
        return out

    def sync(signals, fs, *args):
        stacked = jnp.stack([jnp.pad(s, (0, max(x.shape[-1] for x in signals)
                                         - s.shape[-1])) for s in signals])
        seen["shifts"] = np.asarray(sync_ops._sync_shifts(stacked, fs, True))
        return sync_fn(signals, fs, *args)

    api._estimation_core, api.synchronize_signals = core, sync
    try:
        start = time.perf_counter()
        res = api.localize_sound_source(cfg, calibration_data=calibration,
                                        show_plots=False, dtype=dtype)
        seconds = time.perf_counter() - start
    finally:
        api._estimation_core, api.synchronize_signals = core_fn, sync_fn
    scene = SceneConfig.from_dict(cfg)
    loc = scene.localization
    kw = seen["kw"]
    pi, pj = np.array(kw["pairs_i"]), np.array(kw["pairs_j"])
    signals = seen["signals"]
    n = signals.shape[-1]
    # The bootstrap thresholds, with the keys the core split for them.
    k_metrics, _ = jax.random.split(seen["key"])
    filtered = filters.noise_reduction(signals, scene.fs,
                                       method=loc.filter_method)
    thresholds = np.asarray(jax.vmap(
        lambda s1, s2, k: tdoa_ops.bootstrap_significance(
            s1, s2, k, num_bootstrap=loc.num_bootstrap, nfft=kw["nfft"],
            bootstrap_mode=loc.bootstrap_mode))(
        jnp.take(filtered, pi, 0), jnp.take(filtered, pj, 0),
        jax.random.split(k_metrics, len(pi))))
    # A run without the pre-sync (sync_mode='none') shifts nothing.
    shifts = seen.get("shifts", np.zeros(len(scene.mic_positions)))
    pairs = sorted(res["correlation_metrics"])
    return {
        "seconds": seconds,
        "nfft": int(kw["nfft"]),
        "samples": int(n),
        "sync_shifts": [float(v) for v in shifts],
        "sync_pads": [max(0, int(round(float(s) - float(shifts.min()))))
                      for s in shifts],
        "tdoas": [float(v) for v in res["tdoas"]],
        "margins": peak_margins(seen["corr"], loc.lag_mode, n, scene.fs,
                                loc.max_expected_delay),
        "neighbour_gaps": neighbour_gaps(seen["corr"], loc.lag_mode, n,
                                         scene.fs, seen["measured"]),
        "estimated_position": [float(v) for v in res["estimated_position"]],
        "cost": float(res["cost"]),
        "heuristic": bool(res["uncertainty"]["heuristic"]),
        "pairs": [list(p) for p in pairs],
        "significant": [bool(res["correlation_metrics"][p]["significant"])
                        for p in pairs],
        "peak": [float(v) for v in seen["corr"].max(-1)],
        "threshold": [float(v) for v in thresholds],
    }


def main() -> int:
    os.chdir(tempfile.mkdtemp(prefix="torch_parity_golden_"))
    calibration, _, _ = run_calibration(DEFAULT_CONFIG)
    golden = {"source": "pyaudiolocalization_tpu (JAX %s, CPU)"
                        % jax.__version__,
              "calibration_data": calibration, "cases": {}}
    for name, cfg in case_configs().items():
        golden["cases"][name] = {
            "lag_mode": cfg["localization"].get("lag_mode", "physical"),
            "source_position": cfg["source_position"]}
        for tag, dtype in (("float64", jnp.float64),
                           ("float32", jnp.float32)):
            out = run_case(cfg, calibration, dtype)
            golden["cases"][name][tag] = out
            print(f"{name} {tag}: {out['seconds']:.1f} s, tdoas "
                  f"{out['tdoas']}, margins {out['margins']}, position "
                  f"{out['estimated_position']}, heuristic "
                  f"{out['heuristic']}", flush=True)
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
