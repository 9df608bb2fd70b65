"""Write tests/data/torch_eval_golden.json: the JAX package's answers on
every row of tools/eval_sweep.py's ten sections (EVALUATION.md's accuracy
tables), which ``tools/torch_eval_sweep.py`` prints beside the port's and
``chip_smoke.py`` (phase 13, ``evaluation_fuzz_phase``) holds the port to
on the card.

It runs eval_sweep.py's own section functions, unchanged, with its
``SweepSpec`` and ``monte_carlo_sweep`` names wrapped to record what each
row passes (the keyword arguments, the ``PRNGKey`` seed, the scene count,
and the eval_sweep.py line of the call), so every spec, seed and count is
eval_sweep.py's by construction.  For each sweep row it records the RMSE,
the p90, the median error and the count of errors under 0.1 m over all
``n`` errors (scenes x sources); for ``nees`` the median NEES, the count
inside the 95 % ellipsoid and the mean sigma; for ``crlb`` the bound
(eval_sweep.py's ``_crlb_position_rmse`` at that section's constants).
``extract`` rows are read from the section's printed table (SIRs to 0.1
dB, gains to 0.01); ``tracking`` records each mode's positions through
wrapped ``track_multiple`` and ``OnlineTracker.run`` and derives the
per-walker mean and final errors and whether the identities held (the
track matched to a walker on the first segment is still nearest to it on
the last).

Runs on the CPU (full counts; ``--quick`` for eval_sweep.py's 1/8):

    JAX_PLATFORMS=cpu python tools/torch_eval_golden.py
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_eval_golden.json"
EVAL_SWEEP = REPO / "tools" / "eval_sweep.py"
# The port's tool: its statistics, walker errors and CRLB source grid are
# applied to the JAX package's results here, so both sides share them.
PORT_TOOL = REPO / "tools" / "torch_eval_sweep.py"


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _caller(module_file: str):
    """(section name, line) of the innermost eval_sweep.py section frame."""
    frame = sys._getframe(1)
    while frame is not None:
        if (frame.f_code.co_filename == module_file
                and frame.f_code.co_name.startswith("section_")):
            return frame.f_code.co_name[len("section_"):], frame.f_lineno
        frame = frame.f_back
    raise RuntimeError("not called from an eval_sweep.py section")


def _parse_extract(text: str):
    rows = []
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) != 6 or cells[0] in ("interferer", "---"):
            continue
        try:
            nums = [float(c) for c in cells[1:]]
        except ValueError:
            continue
        rows.append(dict(name=cells[0], das_db=nums[0], mvdr_db=nums[1],
                         mvdr_gain=nums[2], taps3_db=nums[3],
                         taps3_gain=nums[4]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default="snr,weighting,hard,multi,beam,"
                                          "extract,music,crlb,nees,tracking")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=str(GOLDEN))
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pyaudiolocalization_tpu.models import online, tracking

    ev = _load("eval_sweep", EVAL_SWEEP)
    port = _load("torch_eval_sweep", PORT_TOOL)
    scale = 8 if args.quick else 1
    module_file = ev.__file__
    kwargs_of = {}
    rows = []
    tracks = []
    real_spec, real_sweep = ev.SweepSpec, ev.monte_carlo_sweep

    def spec_factory(**kwargs):
        spec = real_spec(**kwargs)
        kwargs_of[id(spec)] = dict(kwargs)
        return spec

    def sweep(spec, key, scenes, *rest, **kw):
        summary = real_sweep(spec, key, scenes, *rest, **kw)
        section, line = _caller(module_file)
        seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1])
        res = summary.results
        row = dict(section=section,
                   index=sum(r["section"] == section for r in rows),
                   line=line, kwargs=port.jsonable(kwargs_of[id(spec)]),
                   seed=seed, scenes=int(scenes))
        row.update(port.row_stats(section, np.asarray(res.estimate),
                                  np.asarray(res.source),
                                  np.asarray(res.error),
                                  np.asarray(res.covariance)))
        if section == "crlb":
            row["bound"] = ev._crlb_position_rmse(
                np.asarray(ev.TETRA, float), port.crlb_sources(),
                port.CRLB_T, port.CRLB_F1, port.CRLB_F2,
                10.0 ** (row["kwargs"]["snr_db"][0] / 10.0))
        rows.append(row)
        return summary

    real_track, real_run = tracking.track_multiple, online.OnlineTracker.run

    def track_multiple(*a, **kw):
        mt = real_track(*a, **kw)
        _, line = _caller(module_file)
        tracks.append(dict(mode=kw["motion"], line=line,
                           positions=np.asarray(mt.positions).tolist(),
                           times=np.asarray(mt.times).tolist()))
        return mt

    def tracker_run(self, signals):
        pos, pw, ok = real_run(self, signals)
        _, line = _caller(module_file)
        hop = self.loc.hop
        times = (np.arange(self.warmup - 1, signals.shape[-1] // hop) * hop
                 / self.loc.fs)[:pos.shape[0]]
        tracks.append(dict(mode="causal compensated (OnlineTracker)",
                           line=line, positions=np.asarray(pos).tolist(),
                           times=times.tolist(),
                           associated=float(np.mean(ok))))
        return pos, pw, ok

    ev.SweepSpec, ev.monte_carlo_sweep = spec_factory, sweep
    tracking.track_multiple = track_multiple
    online.OnlineTracker.run = tracker_run
    golden = dict(scale=scale, rows=rows, extract=[], tracking=[],
                  seconds={})
    t0 = time.time()
    try:
        for name in args.sections.split(","):
            name = name.strip()
            start = time.time()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                ev.SECTIONS[name](scale)
            sys.stdout.write(buf.getvalue())
            if name == "extract":
                golden["extract"] = _parse_extract(buf.getvalue())
                golden["extract_scenes"] = max(8 // scale, 2)
            golden["seconds"][name] = round(time.time() - start, 1)
            print(f"[{name}: {golden['seconds'][name]} s]", flush=True)
    finally:
        ev.SweepSpec, ev.monte_carlo_sweep = real_spec, real_sweep
        tracking.track_multiple = real_track
        online.OnlineTracker.run = real_run
    for t in tracks:
        err, held = port.walker_errors(t["positions"], t["times"])
        golden["tracking"].append(dict(
            mode=t["mode"], line=t["line"], held=bool(held),
            mean=err.mean(0).tolist(), final=err[-1].tolist(),
            **({"associated": t["associated"]} if "associated" in t
               else {})))
    golden["seconds"]["total"] = round(time.time() - t0, 1)
    Path(args.out).write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {args.out} in {golden['seconds']['total']} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
