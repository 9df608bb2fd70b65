"""tools/torch_eval_sweep.py, the port's counterpart of tools/eval_sweep.py,
against its golden (tests/data/torch_eval_golden.json, written by
tools/torch_eval_golden.py from the JAX package on the CPU): every sweep
row's spec, seed and scene count equal the golden's, the numpy copy of the
CRLB equals the golden's bounds, the holding rules of chip_smoke.py's phase
13 pass and fail where they should, and two rows run end to end on the CPU
at 8 scenes and print eval_sweep.py's tables."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((REPO / "tests" / "data" /
                     "torch_eval_golden.json").read_text())


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ev = _load("torch_eval_sweep")


def _ids(row):
    return f"{row['section']}-{row['index']}"


@pytest.mark.parametrize("gold", GOLDEN["rows"], ids=_ids)
def test_row_specs_equal_the_goldens(gold):
    """The port's row has eval_sweep.py's keyword arguments, PRNGKey seed
    and full scene count, as the golden tool recorded them from
    eval_sweep.py's own calls."""
    row = ev.sweep_rows(gold["section"], 1)[gold["index"]]
    assert ev.jsonable(row.kwargs) == gold["kwargs"]
    assert row.seed == gold["seed"]
    assert row.scenes == gold["scenes"]


def test_golden_covers_every_section_at_full_counts():
    """Every sweep row of the tool is in the golden, and the golden holds
    the extraction cases and the three tracking modes."""
    got = {(s, r.index) for s in ev.SECTIONS
           if s not in ("extract", "tracking")
           for r in ev.sweep_rows(s, 1)}
    assert got == {(g["section"], g["index"]) for g in GOLDEN["rows"]}
    assert GOLDEN["scale"] == 1
    assert [g["name"] for g in GOLDEN["extract"]] == [
        c[0] for c in ev.EXTRACT_CASES]
    assert GOLDEN["extract_scenes"] == ev.extract_scenes(1)
    assert [g["mode"] for g in GOLDEN["tracking"]] == [
        "static", "compensated", "causal compensated (OnlineTracker)"]


@pytest.mark.parametrize("gold", [g for g in GOLDEN["rows"]
                                  if g["section"] == "crlb"], ids=_ids)
def test_crlb_copy_equals_the_goldens_bound(gold):
    """The numpy copy of eval_sweep.py's ``_crlb_position_rmse`` at the
    section's constants gives the bound eval_sweep.py's own function
    gave the golden."""
    got = ev.crlb_bound(gold["kwargs"]["snr_db"][0])
    assert got == pytest.approx(gold["bound"], rel=1e-12)


@pytest.mark.parametrize("h1,n1,h2,n2,ok", [
    (128, 128, 128, 128, True),       # 100 % against 100 %
    (127, 128, 128, 128, True),       # one miss
    (128, 128, 115, 128, False),      # 10 points off near the top
    (16, 32, 120, 256, True),         # different counts, same rate
    (0, 128, 0, 128, True),
    (1, 128, 13, 128, False),         # 10 points off near the bottom
    (1754, 2048, 1945, 2048, False),  # NEES coverage 86 % against 95 %
])
def test_hit_rule(h1, n1, h2, n2, ok):
    assert ev.hits_agree(h1, n1, h2, n2) is ok


@pytest.mark.parametrize("port,gold,ok", [
    (0.04, 0.03, True), (0.06, 0.03, False), (0.015, 0.03, False),
    (0.0049, 0.004, True), (0.008, 0.004, False), (0.019, 0.021, True),
    (1.5, 1.0, True), (2.0, 1.0, False)])
def test_p90_rule(port, gold, ok):
    """Within 1.5x either way, or within 2 mm where both are under 2 cm:
    2x off fails."""
    assert ev.p90_agree(port, gold) is ok


def test_p90_rule_by_quantile():
    """Given the port's errors, a p90 outside the ratio still agrees when
    90 % of them lie at or under the golden's p90 (a p90 on the edge of
    the outliers); errors twice the golden's do not."""
    good = np.linspace(0.001, 0.02, 116)
    port = np.concatenate([good, np.full(12, 3.0)])    # 9.4 % outliers
    p90 = float(np.quantile(port, 0.9))
    assert not ev.p90_agree(p90, 0.3)                  # 0.0199 against 0.3
    assert ev.p90_agree(p90, 0.3, port, 128)
    gold = np.linspace(0.001, 0.02, 128)
    doubled = 2.0 * gold
    assert not ev.p90_agree(float(np.quantile(doubled, 0.9)),
                            float(np.quantile(gold, 0.9)), doubled, 128)


def _nees(median, covered, n=2048):
    return dict(median_nees=median, covered=covered, n=n)


@pytest.mark.parametrize("port,gold,ok", [
    (_nees(2.2, 1950), _nees(2.37, 1946), True),
    (_nees(2.0, 1638), _nees(2.37, 1946), False),   # 80 % against 95 %
    (_nees(2.0, 1950), _nees(2.37, 1946), False),   # median 16 % off
    (_nees(2.1, 205, 256), _nees(2.2, 1754), True)])
def test_nees_rule(port, gold, ok):
    assert ev.nees_agree(port, gold) is ok


def test_crlb_sir_and_tracking_rules():
    assert ev.crlb_agree(0.01 * (1 + 5e-10), 0.01)
    assert not ev.crlb_agree(0.01 * (1 + 5e-9), 0.01)
    assert ev.sir_agree(14.0, 15.4) and not ev.sir_agree(14.0, 15.6)
    gold = dict(held=True, mean=[0.03, 0.02])
    assert ev.track_agree(dict(held=True, mean=[0.05, 0.09]), gold)
    assert ev.track_agree(dict(held=True, mean=[0.15, 0.02]),
                          dict(held=True, mean=[0.1, 0.02]))
    assert not ev.track_agree(dict(held=True, mean=[0.15, 0.02]), gold)
    assert not ev.track_agree(dict(held=False, mean=[0.01, 0.01]), gold)
    # Where the golden's identities swap (segment-static detection), the
    # port's may too.
    assert ev.track_agree(dict(held=False, mean=[0.3, 0.5]),
                          dict(held=False, mean=[0.52, 0.36]))


def test_hold_reads_every_rule():
    """The golden held against itself breaks nothing; a changed seed, a
    hit count, a p90, a NEES median, a bound, a SIR and a track each
    break one rule."""
    results = {k: GOLDEN[k] for k in ("rows", "extract", "tracking")}
    assert ev.hold(results, GOLDEN) == []
    rows = [dict(r) for r in GOLDEN["rows"]]
    by = {(r["section"], r["index"]): r for r in rows}
    by["snr", 0]["seed"] += 1
    by["snr", 1]["hits"] -= 20
    by["hard", 2]["p90"] *= 2.0
    by["nees", 0]["median_nees"] *= 1.3
    by["crlb", 3]["bound"] *= 1.001
    extract = [dict(GOLDEN["extract"][0], mvdr_db=0.0)]
    tracking = [dict(GOLDEN["tracking"][1], held=False)]
    bad = ev.hold(dict(rows=rows, extract=extract, tracking=tracking),
                  GOLDEN)
    assert len(bad) == 7, bad
    for tag in ("snr[0]", "snr[1]", "hard[2]", "nees[0]", "crlb[3]",
                "extract white noise", "tracking compensated"):
        assert any(line.startswith(tag) for line in bad), (tag, bad)


def _headers(text):
    return [line for line in text.splitlines() if line.startswith("| ")
            and "---" not in line and ("(m)" in line or "SIR" in line
                                       or "rmse / hit" in line
                                       or "NEES" in line)]


def test_snr_and_hard_rows_run_on_the_cpu():
    """The snr section's 0 dB row and the hard regimes' 0 dB row at 8
    scenes through the port on the CPU: every scene hit, and tables with
    eval_sweep.py's headers, each row followed by the golden's."""
    rows = [ev.sweep_rows("snr")[0], ev.sweep_rows("hard")[2]]
    out = dict(rows=[ev.run_row(r._replace(scenes=8), "cpu") for r in rows],
               scale=1)
    assert [(r["section"], r["n"], r["hits"]) for r in out["rows"]] == [
        ("snr", 8, 8), ("hard", 8, 8)]
    assert all(r["p90"] < 0.05 for r in out["rows"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev.print_tables(out, GOLDEN)
    text = buf.getvalue()
    source = (REPO / "tools" / "eval_sweep.py").read_text()
    want = re.findall(r'print\("(\| (?:SNR \(dB\) \| RMSE|Scenario)[^"]*)"\)',
                      source)
    assert len(want) == 2 and _headers(text) == want
    assert "| 0 | " in text and "| JAX: 0 | " in text
    assert "| 0 dB SNR | lm | " in text and "| JAX: 0 dB SNR | lm | " in text
