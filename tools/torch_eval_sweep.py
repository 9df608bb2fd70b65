"""EVALUATION.md's accuracy tables from the PyTorch port: the counterpart of
tools/eval_sweep.py, with the same ten sections, ``--sections`` and
``--quick``, the same ``SweepSpec`` arguments, seeds, scene counts, table
headers and columns, row for row.  Every row is followed by the JAX
package's row from ``tests/data/torch_eval_golden.json``
(``tools/torch_eval_golden.py``, the JAX package on the CPU at eval_sweep.py's
full counts), its first cell marked ``JAX:``, so a table reads as port vs
reference.

A row's seed is a ``torch.Generator`` seeded with eval_sweep.py's
integer; ``jax.random`` streams cannot be reproduced, so the port and the
golden draw different scenes of the same distribution and are compared
statistically (``hold``: the rules of chip_smoke.py's phase 13).  The
``extract`` section draws its positions from eval_sweep.py's numpy seed
(the same positions) and renders its signals with the port's
``simulate_signals_fast``; ``tracking`` renders the walkers with the
port's ``simulate_moving_source``; both seed the port's generators with
eval_sweep.py's key integers.

It imports torch, numpy and the port, never jax.  On the card (the
default) or the CPU:

    python tools/torch_eval_sweep.py [--sections snr,hard] [--quick]
    python tools/torch_eval_sweep.py --device cpu --quick

``hold`` lists the rows that break phase 13's rules (meaningful at full
counts); chip_smoke.py applies it.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

GOLDEN = REPO / "tests" / "data" / "torch_eval_golden.json"
SECTIONS = ("snr", "weighting", "hard", "multi", "beam", "extract", "music",
            "crlb", "nees", "tracking")

# tools/eval_sweep.py:35-44.
TETRA = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
CUBE8 = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
         (1.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))
ROOM6 = dict(
    plane_coeffs=((1.0, 0, 0, 0.5), (1.0, 0, 0, -5.5), (0, 1.0, 0, 0.5),
                  (0, 1.0, 0, -6.5), (0, 0, 1.0, 0.5), (0, 0, 1.0, -3.0)),
    plane_material_ids=(1, 1, 2, 2, 1, 1),
    max_reflections=2)

# section_crlb (eval_sweep.py:314-318): integration time and band.
CRLB_T, CRLB_F1, CRLB_F2 = 0.1, 300.0, 3400.0
# section_tracking (eval_sweep.py:375-380): the crossing walkers.
TRACK_FS, TRACK_C, TRACK_SEG = 16000.0, 343.0, 2048
TRACK_MICS = ((0.0, 0.0, 0.0), (3.0, 0.0, 0.0), (1.5, 3.0, 0.0),
              (1.5, 1.5, 2.0))
TRACK_BOX = ((0.0, 0.0, 0.0), (3.2, 3.2, 2.2))
WALKER_A = (np.array([0.7, 1.0, 0.6]), np.array([1.2, 0.3, 0.0]))
WALKER_B = (np.array([2.26, 1.0, 1.1]), np.array([-1.2, 0.3, 0.0]))
# chi-square(3): P(NEES < 7.814728) = 95 %, median 2.366.
NEES_95 = 7.814728

# Phase 13's holding rules (PERF.md section 2).
HIT_SIGMAS = 3.0
P90_RATIO = 1.5
P90_FLOOR, P90_ROOM = 0.02, 0.002
NEES_MEDIAN_REL = 0.15
CRLB_REL = 1e-9
SIR_DB = 1.5
TRACK_RATIO, TRACK_FLOOR = 2.0, 0.1


class Row(NamedTuple):
    """One sweep row: ``kwargs`` are eval_sweep.py's ``SweepSpec``
    arguments, ``seed`` its ``PRNGKey`` integer, ``label`` the table's
    leading cells."""
    section: str
    index: int
    label: tuple
    kwargs: dict
    seed: int
    scenes: int


def _rows(section: str, specs) -> List[Row]:
    return [Row(section, i, label, kwargs, seed, scenes)
            for i, (label, kwargs, seed, scenes) in enumerate(specs)]


def sweep_rows(section: str, scale: int = 1) -> List[Row]:
    """The rows of a sweep section at 1/``scale`` of its scenes, in
    eval_sweep.py's order (its line numbers cited)."""
    if section == "snr":                                     # :55-65
        scenes = max(256 // scale, 8)
        return _rows(section, [
            ((str(snr),), dict(fs=44100.0, duration=1.0, signal_type="noise",
                               source_box_lo=(0.1,) * 3,
                               source_box_hi=(0.9,) * 3,
                               snr_db=(float(snr), float(snr))),
             100 + i, scenes) for i, snr in enumerate([0, 5, 10, 20, 30])])
    if section == "weighting":                               # :68-89
        scenes = max(128 // scale, 8)
        return _rows(section, [
            ((str(snr), w), dict(fs=16000.0, duration=0.1,
                                 signal_type="noise",
                                 source_box_lo=(0.2,) * 3,
                                 source_box_hi=(0.8,) * 3,
                                 snr_db=(float(snr), float(snr)),
                                 gcc_weighting=w), 700 + i, scenes)
            for i, snr in enumerate([0, -5, -8, -10])
            for w in ("phat", "cc", "scot")])
    if section in ("hard", "crlb"):                          # :92-117
        scenes = max(128 // scale, 8)
        base = dict(fs=16000.0, duration=0.1, signal_type="noise",
                    source_box_lo=(0.1,) * 3, source_box_hi=(0.9,) * 3)
        if section == "crlb":                                # :308-331
            return _rows(section, [
                ((str(snr),), dict(snr_db=(float(snr), float(snr)), **base),
                 200 + i, scenes) for i, snr in enumerate([-10, -5, 0, 10])])
        cases = [
            ("−10 dB SNR", dict(snr_db=(-10.0, -10.0)), "lm"),
            ("−5 dB SNR", dict(snr_db=(-5.0, -5.0)), "lm"),
            ("0 dB SNR", dict(snr_db=(0.0, 0.0)), "lm"),
            ("10 dB + reverberant room (6 planes, order 2)",
             dict(snr_db=(10.0, 10.0), duration=0.25, **ROOM6), "lm"),
            ("10 dB + reverberant room",
             dict(snr_db=(10.0, 10.0), duration=0.25, **ROOM6), "lm-robust"),
            ("10 dB + reverberant room",
             dict(snr_db=(10.0, 10.0), duration=0.25, **ROOM6), "srp"),
            ("0 dB + reverberant room",
             dict(snr_db=(0.0, 0.0), duration=0.25, **ROOM6), "srp"),
            ("20 dB, 2 cm mic-position jitter",
             dict(snr_db=(20.0, 20.0), mic_jitter=0.02), "lm"),
        ]
        return _rows(section, [
            ((name, solver), dict(solver=solver, **{**base, **over}),
             200 + i, scenes) for i, (name, over, solver) in enumerate(cases)])
    if section == "multi":                                   # :120-131
        return _rows(section, [((), dict(
            fs=16000.0, duration=0.25, signal_type="noise",
            mic_positions=CUBE8, solver="srp", num_sources=2,
            source_min_separation=0.4, source_box_lo=(0.1,) * 3,
            source_box_hi=(0.9,) * 3, snr_db=(20.0, 40.0)), 300,
            max(128 // scale, 8))])
    narrow = max(16 // max(scale // 2, 1), 4)
    tone = dict(fs=16000.0, duration=0.25, signal_type="sine", freq=800.0,
                mic_positions=CUBE8, source_box_lo=(0.2,) * 3,
                source_box_hi=(0.8,) * 3, snr_db=(25.0, 35.0))
    if section == "beam":                                    # :134-145
        return _rows(section, [((), dict(
            fs=16000.0, duration=0.25, signal_type="sine", freq=800.0,
            mic_positions=CUBE8, solver="beam", source_box_lo=(0.2,) * 3,
            source_box_hi=(0.8,) * 3, snr_db=(25.0, 35.0)), 400, narrow)])
    if section == "music":                                   # :247-268
        two = dict(fs=16000.0, duration=0.25, signal_type="sine",
                   mic_positions=CUBE8, solver="music", num_sources=2,
                   source_freqs=(600.0, 950.0), source_min_separation=0.35,
                   source_box_lo=(0.15,) * 3, source_box_hi=(0.85,) * 3,
                   snr_db=(25.0, 35.0))
        return _rows(section, [
            ((solver,), dict(solver=solver, **tone), 400, narrow)
            for solver in ("beam", "capon", "music")] + [
            (("music, 2 tones/scene (600+950 Hz)",), two, 410, narrow)])
    if section == "nees":                                    # :340-367
        base = dict(fs=16000.0, duration=0.1, signal_type="noise",
                    mic_positions=CUBE8, source_box_lo=(0.2,) * 3,
                    source_box_hi=(0.8,) * 3)
        return _rows(section, [
            ((str(snr),), dict(snr_db=(float(snr), float(snr)), **base),
             800 + i, max(2048 // scale, 16))
            for i, snr in enumerate([10, 20, 30])])
    raise ValueError(f"{section!r} has no sweep rows")


def jsonable(value):
    """Tuples as lists, numpy scalars as Python numbers (the golden's
    form of a row's keyword arguments)."""
    if isinstance(value, dict):
        return {k: jsonable(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return [jsonable(v) for v in value]
    if isinstance(value, np.generic):
        return value.item()
    return value


def row_stats(section: str, estimate, source, error, covariance) -> dict:
    """A sweep row's statistics from its per-scene results (numpy): RMSE,
    p90, median, hits under 0.1 m over all ``n`` errors; for ``nees`` the
    median NEES, the count inside the 95 % ellipsoid and the mean sigma
    (mm), as eval_sweep.py's section_nees computes them."""
    err = np.asarray(error, float).ravel()
    out = dict(n=int(err.size), rmse=float(np.sqrt(np.mean(err ** 2))),
               p90=float(np.quantile(err, 0.9)),
               median=float(np.median(err)), hits=int(np.sum(err < 0.1)))
    if section == "nees":
        e = np.asarray(estimate, float) - np.asarray(source, float)
        cov = np.asarray(covariance, float)
        nees = np.einsum("bi,bij,bj->b", e, np.linalg.inv(cov), e)
        out.update(median_nees=float(np.median(nees)),
                   covered=int(np.sum(nees < NEES_95)),
                   mean_sigma_mm=float(np.mean(np.sqrt(
                       np.einsum("bii->bi", cov))) * 1e3))
    return out


def crlb_sources() -> np.ndarray:
    """eval_sweep.py:311-313: the 4^3 source grid the bound averages."""
    ax = np.linspace(0.15, 0.85, 4)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)


def _crlb_position_rmse(mics: np.ndarray, sources: np.ndarray, T: float,
                        f1: float, f2: float, rho: float,
                        c: float = 343.0) -> float:
    """Position-RMSE Cramer-Rao bound for TDOA localization, averaged over
    source positions (eval_sweep.py:271-305, copied).

    Per-pair delay Fisher information (Knapp & Carter 1976; flat signal and
    noise spectra over [f1, f2], per-channel SNR rho, observation time T;
    magnitude-squared coherence |g|^2 = rho^2/(1+rho)^2):

        J_tau = 2 T * Int (2 pi f)^2 |g|^2/(1-|g|^2) df
              = 2 T * rho^2/(1+2 rho) * (2 pi)^2 (f2^3 - f1^3)/3

    Pair delays from independent per-mic noises give per-mic arrival-time
    variance sigma_t^2 = 1/(2 J_tau), and the position FIM with the
    emission time as a nuisance parameter is

        J_pos = (1/(c^2 sigma_t^2)) [ Sum u u^T - (1/M)(Sum u)(Sum u)^T ]

    with u_m the unit source->mic directions (this equals the full-FIM of
    every pairwise TDOA jointly — the P > M-1 pair covariance is singular,
    the per-mic TOA form sidesteps the pseudo-inverse).  Returns
    sqrt(mean over sources of trace(J_pos^-1))."""
    j_tau = (2.0 * T * (rho ** 2 / (1.0 + 2.0 * rho))
             * (2.0 * np.pi) ** 2 * (f2 ** 3 - f1 ** 3) / 3.0)
    sigma_t2 = 1.0 / (2.0 * j_tau)
    m = mics.shape[0]
    traces = []
    for s in sources:
        u = mics - s[None, :]
        u = u / np.linalg.norm(u, axis=1, keepdims=True)
        j = u.T @ u - np.outer(u.sum(0), u.sum(0)) / m
        j = j / (c ** 2 * sigma_t2)
        traces.append(np.trace(np.linalg.inv(j)))
    return float(np.sqrt(np.mean(traces)))


def crlb_bound(snr_db: float) -> float:
    return _crlb_position_rmse(np.asarray(TETRA, float), crlb_sources(),
                               CRLB_T, CRLB_F1, CRLB_F2,
                               10.0 ** (snr_db / 10.0))


def run_row(row: Row, device) -> dict:
    """One sweep row through the port's ``monte_carlo_sweep``."""
    from pyaudiolocalization_tpu_torch.parallel import (SweepSpec,
                                                        monte_carlo_sweep)
    res = monte_carlo_sweep(SweepSpec(**row.kwargs), row.seed, row.scenes,
                            device=device).results
    out = dict(section=row.section, index=row.index, label=list(row.label),
               kwargs=jsonable(row.kwargs), seed=row.seed,
               scenes=row.scenes)
    err = res.error.cpu().numpy()
    out.update(row_stats(row.section, res.estimate.cpu().numpy(),
                         res.source.cpu().numpy(), err,
                         res.covariance.cpu().numpy()))
    out["errors"] = np.sort(err.ravel()).tolist()
    if row.section == "crlb":
        out["bound"] = crlb_bound(row.kwargs["snr_db"][0])
    return out


# ---------------------------------------------------------------------------
# extract (eval_sweep.py:148-244) and tracking (:370-419)
# ---------------------------------------------------------------------------

EXTRACT_CASES = (                                            # :199-205
    ("white noise", "noise", 500.0, 0.25, False, 0.3),
    ("chirp", "chirp", 800.0, 0.25, False, 0.3),
    ("1 kHz sine", "sine", 1000.0, 0.25, False, 0.3),
    ("white noise, 1.0 s adaptation", "noise", 500.0, 1.0, False, 0.3),
    ("REVERBERANT noise (6 planes, order 2), 1.0 s", "noise", 500.0,
     1.0, True, 0.1),
)


def extract_scenes(scale: int = 1) -> int:
    return max(8 // scale, 2)


def run_extract(scale: int, device) -> List[dict]:
    """Delay-and-sum vs MVDR / LCMV SIR on 1:1 two-talker cube mixes:
    weights adapted on the mix, applied to each component.  Positions
    from numpy seed 500 (eval_sweep.py's draws), target keys 5000 + i and
    interferer keys 6000 + i as ``torch.Generator`` seeds."""
    from pyaudiolocalization_tpu_torch.models import beamformer as bf
    from pyaudiolocalization_tpu_torch.models.simulator import \
        simulate_signals_fast
    fs, c = 16000.0, 343.0
    mics = np.asarray(CUBE8, float)
    frame, hop = 256, 64
    planes = np.array([(1.0, 0, 0, 0.3), (1.0, 0, 0, -1.3),
                       (0, 1.0, 0, 0.3), (0, 1.0, 0, -1.3),
                       (0, 0, 1.0, 0.3), (0, 0, 1.0, -1.3)])
    ids = np.array([1, 1, 2, 2, 1, 1], np.int32)

    def sim(pos, seed, sig, freq, dur, reverb=False):
        gen = torch.Generator(device=device).manual_seed(seed)
        if reverb:
            return simulate_signals_fast(
                pos, mics, fs, c, dur, sig, freq, planes, ids,
                [0.01, 0.05, 0.1], [1e-5, 5e-5, 3e-5], 2, 0.01,
                generator=gen, device=device)
        return simulate_signals_fast(pos, mics, fs, c, dur, sig, freq, None,
                                     None, [0.01], [1e-6], 0, 1e-4,
                                     generator=gen, device=device)

    def var(x):
        return float(torch.var(x, unbiased=False))

    rng = np.random.default_rng(500)
    out = []
    for name, sig, freq, dur, reverb, taps_load in EXTRACT_CASES:
        sirs_d, sirs_t, gains_t = [], {1: [], 3: []}, {1: [], 3: []}
        for i in range(extract_scenes(scale)):
            ps = rng.uniform(0.15, 0.85, 3)
            pi_ = rng.uniform(0.15, 0.85, 3)
            while np.linalg.norm(pi_ - ps) < 0.5:
                pi_ = rng.uniform(0.15, 0.85, 3)
            s_only = sim(ps, 5000 + i, "noise", 500.0, dur)
            i_only = sim(pi_, 6000 + i, sig, freq, dur, reverb)
            i_only = i_only * math.sqrt(var(s_only) / var(i_only))
            s_al = bf.align_to_position(s_only, mics, ps, fs, c,
                                        device=device)
            i_al = bf.align_to_position(i_only, mics, ps, fs, c,
                                        device=device)
            tau0 = torch.zeros(mics.shape[0], dtype=s_al.dtype,
                               device=s_al.device)
            ds = bf.extract_source(s_only, mics, ps, fs, c, device=device)
            di = bf.extract_source(i_only, mics, ps, fs, c, device=device)
            sirs_d.append(var(ds) / var(di))
            for taps in (1, 3):
                loading = 0.3 if taps == 1 else taps_load
                wr, wi = bf.mvdr_weights(bf.stack_taps(
                    bf.stft_analysis(s_al + i_al, frame, hop), taps, True),
                    tau0, fs, frame, loading, taps)

                def apply(al):
                    y = bf.apply_weights(wr, wi, bf.stack_taps(
                        bf.stft_analysis(al, frame, hop), taps, False))
                    return bf.wola_synthesis(y, frame, hop,
                                             s_only.shape[-1])

                so, io = apply(s_al), apply(i_al)
                sirs_t[taps].append(var(so) / var(io))
                gains_t[taps].append(var(so) / var(ds))
        db = lambda x: float(10.0 * np.log10(np.mean(x)))
        out.append(dict(name=name, das_db=db(sirs_d), mvdr_db=db(sirs_t[1]),
                        mvdr_gain=float(np.mean(gains_t[1])),
                        taps3_db=db(sirs_t[3]),
                        taps3_gain=float(np.mean(gains_t[3]))))
    return out


def walker_errors(pos, times):
    """Per-walker errors (S, 2) after matching tracks to walkers on the
    first segment (eval_sweep.py's ``report``), and whether the identities
    held: the track matched to each walker on the first segment is still
    the one nearest to it on the last."""
    pos = np.asarray(pos, float)
    times = np.asarray(times, float)
    truth = [s + times[:, None] * v for s, v in (WALKER_A, WALKER_B)]
    first = [int(np.argmin(np.linalg.norm(pos[0] - t[0], axis=-1)))
             for t in truth]
    last = [int(np.argmin(np.linalg.norm(pos[-1] - t[-1], axis=-1)))
            for t in truth]
    held = sorted(first) == [0, 1] and first == last
    err = np.stack([np.linalg.norm(pos[:, first[j]] - truth[j], axis=-1)
                    for j in range(2)], 1)
    return err, held


def _track_record(mode, pos, times, **extra) -> dict:
    err, held = walker_errors(pos, times)
    return dict(mode=mode, held=bool(held), mean=err.mean(0).tolist(),
                final=err[-1].tolist(), **extra)


def run_tracking(scale: int, device) -> List[dict]:
    """Crossing walkers on the port's WOLA moving render (generators 11
    and 22): ``track_multiple`` static and compensated, then the causal
    compensated ``OnlineTracker``."""
    from pyaudiolocalization_tpu_torch.models import tracking
    from pyaudiolocalization_tpu_torch.models.online import (
        OnlineTracker, StreamingLocalizer)
    from pyaudiolocalization_tpu_torch.models.simulator import \
        simulate_moving_source
    fs, c, seg = TRACK_FS, TRACK_C, TRACK_SEG
    mics = np.asarray(TRACK_MICS)
    n_seg = 12 if scale == 1 else 8
    dur = n_seg * seg / fs
    mix = sum(simulate_moving_source(
        start, vel, mics, fs, c, dur, "noise",
        generator=torch.Generator(device=device).manual_seed(seed),
        device=device) for (start, vel), seed in ((WALKER_A, 11),
                                                  (WALKER_B, 22)))
    lower, upper = (np.asarray(b) for b in TRACK_BOX)
    out = []
    for motion in ("static", "compensated"):
        mt = tracking.track_multiple(
            mix, mics, fs, c, lower, upper, num_sources=2, segment=seg,
            hop=seg, coarse_n=32, fine_n=12, max_speed=3.0, motion=motion,
            device=device)
        out.append(_track_record(motion, mt.positions.cpu().numpy(),
                                 mt.times.cpu().numpy()))
    loc = StreamingLocalizer(mics, fs, c, lower, upper, frame=2048,
                             hop=1024, ema=0.4, num_sources=2, coarse_n=32,
                             fine_n=12, motion="compensated", max_speed=3.0,
                             device=device)
    trk = OnlineTracker(loc, max_speed=3.0)
    capture = mix.cpu().numpy()
    pos, _, ok = trk.run(capture)
    times = (np.arange(trk.warmup - 1, capture.shape[-1] // 1024)
             * 1024 / fs)[:pos.shape[0]]
    out.append(_track_record("causal compensated (OnlineTracker)", pos,
                             times, associated=float(np.mean(ok))))
    return out


# ---------------------------------------------------------------------------
# Running, printing, holding
# ---------------------------------------------------------------------------

def run_sections(sections, scale: int = 1,
                 device="cuda") -> Dict[str, list]:
    """{'rows': sweep rows, 'extract': cases, 'tracking': modes} of the
    named sections on ``device``."""
    out = {"rows": [], "extract": [], "tracking": [], "scale": scale}
    for name in sections:
        if name == "extract":
            out["extract"] = run_extract(scale, device)
            out["extract_scenes"] = extract_scenes(scale)
        elif name == "tracking":
            out["tracking"] = run_tracking(scale, device)
        else:
            out["rows"] += [run_row(r, device) for r in sweep_rows(name, scale)]
    return out


def _pct(hits, n):
    return f"{hits / n:.0%}"


def _golden_row(golden, row):
    for g in golden.get("rows", ()):
        if g["section"] == row["section"] and g["index"] == row["index"]:
            return g
    return None


def _table(title, header, lines):
    print(f"\n## {title}\n")
    print(header)
    print("|" + "---|" * (header.count("|") - 1))
    for line in lines:
        print(line)


def _cells(section, r, first):
    """A row's cells after its label, in eval_sweep.py's formats."""
    hit = _pct(r["hits"], r["n"])
    if section == "snr":
        return [first, f"{r['rmse']:.4f}", f"{r['p90']:.4f}", hit]
    if section == "hard":
        return [first, r["label"][1], f"{r['rmse']:.4g}", f"{r['p90']:.4g}",
                hit]
    if section in ("multi", "beam"):
        return [first + f"{r['rmse']:.4f}", f"{r['p90']:.4f}", hit]
    if section == "music":
        return [first, f"{r['rmse']:.4f}", f"{r['p90']:.4f}", hit]
    if section == "crlb":
        rho = 10.0 ** (r["kwargs"]["snr_db"][0] / 10.0)
        d = math.sqrt(2 * CRLB_T * (CRLB_F2 - CRLB_F1)) * rho / (1.0 + rho)
        return [first, f"{r['rmse']:.4g}", f"{r['bound']:.4g}",
                f"{r['rmse'] / r['bound']:.1f}x", f"{d:.1f}"]
    if section == "nees":
        return [first, f"{r['median_nees']:.2f}",
                f"{r['covered'] / r['n']:.1%}", f"{r['mean_sigma_mm']:.2f}",
                f"{r['rmse']:.4f}"]
    raise ValueError(section)


def _line(cells):
    return "| " + " | ".join(cells) + " |"


def print_tables(results: dict, golden: dict, note: str = "") -> None:
    """eval_sweep.py's markdown tables, each port row followed by the
    golden's (first cell marked ``JAX:``)."""
    rows = results["rows"]
    by = {}
    for r in rows:
        by.setdefault(r["section"], []).append(r)
    for section in SECTIONS:
        if section == "extract" and results.get("extract"):
            _print_extract(results, golden, note)
            continue
        if section == "tracking" and results.get("tracking"):
            _print_tracking(results, golden, note)
            continue
        if section not in by:
            continue
        rs = by[section]
        scenes = rs[0]["scenes"]
        if section == "weighting":
            _print_weighting(rs, golden, scenes, note)
            continue
        title, header = _TITLES[section]
        lines = []
        for r in rs:
            g = _golden_row(golden, r)
            label = r["label"][0] if r["label"] else ""
            lines.append(_line(_cells(section, r, label)))
            if g is not None:
                g = dict(g, label=r["label"])
                lines.append(_line(_cells(section, g, f"JAX: {label}".strip()
                                          + ("" if label else " "))))
        _table(title.format(scenes=scenes) + note, header, lines)


_TITLES = {
    "snr": ("SNR sweep — 44.1 kHz × 1 s, {scenes} scenes each",
            "| SNR (dB) | RMSE (m) | p90 (m) | hit@10 cm |"),
    "hard": ("Hard regimes — 16 kHz × 0.1 s, {scenes} scenes each",
             "| Scenario | solver | RMSE (m) | p90 (m) | hit@10 cm |"),
    "multi": ("Multi-source — 2 talkers, 8-mic cube, {scenes} scenes",
              "| per-source RMSE (m) | p90 (m) | hit@10 cm |"),
    "beam": ("Beamformer envelope — 800 Hz pure tone, solver='beam', "
             "{scenes} scenes", "| RMSE (m) | p90 (m) | hit@10 cm |"),
    "music": ("Narrowband trio — 800 Hz pure tone, same {scenes} scenes "
              "(seed 400)", "| solver | RMSE (m) | p90 (m) | hit@10 cm |"),
    "crlb": ("Low-SNR envelope vs the TDOA CRLB — 16 kHz x 0.1 s, "
             "4-mic tetra, {scenes} scenes each",
             "| SNR (dB) | measured RMSE (m) | CRLB RMSE (m) | ratio | "
             "deflection D |"),
    "nees": ("Uncertainty calibration — NEES over {scenes} "
             "simulate→localize scenes per row, 8-mic cube",
             "| SNR (dB) | median NEES (ideal 2.37) | 95%-ellipsoid coverage "
             "(ideal 95%) | mean sigma (mm) | RMSE (m) |"),
}


def _print_weighting(rs, golden, scenes, note):
    lines = []
    for i in range(0, len(rs), 3):
        trio = rs[i:i + 3]
        snr = trio[0]["label"][0]
        for who, src in (("", trio),
                         ("JAX: ", [_golden_row(golden, r) for r in trio])):
            if any(r is None for r in src):
                continue
            lines.append(_line([who + snr] + [
                f"{r['rmse']:.4f} / {_pct(r['hits'], r['n'])}"
                for r in src]))
    _table(f"GCC weighting at low SNR — 16 kHz × 0.1 s, free field, "
           f"{scenes} scenes each" + note,
           "| SNR (dB) | PHAT rmse / hit | CC rmse / hit | SCOT rmse / hit |",
           lines)


def _print_extract(results, golden, note):
    lines = []
    gold = {g["name"]: g for g in golden.get("extract", ())}
    for r in results["extract"]:
        for who, x in (("", r), ("JAX: ", gold.get(r["name"]))):
            if x is None:
                continue
            lines.append(_line([who + r["name"], f"{x['das_db']:.1f}",
                                f"{x['mvdr_db']:.1f}",
                                f"{x['mvdr_gain']:.2f}",
                                f"{x['taps3_db']:.1f}",
                                f"{x['taps3_gain']:.2f}"]))
    _table(f"Beamformed extraction — 1:1 two-talker 8-mic cube mixes, "
           f"{results['extract_scenes']} scenes each (seed 500)" + note,
           "| interferer | das SIR (dB) | MVDR SIR (dB) | MVDR target gain "
           "| taps=3 SIR | taps=3 gain |", lines)


def _print_tracking(results, golden, note):
    lines = []
    gold = {g["mode"]: g for g in golden.get("tracking", ())}
    for r in results["tracking"]:
        for who, x in (("", r), ("JAX: ", gold.get(r["mode"]))):
            if x is None:
                continue
            name = x["mode"]
            if "associated" in x:
                name = name.replace(
                    "(OnlineTracker)",
                    f"(OnlineTracker, ok {x['associated']:.0%})")
            lines.append(_line([who + name, f"{x['mean'][0]:.3f}",
                                f"{x['mean'][1]:.3f}", f"{x['final'][0]:.3f}",
                                f"{x['final'][1]:.3f}"]))
    n_seg = 12 if results["scale"] == 1 else 8
    _table(f"Crossing walkers, full WOLA moving render — 1.2 m/s, {n_seg} x "
           f"128 ms segments, 4-mic tetra (seed 11/22)" + note,
           "| mode | mean err A (m) | mean err B (m) | final err A | "
           "final err B |", lines)


def hits_agree(h1: int, n1: int, h2: int, n2: int,
               sigmas: float = HIT_SIGMAS) -> bool:
    """Two hit counts agree within ``sigmas`` pooled binomial standard
    deviations: sigma^2 = p(1 - p)(1/n1 + 1/n2), p the pooled rate clipped
    to [1/n, 1 - 1/n] (n the smaller count), so that 100 % against 100 %
    still allows a miss."""
    n = min(n1, n2)
    p = min(max((h1 + h2) / (n1 + n2), 1.0 / n), 1.0 - 1.0 / n)
    sigma = math.sqrt(p * (1.0 - p) * (1.0 / n1 + 1.0 / n2))
    return abs(h1 / n1 - h2 / n2) <= sigmas * sigma


def p90_agree(port: float, gold: float, port_errors=None,
              gold_n: int = 0) -> bool:
    """p90 within ``P90_RATIO`` either way, or within ``P90_ROOM`` where
    both lie under ``P90_FLOOR``; else, given the port's errors and the
    golden's count, the port's share of errors at or under the golden's
    p90 is 90 % by ``hits_agree`` (where a row's hit rate is near 90 % its
    p90 sits on the edge of the outliers, and a ratio of two samples' p90
    says nothing)."""
    if port < P90_FLOOR and gold < P90_FLOOR:
        if abs(port - gold) <= P90_ROOM:
            return True
    elif gold / P90_RATIO <= port <= gold * P90_RATIO:
        return True
    if port_errors is None or not gold_n:
        return False
    below = int(np.sum(np.asarray(port_errors) <= gold))
    return hits_agree(below, len(port_errors), round(0.9 * gold_n), gold_n)


def nees_agree(port: dict, gold: dict) -> bool:
    """The 95 % ellipsoid's coverage by ``hits_agree`` and the median NEES
    within ``NEES_MEDIAN_REL``."""
    return (hits_agree(port["covered"], port["n"], gold["covered"],
                       gold["n"])
            and abs(port["median_nees"] - gold["median_nees"])
            <= NEES_MEDIAN_REL * gold["median_nees"])


def crlb_agree(port: float, gold: float) -> bool:
    return abs(port - gold) <= CRLB_REL * abs(gold)


def sir_agree(port_db: float, gold_db: float) -> bool:
    return abs(port_db - gold_db) <= SIR_DB


def track_agree(port: dict, gold: dict) -> bool:
    """Identities held wherever the golden's hold (segment-static
    detection swaps the crossing walkers in the JAX package too), and each
    walker's mean error within ``TRACK_RATIO`` of the golden's or under
    ``TRACK_FLOOR`` m."""
    return (port["held"] or not gold["held"]) and all(
        p <= TRACK_RATIO * g or p < TRACK_FLOOR
        for p, g in zip(port["mean"], gold["mean"]))


def hold(results: dict, golden: dict) -> List[str]:
    """Every broken rule, one line each (empty when all hold): each sweep
    row's spec and seed equal the golden's, its hit count (``hits_agree``)
    and p90 (``p90_agree``); ``nees`` rows ``nees_agree``; ``crlb`` rows
    ``crlb_agree``; every extraction SIR ``sir_agree``; every tracking
    mode ``track_agree``."""
    bad = []
    for r in results["rows"]:
        g = _golden_row(golden, r)
        label = " ".join(r.get("label", ()))
        tag = f"{r['section']}[{r['index']}] {label}".strip()
        if g is None:
            bad.append(f"{tag}: no golden row")
            continue
        if r["kwargs"] != g["kwargs"] or r["seed"] != g["seed"]:
            bad.append(f"{tag}: spec or seed differs from the golden's")
        if not hits_agree(r["hits"], r["n"], g["hits"], g["n"]):
            bad.append(f"{tag}: hits {r['hits']}/{r['n']} vs golden "
                       f"{g['hits']}/{g['n']}")
        if not p90_agree(r["p90"], g["p90"], r.get("errors"), g["n"]):
            bad.append(f"{tag}: p90 {r['p90']:.4g} vs golden {g['p90']:.4g}")
        if r["section"] == "nees" and not nees_agree(r, g):
            bad.append(f"{tag}: NEES median {r['median_nees']:.3f} covered "
                       f"{r['covered']}/{r['n']} vs golden "
                       f"{g['median_nees']:.3f} {g['covered']}/{g['n']}")
        if r["section"] == "crlb" and not crlb_agree(r["bound"], g["bound"]):
            bad.append(f"{tag}: bound {r['bound']!r} vs {g['bound']!r}")
    gold = {g["name"]: g for g in golden.get("extract", ())}
    for r in results.get("extract", ()):
        g = gold.get(r["name"])
        if g is None:
            bad.append(f"extract {r['name']}: no golden row")
            continue
        for key in ("das_db", "mvdr_db", "taps3_db"):
            if not sir_agree(r[key], g[key]):
                bad.append(f"extract {r['name']}: {key} {r[key]:.2f} vs "
                           f"golden {g[key]:.1f}")
    gold = {g["mode"]: g for g in golden.get("tracking", ())}
    for r in results.get("tracking", ()):
        g = gold.get(r["mode"])
        if g is None:
            bad.append(f"tracking {r['mode']}: no golden row")
        elif not track_agree(r, g):
            bad.append(f"tracking {r['mode']}: held {r['held']}, means "
                       f"{np.round(r['mean'], 4).tolist()} vs golden "
                       f"{np.round(g['mean'], 4).tolist()}")
    return bad


def card_note() -> str:
    """' — <name>, <power limit>' from nvidia-smi, or '' off the card."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return f" — {smi.stdout.strip().splitlines()[0]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    scale = 8 if args.quick else 1
    sections = [s.strip() for s in args.sections.split(",")]
    for name in sections:
        if name not in SECTIONS:
            raise SystemExit(f"unknown section {name!r}; one of {SECTIONS}")
    device = torch.device(args.device)
    note = card_note() if device.type == "cuda" else ""
    print(f"device: {torch.cuda.get_device_name(device) if note else device}"
          f"{note}")
    golden = json.loads(GOLDEN.read_text()) if GOLDEN.exists() else {}
    print_tables(run_sections(sections, scale, device), golden, note)
    return 0


if __name__ == "__main__":
    sys.exit(main())
