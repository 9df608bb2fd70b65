"""A/B bench of the port's FFT schedules on the card: the row DFT on the
tensor cores (K10a) against butterfly stages on chip (K10b), and the
shared FFT's production transform K4a against ``torch.fft.rfft``.

The counterpart of ``tools/mxu_rowdft_bench.py``'s ``bench``/``main``
(:499-577), at its shapes (n2, B) = (64, 4096), (128, 2048), (256, 1024),
(512, 1024), (1024, 512): (B, n2, 128) float32 planes, N = n2 * 128.  For
each shape, CUDA-event times (ms per call over the whole batch) of

- the row DFT by stages (one launch per transform, all log2(n2) stages
  in shared memory) and by the tensor cores at rep 1 and 8, and the
  compute-only estimate (rep8 - rep1) / 7 (the plane's read and write
  drop out where a transform streams it once);
- the lane DFT (K10c);
- the full forward of real rows by both schedules (``fft_four_step``),
  and with ``zero_top`` (the lower n2/2 rows only);
- the GCC-like chain by both schedules (n2 >= 512, as the TPU tool), fed
  four planes of their own;
- the plain twins of the row and lane DFTs (``row_dft_plain``,
  ``lane_dft_plain``);
- yardsticks: ``torch.fft.fft`` along the row and the lane axis of the
  complex plane, ``torch.fft.fft`` of the flat real row, the port's
  production K4a (``cuda_fft.fft_real``) at the same N, and
  ``torch.fft.rfft`` of the same real rows (K4a's function).

Every kernel case's first (warm-up) call is held against its plain twin on
the same inputs, within ``rowdft.TRANSFORM_TOL`` of max|twin| (the chain
within ``rowdft.CHAIN_TOL``, K4a within ``K4A_TOL``); a miss raises.
``k4a`` times K4a against ``torch.fft.rfft`` at the production paths'
shapes (``K4A_SHAPES``).  ``boot`` (``--boot``, alone) times K4b at the
permutation null's shapes (``BOOT_SHAPES``) and K7 against ``torch.sgn``
at one scene's spectrum, by CUDA events and in device time with the
device kernels a call runs, and the host time of each step of a wrapper's
launch path over 10,000 calls (``host_steps``).  ``k6`` (``--k6``) times
K6 at the noise null's shapes (``K6_SHAPES``) and ``scene``
(``--scene``) K5, K3 and K2 at the sweep's, the api's, an odd mic count's,
the reverberant render's and, up to 4,096 points, the trio sweep's, the
multi-source cube's, the moving render's, the short sweep's and the scene
chunks' shapes (``SCENE_SHAPES``), each case held against its twin, by
CUDA events beside the twin's time and in device time by kernel, with its
bound.  ``gcc`` (``--gcc``) times K1 at the api's, no_gate's,
``bench_gcc_phat``'s, the reverberant sweep's, the multi-source cube's,
an odd edge's, K2's one-block shapes and the GCC's spectra routes'
shapes (``GCC_SHAPES``) and K9 at the single pair's lengths and an edge
(``CORR_SHAPES``), each held against its twin, by CUDA events and in
device time by kernel, beside the twin's times (cuFFT).  ``--long``
times only K4a, K4b, K6, K1 and K9 at their shapes above 2^20 (two rows
of a 23.7 s pair at 2^21 and one row at 2^22, 2^23 and 2^24 against
``torch.fft.rfft``; the pair's null at 64 and 1,000 draws, one row at
2^22 and three at 2^23 and 2^24, K6 also at 1,000 draws at 2^23 and 300
at 2^24, each K4b or K6 case from ``HEAVY_POINTS`` timed one call a loop
and logged as not fitting where the card runs out of memory; K1 at the
23.7 s recording's 4 and 8 mics at 2^21 and 4 mics at 2^22, K9 at one
pair of each); ``--gcc --long`` times only K1 (``ROUTE_GCC``) and K2,
K3 and K5 (``ROUTE_SCENES``) at the shapes where the GCC goes through
the mic rows' spectra, and K3 at the shapes of its render through the
base rows' spectra (``--scene --long``: those of K2, K3 and K5 alone,
then chip_smoke.py's simulated 20 s and 60 s scenes on the fast path,
``long_scenes``, K3 at 2^20 and 2^22: their wall time cold and warm and
their device time by kernel); ``--recording`` runs chip_smoke.py's 4 x 24 s
recording (phase 10, ``long_recording``) from this tree at 2^21 and 2^22,
its 4 x 60 s recording at 2^23 (``recording23``) and its recordings of
the spectra routes (``spectra_recordings``, 2^20 to 2^22): their wall
time cold and warm and their device time by kernel.  ``--trace`` (alone)
counts the ``device_ms`` traces that miss a kernel, with and without
their idle edges (``trace_check``).  ``k10``
(``--k10``, alone) times K10a (``row_dft``), K10b (``row_stages``) and
K10c (``lane_dft``) at ``SHAPES``, with the full forward by both
schedules and the chain (n2 >= 512), each held against its twin, beside
``torch.fft.fft`` along the rows (dim 1), the lanes (dim 2) and of the
flat row, by CUDA events and in device time by kernel with the device
kernels a call runs, and prints the compiler's registers, stack frames
and spills of the K10 kernels (``nvcc -Xptxas -v``).

It imports numpy and torch only.  Run from the repository root on the
machine with the card:

    python tools/torch_rowdft_bench.py [--reps 5] [--k4a | --boot | --k6 |
                                        --scene | --gcc | --k10 | --long |
                                        --recording | --trace]

``chip_smoke.py`` runs it once as its phase 7 (``run``).  To A/B two
versions of the package in one call, run this file from a copy of each
tree in turns (it imports the package of the tree it lies in).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf  # noqa: E402
from pyaudiolocalization_tpu_torch.ops import rowdft as rd  # noqa: E402

SHAPES = ((64, 4096), (128, 2048), (256, 1024), (512, 1024), (1024, 512))
CHAIN_MIN_N2 = 512
# K4a against its twin, relative to max|twin| (the card tests' limit), and
# the production paths' shapes (rows, len, nfft): the bootstrap's and the
# api's single row, the single pair, max_expected_delay=None, and 1024 rows;
# above 2^20 (the split's strips of 8) the single pair of a 23.7 s
# recording at 44.1 kHz at 2^21 and one row of 2,000,000 samples at 2^22,
# and (the split past 2^22, the long side in the rows) sig1 of a 47.5 s
# and a 95 s recording at 44.1 kHz under max_expected_delay=None (2^23,
# 2^24).
K4A_TOL = 5e-6
LONG = 1046019            # 23.7 s at 44.1 kHz: the api's nfft is 2^21
K4A_SHAPES = ((1, 44100, 65536), (2, 44100, 65536), (1, 44100, 131072),
              (1024, 65536, 65536), (2, LONG, 1 << 21),
              (1, 2000000, 1 << 22), (1, 4200000, 1 << 23),
              (1, 8400000, 1 << 24))
# K4b against its twin, absolute (peaks of correlations bounded by 1), at
# the permutation null's shapes (rows, len, nfft): the main path's and
# no_gate's lengths, two rows (16-row strips) and one block, and above 2^20
# the 23.7 s pair's null at phase 10's 64 and the default 1,000 draws,
# one row at 2^22 and three at 2^23 and 2^24; K7 at one scene's
# exact-length spectrum; the calls a host step is timed over.
BOOT_TOL = 1e-6
BOOT_SHAPES = ((1000, 44100, 65536), (1000, 44100, 131072),
               (2, 44100, 65536), (999, 3000, 4096), (64, LONG, 1 << 21),
               (1000, LONG, 1 << 21), (1, 2000000, 1 << 22),
               (3, 4200000, 1 << 23), (3, 8400000, 1 << 24))
K7_SHAPE = (1, 44100)
HOST_CALLS = 10_000
# K6 at the noise null's shapes (draws, n_samp, nfft): the main path's and
# no_gate's lengths, two draws and one block, K4b's shapes above 2^20, the
# default 1,000 draws at 2^23 and 300 at 2^24 (two launches each under
# ``cuda_fft.SPLIT_SCRATCH_BYTES``); the card tests' limit.
K6_SHAPES = ((1000, 44100, 65536), (1000, 44100, 131072), (2, 44100, 65536),
             (999, 1500, 4096), (64, LONG, 1 << 21), (1000, LONG, 1 << 21),
             (1, 2000000, 1 << 22), (3, 4200000, 1 << 23),
             (3, 8400000, 1 << 24), (1000, 4200000, 1 << 23),
             (300, 8400000, 1 << 24))
# Points (rows x nfft) from which K4b and K6 are timed by one call a loop
# and traced over one call (a parent tree's radix-2 passes take seconds a
# call there).
HEAVY_POINTS = 1 << 31
# --long: the shapes from this length on (the split's strips of 8 columns).
LONG_MIN = 1 << 21
# Points (rows x nfft) a call of K4b's and K6's plain twins takes at once:
# the twins hold several copies of the rows' spectra (K6's Philox twin
# eight int64 words a sample), past the card's memory at 1,000 rows of
# 2^21.  Each row's peak does not depend on the others.
TWIN_POINTS = 1 << 28
# Idle host time (s) between a traced step's edges and its calls
# (``device_ms``).  ``--trace`` counts the traces that miss a kernel with
# and without it (``trace_check``).
TRACE_EDGE_S = 0.02
# --trace: traces a case.
TRACE_RUNS = 60
# K5, K3 and K2 (scenes, mics, paths, padded length, samples, nfft, wq,
# finish): the fused sweep's 512 scenes, the api's scene (22 paths), an
# odd mic count on the split and the reverberant SRP sweep's render (K3
# only); up to 4,096 points (one block): the trio sweep's render (512 x 8
# mics, K3 only), the multi-source cube's raw per-source renders (256 x 8,
# K3 only) and the moving render's 132 frames (K3 only; both without the
# finalize and the noise: finish False), the short sweep (16 kHz x 0.1 s,
# 512 x 4 at 2,048) and the scene chunks (21,846 x 4 at 512, two launches
# a call).
# The render takes the finalize and noise where finish is True.
SCENE_SHAPES = {"sweep": (512, 4, 1, 44356, 44100, 65536, 6, True),
                "api": (1, 4, 22, 50292, 44100, 65536, 21, True),
                "odd": (3, 3, 2, 7000, 6000, 8192, 2, True),
                "reverb": (512, 4, 37, 4400, 4000, 8192, None, True),
                "trio": (512, 8, 1, 4094, 4000, 4096, None, True),
                "multi": (256, 8, 1, 4094, 4000, 4096, None, False),
                "moving": (132, 4, 1, 788, 788, 1024, None, False),
                "short": (512, 4, 1, 1694, 1600, 2048, 3, True),
                "chunks": (21846, 4, 1, 448, 400, 512, 2, True)}
# Absolute limits against the twins (chip_smoke's phase 3): the render's
# finalized signals and the windows of correlations, bounded by 1.
SCENE_TOL = {"scene_windowed": 1e-5, "delay_sum": 2e-5, "gcc_windowed": 1e-6}
# At the scene chunks ("chunks": 21,846 x 4 rows of 512 lags) float32
# rounding at the bins nearest zero, which PHAT's whitening divides by,
# moves the float32 twin itself past GCC_TOL from exact arithmetic on some
# inputs.  There K2's and K1's correlations are held against the twin run
# in float64, within CHUNKS_TOL (the limit chip_smoke.py's phase 3 holds
# K2 to at that shape); every other case against its float32 twin.
CHUNKS_TOL = 2e-6
# K1 (scenes or None for one scene, mics, samples, nfft, band) and K9
# (row pairs, samples, nfft) at chip_smoke.py's phase-3 shapes; the limit
# is absolute (correlations bounded by 1).  Above 2^20 ("long": the 23.7 s
# recording's 4 and 8 mics at 2^21, 4 mics at 2^22; K9's pair at each)
# the limit is GCC_TOL plus the float32 twin's own distance from its
# float64 run on the same inputs, as chip_smoke.py's phase 3 holds them.
BAND = (300.0, 3400.0)
GCC_SHAPES = {"api": (None, 4, 44100, 65536, BAND),
              "no_gate": (None, 4, 44100, 131072, None),
              "main": (256, 4, 44100, 65536, None),
              "reverb": (512, 4, 4000, 4096, BAND),
              "multi": (128, 8, 4000, 4096, BAND),
              "edge": (5, 3, 1500, 2048, BAND),
              "mics11": (None, 11, 44100, 65536, BAND),
              "trio": (512, 8, 4000, 4096, BAND),
              "moving": (132, 4, 788, 1024, None),
              "short": (512, 4, 1600, 2048, BAND),
              "chunks": (21846, 4, 400, 512, BAND),
              "long": (None, 4, LONG, 1 << 21, BAND),
              "long8": (None, 8, LONG, 1 << 21, BAND),
              "long22": (None, 4, 2000000, 1 << 22, None),
              "spectra20": (None, 4, 800000, 1 << 20, BAND),
              "spectra18": (None, 8, 200000, 1 << 18, BAND),
              "spectra_block": (128, 16, 4000, 4096, BAND)}
# --gcc --long: the shapes where K1's, K2's and K5's GCC goes through the
# mic rows' spectra (``cuda_fft.gcc_route``; before, the radix-2 passes):
# K1 at 11 mics x 65,536, 8 mics x 2^18, 4 mics of an 18 s recording at
# 2^20, 128 x 16 mics at 4,096 and its shapes above 2^20 (GCC_SHAPES);
# K2 (with K3 and K5 beside it, ``SCENE_SHAPES``' layout) at the fast
# path's 4 mics at 2^20, 2^21 and 2^22, where K3's render also goes
# through the base rows' spectra with its finish spread over the card,
# 512 x 12 mics at 4,096 and one scene of 6 mics at 2^18; K3 alone at 2
# scenes x 3 mics x 3 paths at 2^21 (mic rows packed across scenes) and
# 64 scenes x 4 mics at 2^20 (rows that fill the card: one finish block a
# mic row).
ROUTE_GCC = ("mics11", "spectra18", "spectra20", "spectra_block", "long",
             "long8", "long22")
ROUTE_SCENES = {"fast20": (1, 4, 1, 900000, 800000, 1 << 20, 21, True),
                "fast21": (1, 4, 1, 1600000, 1500000, 1 << 21, 21, True),
                "fast22": (1, 4, 1, 3100000, 3000000, 1 << 22, 21, True),
                "spectra_block": (512, 12, 1, 4094, 4000, 4096, 2, True),
                "spectra18": (1, 6, 1, 250000, 200000, 1 << 18, 8, True),
                "odd21": (2, 3, 3, 1600000, 1500000, 1 << 21, None, True),
                "scenes20": (64, 4, 1, 900000, 800000, 1 << 20, None,
                             True)}
CORR_SHAPES = {"main": (1, 44100, 65536), "no_gate": (1, 44100, 131072),
               "edge": (3, 3000, 4096), "long": (1, LONG, 1 << 21),
               "long22": (1, 2000000, 1 << 22)}
GCC_TOL = 1e-6
# The split's kernels whose compiler report --long prints.
SPLIT_KERNELS = ("fft_real_cols", "fft_real_rows", "boot_rows", "boot_cols")


def time_ms(fn, reps: int, loops: int = 3):
    """(the output of a first, warm-up call, device time of ``fn`` per call
    by CUDA events: the median over ``loops`` loops of ``reps`` calls)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return out, sorted(times)[loops // 2]


def check(name: str, got, want, tol: float):
    """(max |got - want|, max |want|); raises unless the first is within
    ``tol`` of the second.  Outputs may be tuples of tensors."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = scale = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: output of shape {tuple(g.shape)} "
                                 f"(want {tuple(w.shape)}) or non-finite")
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} > "
                             f"{tol:g} x {scale:.3e}")
    return err, scale


def bench(n2: int, batch: int, reps: int) -> dict:
    """Times (ms per call) of every schedule at one shape, and each kernel
    case's (max abs error, max |twin|) against its twin."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn((batch, n2, rd.N1), generator=gen, device=dev)
    xi = torch.randn((batch, n2, rd.N1), generator=gen, device=dev)
    xh = xr[:, :n2 // 2].contiguous()
    xc = torch.complex(xr, xi)
    flat = xr.reshape(batch, -1)
    tt, ct = rd.TRANSFORM_TOL, rd.CHAIN_TOL
    # name -> (call, twin or None, tolerance)
    cases = {
        "stages": (lambda: rd.row_stages(xr, xi),
                   lambda: rd.row_dft_plain(xr, xi), tt),
        "rowdft": (lambda: rd.row_dft(xr, xi),
                   lambda: rd.row_dft_plain(xr, xi), tt),
        "stages8": (lambda: rd.row_stages(xr, xi, rep=8),
                    lambda: rd.row_dft_plain(xr, xi, rep=8), tt),
        "rowdft8": (lambda: rd.row_dft(xr, xi, rep=8),
                    lambda: rd.row_dft_plain(xr, xi, rep=8), tt),
        "lane": (lambda: rd.lane_dft(xr, xi),
                 lambda: rd.lane_dft_plain(xr, xi), tt),
        "fwd_stages": (lambda: rd.fft_four_step(xr, "stages"),
                       lambda: rd.fft_four_step_plain(xr), tt),
        "fwd_mxu": (lambda: rd.fft_four_step(xr, "mxu"),
                    lambda: rd.fft_four_step_plain(xr), tt),
        "fwdz_stages": (lambda: rd.fft_four_step(xh, "stages", True),
                        lambda: rd.fft_four_step_plain(xh, True), tt),
        "fwdz_mxu": (lambda: rd.fft_four_step(xh, "mxu", True),
                     lambda: rd.fft_four_step_plain(xh, True), tt),
        "row_plain": (lambda: rd.row_dft_plain(xr, xi), None, None),
        "lane_plain": (lambda: rd.lane_dft_plain(xr, xi), None, None),
        "torch_row": (lambda: torch.fft.fft(xc, dim=1), None, None),
        "torch_lane": (lambda: torch.fft.fft(xc, dim=2), None, None),
        "torch_flat": (lambda: torch.fft.fft(flat), None, None),
        "k4a": (lambda: cf.fft_real(flat, n2 * rd.N1),
                lambda: cf.fft_real_plain(flat, n2 * rd.N1), K4A_TOL),
        "torch_rfft": (lambda: torch.fft.rfft(flat), None, None),
    }
    if n2 >= CHAIN_MIN_N2:
        x4 = torch.randn((4, batch, n2, rd.N1), generator=gen, device=dev)
        for schedule in ("stages", "mxu"):
            cases[f"chain_{schedule}"] = (
                lambda s=schedule: rd.chain(x4, s),
                lambda: rd.chain_plain(x4), ct)
    ms, err = {}, {}
    for name, (call, twin, tol) in cases.items():
        out, ms[name] = time_ms(call, reps)
        if twin is not None:
            err[name] = check(f"{name} n2={n2} B={batch}", out, twin(), tol)
        del out
    ms["compute_stages"] = (ms["stages8"] - ms["stages"]) / 7.0
    ms["compute_rowdft"] = (ms["rowdft8"] - ms["rowdft"]) / 7.0
    return {"ms": ms, "err": err}


def line(n2: int, batch: int, res: dict) -> str:
    ms = res["ms"]
    worst = max(e / s for e, s in res["err"].values())
    out = (f"n2={n2:5d} B={batch:5d} N={n2 * rd.N1:7d}  row: stages "
           f"{ms['stages']:.4f} ms, rowdft {ms['rowdft']:.4f} ms "
           f"({ms['stages'] / ms['rowdft']:.2f}x); compute-only stages "
           f"{ms['compute_stages']:.4f}, rowdft {ms['compute_rowdft']:.4f}; "
           f"lane {ms['lane']:.4f}; fwd stages {ms['fwd_stages']:.4f}, mxu "
           f"{ms['fwd_mxu']:.4f} ({ms['fwd_stages'] / ms['fwd_mxu']:.2f}x); "
           f"zero_top stages {ms['fwdz_stages']:.4f}, mxu "
           f"{ms['fwdz_mxu']:.4f}; plain row {ms['row_plain']:.4f}, lane "
           f"{ms['lane_plain']:.4f}; torch.fft rows {ms['torch_row']:.4f}, "
           f"lanes {ms['torch_lane']:.4f}, flat {ms['torch_flat']:.4f}, K4a "
           f"fft_real {ms['k4a']:.4f}, torch.fft.rfft "
           f"{ms['torch_rfft']:.4f}")
    if "chain_mxu" in ms:
        out += (f"; chain stages {ms['chain_stages']:.4f}, mxu "
                f"{ms['chain_mxu']:.4f} "
                f"({ms['chain_stages'] / ms['chain_mxu']:.2f}x)")
    return out + (f"; worst error {worst:.2e} of max over "
                  f"{len(res['err'])} checks")


def run(reps: int = 5, log=print) -> dict:
    """Every shape once; logs one line per shape and returns
    {(n2, B): bench's result}."""
    results = {}
    for n2, batch in SHAPES:
        results[(n2, batch)] = bench(n2, batch, reps)
        log(line(n2, batch, results[(n2, batch)]))
        torch.cuda.empty_cache()
    return results


def device_ms(fn, calls: int = 20, edge: float = TRACE_EDGE_S) -> dict:
    """Device time per call of ``fn`` by kernel (the sum of each kernel's
    durations in a ``torch.profiler`` trace of CUDA activity over
    ``calls`` warm calls, divided by ``calls``), with their total under
    "total" and the device kernels a call runs under "kernels".  Unlike
    CUDA events around a loop it leaves out the host's time between
    launches."""
    import tempfile
    import time
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    # A process's first trace may miss kernels: the schedule's warm-up step
    # takes those calls, and only the second step's are kept.  Kernels that
    # run within about a tenth of a millisecond of a step's edge may be
    # lost or counted in the wrong step, so each step's calls stand
    # ``edge`` seconds of idle host time inside its edges.
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(edge)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(edge)
            prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    out = {}
    kernels = 0
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1].split()[-1]
            out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / calls
            kernels += 1
    out["total"] = sum(out.values())
    out["kernels"] = kernels / calls
    return out


def trace_check(runs: int = TRACE_RUNS, log=print) -> dict:
    """How often a ``device_ms`` trace misses kernels, with and without
    its idle edges: three calls of one kernel (an elementwise product on
    4,096 points, a 4,096^2 matmul, a spin of 5e7 cycles) traced ``runs``
    times each at edge 0 and at ``TRACE_EDGE_S``.  Logs one line per case
    and edge and returns {(case, edge): traces that recorded another count
    than one kernel a call}."""
    dev = torch.device("cuda")
    x = torch.randn(4096, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    out = {}
    for name, calls, fn in (
            ("elementwise", 5, lambda: x.mul_(1.0)),
            ("matmul", 5, lambda: a @ a),
            ("sleep", 2, lambda: torch.cuda._sleep(50_000_000))):
        for edge in (0.0, TRACE_EDGE_S):
            counts = [device_ms(fn, calls, edge)["kernels"]
                      for _ in range(runs)]
            out[(name, edge)] = sum(k != 1 for k in counts)
            log(f"trace {name} ({calls} calls a trace), edge {edge:g} s: "
                f"{out[(name, edge)]} of {runs} traces miscount, kernels a "
                f"call {sorted(set(counts))}")
    return out


def twin_rows(fn, rows: torch.Tensor, nfft: int) -> torch.Tensor:
    """``fn`` over the rows (or seeds) in chunks of TWIN_POINTS // nfft,
    joined: a plain twin of per-row peaks at a batch too large to take at
    once."""
    step = max(1, TWIN_POINTS // nfft)
    return torch.cat([fn(rows[i:i + step])
                      for i in range(0, rows.shape[0], step)])


def _split(dev: dict) -> str:
    """"name ms, ..." of ``device_ms``'s kernels."""
    return ", ".join(f"{k} {v:.4f}" for k, v in dev.items()
                     if k not in ("total", "kernels"))


def _shapes(shapes, min_nfft: int):
    return [s for s in shapes if s[2] >= min_nfft]


def _calls(rows: int, nfft: int, reps: int):
    """(CUDA-event calls a loop, traced calls) of a K4b or K6 case: reps
    and 5, one and one from ``HEAVY_POINTS`` on."""
    return (reps, 5) if rows * nfft < HEAVY_POINTS else (1, 1)


def k4a(reps: int = 20, log=print, min_nfft: int = 0) -> dict:
    """K4a against ``torch.fft.rfft`` at ``K4A_SHAPES`` (those from
    ``min_nfft`` on), each held against its twin: CUDA-event ms per call
    (``time_ms``, five loops) and device ms per call (``device_ms``, by
    kernel).  Logs one line per shape and returns {shape: {"k4a", "rfft",
    "k4a_device", "rfft_device"}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for rows, length, nfft in _shapes(K4A_SHAPES, min_nfft):
        x = torch.randn((rows, length), generator=gen, device=dev)
        shape = f"{rows} x {length} -> {nfft}"
        check(f"k4a {shape}", cf.fft_real(x, nfft),
              cf.fft_real_plain(x, nfft), K4A_TOL)
        calls = {"k4a": lambda: cf.fft_real(x, nfft),
                 "rfft": lambda: torch.fft.rfft(x, n=nfft)}
        res = {name: time_ms(fn, reps, 5)[1] for name, fn in calls.items()}
        for name, fn in calls.items():
            res[f"{name}_device"] = device_ms(fn)
        out[(rows, length, nfft)] = res
        log(f"K4a {shape}: fft_real {res['k4a']:.4f} ms, torch.fft.rfft "
            f"{res['rfft']:.4f} ms ({res['k4a'] / res['rfft']:.2f}x); "
            f"device fft_real {res['k4a_device']['total']:.4f} ms "
            f"({_split(res['k4a_device'])}), torch.fft.rfft "
            f"{res['rfft_device']['total']:.4f} ms")
    return out


def boot(reps: int = 10, log=print, min_nfft: int = 0) -> dict:
    """K4b against its twin at ``BOOT_SHAPES`` (permuted rows of one
    signal, as the permutation null draws them; those from ``min_nfft`` on)
    and, without ``min_nfft``, K7 against its twin and ``torch.sgn`` at
    ``K7_SHAPE``: CUDA-event ms per call (``time_ms``, median of three
    loops), device ms per call by kernel and device kernels per call
    (``device_ms``); then ``host_steps``.  Logs one line per case and
    returns {case: {"ms", "device"}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for rows, length, nfft in _shapes(BOOT_SHAPES, min_nfft):
        sig = torch.randn(length, generator=gen, device=dev)
        keys = torch.rand((rows, length), generator=gen, device=dev)
        x = sig[torch.argsort(keys, dim=-1)].contiguous()
        del keys
        s1 = cf.fft_real_plain(torch.randn((1, length), generator=gen,
                                           device=dev), nfft)[0].contiguous()
        call = lambda: cf.bootstrap_peaks(s1, x, nfft)  # noqa: E731
        calls, traced = _calls(rows, nfft, reps)
        got, ms = time_ms(call, calls)
        want = twin_rows(lambda r: cf.bootstrap_peaks_plain(s1, r, nfft), x,
                         nfft)
        err = float((got - want).abs().max())
        if not err <= BOOT_TOL:
            raise AssertionError(f"K4b {rows} x {length} -> {nfft}: max "
                                 f"|kernel - plain| = {err:.3e}")
        res = {"ms": ms, "device": device_ms(call, traced)}
        out[("k4b", rows, length, nfft)] = res
        log(f"K4b {rows} x {length} -> {nfft}: {ms:.4f} ms; device "
            f"{res['device']['total']:.4f} ms in "
            f"{res['device']['kernels']:g} kernels a call "
            f"({_split(res['device'])}); max |kernel - plain| {err:.2e}")
        del x, got
    if min_nfft:
        return out
    spec = torch.complex(torch.randn(K7_SHAPE, generator=gen, device=dev),
                         torch.randn(K7_SHAPE, generator=gen, device=dev))
    check(f"K7 {K7_SHAPE}", cf.whiten(spec), cf.whiten_plain(spec), 1e-6)
    for name, call in (("K7 whiten", lambda: cf.whiten(spec)),
                       ("torch.sgn", lambda: torch.sgn(spec))):
        res = {"ms": time_ms(call, 10 * reps)[1],
               "device": device_ms(call, 50)}
        out[(name,) + K7_SHAPE] = res
        log(f"{name} {K7_SHAPE}: {res['ms']:.4f} ms by CUDA events; device "
            f"{res['device']['total']:.4f} ms a call "
            f"({_split(res['device'])})")
    out["host"] = host_steps(spec, log)
    return out


def k6(reps: int = 10, log=print, min_nfft: int = 0) -> dict:
    """K6 against its twin at ``K6_SHAPES`` (those from ``min_nfft`` on):
    CUDA-event ms per call (``time_ms``, median of three loops), device
    ms per call by kernel with the device kernels a call runs
    (``device_ms``), and the twin's ms for the call (one run, in chunks of
    ``TWIN_POINTS``, synchronized at both ends).  Logs one line per shape
    and returns {shape: {"ms", "device", "twin_ms"}}."""
    import time
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for rows, n_samp, nfft in _shapes(K6_SHAPES, min_nfft):
        s1 = cf.fft_real_plain(torch.randn((1, n_samp), generator=gen,
                                           device=dev), nfft)[0].contiguous()
        seeds = torch.randint(-2 ** 31, 2 ** 31, (rows, 2), generator=gen,
                              dtype=torch.int32, device=dev)
        call = lambda: cf.noise_bootstrap_peaks(  # noqa: E731
            s1, seeds, n_samp, nfft)
        calls, traced = _calls(rows, nfft, reps)
        try:
            got, ms = time_ms(call, calls)
        except torch.cuda.OutOfMemoryError as err:
            # A parent tree's passes need twice the scratch.
            log(f"K6 {rows} x {n_samp} -> {nfft}: does not fit the card "
                f"({str(err).splitlines()[0]})")
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        start = time.perf_counter()
        want = twin_rows(lambda sd: cf.noise_bootstrap_peaks_plain(
            s1, sd, n_samp, nfft), seeds, nfft)
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - start) * 1e3
        err = float((got - want).abs().max())
        if not err <= BOOT_TOL:
            raise AssertionError(f"K6 {rows} x {n_samp} -> {nfft}: max "
                                 f"|kernel - plain| = {err:.3e}")
        res = {"ms": ms, "device": device_ms(call, traced),
               "twin_ms": twin_ms}
        out[(rows, n_samp, nfft)] = res
        log(f"K6 {rows} x {n_samp} -> {nfft}: {ms:.4f} ms; device "
            f"{res['device']['total']:.4f} ms in "
            f"{res['device']['kernels']:g} kernels a call "
            f"({_split(res['device'])}); max |kernel - plain| {err:.2e}; "
            f"twin {twin_ms:.1f} ms")
    return out


def scene_inputs(gen, scenes, mics, paths, total, out):
    """A sweep-like batch: scenes' base signals (scenes, total) zero past
    ``out``, delays (scenes, mics, paths) in samples, gains with the
    strongest path at 1, SNRs in [20, 40) dB, seeds and the fade."""
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    dev = torch.device("cuda")
    base = torch.zeros((scenes, total), device=dev)
    base[:, :out] = torch.randn((scenes, out), generator=gen, device=dev)
    tau = torch.rand((scenes, mics, paths), generator=gen,
                     device=dev) * (total - out)
    gains = torch.rand((scenes, mics, paths), generator=gen, device=dev)
    gains[..., 0] = 1.0
    snr = 20.0 + 20.0 * torch.rand(scenes, generator=gen, device=dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (scenes, 2), generator=gen,
                          dtype=torch.int32, device=dev)
    fade = fade_window(total, dtype=torch.float32, device=dev)[:out]
    return (base, tau.contiguous(), gains.contiguous(), snr, seeds,
            fade.contiguous())


def scene(reps: int = 5, log=print, shapes=None) -> dict:
    """K5 (``scene_windowed``), K3 (``delay_sum`` with finalize and noise,
    or neither where the shape's finish is False) and K2 (``gcc_windowed``
    on K3's signals) at ``shapes`` (``SCENE_SHAPES`` by default), each
    held against its twin within ``SCENE_TOL`` (a render without the
    finalize relative to its peak; K2 at "chunks" against its float64 run
    within ``CHUNKS_TOL``, above 2^20 within ``SCENE_TOL`` plus the float32
    twin's distance from its float64 run):
    CUDA-event ms per call, the twin's beside it, device ms per call by
    kernel and the bound (chip_smoke.py's ``scene_bound``).  Logs one line
    per kernel and shape and returns {(name, shape): {"ms", "plain_ms",
    "device", "bound"}}."""
    import chip_smoke as cs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape, (scenes, mics, paths, total, n, nfft, wq, finish) in (
            shapes or SCENE_SHAPES).items():
        base, tau, gains, snr, seeds, fade = scene_inputs(
            gen, scenes, mics, paths, total, n)
        pairs = [(i, j) for i in range(mics) for j in range(i + 1, mics)]
        pi, pj = [p[0] for p in pairs], [p[1] for p in pairs]
        mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=dev)
        noise = (snr, seeds) if finish else (None, None)
        render = (base, tau, gains, nfft, n, fade, finish) + noise
        sigs = cf.delay_sum(*render)
        cases = {"delay_sum": (lambda: cf.delay_sum(*render),
                               lambda: cf.delay_sum_plain(*render))}
        if wq is not None:
            fused = (base, tau, gains, pi, pj, nfft, n, wq, fade, mask, snr,
                     seeds)
            cases["gcc_windowed"] = (
                lambda: cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask),
                lambda: cf.gcc_windowed_plain(sigs, pi, pj, nfft, wq, mask))
            cases["scene_windowed"] = (
                lambda: cf.scene_windowed(*fused),
                lambda: cf.scene_windowed_plain(*fused))
        for name, (call, twin) in cases.items():
            got, ms = time_ms(call, reps)
            want, plain_ms = time_ms(twin, reps)
            got, want = ((got, want) if name == "delay_sum"
                         else (got[0], want[0]))
            err = float((got - want).abs().max())
            if shape == "chunks" and name == "gcc_windowed":
                ref = cf.gcc_windowed_plain(sigs.double(), pi, pj, nfft, wq,
                                            mask.double())[0]
                exact_err = float((got.double() - ref).abs().max())
                log(f"{name} [{shape}]: max |kernel - float64 twin| "
                    f"{exact_err:.3e} (limit {CHUNKS_TOL:g}), |float32 twin "
                    f"- float64 twin| "
                    f"{float((want.double() - ref).abs().max()):.3e}")
                del ref
                if not exact_err <= CHUNKS_TOL:
                    raise AssertionError(f"{name} {shape}: max |kernel - "
                                         f"float64 twin| = {exact_err:.3e}")
            else:
                tol = SCENE_TOL[name] * (1.0 if finish else max(
                    float(want.abs().max()), 1.0))
                if name == "gcc_windowed" and nfft > cf.STAGE_SPLIT_MAX:
                    gap = float((want.double() - cf.gcc_windowed_plain(
                        sigs.double(), pi, pj, nfft, wq,
                        mask.double())[0]).abs().max())
                    tol += gap
                    log(f"{name} [{shape}]: max |float32 twin - float64 "
                        f"twin| {gap:.3e}, limit {tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"{name} {shape}: max |kernel - "
                                         f"plain| = {err:.3e}")
            del got, want
            res = {"ms": ms, "plain_ms": plain_ms,
                   "device": device_ms(call, 3),
                   "bound": cs.scene_bound(name, scenes, mics, paths, total,
                                           n, nfft, wq, int(finish))}
            out[(name, shape)] = res
            log(f"{name} [{shape}] {scenes} x {mics} mics x {paths} paths "
                f"-> {nfft}: {ms:.4f} ms; device "
                f"{res['device']['total']:.4f} ms in "
                f"{res['device']['kernels']:g} kernels a call "
                f"({_split(res['device'])}); twin {plain_ms:.4f} ms; bound "
                f"{res['bound'][0]:.5f} ms ({res['bound'][1]}); max "
                f"|kernel - plain| {err:.2e}")
        del sigs
        torch.cuda.empty_cache()
    return out


def gcc(reps: int = 5, log=print, min_nfft: int = 0,
        names=None) -> dict:
    """K1 (``gcc_all_pairs``) at ``GCC_SHAPES`` and K9 (``whitened_corr``)
    at ``CORR_SHAPES`` (those from ``min_nfft`` on; with ``names``, K1 at
    those shapes alone), each held against its twin within ``GCC_TOL``
    (K1 at "chunks" against its float64 run within ``CHUNKS_TOL``; from
    2^20 within ``GCC_TOL`` plus the float32 twin's distance from its
    float64 run): CUDA-event ms per call (median of
    three loops) and device ms per call by kernel, the kernel's and the
    twin's.  Logs one line per case and returns {(name, shape): {"ms",
    "device", "plain_ms", "plain_device"}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    exact = {}  # the twin in float64 at "chunks"
    wide = {}   # the twin in float64 above 2^20
    for shape, (scenes, mics, n, nfft, band) in GCC_SHAPES.items():
        if nfft < min_nfft or (names is not None and shape not in names):
            continue
        sig = torch.randn((mics, n) if scenes is None else (scenes, mics, n),
                          generator=gen, device=dev)
        pairs = [(i, j) for i in range(mics) for j in range(i + 1, mics)]
        pi, pj = [p[0] for p in pairs], [p[1] for p in pairs]
        mask = cf.band_mask(nfft, band, 44100.0, device=dev)
        cases[("gcc_all_pairs", shape)] = (
            f"{scenes or 1} x {mics} mics x {n} -> {nfft}",
            lambda sig=sig, pi=pi, pj=pj, nfft=nfft, mask=mask:
            cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
            lambda sig=sig, pi=pi, pj=pj, nfft=nfft, mask=mask:
            cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask))
        double = (lambda sig=sig, pi=pi, pj=pj, nfft=nfft, mask=mask:
                  cf.gcc_all_pairs_plain(sig.double(), pi, pj, nfft,
                                         mask.double()))
        if shape == "chunks":
            exact[("gcc_all_pairs", shape)] = double
        elif nfft >= cf.STAGE_SPLIT_MAX:
            wide[("gcc_all_pairs", shape)] = double
    for shape, (rows, n, nfft) in CORR_SHAPES.items():
        if nfft < min_nfft or names is not None:
            continue
        spec = cf.fft_real_plain(torch.randn((2 * rows, n), generator=gen,
                                             device=dev), nfft)
        a, b = spec[:rows].contiguous(), spec[rows:].contiguous()
        mask = cf.band_mask(nfft, None, None, device=dev)
        cases[("whitened_corr", shape)] = (
            f"{rows} row pairs x {n} -> {nfft}",
            lambda a=a, b=b, nfft=nfft, mask=mask:
            cf.whitened_corr(a, b, mask, nfft),
            lambda a=a, b=b, nfft=nfft, mask=mask:
            cf.whitened_corr_plain(a, b, mask, nfft))
        if nfft > cf.STAGE_SPLIT_MAX:
            wide[("whitened_corr", shape)] = (
                lambda a=a, b=b, nfft=nfft, mask=mask:
                cf.whitened_corr_plain(a.to(torch.complex128),
                                       b.to(torch.complex128), mask.double(),
                                       nfft))
    out = {}
    for (name, shape), (what, call, twin) in cases.items():
        got, ms = time_ms(call, reps)
        want, plain_ms = time_ms(twin, reps)
        tol = GCC_TOL
        if (name, shape) in wide:
            gap = float((want.double() - wide[(name, shape)]()).abs().max())
            tol += gap
            log(f"{name} [{shape}]: max |float32 twin - float64 twin| "
                f"{gap:.3e}, limit {tol:.3e}")
        if (name, shape) in exact:
            ref = exact[(name, shape)]()
            exact_err, _ = check(f"{name} [{shape}] (float64 twin)",
                                 got.double(), ref,
                                 CHUNKS_TOL / float(ref.abs().max()))
            err = float((got - want).abs().max())
            twin_err = float((want.double() - ref).abs().max())
            log(f"{name} [{shape}]: max |kernel - float64 twin| "
                f"{exact_err:.3e} (limit {CHUNKS_TOL:g}), |float32 twin - "
                f"float64 twin| {twin_err:.3e}")
            del ref
        else:
            err, _ = check(f"{name} [{shape}]", got, want,
                           tol / float(want.abs().max()))
        del got, want
        res = {"ms": ms, "device": device_ms(call, 3), "plain_ms": plain_ms,
               "plain_device": device_ms(twin, 3)}
        out[(name, shape)] = res
        log(f"{name} [{shape}] {what}: {ms:.4f} ms; device "
            f"{res['device']['total']:.4f} ms in "
            f"{res['device']['kernels']:g} kernels a call "
            f"({_split(res['device'])}); twin {plain_ms:.4f} ms, device "
            f"{res['plain_device']['total']:.4f} ms; max |kernel - plain| "
            f"{err:.2e}")
        torch.cuda.empty_cache()
    return out


def k10(reps: int = 5, log=print) -> dict:
    """K10a, K10b and K10c at ``SHAPES`` on complex planes, the full
    forward of the real plane by both schedules and the chain on four
    planes of their own (n2 >= ``CHAIN_MIN_N2``), each held against its
    twin, beside the twins and ``torch.fft.fft`` along dims 1 and 2 and of
    the flat row, and K10a's precision controls (2 and 1 TF32 products
    a real product instead of 3, held to nothing: their time shows what
    the products cost): CUDA-event ms per call (``time_ms``, median of
    three loops) and device ms per call by kernel with the device kernels
    a call runs (``device_ms``).  Logs one line per case and returns
    {(case, n2, B): {"ms", "device", "err"}}."""
    dev = torch.device("cuda")
    tt, ct = rd.TRANSFORM_TOL, rd.CHAIN_TOL
    out = {}
    for n2, batch in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n2)
        xr = torch.randn((batch, n2, rd.N1), generator=gen, device=dev)
        xi = torch.randn((batch, n2, rd.N1), generator=gen, device=dev)
        xc = torch.complex(xr, xi)
        flat = xr.reshape(batch, -1)
        # name -> (call, twin or None, tolerance)
        cases = {
            "row_dft": (lambda: rd.row_dft(xr, xi),
                        lambda: rd.row_dft_plain(xr, xi), tt),
            "row_stages": (lambda: rd.row_stages(xr, xi),
                           lambda: rd.row_dft_plain(xr, xi), tt),
            "lane_dft": (lambda: rd.lane_dft(xr, xi),
                         lambda: rd.lane_dft_plain(xr, xi), tt),
            "row_plain": (lambda: rd.row_dft_plain(xr, xi), None, None),
            "lane_plain": (lambda: rd.lane_dft_plain(xr, xi), None, None),
            "torch.fft.fft dim 1": (lambda: torch.fft.fft(xc, dim=1), None,
                                    None),
            "torch.fft.fft dim 2": (lambda: torch.fft.fft(xc, dim=2), None,
                                    None),
            # The precision controls: what the TF32 products cost.
            "row_dft 2 products": (
                lambda: rd._row_launch("row_dft", xr, xi, n2, False, 1, 1.0,
                                       terms=2),
                lambda: rd.row_dft_plain(xr, xi), 1.0),
            "row_dft 1 product": (
                lambda: rd._row_launch("row_dft", xr, xi, n2, False, 1, 1.0,
                                       terms=1),
                lambda: rd.row_dft_plain(xr, xi), 1.0),
            "fwd_mxu": (lambda: rd.fft_four_step(xr, "mxu"),
                        lambda: rd.fft_four_step_plain(xr), tt),
            "fwd_stages": (lambda: rd.fft_four_step(xr, "stages"),
                           lambda: rd.fft_four_step_plain(xr), tt),
            "torch.fft.fft flat": (lambda: torch.fft.fft(flat), None, None),
        }
        if n2 >= CHAIN_MIN_N2:
            x4 = torch.randn((4, batch, n2, rd.N1), generator=gen,
                             device=dev)
            for schedule in ("mxu", "stages"):
                cases[f"chain_{schedule}"] = (
                    lambda s=schedule: rd.chain(x4, s),
                    lambda: rd.chain_plain(x4), ct)
        for name, (call, twin, tol) in cases.items():
            got, ms = time_ms(call, reps)
            err = None
            if twin is not None:
                err, scale = check(f"{name} n2={n2} B={batch}", got, twin(),
                                   tol)
                err = err / scale
            del got
            res = {"ms": ms, "device": device_ms(call, 5), "err": err}
            out[(name, n2, batch)] = res
            log(f"K10 n2={n2:5d} B={batch:5d} {name}: {ms:.4f} ms; device "
                f"{res['device']['total']:.4f} ms in "
                f"{res['device']['kernels']:g} kernels a call "
                f"({_split(res['device'])})"
                + ("" if err is None else
                   f"; max |kernel - plain| {err:.2e} of max"))
        del cases
        torch.cuda.empty_cache()
    return out


def ptxas_report(names=("row_dft_kernel", "row_fft_kernel",
                        "lane_dft_kernel"), log=print) -> None:
    """The compiler's lines (``nvcc -Xptxas -v``, ``cuda_fft.build``'s
    ``ptxas.log``) for each kernel whose mangled name holds one of
    ``names``: registers, stack frame, spill stores and loads."""
    lines = (cf.BUILD_DIR / "ptxas.log").read_text().splitlines()
    for i, text in enumerate(lines):
        if "Compiling entry" in text and any(n in text for n in names):
            log(f"ptxas {text.split(chr(39))[1]}: "
                + "; ".join(t.strip().split(": ")[-1]
                            for t in lines[i + 1:i + 5]
                            if "stack frame" in t or "Used" in t))


def host_steps(spec: torch.Tensor, log=print, calls: int = HOST_CALLS):
    """Host time per call (µs: ``time.perf_counter`` around ``calls``
    calls, synchronized at both ends) of each step of a wrapper's launch
    path, on K7 at ``spec``, and of the whole wrapper and ``torch.sgn``.
    Returns {step: µs}."""
    import time
    lib = cf._library()
    dev = spec.device
    out = torch.empty_like(spec)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def guard():
        with torch.cuda.device(dev):
            pass

    steps = {
        "device check (_use_plain)": lambda: cf._use_plain(spec),
        "contiguity and dtype checks": lambda: (
            cf._check_contiguous("whiten", spec),
            spec.dtype != torch.complex64),
        "torch.cuda.device guard": guard,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "current device (_cuda_getDevice)": torch._C._cuda_getDevice,
        "Stream object (current_stream(dev).cuda_stream)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream pointer (_cuda_getCurrentRawStream)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "output allocation (empty_like)": lambda: torch.empty_like(spec),
        "ctypes call of palt_whiten (enqueue)": lambda: lib.palt_whiten(
            spec.data_ptr(), spec.numel(), cf.PHAT_EPS, out.data_ptr(),
            stream),
        "whole wrapper (cuda_fft.whiten)": lambda: cf.whiten(spec),
        "torch.sgn": lambda: torch.sgn(spec),
    }
    res = {}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - start) / calls * 1e6
        log(f"host {name}: {res[name]:.3f} us a call ({calls} calls)")
    return res


def recording(card: str) -> None:
    """``chip_smoke.long_recording`` of this tree (the 4 x 24 s recording
    written, read back and localized with the noise null at nfft 2^21 and,
    under ``max_expected_delay=None``, 2^22, a warm call each, the device
    time by kernel), ``recording23`` (4 x 60 s at 44.1 kHz under
    ``max_expected_delay=None``: K4a and K6 at 2^23, K1 on its passes) and
    ``spectra_recordings`` (16 s on the full core at 2^20; 16, 30 and 60 s
    on the fast path at 2^20 to 2^22), logged beside ``card``.  A tree
    whose K1, K2, K4a or K6 still runs its radix-2 passes there logs them
    (``hold_split=False``, ``hold_spectra=False``)."""
    smoke = _smoke()
    smoke.CARD[0] = card
    smoke.long_recording(cf, torch, {}, hold_split=False)
    smoke.recording23(cf, torch, {}, hold_split=False)
    smoke.spectra_recordings(cf, torch, {}, hold_spectra=False)


def simulations(card: str) -> None:
    """``chip_smoke.long_scenes`` of this tree (the simulated 20 s and 60 s
    scenes on the fast path, K3's render at 2^20 and 2^22: wall time cold
    and warm, device time by kernel, the TDOAs against the CPU's), logged
    beside ``card``; a tree whose K3 still renders on the radix-2 passes
    there logs them (``hold_spectra=False``)."""
    smoke = _smoke()
    smoke.CARD[0] = card
    smoke.long_scenes(cf, torch, {}, hold_spectra=False)


def _smoke():
    """This tree's ``chip_smoke.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--k4a", action="store_true",
                    help="also time K4a at the production shapes")
    ap.add_argument("--boot", action="store_true",
                    help="time only K4b and K7 at the production shapes, "
                         "and the wrappers' host steps")
    ap.add_argument("--k6", action="store_true",
                    help="time only K6 at the noise null's shapes")
    ap.add_argument("--scene", action="store_true",
                    help="time only K5, K3 and K2 at the sweep's, the "
                         "api's, an odd, the reverberant and the one-block "
                         "shapes, beside their cuFFT twins")
    ap.add_argument("--gcc", action="store_true",
                    help="time only K1 and K9 at chip_smoke.py's shapes and "
                         "K2's one-block ones, beside their cuFFT twins")
    ap.add_argument("--long", action="store_true",
                    help="time only K4a, K4b, K6, K1 and K9 at their "
                         "shapes above 2^20 (the split's strips of 8 "
                         "columns); with --gcc, K1, K2, K3 and K5 at the "
                         "shapes of their GCC through the mic rows' "
                         "spectra and of the render through the base "
                         "rows'; with --scene, only K2, K3 and K5 there "
                         "and the simulated 20 s and 60 s scenes")
    ap.add_argument("--recording", action="store_true",
                    help="localize chip_smoke.py's 4 x 24 s recording "
                         "(phase 10) cold and warm, with its device time "
                         "by kernel")
    ap.add_argument("--trace", action="store_true",
                    help="only count the device-time traces that miss a "
                         "kernel, with and without their idle edges")
    ap.add_argument("--k10", action="store_true",
                    help="time only K10a, K10b and K10c, the full forward "
                         "and the chain at the TPU tool's shapes, with "
                         "device time by kernel and the compiler's report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rowdft_bench: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    def log(msg):
        print(msg, flush=True)

    if args.trace:
        trace_check(log=log)
        return 0
    cf.build()

    if args.long or args.recording:
        if args.long and (args.gcc or args.scene):
            if args.gcc:
                gcc(args.reps, log, names=ROUTE_GCC)
            scene(args.reps, log, ROUTE_SCENES)
            if args.scene:
                simulations(smi)
        elif args.long:
            ptxas_report(SPLIT_KERNELS, log)
            k4a(4 * args.reps, log, LONG_MIN)
            boot(2 * args.reps, log, LONG_MIN)
            k6(2 * args.reps, log, LONG_MIN)
            gcc(args.reps, log, LONG_MIN)
        if args.recording:
            recording(smi)
        return 0
    if args.boot:
        boot(2 * args.reps, log)
        return 0
    if args.k10:
        ptxas_report(log=log)
        k10(args.reps, log)
        return 0
    if args.k6 or args.scene or args.gcc:
        if args.k6:
            k6(2 * args.reps, log)
        if args.scene:
            scene(args.reps, log)
        if args.gcc:
            gcc(args.reps, log)
        return 0
    run(args.reps, log)
    if args.k4a:
        k4a(4 * args.reps, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
