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
shapes (``K4A_SHAPES``).

It imports numpy and torch only.  Run from the repository root on the
machine with the card:

    python tools/torch_rowdft_bench.py [--reps 5] [--k4a]

``chip_smoke.py`` runs it once as its phase 7 (``run``).
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
# api's single row, the single pair, max_expected_delay=None, and 1024 rows.
K4A_TOL = 5e-6
K4A_SHAPES = ((1, 44100, 65536), (2, 44100, 65536), (1, 44100, 131072),
              (1024, 65536, 65536))


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


def device_ms(fn, calls: int = 20) -> dict:
    """Device time per call of ``fn`` by kernel (the sum of each kernel's
    durations in a ``torch.profiler`` trace of CUDA activity over
    ``calls`` warm calls, divided by ``calls``), with their total under
    "total".  Unlike CUDA events around a loop it leaves out the host's
    time between launches."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a process's first trace may miss kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1].split()[-1]
            out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / calls
    out["total"] = sum(out.values())
    return out


def k4a(reps: int = 20, log=print) -> dict:
    """K4a against ``torch.fft.rfft`` at ``K4A_SHAPES``, each held against
    its twin: CUDA-event ms per call (``time_ms``, five loops) and device
    ms per call (``device_ms``, by kernel).
    Logs one line per shape and returns {shape: {"k4a", "rfft",
    "k4a_device", "rfft_device"}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for rows, length, nfft in K4A_SHAPES:
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
        split = ", ".join(f"{k} {v:.4f}" for k, v in
                          res["k4a_device"].items() if k != "total")
        log(f"K4a {shape}: fft_real {res['k4a']:.4f} ms, torch.fft.rfft "
            f"{res['rfft']:.4f} ms ({res['k4a'] / res['rfft']:.2f}x); "
            f"device fft_real {res['k4a_device']['total']:.4f} ms ({split}),"
            f" torch.fft.rfft {res['rfft_device']['total']:.4f} ms")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--k4a", action="store_true",
                    help="also time K4a at the production shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_rowdft_bench: needs an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    cf.build()
    def log(msg):
        print(msg, flush=True)

    run(args.reps, log)
    if args.k4a:
        k4a(4 * args.reps, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
