"""A/B bench of the port's FFT schedules on the card: the row DFT on the
tensor cores (K10a) against radix-2 passes through device memory (K10b).

The counterpart of ``tools/mxu_rowdft_bench.py``'s ``bench``/``main``
(:499-577), at its shapes (n2, B) = (64, 4096), (128, 2048), (256, 1024),
(512, 1024), (1024, 512): (B, n2, 128) float32 planes, N = n2 * 128.  For
each shape, CUDA-event times (ms per call over the whole batch) of

- the row DFT by stages and by the tensor cores at rep 1 and 8, and the
  compute-only estimate (rep8 - rep1) / 7 (the plane's read and write
  drop out);
- the lane DFT (K10c);
- the full forward of real rows by both schedules (``fft_four_step``),
  and with ``zero_top`` (the lower n2/2 rows only);
- the GCC-like chain by both schedules (n2 >= 512, as the TPU tool), fed
  four planes of their own;
- the plain twins of the row and lane DFTs (``row_dft_plain``,
  ``lane_dft_plain``);
- yardsticks: ``torch.fft.fft`` along the row and the lane axis of the
  complex plane, ``torch.fft.fft`` of the flat real row, and the port's
  production K4a (``cuda_fft.fft_real``) at the same N.

Every kernel case's first (warm-up) call is held against its plain twin on
the same inputs, within ``rowdft.TRANSFORM_TOL`` of max|twin| (the chain
within ``rowdft.CHAIN_TOL``); a miss raises.

It imports numpy and torch only.  Run from the repository root on the
machine with the card:

    python tools/torch_rowdft_bench.py [--reps 5]

``chip_smoke.py`` runs it once as its phase 7 (``run``).
"""

from __future__ import annotations

import argparse
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


def time_ms(fn, reps: int):
    """(the output of a first, warm-up call, mean device time of ``fn``
    over the next ``reps`` calls)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


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
        "k4a": (lambda: cf.fft_real(flat, n2 * rd.N1), None, None),
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
           f"fft_real {ms['k4a']:.4f}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
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
    run(args.reps, lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
