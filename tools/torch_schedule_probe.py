"""Probes of the port's schedules on the card, for one tree.

    python tools/torch_schedule_probe.py TREE ptxas,boot,k9big,half

Needs an NVIDIA card.  Imports the port from TREE (a checkout, or a copy
of one with other kernel sources), builds its kernels there at first use
and runs the probes named, each logged beside the tree's name:

- ``ptxas``: the compiler's report (registers, stack, spill bytes) of
  every instantiation of ``boot_rows``, ``boot_rows_long``, ``boot_cols``
  and ``long_cols_max``;
- ``boot``: K4b and K6 against their twins from 2^16 to 2^27
  (``tools/torch_rowdft_bench.py``'s ``boot`` and ``k6`` at
  ``BOOT_SHAPES`` and ``K6_SHAPES``): device time by kernel and the
  largest distance from the twin;
- ``k9big``: K9 at one row pair of 2^29 and 2^30 points, device time by
  kernel, its twin's and the largest distance between them;
- ``half``: K4a's one row at 2^23, 2^24 and 2^25 with ``HALF_LONG_MIN``
  at 2^23, 2^25 (m = nfft / 2 on the split up to 2^24 points) and 2^23
  again: the plan, device time by kernel beside ``torch.fft.rfft``'s and
  the error relative to the spectrum's peak.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import time
import traceback


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    tree, what = sys.argv[1], sys.argv[2].split(",")
    sys.path.insert(0, tree)
    import torch
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(tree, "tools", "torch_rowdft_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    tag = os.path.basename(tree.rstrip("/"))

    def log(msg):
        print(f"[{tag}] {msg}", flush=True)

    start = time.time()
    log(f"build {cf.build():.1f} s")

    def section(name, fn):
        t0 = time.time()
        try:
            fn()
        except Exception:
            log(f"FAILED {name}:\n{traceback.format_exc()[-3000:]}")
        log(f"[{name}] {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()

    def k9big():
        g = torch.Generator(device="cuda").manual_seed(3)
        for nfft, n in ((1 << 29, 268000000), (1 << 30, 400000000)):
            sp = cf.fft_real_plain(torch.randn((2, n), generator=g,
                                               device="cuda"), nfft)
            a, b = sp[:1].contiguous(), sp[1:].contiguous()
            del sp
            mask = cf.band_mask(nfft, None, None, device="cuda")
            got = cf.whitened_corr(a, b, mask, nfft)
            want = cf.whitened_corr_plain(a, b, mask, nfft)
            err = float((got - want).abs().max())
            del got, want
            torch.cuda.empty_cache()
            d = bench.device_ms(lambda: cf.whitened_corr(a, b, mask, nfft), 5)
            p = bench.device_ms(
                lambda: cf.whitened_corr_plain(a, b, mask, nfft), 3)
            log(f"K9 1 pair x {n} -> {nfft}: device {d['total']:.4f} ms "
                f"({bench._split(d)}); twin {p['total']:.4f} ms; max "
                f"|kernel - twin| {err:.3e}")
            del a, b
            torch.cuda.empty_cache()

    def half():
        g = torch.Generator(device="cuda").manual_seed(4)
        for limit in (1 << 23, 1 << 25, 1 << 23):
            cf.HALF_LONG_MIN = limit
            cf._half_post.cache_clear()
            for nfft, n in ((1 << 23, 4200000), (1 << 24, 8400000),
                            (1 << 25, 16800000)):
                x = torch.randn((1, n), generator=g, device="cuda")
                try:
                    plan = cf.half_plan(nfft)
                    got = cf.fft_real(x, nfft)
                    want = cf.fft_real_plain(x, nfft)
                    err = float((got - want).abs().max()
                                / want.abs().max())
                    del got, want
                    d = bench.device_ms(lambda: cf.fft_real(x, nfft), 20)
                    r = bench.device_ms(lambda: torch.fft.rfft(x, n=nfft), 20)
                    log(f"HALF_LONG_MIN {limit}: K4a 1 x {n} -> {nfft} plan "
                        f"{tuple(plan)}: {d['total']:.4f} ms "
                        f"({bench._split(d)}); rfft {r['total']:.4f}; ratio "
                        f"{d['total'] / r['total']:.3f}; rel err {err:.2e}")
                except Exception:
                    log(f"HALF_LONG_MIN {limit} nfft {nfft} FAILED "
                        f"{traceback.format_exc()[-1500:]}")
        cf.HALF_LONG_MIN = 1 << 23
        cf._half_post.cache_clear()

    if "ptxas" in what:
        section("ptxas", lambda: bench.ptxas_report(
            ("boot_rows", "boot_cols", "long_cols_max"), log))
    if "boot" in what:
        section("k4b", lambda: bench.boot(6, log, 1 << 16, 1 << 27))
        section("k6", lambda: bench.k6(6, log, 1 << 16, 1 << 27))
    if "k9big" in what:
        section("k9big", k9big)
    if "half" in what:
        section("half", half)
    log(f"total {time.time() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
