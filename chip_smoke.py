#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Drives the port's main paths on ``cuda`` at full width (4 mics, 44.1 kHz,
1 s, nfft 65,536), in five phases:

1. device report (``nvidia-smi`` name and power limit);
2. build of the kernels from ``pyaudiolocalization_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at an edge shape, with kernel and plain times taken in
   turns, the least time the card could take (``bound_ms``) and, where one
   PyTorch call computes the same function, that call's time;
4. ``localize_sound_source`` in physical mode
   (``python -m pyaudiolocalization_tpu_torch --physical --no-calibration
   --no-plots``) on the demo scene and an off-centre chirp scene, cold and
   warm, held against ``tests/data/torch_slice_golden.json`` (TDOAs within
   0.05 samples, position within 5 mm, ``significant`` equal); then the
   demo scene with ``analyze_correlation=False``, which takes the windowed
   fast path, held against ``tests/data/torch_sweep_golden.json``;
5. the batched Monte-Carlo sweep at ``bench.py``'s ``bench_full_sweep``
   spec on 512 scenes: the fused path (K5) against the split path (K3 with
   noise, then K2) per scene on the same draws, the hit rate and median
   error against the JAX sweep's, ``localize_batch`` on 256 numpy-built
   scenes against the JAX answers for the first 64, warm scenes/s, and a
   stage breakdown.

Every path runs with the launch counts set to 0 just before it and read
just after; each must have launched its kernels.  Any failure raises, and
the script exits non-zero.  The last line is ``{"ok": true, "device":
{...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SLICE_GOLDEN = REPO / "tests" / "data" / "torch_slice_golden.json"
SWEEP_GOLDEN = REPO / "tests" / "data" / "torch_sweep_golden.json"
FS = 44100.0
NFFT = 65536
N = 44100
SWEEP_SCENES = 512
BATCH_SCENES = 256
# H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside the
# tensor cores (at the full 700 W power limit).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
CSRC = "pyaudiolocalization_tpu_torch/csrc/kernels.cu"
PALLAS = "pyaudiolocalization_tpu/ops/pallas_fft.py"

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "delay_sum": (CSRC, f"{PALLAS}:1851"),
    "gcc_all_pairs": (CSRC, f"{PALLAS}:922"),
    "gcc_windowed": (CSRC, f"{PALLAS}:1095"),
    "fft_real": (CSRC, f"{PALLAS}:685"),
    "bootstrap_peaks": (CSRC, f"{PALLAS}:1227"),
    "scene_windowed": (CSRC, f"{PALLAS}:1600"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Bounds: the larger of bytes / HBM rate and operations / float32 rate.
# Bytes count each input read once and each output written once; a complex
# N-point FFT counts 5 N log2 N operations, a real one half that.
# ---------------------------------------------------------------------------

def _rfft_ops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gcc_ops(scenes, mics, pairs, n):
    """Forward spectra, whitening (~15 operations a bin) and inverses."""
    return scenes * ((mics + pairs) * _rfft_ops(n) + pairs * (n // 2) * 15)


def render_ops(scenes, mics, paths, n, out, noise):
    """Base spectra, ramp synthesis (~20 operations a path and bin),
    inverses, finalize (~10 a sample) and Philox + Box-Muller (~80)."""
    return scenes * (_rfft_ops(n) + mics * (
        _rfft_ops(n) + paths * (n // 2) * 20 + out * (10 + 80 * noise)))


def compare(name, kernel_fn, plain_fn, tol, reps, least, scale_by_max=False,
            library_fn=None):
    """Kernel vs plain on the same inputs: the max abs error, checked
    against ``tol`` (relative to max|plain| when ``scale_by_max``), and the
    times, measured in turns (plain, kernel, kernel, plain).  Outputs may
    be tuples of tensors.  ``least`` is (bound ms, what sets it).  Logs one
    line; returns (error, kernel ms, plain ms, library ms or None, bound
    ms, what sets it)."""
    import torch
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    limit = tol
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: kernel output shape "
                                 f"{tuple(g.shape)} or non-finite values")
        err = max(err, float((g - w).abs().max()))
        if scale_by_max:
            limit = tol * float(w.abs().max())
    if not err <= limit:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} > "
                             f"{limit:.3e}")
    p1 = time_ms(plain_fn, reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, reps)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    lib_ms = time_ms(library_fn, reps) if library_fn is not None else None
    log(f"{name}: max_abs_err={err:.3e} (limit {limit:.3e}) kernel "
        f"{k_ms:.4f} ms plain {p_ms:.4f} ms"
        + (f" library {lib_ms:.4f} ms" if lib_ms is not None else "")
        + f" bound {least[0]:.5f} ms ({least[1]})")
    return (err, k_ms, p_ms, lib_ms) + tuple(least)


def kernel_phase(cf, torch):
    """Phase 3: every kernel against its plain version on the card, at the
    main paths' shapes ("main", recorded) and edge shapes.  Tolerances are
    float32's: transforms of log2(nfft) radix-2 passes in the kernel and in
    cuFFT, on values bounded by 1 (correlations, peaks, finalized renders)
    or relative to the spectrum's peak (fft_real); noisy renders add the
    Philox normals, equal integers in both, float32 log/cos within a few
    units in the last place."""
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def pairs(m):
        pp = [(i, j) for i in range(m) for j in range(i + 1, m)]
        return [p[0] for p in pp], [p[1] for p in pp]

    def scene_inputs(b, m, paths, total, out):
        base = torch.zeros((b, total), device=dev)
        base[:, :out] = randn(b, out)
        tau = (rand(b, m, paths) * (total - out)).contiguous()
        gains = rand(b, m, paths)
        gains[..., 0] = 1.0  # the strongest path has gain 1 (scene_paths)
        snr = 20.0 + 20.0 * rand(b)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (b, 2), generator=gen,
                              dtype=torch.int32, device=dev)
        fade = fade_window(total, dtype=torch.float32,
                           device=dev)[:out].contiguous()
        return base, tau, gains.contiguous(), snr, seeds, fade

    results = {}
    # K3: render with finalize.  Main paths: the sweep's split render (512
    # scenes, 1 path, noise, 44,356 padded samples) and the single scene's
    # (22 paths = direct + 21 image sources of 3 planes at order 3, 50,292
    # padded samples, no noise).
    for tag, (b, m, paths, total, out, nfft, noise) in {
            "main": (SWEEP_SCENES, 4, 1, 44356, N, NFFT, True),
            "scene": (1, 4, 22, 50292, N, NFFT, True),
            "api": (1, 4, 22, 50292, N, NFFT, False),
            "edge": (3, 3, 5, 3500, 3000, 4096, True)}.items():
        base, tau, gains, snr, seeds, fade = scene_inputs(b, m, paths,
                                                          total, out)
        nz = (snr, seeds) if noise else (None, None)
        nbytes = 4 * (b * total + 2 * b * m * paths + out + 3 * b * noise
                      + b * m * out)
        res = compare(
            f"delay_sum[{tag}] B={b} M={m} paths={paths} nfft={nfft} "
            f"out={out} noise={noise}",
            lambda: cf.delay_sum(base, tau, gains, nfft, out, fade, True,
                                 *nz),
            lambda: cf.delay_sum_plain(base, tau, gains, nfft, out, fade,
                                       True, *nz),
            tol=2e-5, reps=3 if b > 1 else 20,
            least=bound(nbytes, render_ops(b, m, paths, nfft, out, noise)))
        if tag == "main":
            results["delay_sum"] = res

    # K1: all-pairs GCC-PHAT, band (300, 3400) Hz.
    for tag, (m, length, nfft) in {"main": (4, N, NFFT),
                                   "edge": (3, 3000, 4096)}.items():
        pi, pj = pairs(m)
        sig = randn(m, length).contiguous()
        mask = cf.band_mask(nfft, (300.0, 3400.0), FS, device=dev)
        nbytes = 4 * (m * length + len(pi) * nfft + nfft // 2 + 1)
        res = compare(
            f"gcc_all_pairs[{tag}] M={m} P={len(pi)} nfft={nfft}",
            lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
            lambda: cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask),
            tol=1e-6, reps=20,
            least=bound(nbytes, gcc_ops(1, m, len(pi), nfft)))
        if tag == "main":
            results["gcc_all_pairs"] = res

    # K2: windowed GCC.  Main: the sweep's (512 scenes, wq 6); also the
    # api fast path's single scene (wq 21) and an odd edge shape.
    for tag, (b, m, length, nfft, wq) in {
            "main": (SWEEP_SCENES, 4, N, NFFT, 6),
            "api": (1, 4, N, NFFT, 21),
            "edge": (2, 3, 3000, 4096, 2)}.items():
        pi, pj = pairs(m)
        sig = randn(b, m, length).contiguous()
        mask = cf.band_mask(nfft, (300.0, 3400.0), FS, device=dev)
        p = len(pi)
        nbytes = 4 * (b * m * length + nfft // 2 + 1
                      + b * p * (2 * wq * 128 + 3))
        res = compare(
            f"gcc_windowed[{tag}] B={b} M={m} P={p} nfft={nfft} wq={wq}",
            lambda: cf.gcc_windowed(sig, pi, pj, nfft, wq, mask),
            lambda: cf.gcc_windowed_plain(sig, pi, pj, nfft, wq, mask),
            tol=1e-6, reps=3 if b > 1 else 20,
            least=bound(nbytes, gcc_ops(b, m, p, nfft) + 3 * b * p * nfft))
        if tag == "main":
            results["gcc_windowed"] = res

    # K4a + K4b: bootstrap null at 1000 permuted rows (edge: 999 rows).
    for tag, (rows_n, length, nfft) in {"main": (1000, N, NFFT),
                                        "edge": (999, 3000, 4096)}.items():
        sig1 = randn(1, length).contiguous()
        sig2 = randn(length)
        keys = rand(rows_n, length)
        rows = sig2[torch.argsort(keys, dim=-1)].contiguous()
        res_a = compare(
            f"fft_real[{tag}] rows=1 len={length} nfft={nfft}",
            lambda: cf.fft_real(sig1, nfft),
            lambda: cf.fft_real_plain(sig1, nfft), tol=5e-6, reps=20,
            least=bound(4 * length + 8 * (nfft // 2 + 1), _rfft_ops(nfft)),
            scale_by_max=True,
            library_fn=lambda: torch.fft.rfft(sig1, n=nfft))
        s1 = cf.fft_real_plain(sig1, nfft)[0].contiguous()
        res_b = compare(
            f"bootstrap_peaks[{tag}] rows={rows_n} len={length} nfft={nfft}",
            lambda: cf.bootstrap_peaks(s1, rows, nfft),
            lambda: cf.bootstrap_peaks_plain(s1, rows, nfft),
            tol=1e-6, reps=3,
            least=bound(8 * (nfft // 2 + 1) + 4 * rows_n * (length + 1),
                        rows_n * (2 * _rfft_ops(nfft) + (nfft // 2) * 15)))
        if tag == "main":
            results["fft_real"] = res_a
            results["bootstrap_peaks"] = res_b

    # K5: the whole scene.  Main: the sweep's 512 scenes; edge: out == nfft.
    for tag, (b, m, paths, total, out, nfft, wq) in {
            "main": (SWEEP_SCENES, 4, 1, 44356, N, NFFT, 6),
            "edge": (2, 2, 2, 1024, 1024, 1024, 2)}.items():
        pi, pj = pairs(m)
        base, tau, gains, snr, seeds, fade = scene_inputs(b, m, paths,
                                                          total, out)
        mask = cf.band_mask(nfft, (300.0, 3400.0), FS, device=dev)
        p = len(pi)
        nbytes = 4 * (b * total + 2 * b * m * paths + out + 3 * b
                      + nfft // 2 + 1 + b * p * (2 * wq * 128 + 3))
        res = compare(
            f"scene_windowed[{tag}] B={b} M={m} paths={paths} nfft={nfft} "
            f"out={out} wq={wq}",
            lambda: cf.scene_windowed(base, tau, gains, pi, pj, nfft, out,
                                      wq, fade, mask, snr, seeds),
            lambda: cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft,
                                            out, wq, fade, mask, snr, seeds),
            tol=1e-5, reps=3,
            least=bound(nbytes, render_ops(b, m, paths, nfft, out, 1)
                        + gcc_ops(b, m, p, nfft) + 3 * b * p * nfft))
        split = cf.gcc_windowed(cf.delay_sum(base, tau, gains, nfft, out,
                                             fade, True, snr, seeds),
                                pi, pj, nfft, wq, mask)
        fused = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq,
                                  fade, mask, snr, seeds)
        gap = max(float((a - c).abs().max()) for a, c in zip(fused, split))
        log(f"scene_windowed[{tag}] vs delay_sum -> gcc_windowed kernels: "
            f"max |diff| = {gap:.3e}")
        if gap > 1e-6:
            raise AssertionError(f"scene_windowed[{tag}] departs from the "
                                 f"split kernels by {gap:.3e}")
        if tag == "main":
            results["scene_windowed"] = res
    return results


# ---------------------------------------------------------------------------
# Phase 4: localize_sound_source
# ---------------------------------------------------------------------------

def scene_configs(default_config):
    base = copy.deepcopy(default_config)
    base["localization"]["lag_mode"] = "physical"
    base["localization"]["sync_mode"] = "none"
    off = copy.deepcopy(base)
    off["source_position"] = [0.2, 0.6, 0.4]
    off["signal_type"] = "chirp"
    return {"default": base, "off_centre": off}


def check_scene(name, res, want, seconds, run):
    est = [float(v) for v in res["estimated_position"]]
    tdoas = [float(v) for v in res["tdoas"]]
    td_err = max(abs(a - b) for a, b in zip(tdoas, want["tdoas"]))
    pos_err = sum((a - b) ** 2 for a, b in
                  zip(est, want["estimated_position"])) ** 0.5
    log(f"main path {name} {run}: {seconds:.3f} s wall, position "
        f"{[round(v, 5) for v in est]} (golden delta {pos_err:.2e} m), max "
        f"TDOA delta {td_err * FS:.3f} samples")
    if not all(map(math.isfinite, est + tdoas)):
        raise AssertionError(f"{name}: non-finite output")
    if td_err > 0.05 / FS:
        raise AssertionError(f"{name}: TDOAs {tdoas} vs golden "
                             f"{want['tdoas']}")
    if pos_err > 5e-3:
        raise AssertionError(f"{name}: position {est} vs golden "
                             f"{want['estimated_position']}")


def run_path(cf, name, fn, expect, forbid=()):
    """Runs ``fn`` with every launch count set to 0 just before and read
    just after; every kernel in ``expect`` must have launched, none in
    ``forbid``.  Returns (fn's result, the counts)."""
    cf.reset_launches()
    out = fn()
    counts = dict(cf.LAUNCHES)
    log(f"launches on {name}: {counts}")
    missing = [k for k in expect if counts[k] == 0]
    extra = [k for k in forbid if counts[k] != 0]
    if missing or extra:
        raise AssertionError(f"{name}: kernels not launched {missing}, "
                             f"launched though off the path {extra}")
    return out, counts


def main_path_phase(cf, torch, slice_golden, sweep_golden, launches):
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import localize_sound_source

    def timed(cfg):
        start = time.perf_counter()
        res = localize_sound_source(cfg, device="cuda", dtype=torch.float32)
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    def full_path():
        for name, cfg in scene_configs(DEFAULT_CONFIG).items():
            want = slice_golden["scenes"][name]
            for run in ("cold", "warm"):
                res, seconds = timed(cfg)
                check_scene(name, res, want, seconds, run)
                pairs = sorted(res["correlation_metrics"])
                sig = [res["correlation_metrics"][p]["significant"]
                       for p in pairs]
                if [list(p) for p in pairs] != want["pairs"]:
                    raise AssertionError(f"{name}: pair order {pairs}")
                if sig != want["significant"]:
                    raise AssertionError(f"{name}: significant {sig} vs "
                                         f"golden {want['significant']}")

    def fast_path():
        cfg = scene_configs(DEFAULT_CONFIG)["default"]
        cfg["localization"]["analyze_correlation"] = False
        cfg["localization"]["visualize_correlation"] = False
        for run in ("cold", "warm"):
            res, seconds = timed(cfg)
            check_scene("fast_path", res, sweep_golden["fast_path"],
                        seconds, run)

    _, counts = run_path(cf, "the full main path", full_path,
                         ("delay_sum", "gcc_all_pairs", "fft_real",
                          "bootstrap_peaks"))
    _add(launches, counts)
    _, counts = run_path(cf, "the windowed fast path", fast_path,
                         ("delay_sum", "gcc_windowed"),
                         ("gcc_all_pairs", "bootstrap_peaks"))
    _add(launches, counts)


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


# ---------------------------------------------------------------------------
# Phase 5: the sweep
# ---------------------------------------------------------------------------

def _load_scene_builder():
    path = REPO / "tools" / "torch_sweep_golden.py"
    spec = importlib.util.spec_from_file_location("torch_sweep_golden",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _wall(torch, fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def sweep_stages(torch, sw, spec):
    """Warm stage breakdown of one fused 512-scene sweep, each stage timed
    with a synchronize on both sides."""
    from pyaudiolocalization_tpu_torch.models import tdoa as tdoa_ops
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    c = spec.speed_of_sound
    dt = torch.float32
    times = {}

    def stage(name, fn):
        out, seconds = _wall(torch, fn)
        times[name] = seconds * 1e3
        return out

    sources, mics, snr = stage("draw scenes", lambda: sw._random_scene(
        spec, gen, SWEEP_SCENES, dt, dev))
    base, seeds = stage("draw base signals + seeds", lambda: sw._draw_signals(
        spec, gen, SWEEP_SCENES, dt, dev))
    paths = stage("paths", lambda: sw._source_paths(spec, sources, mics, c))
    pi, pj = spec.pairs
    wq = sw._tdoa_window_wq(spec)

    def k5():
        padded = torch.zeros((SWEEP_SCENES, spec.total_samples), device=dev)
        padded[:, :spec.num_samples] = base
        fade = fade_window(spec.total_samples, dtype=dt,
                           device=dev)[:spec.num_samples].contiguous()
        return cf.scene_windowed(
            padded, (paths.delays * spec.fs).contiguous(),
            paths.gains.contiguous(), pi, pj, spec.nfft, spec.num_samples,
            wq, fade, sw._band_mask(spec, base),
            snr_db=snr.contiguous(), seeds=seeds)

    win, stats = stage("K5 scene_windowed", k5)
    td = stage("windowed TDOA ladder", lambda: -tdoa_ops.
               tdoa_single_from_window(win, stats, wq, spec.nfft, spec.fs,
                                       spec.max_tdoa))
    est, _ = stage("k-means + multi-start LM", lambda: sw._solve_from_td(
        spec, mics, td, c, gen))
    stage("covariance + summary", lambda: sw.uncertainty_ops.
          position_covariance(est, mics, pi, pj, td, c))
    total = sum(times.values())
    for name, ms in times.items():
        log(f"  sweep stage {name}: {ms:.3f} ms ({100 * ms / total:.1f} %)")
    log(f"  sweep stages total: {total:.3f} ms for {SWEEP_SCENES} scenes")


def sweep_phase(cf, torch, sweep_golden, launches):
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    spec = sw.SweepSpec(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in sweep_golden["spec"].items()})
    if not sw._mono_scene_eligible(spec):
        raise AssertionError("the full-width sweep spec misses the fused "
                             "path")

    # (a) the sweep (fused by its gate) vs the split path on the same
    # draws (the same seed on the same device).
    summary, counts = run_path(
        cf, "the sweep (fused path)", lambda: sw.monte_carlo_sweep(
            spec, 7, SWEEP_SCENES, device="cuda"),
        ("scene_windowed",), ("delay_sum", "gcc_windowed"))
    _add(launches, counts)
    fused = summary.results
    gen = torch.Generator(device="cuda").manual_seed(7)
    split, counts = run_path(
        cf, "the split sweep", lambda: sw._run_scenes(
            spec, gen, SWEEP_SCENES, torch.float32, False),
        ("delay_sum", "gcc_windowed"), ("scene_windowed",))
    _add(launches, counts)
    td_gap = float((fused.tdoas - split.tdoas).abs().max()) * spec.fs
    pos_gap = float((fused.estimate - split.estimate).abs().max())
    log(f"fused vs split over {SWEEP_SCENES} scenes: max TDOA difference "
        f"{td_gap:.4f} samples, max estimate difference {pos_gap:.3e} m")
    if not (td_gap < 0.5 and pos_gap < 1e-3):
        raise AssertionError("fused and split sweep paths disagree")
    if not bool(torch.isfinite(fused.estimate).all()):
        raise AssertionError("non-finite sweep estimates")

    # (b) statistics against the JAX sweep.
    err = fused.error.double().cpu()
    hit = float((err < 0.1).double().mean())
    median = float(err.median())
    want = sweep_golden["sweep"]
    n1, n2 = err.numel(), want["num_scenes"]
    pooled = (hit * n1 + want["hit_rate"] * n2) / (n1 + n2)
    pooled = min(max(pooled, 1.0 / (n1 + n2)), 1.0 - 1.0 / (n1 + n2))
    sigma = math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    log(f"sweep statistics: hit rate {hit:.4f} (JAX {want['hit_rate']:.4f},"
        f" 3 sigma = {3 * sigma:.4f}), median error {median:.5f} m (JAX "
        f"{want['median_error_m']:.5f} m), rmse "
        f"{float(err.pow(2).mean().sqrt()):.5f} m")
    if abs(hit - want["hit_rate"]) > 3 * sigma:
        raise AssertionError("sweep hit rate departs from the JAX sweep's")
    # A broken estimator moves the median by orders of magnitude; two
    # draws of 128 and 512 scenes move it by well under a factor of 2.
    if not want["median_error_m"] / 2 <= median <= 2 * want["median_error_m"]:
        raise AssertionError("sweep median error departs from the JAX "
                             "sweep's by more than a factor of 2")

    # (c) localize_batch on numpy-built scenes.
    builder = _load_scene_builder()
    signals, _ = builder.batch_scenes(
        sweep_golden["localize_batch"]["seed"], BATCH_SCENES, spec.fs,
        spec.duration, spec.mic_positions, spec.speed_of_sound,
        spec.source_box_lo, spec.source_box_hi)
    signals = torch.as_tensor(signals, device="cuda")
    (est, _, td), counts = run_path(
        cf, "localize_batch", lambda: sw.localize_batch(
            spec, signals, spec.mic_positions, 3, device="cuda"),
        ("gcc_windowed",), ("delay_sum", "scene_windowed"))
    _add(launches, counts)
    k = sweep_golden["localize_batch"]["num_scenes"]
    want_td = torch.tensor(sweep_golden["localize_batch"]["tdoas"])
    want_est = torch.tensor(sweep_golden["localize_batch"]["estimates"])
    td_gap = float((td[:k].double().cpu() - want_td).abs().max()) * spec.fs
    pos_gap = float((est[:k].double().cpu() - want_est).norm(dim=-1).max())
    log(f"localize_batch vs JAX on the first {k} of {BATCH_SCENES} scenes: "
        f"max TDOA difference {td_gap:.4f} samples, max position "
        f"difference {pos_gap:.3e} m")
    if not (td_gap < 0.05 and pos_gap < 5e-3):
        raise AssertionError("localize_batch departs from the JAX answers")

    # Warm throughput: host wall clock around work that ends in a sync.
    _, sweep_s = _wall(torch, lambda: sw.monte_carlo_sweep(
        spec, 21, SWEEP_SCENES, device="cuda"))
    _, batch_s = _wall(torch, lambda: sw.localize_batch(
        spec, signals, spec.mic_positions, 4, device="cuda"))
    log(f"warm monte_carlo_sweep: {SWEEP_SCENES / sweep_s:.1f} scenes/s "
        f"({sweep_s:.3f} s for {SWEEP_SCENES} scenes)")
    log(f"warm localize_batch: {BATCH_SCENES / batch_s:.1f} scenes/s "
        f"({batch_s:.3f} s for {BATCH_SCENES} scenes)")
    sweep_stages(torch, sw, spec)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (REPO / "pyaudiolocalization_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    # Full float32 everywhere in the reference computations.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slice_golden = json.loads(SLICE_GOLDEN.read_text())
    sweep_golden = json.loads(SWEEP_GOLDEN.read_text())

    # Phase 1: device.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} ({smi})")

    # Phase 2: build.
    build_s = cf.build()
    log(f"kernel build: {build_s:.2f} s")
    ptxas = cf.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {line.strip()}")

    # Phase 3: kernels against their plain versions.
    results = kernel_phase(cf, torch)

    # Phases 4 and 5: the main paths, each with its own launch counts.
    launches = {name: 0 for name in KERNELS}
    main_path_phase(cf, torch, slice_golden, sweep_golden, launches)
    sweep_phase(cf, torch, sweep_golden, launches)
    log(f"launches over the main paths: {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main paths: "
                             f"{missing}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, k_ms, p_ms, lib_ms, b_ms, b_by = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
