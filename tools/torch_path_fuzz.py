"""On-card fuzz of the port's kernel paths against their plain twins: the
counterpart of tools/tpu_path_fuzz.py and tools/tpu_kernel_check.py.

Configurations come from a fixed numpy seed (``configs``): random mic
arrays of 2 to 12 mics (odd counts included) and one of 64, fs of 8, 16,
44.1 and 48 kHz, durations whose transform runs from 512 to 131,072
points, free field and eval_sweep.py's ``ROOM6`` (6 planes, order 2),
solvers ``lm`` and ``srp``, and five single pairs up to a transform of
2^22.  Together they reach every sweep route the card runs (``route``
names each configuration's): K5 fused (parallel/sweep.py
``_sim_est_fused``), K3 then K2 on the split (``_simulate`` +
``_estimate``), K1 on the full-correlation branch in one block, on the
split with ``gcc_rows`` and, where those do not fit, through its mic
rows' spectra (``cuda_fft.gcc_route``): in one block with 11 mics at
4,096 ("spectra block"), on the split with 64 mics at 65,536 ("spectra
256", standing in for tpu_kernel_check.py's check (b), the GCC beyond
the split's strips), K2 / K3 / K5 in one block at nfft <= 4,096 and,
with 12 mics at 4,096, K2 and K5's GCC stage through the spectra in one
block, where a scene's rows do not fit one, and K4a + K9 through
``models.tdoa.get_time_delays_phat`` at random lengths, above 2^20 both
on their split of 8-wide strips (2^21, 2^22: "split 2048").

For each configuration the scenes are drawn and rendered on the card
(K3), then localized twice: on the card (the kernels: the fused K5 path
where it is eligible, and the split path) and from the same signals
copied to the CPU in float32 (the plain twins, ``cuda_fft._use_plain``).
The limits are tpu_path_fuzz.py's: TDOAs within 0.5 sample, estimates
within 1 mm; the CPU run replays the card's k-means++ seed indices, so
both solve from the same starts.  A scene whose CPU run shows a near-tie
of its TDOA ladder — a pair's correlation peak within ``TIE`` (relative)
of its best value two or more lags away — is reported and counted, not
held, and at most one scene in ten may be such a tie.  A scene whose SRP
coarse map ties — its maximum within ``TIE`` of its best cell more than
one cell away (the repo's coarse margin; the pooled map's plateau often
ties exactly there) — has its TDOAs held and its SRP fix reported and
counted: the coarse cell, and with it the fine stage's fix, is then
decided by rounding on either device.  Estimates are held where the
array fixes a point (4 mics or more); with 2 or 3 mics the TDOAs leave a
surface or a curve of equal cost, and the solver's point on it moves with
rounding, so those configurations hold their TDOAs only.

tpu_kernel_check.py's checks (a), the in-kernel noise statistics, and
(c), the whole-scene kernel against the split, are held by chip_smoke.py
already: phase 3 checks K3's Philox noise in distribution, and phase 5
the fused sweep against the split to the bit at 512 and 21,846 scenes.

It imports torch, numpy and the port, never jax.  On the card:

    python tools/torch_path_fuzz.py

prints one JSON line a configuration (its route, the kernels it
launched, the largest TDOA and estimate differences, its ties) and exits
0 when every configuration holds.  ``--device cpu`` rehearses the control
flow on the CPU: both halves then run the plain twins, so it compares
the plain path with itself and launches nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CONFIG_SEED = 7
TD_SAMPLES = 0.5
EST_M = 1e-3
TIE = 1e-5
TIE_SHARE = 0.1
ROOM6 = dict(
    plane_coeffs=((1.0, 0, 0, 0.5), (1.0, 0, 0, -5.5), (0, 1.0, 0, 0.5),
                  (0, 1.0, 0, -6.5), (0, 0, 1.0, 0.5), (0, 0, 1.0, -3.0)),
    plane_material_ids=(1, 1, 2, 2, 1, 1),
    max_reflections=2)
# (solver, reverberant, mics, fs, transform, scenes): what each reaches.
SWEEPS = (
    ("lm", False, 4, 16000.0, 4096, 4),     # K5 / K3 / K2 in one block
    ("lm", False, 5, 8000.0, 512, 4),       # the shortest transform
    ("lm", False, 3, 48000.0, 16384, 4),    # K5 / K3 / K2 on the split
    ("lm", True, 7, 16000.0, 8192, 4),      # reverberant, on the split
    ("lm", False, 9, 44100.0, 131072, 4),   # the longest sweep transform
    ("lm", False, 2, 16000.0, 1024, 4),     # a single pair
    ("srp", False, 4, 16000.0, 4096, 4),    # K1 in one block
    ("srp", True, 8, 16000.0, 4096, 4),     # K1 in one block, reverberant
    ("srp", False, 11, 8000.0, 4096, 4),    # K1 on the spectra, one block
    ("srp", False, 6, 44100.0, 65536, 4),   # K1 on the split
    ("srp", False, 12, 48000.0, 32768, 4),  # K1 on the split, 66 pairs
    ("srp", False, 64, 16000.0, 65536, 2),  # K1 on the spectra, split
    ("lm", False, 12, 16000.0, 4096, 4),    # K2 / K5's GCC on the spectra
)
# (fs, transform) of the single pairs: one block, the split, 2^20 (the
# longest split of strips of 16), and 2^21 and 2^22, where K4a's and K9's
# split takes strips of 8.  A pair added later goes last, so that the
# earlier configurations keep their draws.
PAIRS = ((8000.0, 4096), (16000.0, 65536), (48000.0, 1 << 20),
         (44100.0, 1 << 21), (48000.0, 1 << 22))


def configs(seed: int = CONFIG_SEED) -> List[dict]:
    """The configurations, drawn from numpy ``seed``: each sweep's mic
    positions (uniform in the unit cube) and duration (its sample count
    uniform in 0.55-0.9 of the transform), each pair's length (0.55-0.95
    of half the transform) and delay (uniform +-20 samples)."""
    rng = np.random.default_rng(seed)
    out = []
    for solver, room, mics, fs, nfft, scenes in SWEEPS:
        pos = rng.uniform(0.0, 1.0, (mics, 3))
        n = int(nfft * rng.uniform(0.55, 0.9))
        out.append(dict(kind="sweep", solver=solver, room=room, fs=fs,
                        duration=n / fs, scenes=scenes,
                        mic_positions=pos.round(6).tolist(),
                        seed=int(rng.integers(0, 2 ** 31))))
    for fs, nfft in PAIRS:
        n = int(nfft / 2 * rng.uniform(0.55, 0.95))
        out.append(dict(kind="pair", fs=fs, length=n, nfft=nfft,
                        delay=float(rng.uniform(-20.0, 20.0)),
                        seed=int(rng.integers(0, 2 ** 31))))
    return out


def sweep_spec(cfg: dict):
    from pyaudiolocalization_tpu_torch.parallel import SweepSpec
    return SweepSpec(fs=cfg["fs"], duration=cfg["duration"],
                     signal_type="noise", solver=cfg["solver"],
                     mic_positions=tuple(map(tuple, cfg["mic_positions"])),
                     source_box_lo=(0.2,) * 3, source_box_hi=(0.8,) * 3,
                     snr_db=(20.0, 35.0), **(ROOM6 if cfg["room"] else {}))


def _stage(n1: int) -> str:
    return "block" if n1 == 1 else f"split {n1}"


def _gcc_stage(route) -> str:
    """A GCC or render route's label: "block", "split n1" (``gcc_rows``,
    ``render_rows``), "spectra n1", "spectra block" or "long"."""
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    if route.kind == cf.ROUTE_ROWS:
        return f"split {route.n1}"
    if route.kind == cf.ROUTE_SPECTRA:
        return f"spectra {route.n1}"
    return cf.ROUTE_NAMES[route.kind]


def route(cfg: dict) -> Dict[str, tuple]:
    """{kernel: (nfft, n1, ..., schedule)} that ``cfg`` launches on the
    card, by the wrappers' own schedule rules (``cuda_fft.render_route``,
    ``gcc_route``, ``_split_n1``,
    ``corr_schedule``); the GCCs' tuples
    hold their route's kind after n1."""
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    from pyaudiolocalization_tpu_torch.ops.fftutils import next_pow2
    from pyaudiolocalization_tpu_torch.parallel import sweep as tsw
    if cfg["kind"] == "pair":
        n = cfg["nfft"]
        return {"fft_real": (n, cf._split_n1(n), _stage(cf._split_n1(n))),
                "whitened_corr": (n, cf.corr_schedule(n),
                                  _stage(cf.corr_schedule(n)))}
    spec = sweep_spec(cfg)
    m, nfft = spec.num_mics, spec.nfft
    render = next_pow2(spec.total_samples)
    r1 = cf.render_route(render)
    out = {"delay_sum": (render, r1.n1, _gcc_stage(r1))}
    gcc = cf.gcc_route(nfft, m)
    if tsw._use_windowed(spec):
        rr = cf.render_route(nfft)
        out["gcc_windowed"] = (nfft, gcc.n1, gcc.kind, _gcc_stage(gcc))
        if tsw._mono_scene_eligible(spec):
            out["scene_windowed"] = (
                nfft, rr.n1, gcc.n1, gcc.kind,
                f"fused {_gcc_stage(rr)}/{_gcc_stage(gcc)}")
    else:
        out["gcc_all_pairs"] = (nfft, gcc.n1, gcc.kind, _gcc_stage(gcc))
    return out


@contextlib.contextmanager
def _recording(module, name, record):
    """``module.name`` wrapped to pass (args, output) to ``record``."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        record(args, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def peak_gaps(values: torch.Tensor, lags: torch.Tensor,
              limit: float) -> torch.Tensor:
    """Relative gap between each row's peak within |lag| <= ``limit`` and
    its best value two or more lags from the peak: (..., L) -> (...)."""
    neg = torch.tensor(-float("inf"), dtype=values.dtype)
    v = torch.where(torch.abs(lags) <= limit, values, neg)
    top, idx = torch.max(v, -1)
    far = torch.abs(lags - lags[idx][..., None]) >= 2
    second = torch.amax(torch.where(far, v, neg), -1)
    return (top - second) / torch.clamp(torch.abs(top), min=1e-30)


def map_gaps(values: torch.Tensor, n: int) -> torch.Tensor:
    """Relative gap between each coarse map's maximum and its best cell
    more than one cell away (the repo's coarse margin: the fine stage
    searches +-1.5 cells around the maximum, so its neighbours are the
    same peak): (B, n^3) -> (B,)."""
    ax = torch.arange(n)
    cells = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                        -1).reshape(-1, 3)
    top, k = torch.max(values, -1)
    far = torch.amax(torch.abs(cells - cells[k][:, None, :]), -1) > 1
    below = torch.amax(torch.where(far, values, torch.full_like(
        values, -float("inf"))), -1)
    return (top - below) / torch.clamp(torch.abs(top), min=1e-30)


def _plain_sweep(spec, signals, mics, kmeans_seeds):
    """The CPU run, with the card's k-means++ seed indices (``None`` where
    the solver clusters nothing) in place of the CPU generator's, and
    every scene's smallest gap: (x, td, ladder gaps, coarse-map gaps).
    The ladder's gap is read from ``_solve_from_window``'s window or from
    the full correlations; the map's from the SRP coarse map (inf for a
    solver without one)."""
    from pyaudiolocalization_tpu_torch.models import cluster
    from pyaudiolocalization_tpu_torch.models import srp as srp_ops
    from pyaudiolocalization_tpu_torch.parallel import sweep as tsw
    ladder, maps = [], []
    lim = spec.max_tdoa * spec.fs

    def window(args, out):
        win, wq = args[1], tsw._tdoa_window_wq(spec)
        lags = torch.arange(win.shape[-1], dtype=win.dtype) - wq * 128
        ladder.append(peak_gaps(win, lags, lim).amin(-1))

    def corr(args, out):
        n = out.shape[-1]
        lags = torch.arange(n, dtype=out.dtype)
        lags = torch.where(lags >= n // 2, lags - n, lags)
        ladder.append(peak_gaps(out, lags, lim).amin(-1))

    def two_stage(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n):
        vals = coarse_fn(srp_ops._grid_points(lower, upper, coarse_n))
        maps.append(map_gaps(vals.reshape(-1, vals.shape[-1]), coarse_n))
        return real_two(coarse_fn, fine_fn, lower, upper, coarse_n, fine_n)

    real_two, real_seeds = srp_ops.two_stage_search, cluster.kmeanspp_seeds
    srp_ops.two_stage_search = two_stage
    if kmeans_seeds is not None:
        cluster.kmeanspp_seeds = lambda *args: kmeans_seeds.cpu()
    try:
        with _recording(tsw, "_solve_from_window", window), \
                _recording(tsw, "_correlate", corr):
            x, _, td = tsw._estimate(spec, signals, mics,
                                     spec.speed_of_sound, torch.Generator())
    finally:
        srp_ops.two_stage_search, cluster.kmeanspp_seeds = real_two, \
            real_seeds
    inf = torch.full((x.shape[0],), float("inf"))
    return (x, td, torch.stack(ladder).amin(0),
            torch.stack(maps).amin(0) if maps else inf)


def _launched(before: Dict[str, int]) -> Dict[str, int]:
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    return {k: v - before.get(k, 0) for k, v in cf.LAUNCHES.items()
            if v - before.get(k, 0)}


def card_sweep(cfg: dict, device):
    """The card half of a sweep configuration: draws, the K3 render, the
    fused estimate (where eligible) and the split one, each with a
    generator seeded alike.  Returns (signals, mics, {path: (x, td)}, the
    split run's k-means++ seed indices or None)."""
    from pyaudiolocalization_tpu_torch.models import cluster
    from pyaudiolocalization_tpu_torch.parallel import sweep as tsw
    spec = sweep_spec(cfg)
    c, s = spec.speed_of_sound, cfg["scenes"]
    gen = torch.Generator(device=device).manual_seed(cfg["seed"])
    sources, mics, snr = tsw._random_scene(spec, gen, s, torch.float32,
                                           gen.device)
    base, seeds = tsw._draw_signals(spec, gen, s, torch.float32, gen.device)
    signals = tsw._simulate(spec, sources, mics, c, base, snr, seeds)
    paths, drawn = {}, []
    if tsw._mono_scene_eligible(spec):
        p = tsw._source_paths(spec, sources[:, 0], mics, c)
        x, _, td = tsw._sim_est_fused(
            spec, p, base[:, 0], snr, seeds, mics, c,
            torch.Generator(device=device).manual_seed(cfg["seed"] + 1))
        paths["fused"] = (x, td)
    with _recording(cluster, "kmeanspp_seeds",
                    lambda args, out: drawn.append(out)):
        x, _, td = tsw._estimate(
            spec, signals, mics, c,
            torch.Generator(device=device).manual_seed(cfg["seed"] + 1))
    paths["split"] = (x, td)
    return signals, mics, paths, (drawn[-1] if drawn else None)


def card_pair(cfg: dict, device):
    """The card half of a single pair: a noise row and its delayed,
    noisy copy rendered on ``device``, then ``get_time_delays_phat`` at
    the configuration's power-of-two transform (K4a + K9).  Returns
    ((sig1, sig2), the first peak's delay in seconds)."""
    from pyaudiolocalization_tpu_torch.models import tdoa
    from pyaudiolocalization_tpu_torch.ops.delay import fractional_delay
    gen = torch.Generator(device=device).manual_seed(cfg["seed"])
    n, fs = cfg["length"], cfg["fs"]
    sig1 = torch.randn(n, generator=gen, device=device)
    sig2 = (fractional_delay(sig1, cfg["delay"] / fs, fs)
            + 0.1 * torch.randn(n, generator=gen, device=device))
    res = tdoa.get_time_delays_phat(sig1, sig2.contiguous(), fs,
                                    lag_mode="physical", nfft=cfg["nfft"])
    return (sig1, sig2), res.delays[..., 0]


def run_config(cfg: dict, device="cuda") -> dict:
    """One configuration on the card and from its signals on the CPU:
    the JSON record of ``main``'s line."""
    from pyaudiolocalization_tpu_torch.models import tdoa
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    before = dict(cf.LAUNCHES)
    rt = route(cfg)
    rec = dict(kind=cfg["kind"], fs=cfg["fs"],
               route={k: v[-1] for k, v in rt.items()},
               nfft=max(v[0] for v in rt.values()))
    if cfg["kind"] == "pair":
        (s1, s2), card_td = card_pair(cfg, device)
        launches = _launched(before)
        res = tdoa.get_time_delays_phat(s1.cpu(), s2.cpu().contiguous(),
                                        cfg["fs"], lag_mode="physical",
                                        nfft=cfg["nfft"])
        gap = peak_gaps(res.corr, res.time_lags * cfg["fs"], float("inf"))
        td_diff = (torch.abs(card_td.cpu() - res.delays[..., 0])
                   * cfg["fs"]).reshape(1)
        est_diff = torch.zeros(1)
        gaps, map_gap = gap.reshape(1), torch.full((1,), float("inf"))
        rec.update(length=cfg["length"], mics=2, scenes=1)
    else:
        signals, mics, paths, kmeans_seeds = card_sweep(cfg, device)
        launches = _launched(before)
        spec = sweep_spec(cfg)
        x, td, gaps, map_gap = _plain_sweep(spec, signals.cpu(), mics.cpu(),
                                            kmeans_seeds)
        td_diff = torch.stack([torch.amax(torch.abs(t.cpu() - td), -1)
                               for _, t in paths.values()]).amax(0) * spec.fs
        est_diff = torch.stack([torch.linalg.norm(e.cpu() - x, dim=-1)
                                for e, _ in paths.values()]).amax(0)
        rec.update(solver=cfg["solver"], room=cfg["room"],
                   mics=spec.num_mics, scenes=cfg["scenes"],
                   paths=sorted(paths))
    # A ladder tie exempts the scene's TDOAs and estimate, a coarse-map
    # tie its SRP estimate only.
    tied = gaps < TIE
    map_tied = map_gap < TIE
    bad_td = (td_diff >= TD_SAMPLES) & ~tied
    bad_est = (est_diff >= EST_M) & ~tied & ~map_tied & (rec["mics"] >= 4)
    rec.update(launches=launches,
               td_diff_samples=td_diff.tolist(), est_diff_m=est_diff.tolist(),
               max_td_diff_samples=float(td_diff.max()),
               max_est_diff_m=float(est_diff.max()),
               min_gap=float(gaps.min()), ties=int(tied.sum()),
               map_ties=int(map_tied.sum()),
               exempt_misses=int(((est_diff >= EST_M) & (tied | map_tied))
                                 .sum()),
               ok=bool(not (bad_td | bad_est).any()))
    return rec


def run_fuzz(device="cuda", emit=print) -> dict:
    """Every configuration (``emit`` gets each JSON line); returns
    {'ok', 'records', 'launches', 'scenes', 'ties'}: ok when every
    configuration holds and ties stay within ``TIE_SHARE`` of the
    scenes."""
    records, launches = [], {}
    for i, cfg in enumerate(configs()):
        rec = dict(config=i, **run_config(cfg, device))
        records.append(rec)
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        emit(json.dumps(rec))
    scenes = sum(r["scenes"] for r in records)
    ties = sum(r["ties"] for r in records)
    ok = all(r["ok"] for r in records) and ties <= TIE_SHARE * scenes
    return dict(ok=ok, records=records, launches=launches, scenes=scenes,
                ties=ties, map_ties=sum(r["map_ties"] for r in records))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to rehearse on the CPU",
              file=sys.stderr)
        return 2
    out = run_fuzz(args.device)
    print(json.dumps({k: (len(v) if k == "records" else v)
                      for k, v in out.items()}))
    print("ALL OK" if out["ok"] else "FAILURES")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
