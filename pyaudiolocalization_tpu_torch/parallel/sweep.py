"""Monte-Carlo scene sweeps: batches of simulate -> localize pipelines on
one card or a mesh of cards (counterpart of the JAX package's
parallel/sweep.py).

The JAX package ``vmap``s one scene's pipeline over keys and shards the
scene axis over a TPU mesh.  Here the scene axis is a leading tensor
dimension written out through every stage: one kernel launch renders and
correlates every scene, the solver iterates every start of every scene in
lock-step.

Ported: every solver — 'lm', 'lm-robust' and 'de' (differential evolution
seeded by the clustered guesses and polished by L-BFGS-B, batched over
scenes: models/solver.differential_evolution_batched), 'srp' and 'srp+lm',
and the narrowband 'beam', 'music' and 'capon'; PHAT, SCOT, Roth and CC
weightings; the 'gaussian', 'median' and 'adaptive' thresholds; the LTI
front ends ('butterworth' / 'fir', which the band mask replaces) and
Wiener, which really runs (``_prefilter``); and multi-source scenes
(``num_sources`` 2-6: 'srp' with 'spatial' or 'claim' suppression,
'music' and 'capon').  Four estimation paths, chosen as the JAX package
chooses them (``_mono_scene_eligible``, ``_use_windowed``):

* fused (``_sim_est_fused``, kernel K5 ``scene_windowed``): render,
  finalize, noise and the windowed GCC in one host entry, for single-
  source 'lm' / 'lm-robust' / 'de' scenes with PHAT, the 'gaussian'
  threshold and an LTI front end, whose render transform is the
  correlation's;
* split windowed (``_simulate`` + ``_estimate``): K3 ``delay_sum`` with
  noise, then (Wiener, then) K2 ``gcc_windowed`` and the windowed ladder,
  for the other such scenes (a lag gate wider than K2's window is capped
  at nfft/2, as in the JAX package);
* full correlation (``_simulate`` + ``_estimate``): K3, then K1
  ``gcc_all_pairs`` over every scene (the unfused GCC for the other
  weightings), the full TDOA ladder, and the LM tail or the SRP search;
  multi-source scenes render each source raw through K3, sum, finalize
  and add noise, then run K1 and the multi-source SRP search;
* narrowband (``_simulate`` + ``_estimate_narrowband``): K3, then the
  steered-power, MUSIC or Capon search on the (prefiltered) signals, no
  correlation at all, in scene chunks within ``NB_CHUNK_BYTES``; TDOAs
  are returned as zeros.

Every random draw of a sweep comes from one ``torch.Generator`` in a fixed
order: sources (for K > 1 sources, 16 candidates per source), mic jitter,
SNR, base signals (one batch per source), noise seeds, then the solver's
k-means++ seeds.  The same seed on the same device gives the same sweep;
the measurement noise itself is a counter-based stream of the noise seeds
(ops/noise.py), identical in K3, K5, their twins and the multi-source
noise (``ops/noise.add_noise``).  The JAX package's ``jax.random`` draws
cannot be reproduced; sweeps agree with it in distribution.

Entry points run on ``cuda`` unless given ``device`` (``device="cpu"``
runs the plain PyTorch twins).  The chunked, restartable form of the
sweep is parallel/checkpoint.py.

The mesh (``make_mesh``, parallel/multihost.py) is one process a card over
``torch.distributed``, the counterpart of the JAX package's one process a
host with the scene axis sharded by ``shard_map``.  A meshed sweep of
``num_scenes`` over W ranks runs num_scenes / W scenes on each rank, rank
r drawing from a generator seeded ``chunk_seed(seed, r)``: the rule of the
checkpointed sweep's chunks, so that the meshed sweep equals
``run_sweep_checkpointed(spec, seed, num_scenes, num_scenes // W)`` to
the bit on one kind of device, rank r's results being chunk r.  The
summary is all-reduced (the JAX package's ``pmean``) and replicated;
``results`` holds this rank's shard.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models import acoustics
from ..models import beamformer as beam_ops
from ..models import capon as capon_ops
from ..models import music as music_ops
from ..models import solver as solver_ops
from ..models import srp as srp_ops
from ..models import tdoa as tdoa_ops
from ..models import uncertainty as uncertainty_ops
from ..models.simulator import render_scene, scene_paths
from ..ops import cuda_fft
from ..ops import filters as filter_ops
from ..ops import gccphat
from ..ops import noise as noise_ops
from ..ops import signal as sig_ops
from ..ops.delay import fade_window
from ..ops.fftutils import fft_length, next_pow2
from ..utils.device import resolve_device

SCENE_AXIS = "scenes"
_NARROWBAND = ("beam", "music", "capon")
#: Device bytes the narrowband search may hold at once: its (scenes, 24^3
#: points, mics, bins) planes are taken in scene chunks that fit.
NB_CHUNK_BYTES = 2 << 30


def _pairs(num_mics: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """All i<j mic pairs in the reference's loop order (main.py:202-203)."""
    pi, pj = [], []
    for i in range(num_mics):
        for j in range(i + 1, num_mics):
            pi.append(i)
            pj.append(j)
    return tuple(pi), tuple(pj)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Static description of a randomized-scene distribution: a copy of
    the JAX package's ``SweepSpec`` (parallel/sweep.py:71-229 there), same
    fields, defaults and derived properties.  See that class for what each
    knob means; the module docstring lists the subset that runs."""

    fs: float = 44100.0
    duration: float = 1.0
    signal_type: str = "sine"
    freq: float = 1000.0
    mic_positions: tuple = (
        (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    plane_coeffs: tuple = ()
    plane_material_ids: tuple = ()
    material_absorption: tuple = (0.01, 0.05, 0.1)
    material_freq: tuple = (1e-5, 5e-5, 3e-5)
    max_reflections: int = 0
    absorption_threshold: float = 0.01
    source_box_lo: tuple = (0.0, 0.0, 0.0)
    source_box_hi: tuple = (1.0, 1.0, 1.0)
    mic_jitter: float = 0.0
    snr_db: Tuple[float, float] = (20.0, 40.0)
    solver: str = "lm"
    de_popsize: int = 15
    de_maxiter: int = 200
    num_sources: int = 1
    source_min_separation: float = 0.0
    source_freqs: Optional[tuple] = None
    suppression: str = "spatial"
    filter_method: str = "butterworth"
    lowcut: float = 300.0
    highcut: float = 3400.0
    nfft_mode: str = "circular"
    threshold_method: str = "gaussian"
    gcc_weighting: str = "phat"
    temperature: float = 20.0
    humidity: float = 50.0
    delay_budget_s: Optional[float] = None

    @property
    def num_mics(self) -> int:
        return len(self.mic_positions)

    @property
    def num_samples(self) -> int:
        return int(self.fs * self.duration)

    @property
    def pairs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        return _pairs(self.num_mics)

    @property
    def nfft(self) -> int:
        return fft_length(self.num_samples, self.num_samples, self.nfft_mode)

    @property
    def speed_of_sound(self) -> float:
        t = 20.0 if not (-50 <= self.temperature <= 50) else self.temperature
        h = 50.0 if not (0 <= self.humidity <= 100) else self.humidity
        return 331.0 + 0.6 * t + 0.0124 * h

    @property
    def max_tdoa(self) -> float:
        """Physical bound on any pairwise TDOA: array diameter over c, with
        jitter headroom (the peak-search lag window)."""
        mics = np.asarray(self.mic_positions, float)
        diam = float(np.max(np.linalg.norm(
            mics[:, None, :] - mics[None, :, :], axis=-1)))
        diam += 6.0 * self.mic_jitter
        return 1.25 * diam / self.speed_of_sound

    @property
    def delay_budget(self) -> float:
        """Conservative static bound on the longest path delay (s)."""
        if self.delay_budget_s is not None:
            return self.delay_budget_s
        mics = np.asarray(self.mic_positions, float)
        lo = np.minimum(np.asarray(self.source_box_lo, float), mics.min(0))
        hi = np.maximum(np.asarray(self.source_box_hi, float), mics.max(0))
        diam = float(np.linalg.norm(hi - lo)) + 6.0 * self.mic_jitter
        corners = np.array([[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
                            [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
                            [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
                            [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]]])
        reach = 0.0
        for coeffs in self.plane_coeffs:
            n = np.asarray(coeffs[:3], float)
            nn = max(float(np.linalg.norm(n)), 1e-9)
            dist = float(np.max(np.abs(corners @ n + float(coeffs[3])))) / nn
            reach = max(reach, 2.0 * dist + 2.0 * diam)
        return (diam + self.max_reflections * reach) / 300.0 + 1.0 / self.fs

    @property
    def total_samples(self) -> int:
        return self.num_samples + int(np.ceil(self.delay_budget * self.fs))


class SceneResult(NamedTuple):
    """Per-scene results, leading scene axis B.  With ``num_sources`` K > 1
    every field but ``tdoas`` / ``covariance`` gains a source axis K
    before its trailing dims (estimates assignment-matched to the ground
    truth, cost the negated fine-stage map value), and the covariance is
    NaN; so it is for the narrowband solvers, which measure no TDOAs."""
    estimate: torch.Tensor    # (B, 3) / (B, K, 3)
    source: torch.Tensor      # (B, 3) / (B, K, 3) ground truth
    error: torch.Tensor       # (B,) / (B, K) Euclidean error in meters
    cost: torch.Tensor        # (B,) / (B, K) final solver cost
    tdoas: torch.Tensor       # (B, P)
    covariance: torch.Tensor  # (B, 3, 3) position covariance (m^2)


class SweepSummary(NamedTuple):
    rmse: torch.Tensor        # scalar
    mean_error: torch.Tensor  # scalar
    hit_rate: torch.Tensor    # fraction of scenes with error < hit_threshold
    results: SceneResult      # per-scene


# ---------------------------------------------------------------------------
# Estimation back half (signals -> position), batched over scenes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _permutations(k: int) -> np.ndarray:
    """All K! assignment permutations (K is capped at 6)."""
    return np.array(list(itertools.permutations(range(k))), np.int64)


def _check_spec(spec: SweepSpec) -> None:
    """The JAX package's ValueErrors."""
    if spec.num_sources < 1:
        raise ValueError("num_sources must be >= 1")
    if spec.gcc_weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError(
            f"unknown gcc_weighting {spec.gcc_weighting!r}; sweeps support "
            "'phat', 'scot', 'roth', 'cc'")
    if spec.suppression not in ("spatial", "claim"):
        raise ValueError("suppression must be 'spatial' or 'claim'")
    if spec.num_sources > 1:
        if spec.solver not in ("srp", "music", "capon"):
            raise ValueError(
                "multi-source sweeps (num_sources > 1) require solver='srp', "
                "'music', or 'capon': per-pair TDOA solvers assume a single "
                "dominant source")
        if spec.num_sources > 6:
            raise ValueError(
                "num_sources > 6 not supported (K! assignment matching)")
        if (spec.source_freqs is not None
                and len(spec.source_freqs) != spec.num_sources):
            raise ValueError("source_freqs must have num_sources entries")
        if spec.signal_type == "sine" and spec.source_freqs is None:
            raise ValueError(
                "multi-source 'sine' scenes need distinct source_freqs: "
                "same-frequency sines are fully coherent and cannot be "
                "separated (SRP-PHAT or MUSIC)")


def _tdoa_window_wq(spec: SweepSpec) -> int:
    return tdoa_ops.window_wq(spec.fs, spec.max_tdoa, spec.nfft)


def _prefilter(spec: SweepSpec, signals: torch.Tensor):
    """(filtered signals, whitening band) of the front end
    (parallel/sweep.py:363-381 of the JAX package).  An LTI front end
    ('butterworth' / 'fir') is not run: one filter on both channels
    multiplies the cross-spectrum by |H|^2, which PHAT cancels in-band, and
    the band mask zeroes the rest (for the narrowband solvers the band
    selects the bins).  Wiener is nonlinear, so it really runs, and no band
    applies."""
    if spec.filter_method in ("butterworth", "fir"):
        return signals, (spec.lowcut, spec.highcut)
    return filter_ops.noise_reduction(signals, spec.fs,
                                      method=spec.filter_method,
                                      lowcut=spec.lowcut,
                                      highcut=spec.highcut), None


def _band_mask(spec: SweepSpec, band, like: torch.Tensor) -> torch.Tensor:
    return cuda_fft.band_mask(spec.nfft, band, spec.fs, dtype=like.dtype,
                              device=like.device)


def _srp_box(spec: SweepSpec):
    """SRP search box: the source prior expanded 20% per side."""
    blo = np.asarray(spec.source_box_lo, float)
    bhi = np.asarray(spec.source_box_hi, float)
    margin = 0.2 * (bhi - blo) + 1e-3
    return blo - margin, bhi + margin


def _srp_args(spec: SweepSpec, like: torch.Tensor):
    """(lower, upper, keyword arguments) of the sweep's SRP searches: the
    box, its pool width and the lag gate as the max-lag bound."""
    blo, bhi = _srp_box(spec)
    pool = srp_ops._resolve_pool(None, blo, bhi, srp_ops.COARSE_N, spec.fs,
                                 spec.speed_of_sound)
    kw = dict(pool_samples=pool,
              max_lag_samples=int(np.ceil(spec.max_tdoa * spec.fs)))
    return (torch.as_tensor(blo, dtype=like.dtype, device=like.device),
            torch.as_tensor(bhi, dtype=like.dtype, device=like.device), kw)


def _windowed_tdoa_solvers(spec: SweepSpec) -> bool:
    """Specs whose TDOA stage runs the windowed single-peak ladder; shared
    by ``_use_windowed`` and ``_mono_scene_eligible`` (the JAX package's
    ``_windowed_tdoa_solvers``)."""
    return (spec.solver in ("lm", "lm-robust", "de")
            and spec.threshold_method == "gaussian")


def _use_windowed(spec: SweepSpec) -> bool:
    """K2's lag window in place of full correlations: a windowed solver
    with PHAT.  The JAX package adds the TPU kernel's VMEM rules, which do
    not apply here; a gate wider than K2's window is capped at nfft/2 as
    it is there (``_tdoa_window_wq``)."""
    return _windowed_tdoa_solvers(spec) and spec.gcc_weighting == "phat"


def _solve_from_td(spec: SweepSpec, mics, td, c, generator,
                   seed_indices=None):
    """The TDOA solver tail (unit weights) for every scene at once: mics
    (B, M, 3), td (B, P) -> (x (B, 3), cost (B,)).  'lm' / 'lm-robust':
    clustered init, clipped to the bounds, and the bounded multi-start LM,
    plain or robust.  'de': differential evolution over the bounds with
    the (unclipped) clustered guesses as its first members and an
    L-BFGS-B polish, every scene at once (parallel/sweep.py:499-532 of the
    JAX package)."""
    pi, pj = spec.pairs
    weights = torch.ones_like(td)
    guesses, _ = solver_ops.heuristic_initial_guesses(
        mics, pi, pj, td, c, generator, seed_indices=seed_indices)
    lower, upper = solver_ops.dynamic_bounds(mics, td, c)
    if spec.solver == "de":
        def objective(x):
            one = x.dim() == 2                        # (B, 3): the polish
            xs = x[:, None] if one else x             # (B, N, 3)
            r = solver_ops.tdoa_residuals(xs, mics[:, None], pi, pj,
                                          td[:, None], c, weights[:, None])
            e = torch.sum(r * r, -1)
            return e[:, 0] if one else e

        de = solver_ops.differential_evolution_batched(
            objective, lower, upper, generator, popsize=spec.de_popsize,
            maxiter=spec.de_maxiter, init=guesses,
            polish_fn=lambda x: tuple(solver_ops.lbfgsb_minimize_batched(
                objective, x, lower, upper)))
        return de.x, de.energy
    guesses = torch.clamp(guesses, lower[:, None, :], upper[:, None, :])
    solve = (solver_ops.multi_start_lm_robust if spec.solver == "lm-robust"
             else solver_ops.multi_start_lm)
    best = solve(guesses, mics, pi, pj, td, c, weights, lower, upper)
    return best.x, best.cost


def _solve_from_window(spec: SweepSpec, win, stats, mics, c, generator,
                       seed_indices=None):
    """Windowed TDOA ladder -> solver tail; returns (x, cost, td)."""
    td = -tdoa_ops.tdoa_single_from_window(win, stats, _tdoa_window_wq(spec),
                                           spec.nfft, spec.fs, spec.max_tdoa)
    x, cost = _solve_from_td(spec, mics, td, c, generator, seed_indices)
    return x, cost, td


def _correlate(spec: SweepSpec, signals: torch.Tensor,
               band) -> torch.Tensor:
    """(B, M, N) -> (B, P, nfft) correlations of every scene, whitened in
    ``band``: K1 for PHAT, the unfused GCC for the other weightings."""
    pi, pj = spec.pairs
    return gccphat.gcc_phat_all_pairs(signals, pi, pj, nfft=spec.nfft,
                                      band=band, fs=spec.fs,
                                      weighting=spec.gcc_weighting)


def _solve_srp(spec: SweepSpec, corr, mics, td, c):
    """SRP over every scene's box, and for 'srp+lm' the LM polish kept
    within one coarse cell.  Returns (x (B, 3), cost (B,))."""
    pi, pj = spec.pairs
    lower, upper, kw = _srp_args(spec, corr)
    srp = srp_ops.srp_phat_locate(corr, mics, pi, pj, spec.fs, c, lower,
                                  upper, **kw)
    if spec.solver == "srp":
        return srp.position, -srp.power
    blo, bhi = _srp_box(spec)
    cell = float(np.linalg.norm((bhi - blo) / srp_ops.COARSE_N))
    return srp_ops.lm_polish(srp, mics, pi, pj, td, c, torch.ones_like(td),
                             cell)


def _separation(spec: SweepSpec) -> Optional[float]:
    """Suppression radius of the multi-source searches: 0.8 of the drawn
    sources' minimum separation, else the default (three coarse cells)."""
    return (0.8 * spec.source_min_separation
            if spec.source_min_separation > 0 else None)


def _nb_chunk(spec: SweepSpec, itemsize: int) -> int:
    """Scenes a narrowband chunk holds: its coarse map's (24^3 points,
    mics, bins) planes, about a dozen of them live at once, within
    ``NB_CHUNK_BYTES``."""
    bins = 12 if spec.solver == "beam" else 8
    per_scene = srp_ops.COARSE_N ** 3 * spec.num_mics * bins * 12 * itemsize
    return max(1, NB_CHUNK_BYTES // per_scene)


def _estimate_narrowband(spec: SweepSpec, filtered: torch.Tensor,
                         mics: torch.Tensor, c, band):
    """'beam' / 'music' / 'capon' over the source box expanded 20 %, single-
    or multi-source ('music' / 'capon'), on the signals alone (no
    correlation: narrowband sources have no usable correlation peaks), in
    scene chunks of ``_nb_chunk``.  Returns (x (B, 3) or (B, K, 3),
    negated map values (B,) or (B, K), zero TDOAs (B, P))."""
    blo, bhi = _srp_box(spec)
    lower, upper = srp_ops._box(blo, bhi, filtered)
    kw = dict(band=band)
    if spec.num_sources > 1:
        locate = (music_ops.music_locate_multi if spec.solver == "music"
                  else capon_ops.capon_locate_multi)
        kw.update(num_sources=spec.num_sources,
                  min_separation=_separation(spec))
    elif spec.solver == "beam":
        locate = beam_ops.beamform_locate
        kw.update(nfft=spec.nfft)
    else:
        locate = (music_ops.music_locate if spec.solver == "music"
                  else capon_ops.capon_locate)
    step = _nb_chunk(spec, filtered.element_size())
    xs, costs = [], []
    for i in range(0, filtered.shape[0], step):
        out = locate(filtered[i:i + step], mics[i:i + step], spec.fs, c,
                     lower, upper, **kw)
        xs.append(out[0])
        costs.append(-out[1])
    td = torch.zeros((filtered.shape[0], len(spec.pairs[0])),
                     dtype=filtered.dtype, device=filtered.device)
    return torch.cat(xs), torch.cat(costs), td


def _estimate_multi(spec: SweepSpec, signals: torch.Tensor,
                    mics: torch.Tensor, c):
    """Multi-source estimation: K1 over every scene, then the multi-source
    SRP search (suppression ``spec.suppression``); or for 'music' /
    'capon' the narrowband multi-source search.  Returns (positions
    (B, K, 3) in coarse extraction order, negated fine-stage powers
    (B, K), diagnostic TDOAs (B, P): the circular argmax index decoded as
    a physical lag, dominated by the strongest source; zeros for the
    narrowband solvers)."""
    pi, pj = spec.pairs
    filtered, band = _prefilter(spec, signals)
    if spec.solver in _NARROWBAND:
        return _estimate_narrowband(spec, filtered, mics, c, band)
    corr = _correlate(spec, filtered, band)
    n = corr.shape[-1]
    am = torch.argmax(corr, -1)
    td = -torch.where(am >= n // 2, am - n, am).to(signals.dtype) / spec.fs
    lower, upper, kw = _srp_args(spec, corr)
    out = srp_ops.srp_phat_locate_multi(
        corr, mics, pi, pj, spec.fs, c, lower, upper,
        num_sources=spec.num_sources, min_separation=_separation(spec),
        suppression=spec.suppression, **kw)
    return out.positions, -out.powers, td


def _estimate(spec: SweepSpec, signals: torch.Tensor, mics: torch.Tensor,
              c, generator, seed_indices=None):
    """Signals (B, M, N), mics (B, M, 3) -> (x (B, 3), cost (B,), td
    (B, P)); (B, K, 3), (B, K), (B, P) for K > 1 sources.  The front end
    first (``_prefilter``).  Narrowband solvers: their search on the
    signals.  Windowed specs (``_use_windowed``): K2 -> windowed ladder ->
    the solver tail (``_solve_from_td``).  The others: correlations of
    every scene -> the full ladder -> that tail or the SRP search."""
    if spec.num_sources > 1:
        return _estimate_multi(spec, signals, mics, c)
    pi, pj = spec.pairs
    filtered, band = _prefilter(spec, signals)
    if spec.solver in _NARROWBAND:
        return _estimate_narrowband(spec, filtered, mics, c, band)
    if _use_windowed(spec):
        win, stats = cuda_fft.gcc_windowed(
            filtered.contiguous(), pi, pj, spec.nfft, _tdoa_window_wq(spec),
            _band_mask(spec, band, filtered))
        return _solve_from_window(spec, win, stats, mics, c, generator,
                                  seed_indices)
    corr = _correlate(spec, filtered, band)
    res = tdoa_ops.time_delays_from_corr(
        corr, spec.num_samples, spec.num_samples, spec.fs, num_peaks=1,
        threshold_method=spec.threshold_method,
        max_expected_delay=spec.max_tdoa)
    # physical peak lag -> td = arrival_j - arrival_i (models/tdoa.py).
    td = -res.delays[..., 0]
    if spec.solver in ("srp", "srp+lm"):
        x, cost = _solve_srp(spec, corr, mics, td, c)
    else:
        x, cost = _solve_from_td(spec, mics, td, c, generator, seed_indices)
    return x, cost, td


def _generator(seed_or_generator, dev: torch.device) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        if seed_or_generator.device.type != dev.type:
            raise ValueError(f"the generator lies on "
                             f"{seed_or_generator.device}, the sweep runs "
                             f"on {dev}")
        return seed_or_generator
    return torch.Generator(device=dev).manual_seed(int(seed_or_generator))


def localize_batch(spec: SweepSpec, signals, mics,
                   seed_or_generator: Union[int, torch.Generator] = 0,
                   dtype: torch.dtype = torch.float32, device=None):
    """Estimation-only batch: signals (B, M, N), mic geometry (M, 3) shared
    or (B, M, 3) per scene.  Returns (estimates (B, 3), costs (B,), tdoas
    (B, P)); with ``num_sources`` K > 1, estimates (B, K, 3) and costs
    (B, K), the negated fine-stage SRP powers, in coarse extraction order
    (no ground truth to match against here)."""
    _check_spec(spec)
    dev = resolve_device(device)
    generator = _generator(seed_or_generator, dev)
    sigs = torch.as_tensor(signals, dtype=dtype, device=dev)
    mics_t = torch.as_tensor(mics, dtype=dtype, device=dev)
    if mics_t.dim() == 2:
        mics_t = mics_t.expand(sigs.shape[0], *mics_t.shape)
    return _estimate(spec, sigs, mics_t, spec.speed_of_sound, generator)


# ---------------------------------------------------------------------------
# Full scene pipeline (randomize -> simulate -> estimate)
# ---------------------------------------------------------------------------

def _draw_sources(spec: SweepSpec, generator, num_scenes: int, dtype, dev):
    """(B, K, 3) sources uniform in the box.  K > 1 draws 16 candidates
    per source and places the sources greedily: each takes its first
    candidate at least ``source_min_separation`` from every source placed
    before it, candidate 0 when none is (a soft constraint, as in the JAX
    package)."""
    lo = torch.as_tensor(spec.source_box_lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(spec.source_box_hi, dtype=dtype, device=dev)
    k = spec.num_sources
    if k == 1:
        return (lo + (hi - lo) * torch.rand(
            (num_scenes, 3), generator=generator, dtype=dtype,
            device=dev))[:, None, :]
    cands = lo + (hi - lo) * torch.rand(
        (num_scenes, k, 16, 3), generator=generator, dtype=dtype, device=dev)
    if spec.source_min_separation <= 0:
        return cands[:, :, 0]
    rows = torch.arange(num_scenes, device=dev)
    placed = []
    for idx in range(k):
        ck = cands[:, idx]                                        # (B, 16, 3)
        ok = torch.ones(ck.shape[:2], dtype=torch.bool, device=dev)
        for prev in placed:
            ok &= torch.linalg.norm(ck - prev[:, None, :], dim=-1) \
                >= spec.source_min_separation
        pick = torch.argmax(ok.to(torch.uint8), -1)  # first valid, else 0
        placed.append(ck[rows, pick])
    return torch.stack(placed, 1)


def _random_scene(spec: SweepSpec, generator, num_scenes: int, dtype, dev):
    """(sources (B, K, 3), mics (B, M, 3), snr_db (B,)), drawn in that
    order."""
    sources = _draw_sources(spec, generator, num_scenes, dtype, dev)
    mics = torch.as_tensor(spec.mic_positions, dtype=dtype, device=dev)
    mics = mics.expand(num_scenes, *mics.shape)
    if spec.mic_jitter > 0:
        mics = mics + spec.mic_jitter * torch.randn(
            mics.shape, generator=generator, dtype=dtype, device=dev)
    u = torch.rand((num_scenes,), generator=generator, dtype=dtype,
                   device=dev)
    snr_db = spec.snr_db[0] + (spec.snr_db[1] - spec.snr_db[0]) * u
    return sources, mics.contiguous(), snr_db


def _source_freq(spec: SweepSpec, k: int) -> float:
    return spec.source_freqs[k] if spec.source_freqs is not None else spec.freq


def _draw_signals(spec: SweepSpec, generator, num_scenes: int, dtype, dev):
    """(base (B, K, N), one batch per source at its frequency, then noise
    seeds (B, 2) int32), drawn in that order."""
    base = torch.stack([sig_ops.generate_signal(
        spec.signal_type, spec.fs, spec.duration, _source_freq(spec, k),
        generator=generator, dtype=dtype, device=dev, batch=num_scenes)
        for k in range(spec.num_sources)], 1)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (num_scenes, 2),
                          generator=generator, dtype=torch.int32, device=dev)
    return base, seeds


def _source_paths(spec: SweepSpec, sources, mics, c,
                  freq: Optional[float] = None):
    """Delay/gain matrices (B, M, paths) of each scene's direct + image
    paths for sources (B, 3) at ``freq`` (default ``spec.freq``)."""
    freq = spec.freq if freq is None else freq
    dtype, dev = sources.dtype, sources.device
    absorption = torch.as_tensor(spec.material_absorption, dtype=dtype,
                                 device=dev)
    freq_tab = torch.as_tensor(spec.material_freq, dtype=dtype, device=dev)
    planes = torch.as_tensor(np.asarray(spec.plane_coeffs, float).reshape(
        -1, 4), dtype=dtype, device=dev)
    mat_ids = torch.as_tensor(np.asarray(spec.plane_material_ids,
                                         np.int64).reshape(-1), device=dev)
    images = acoustics.image_sources(sources, planes, mat_ids, mics,
                                     freq, absorption, freq_tab,
                                     spec.max_reflections,
                                     spec.absorption_threshold)
    return scene_paths(sources, mics, c, freq, images, absorption, freq_tab)


def _simulate(spec: SweepSpec, sources, mics, c, base, snr_db,
              seeds) -> torch.Tensor:
    """Split path's render -> signals (B, M, N).  One source: K3 with
    finalize and measurement noise.  K > 1: every source of every scene
    rendered raw in one K3 launch (rows scene * K + source), summed,
    normalized and compressed per mic, then the same noise stream added
    at the scene's SNR (``ops/noise.add_noise``)."""
    num_scenes, k = sources.shape[:2]
    if k == 1:
        paths = _source_paths(spec, sources[:, 0], mics, c)
        return render_scene(base[:, 0], paths.delays, paths.gains, spec.fs,
                            spec.total_samples, spec.num_samples,
                            finalize=True, snr_db=snr_db, noise_seeds=seeds)
    paths = [_source_paths(spec, sources[:, s], mics, c,
                           _source_freq(spec, s)) for s in range(k)]
    delays = torch.stack([p.delays for p in paths], 1)
    gains = torch.stack([p.gains for p in paths], 1)
    raw = render_scene(base.reshape(num_scenes * k, -1),
                       delays.reshape((num_scenes * k,) + delays.shape[2:]),
                       gains.reshape((num_scenes * k,) + gains.shape[2:]),
                       spec.fs, spec.total_samples, spec.num_samples,
                       finalize=False)
    raw = raw.reshape((num_scenes, k) + raw.shape[1:]).sum(1)
    sigs = sig_ops.dynamic_range_compression(sig_ops.normalize_signal(raw))
    return noise_ops.add_noise(sigs, snr_db, seeds)


def _sim_est_fused(spec: SweepSpec, paths, base, snr_db, seeds, mics, c,
                   generator):
    """Fused path: kernel K5 renders every scene (finalize and noise
    included) and returns the windowed correlations and statistics; the
    TDOA ladder and solver tail follow.  Same estimator, draws and noise
    stream as ``_simulate`` + ``_estimate``.  base (B, N)."""
    pi, pj = spec.pairs
    dtype, dev = base.dtype, base.device
    padded = torch.zeros((base.shape[0], spec.total_samples), dtype=dtype,
                         device=dev)
    padded[:, :base.shape[1]] = base
    fade = fade_window(spec.total_samples, dtype=dtype,
                       device=dev)[:spec.num_samples].contiguous()
    win, stats = cuda_fft.scene_windowed(
        padded, (paths.delays * spec.fs).to(dtype).contiguous(),
        paths.gains.to(dtype).contiguous(), pi, pj, spec.nfft,
        spec.num_samples, _tdoa_window_wq(spec), fade,
        _band_mask(spec, (spec.lowcut, spec.highcut), base),
        snr_db=snr_db.contiguous(), seeds=seeds)
    return _solve_from_window(spec, win, stats, mics, c, generator)


def _mono_scene_eligible(spec: SweepSpec) -> bool:
    """Gate of the fused path: the JAX package's semantic conditions
    (parallel/sweep.py:728-738 there) — one source, a windowed solver
    ('lm', 'lm-robust', 'de') with the 'gaussian' threshold, PHAT, an LTI
    front end, and a render transform that is the correlation's.  The
    TPU's VMEM rule does not apply."""
    return (spec.num_sources == 1 and _windowed_tdoa_solvers(spec)
            and spec.gcc_weighting == "phat"
            and spec.filter_method in ("butterworth", "fir")
            and next_pow2(spec.total_samples) == spec.nfft)


def run_scene(spec: SweepSpec,
              seed_or_generator: Union[int, torch.Generator] = 0,
              num_scenes: int = 1, dtype: torch.dtype = torch.float32,
              device=None) -> SceneResult:
    """``num_scenes`` randomized simulate -> localize pipelines, batched
    (the JAX package's ``run_scene`` vmapped over keys): the fused K5 path
    where ``_mono_scene_eligible`` holds, else K3 then ``_estimate``."""
    _check_spec(spec)
    dev = resolve_device(device)
    return _run_scenes(spec, _generator(seed_or_generator, dev), num_scenes,
                       dtype, _mono_scene_eligible(spec))


def _run_scenes(spec: SweepSpec, generator, num_scenes: int, dtype,
                fused: bool) -> SceneResult:
    """``run_scene`` on the path that ``fused`` names; the draws do not
    depend on it."""
    dev = generator.device
    c = spec.speed_of_sound
    sources, mics, snr_db = _random_scene(spec, generator, num_scenes, dtype,
                                          dev)
    base, seeds = _draw_signals(spec, generator, num_scenes, dtype, dev)
    if fused:
        paths = _source_paths(spec, sources[:, 0], mics, c)
        estimate, cost, td = _sim_est_fused(spec, paths, base[:, 0], snr_db,
                                            seeds, mics, c, generator)
    else:
        signals = _simulate(spec, sources, mics, c, base, snr_db, seeds)
        estimate, cost, td = _estimate(spec, signals, mics, c, generator)
    nan_cov = torch.full((num_scenes, 3, 3), float("nan"), dtype=dtype,
                         device=dev)
    if spec.num_sources == 1:
        source = sources[:, 0]
        error = torch.linalg.norm(estimate - source, dim=-1)
        pi, pj = spec.pairs
        # The narrowband solvers measure no TDOAs: no Gauss-Markov
        # covariance (NaN, as in the JAX package).
        cov = (nan_cov if spec.solver in _NARROWBAND else
               uncertainty_ops.position_covariance(estimate, mics, pi, pj,
                                                   td, c))
        return SceneResult(estimate, source, error, cost, td, cov)
    # Match estimates to sources by the best (least mean error) of the K!
    # assignments.
    perms = torch.as_tensor(_permutations(spec.num_sources), device=dev)
    d = torch.linalg.norm(estimate[:, perms] - sources[:, None], dim=-1)
    best = torch.argmin(torch.mean(d, -1), -1)                        # (B,)
    order = perms[best]                                               # (B, K)
    rows = torch.arange(num_scenes, device=dev)[:, None]
    return SceneResult(estimate[rows, order], sources, d[rows[:, 0], best],
                       cost[rows, order], td, nan_cov)


# ---------------------------------------------------------------------------
# The scene mesh: one process a card over torch.distributed
# ---------------------------------------------------------------------------

def chunk_seed(seed: int, chunk_index: int) -> int:
    """The generator seed of chunk ``chunk_index`` of a sweep seeded
    ``seed`` (a checkpointed sweep's chunk, or a meshed sweep's rank):
    63 bits of ``numpy.random.SeedSequence([seed, index])``."""
    state = np.random.SeedSequence([seed, chunk_index]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@dataclasses.dataclass(frozen=True)
class SceneMesh:
    """A 1-D scene mesh: ``size`` ranks of ``group`` (None: this process
    alone, no collectives), this process being ``rank`` and running its
    scenes on ``device``.  Its one axis is named ``SCENE_AXIS``, as the
    JAX package's mesh axis."""
    group: object
    size: int
    rank: int
    device: torch.device
    axis_name: ClassVar[str] = SCENE_AXIS

    def _collective_device(self) -> torch.device:
        """Where the collectives' tensors live: the card for NCCL, the CPU
        for gloo."""
        if dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")

    def all_reduce_mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``values`` (the JAX package's
        ``pmean``), replicated on every rank."""
        if self.group is None:
            return values
        buf = values.to(self._collective_device()).clone()
        dist.all_reduce(buf, group=self.group)
        return (buf / self.size).to(values.device)

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's ``shard`` concatenated in rank order along the
        leading axis, on every rank."""
        if self.group is None:
            return shard
        buf = shard.to(self._collective_device()).contiguous()
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf, group=self.group)
        return torch.cat(out, 0).to(shard.device)

    def broadcast(self, obj):
        """Rank 0's picklable ``obj``, on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self._collective_device())
        return box[0]

    def barrier(self) -> None:
        if self.group is None:
            return
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(num_devices: Optional[int] = None, device=None) -> SceneMesh:
    """The scene mesh over the initialized process group
    (``torch.distributed``; parallel/multihost.initialize), one rank a
    card: ``num_devices`` must be None or the group's size.  This rank
    runs on ``device``, default ``cuda:$LOCAL_RANK`` (or the rank modulo
    the cards).  Without a process group: a one-rank mesh on ``device``
    (``utils.device.resolve_device``: the card unless named)."""
    if not (dist.is_available() and dist.is_initialized()):
        if num_devices not in (None, 1):
            raise ValueError(f"make_mesh({num_devices}): no process group "
                             "is initialized, so the mesh has one rank "
                             "(parallel/multihost.initialize)")
        return SceneMesh(None, 1, 0, resolve_device(device))
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh({num_devices}): the process group has "
                         f"{size} ranks; a mesh spans all of them")
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        count = max(torch.cuda.device_count(), 1)
        device = f"cuda:{int(local) if local is not None else rank % count}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return SceneMesh(dist.group.WORLD, size, rank, dev)


def _summary(results: SceneResult, hit_threshold: float,
             mesh: Optional[SceneMesh] = None) -> SweepSummary:
    err = results.error
    stats = torch.stack([torch.mean(err * err), torch.mean(err),
                         torch.mean((err < hit_threshold).to(err.dtype))])
    if mesh is not None:
        stats = mesh.all_reduce_mean(stats)
    return SweepSummary(torch.sqrt(stats[0]), stats[1], stats[2], results)


def _meshed_sweep(spec: SweepSpec, seed: int, num_scenes: int,
                  mesh: SceneMesh, hit_threshold: float, dtype,
                  first_chunk: int = 0) -> SweepSummary:
    """This rank's shard of a meshed sweep: num_scenes / size scenes drawn
    from ``chunk_seed(seed, first_chunk + rank)``."""
    if num_scenes % mesh.size != 0:
        raise ValueError(f"num_scenes={num_scenes} must be divisible by the "
                         f"mesh size {mesh.size}")
    gen = torch.Generator(device=mesh.device).manual_seed(
        chunk_seed(seed, first_chunk + mesh.rank))
    results = run_scene(spec, gen, num_scenes // mesh.size, dtype,
                        mesh.device)
    return _summary(results, hit_threshold, mesh)


def _check_mesh(mesh, seed_or_generator) -> None:
    if not isinstance(mesh, SceneMesh):
        raise TypeError(f"mesh must be a SceneMesh (parallel.make_mesh), "
                        f"got {type(mesh).__name__}")
    if isinstance(seed_or_generator, torch.Generator):
        raise TypeError("a meshed sweep takes an int seed: a generator's "
                        "state cannot be split across processes (rank r "
                        "draws from chunk_seed(seed, r))")


def monte_carlo_sweep(spec: SweepSpec,
                      seed_or_generator: Union[int, torch.Generator],
                      num_scenes: int, mesh: Optional[SceneMesh] = None,
                      hit_threshold: float = 0.1,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> SweepSummary:
    """Run ``num_scenes`` randomized scenes and summarize them (RMSE, mean
    error, hit rate under ``hit_threshold`` meters).  With a ``mesh``
    (``make_mesh``) the scenes are split over its ranks, each on the
    mesh's device (``device`` is not used): rank r runs num_scenes / W of
    them from ``chunk_seed(seed, r)`` (an int seed; ``num_scenes`` must be
    divisible by W), the summary is all-reduced and replicated, and
    ``results`` holds this rank's shard."""
    if mesh is None:
        return _summary(run_scene(spec, seed_or_generator, num_scenes, dtype,
                                  device), hit_threshold)
    _check_mesh(mesh, seed_or_generator)
    return _meshed_sweep(spec, int(seed_or_generator), num_scenes, mesh,
                         hit_threshold, dtype)
