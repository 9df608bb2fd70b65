"""Monte-Carlo scene sweeps: batches of simulate -> localize pipelines on
one card (counterpart of the JAX package's parallel/sweep.py).

The JAX package ``vmap``s one scene's pipeline over keys and shards the
scene axis over a TPU mesh.  Here the scene axis is a leading tensor
dimension written out through every stage: one kernel launch renders and
correlates every scene, the solver iterates every start of every scene in
lock-step.

Ported: single-source scenes with the 'lm' solver, PHAT weighting, the
'gaussian' threshold and an LTI front end ('butterworth' / 'fir', which
the band mask replaces), through two paths with the same draws and the
same answer:

* fused (``_sim_est_fused``, kernel K5 ``scene_windowed``): render,
  finalize, noise and the windowed GCC in one host entry;
* split (``_simulate`` + ``_estimate``): K3 ``delay_sum`` with noise, then
  K2 ``gcc_windowed``.

Every random draw of a sweep comes from one ``torch.Generator`` in a fixed
order (sources, mic jitter, SNR, base signals, noise seeds, then the
solver's k-means++ seeds), so the same seed on the same device gives the
same sweep; the measurement noise itself is a counter-based stream of the
noise seeds (ops/noise.py), identical in K3, K5 and their twins.

Entry points run on ``cuda`` unless given ``device`` (``device="cpu"``
runs the plain PyTorch twins).  The other solvers, multi-source scenes,
other weightings and thresholds, the Wiener front end, checkpointing and
the multi-card mesh raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..models import acoustics
from ..models import solver as solver_ops
from ..models import tdoa as tdoa_ops
from ..models import uncertainty as uncertainty_ops
from ..models.simulator import render_scene, scene_paths
from ..ops import cuda_fft
from ..ops import signal as sig_ops
from ..ops.delay import fade_window
from ..ops.fftutils import fft_length, next_pow2
from ..utils.device import resolve_device

_LATER = "is not ported yet; a later slice of the PyTorch port brings it"


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
    knob means; this slice runs the single-source 'lm' subset."""

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
    """Per-scene results, leading scene axis B."""
    estimate: torch.Tensor    # (B, 3)
    source: torch.Tensor      # (B, 3) ground truth
    error: torch.Tensor       # (B,) Euclidean error in meters
    cost: torch.Tensor        # (B,) final solver cost
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

def _check_spec(spec: SweepSpec) -> None:
    """The JAX package's ValueErrors, then this slice's limits."""
    if spec.num_sources < 1:
        raise ValueError("num_sources must be >= 1")
    if spec.gcc_weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError(
            f"unknown gcc_weighting {spec.gcc_weighting!r}; sweeps support "
            "'phat', 'scot', 'roth', 'cc'")
    if spec.suppression not in ("spatial", "claim"):
        raise ValueError("suppression must be 'spatial' or 'claim'")
    unsupported = [
        (spec.num_sources != 1, f"num_sources={spec.num_sources}"),
        (spec.solver != "lm", f"solver={spec.solver!r}"),
        (spec.gcc_weighting != "phat",
         f"gcc_weighting={spec.gcc_weighting!r}"),
        (spec.threshold_method != "gaussian",
         f"threshold_method={spec.threshold_method!r}"),
        (spec.filter_method not in ("butterworth", "fir"),
         f"filter_method={spec.filter_method!r}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"sweep {what} {_LATER}")
    half = tdoa_ops.window_half(spec.fs, spec.max_tdoa)
    if half > (spec.nfft // 256) * 128:
        raise NotImplementedError(
            f"sweep lag gate of {half} samples exceeds the windowed GCC's "
            f"cap of nfft/2 = {spec.nfft // 2}; the full-correlation path "
            f"(K1 with a scene axis) {_LATER}")


def _tdoa_window_wq(spec: SweepSpec) -> int:
    return tdoa_ops.window_wq(spec.fs, spec.max_tdoa, spec.nfft)


def _band_mask(spec: SweepSpec, like: torch.Tensor) -> torch.Tensor:
    return cuda_fft.band_mask(spec.nfft, (spec.lowcut, spec.highcut),
                              spec.fs, dtype=like.dtype, device=like.device)


def _solve_from_td(spec: SweepSpec, mics, td, c, generator,
                   seed_indices=None):
    """Clustered init + bounded multi-start LM (unit weights) for every
    scene at once: mics (B, M, 3), td (B, P) -> (x (B, 3), cost (B,))."""
    pi, pj = spec.pairs
    weights = torch.ones_like(td)
    guesses, _ = solver_ops.heuristic_initial_guesses(
        mics, pi, pj, td, c, generator, seed_indices=seed_indices)
    lower, upper = solver_ops.dynamic_bounds(mics, td, c)
    guesses = torch.clamp(guesses, lower[:, None, :], upper[:, None, :])
    best = solver_ops.multi_start_lm(guesses, mics, pi, pj, td, c, weights,
                                     lower, upper)
    return best.x, best.cost


def _solve_from_window(spec: SweepSpec, win, stats, mics, c, generator,
                       seed_indices=None):
    """Windowed TDOA ladder -> solver tail; returns (x, cost, td)."""
    td = -tdoa_ops.tdoa_single_from_window(win, stats, _tdoa_window_wq(spec),
                                           spec.nfft, spec.fs, spec.max_tdoa)
    x, cost = _solve_from_td(spec, mics, td, c, generator, seed_indices)
    return x, cost, td


def _estimate(spec: SweepSpec, signals: torch.Tensor, mics: torch.Tensor,
              c, generator, seed_indices=None):
    """K2 windowed GCC -> windowed TDOA ladder -> clustered init ->
    bounded multi-start LM for signals (B, M, N), mics (B, M, 3).  Returns
    (x (B, 3), cost (B,), td (B, P)).  The LTI bandpass front end is not
    run: one filter on both channels multiplies the cross-spectrum by
    |H|^2, which PHAT cancels in-band, and the band mask zeroes the rest
    (parallel/sweep.py:363-381 of the JAX package)."""
    pi, pj = spec.pairs
    win, stats = cuda_fft.gcc_windowed(
        signals.contiguous(), pi, pj, spec.nfft, _tdoa_window_wq(spec),
        _band_mask(spec, signals))
    return _solve_from_window(spec, win, stats, mics, c, generator,
                              seed_indices)


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
    (B, P))."""
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

def _random_scene(spec: SweepSpec, generator, num_scenes: int, dtype, dev):
    """(sources (B, 3) uniform in the box, mics (B, M, 3), snr_db (B,)),
    drawn in that order."""
    lo = torch.as_tensor(spec.source_box_lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(spec.source_box_hi, dtype=dtype, device=dev)
    sources = lo + (hi - lo) * torch.rand(
        (num_scenes, 3), generator=generator, dtype=dtype, device=dev)
    mics = torch.as_tensor(spec.mic_positions, dtype=dtype, device=dev)
    mics = mics.expand(num_scenes, *mics.shape)
    if spec.mic_jitter > 0:
        mics = mics + spec.mic_jitter * torch.randn(
            mics.shape, generator=generator, dtype=dtype, device=dev)
    u = torch.rand((num_scenes,), generator=generator, dtype=dtype,
                   device=dev)
    snr_db = spec.snr_db[0] + (spec.snr_db[1] - spec.snr_db[0]) * u
    return sources, mics.contiguous(), snr_db


def _draw_signals(spec: SweepSpec, generator, num_scenes: int, dtype, dev):
    """(base (B, N), noise seeds (B, 2) int32), drawn in that order."""
    base = sig_ops.generate_signal(spec.signal_type, spec.fs, spec.duration,
                                   spec.freq, generator=generator,
                                   dtype=dtype, device=dev, batch=num_scenes)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (num_scenes, 2),
                          generator=generator, dtype=torch.int32, device=dev)
    return base, seeds


def _source_paths(spec: SweepSpec, sources, mics, c):
    """Delay/gain matrices (B, M, paths) for each scene's direct + image
    paths."""
    dtype, dev = sources.dtype, sources.device
    absorption = torch.as_tensor(spec.material_absorption, dtype=dtype,
                                 device=dev)
    freq_tab = torch.as_tensor(spec.material_freq, dtype=dtype, device=dev)
    planes = torch.as_tensor(np.asarray(spec.plane_coeffs, float).reshape(
        -1, 4), dtype=dtype, device=dev)
    mat_ids = torch.as_tensor(np.asarray(spec.plane_material_ids,
                                         np.int64).reshape(-1), device=dev)
    images = acoustics.image_sources(sources, planes, mat_ids, mics,
                                     spec.freq, absorption, freq_tab,
                                     spec.max_reflections,
                                     spec.absorption_threshold)
    return scene_paths(sources, mics, c, spec.freq, images, absorption,
                       freq_tab)


def _simulate(spec: SweepSpec, paths, base, snr_db, seeds) -> torch.Tensor:
    """Split path's render: K3 with finalize and measurement noise ->
    signals (B, M, N)."""
    return render_scene(base, paths.delays, paths.gains, spec.fs,
                        spec.total_samples, spec.num_samples, pad_mode="pow2",
                        finalize=True, snr_db=snr_db, noise_seeds=seeds)


def _sim_est_fused(spec: SweepSpec, paths, base, snr_db, seeds, mics, c,
                   generator):
    """Fused path: kernel K5 renders every scene (finalize and noise
    included) and returns the windowed correlations and statistics; the
    TDOA ladder and solver tail follow.  Same estimator, draws and noise
    stream as ``_simulate`` + ``_estimate``."""
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
        _band_mask(spec, base), snr_db=snr_db.contiguous(), seeds=seeds)
    return _solve_from_window(spec, win, stats, mics, c, generator)


def _mono_scene_eligible(spec: SweepSpec) -> bool:
    """Gate of the fused path.  ``_check_spec`` already holds the JAX
    package's other semantic conditions (single source, windowed solver,
    PHAT, LTI front end; parallel/sweep.py:728-738 there), and the TPU's
    VMEM rule does not apply: what is left is that the render's transform
    is the correlation's."""
    return next_pow2(spec.total_samples) == spec.nfft


def run_scene(spec: SweepSpec,
              seed_or_generator: Union[int, torch.Generator] = 0,
              num_scenes: int = 1, dtype: torch.dtype = torch.float32,
              device=None) -> SceneResult:
    """``num_scenes`` randomized simulate -> localize pipelines, batched
    (the JAX package's ``run_scene`` vmapped over keys): the fused K5 path
    where ``_mono_scene_eligible`` holds, else K3 then K2."""
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
    paths = _source_paths(spec, sources, mics, c)
    if fused:
        estimate, cost, td = _sim_est_fused(spec, paths, base, snr_db, seeds,
                                            mics, c, generator)
    else:
        signals = _simulate(spec, paths, base, snr_db, seeds)
        estimate, cost, td = _estimate(spec, signals, mics, c, generator)
    error = torch.linalg.norm(estimate - sources, dim=-1)
    pi, pj = spec.pairs
    cov = uncertainty_ops.position_covariance(estimate, mics, pi, pj, td, c)
    return SceneResult(estimate, sources, error, cost, td, cov)


def _summary(results: SceneResult, hit_threshold: float) -> SweepSummary:
    err = results.error
    hits = torch.mean((err < hit_threshold).to(err.dtype))
    return SweepSummary(torch.sqrt(torch.mean(err * err)), torch.mean(err),
                        hits, results)


def monte_carlo_sweep(spec: SweepSpec,
                      seed_or_generator: Union[int, torch.Generator],
                      num_scenes: int, mesh=None, hit_threshold: float = 0.1,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> SweepSummary:
    """Run ``num_scenes`` randomized scenes on one device and summarize
    them (RMSE, mean error, hit rate under ``hit_threshold`` meters)."""
    if mesh is not None:
        raise NotImplementedError(f"the multi-card mesh sweep {_LATER}")
    return _summary(run_scene(spec, seed_or_generator, num_scenes, dtype,
                              device), hit_threshold)
