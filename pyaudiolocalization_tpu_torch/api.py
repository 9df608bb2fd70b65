"""Public API: the reference-compatible entry points
``localize_sound_source`` and ``simulate_signals_with_multipath``, and
``run_calibration`` re-exported from models/calibration (counterpart of the
JAX package's api.py; reference: main.py:66-333).

Ported: the reference pre-sync (``sync_mode='reference'``,
models/sync.py; ``DEFAULT_CONFIG``'s, in either lag mode); parity mode
(``lag_mode='reference'``): the reference's exact-length simulation
(``simulate_signals``), the exact 2n - 1 transform, the reference lag axis
with plateau peaks, the exact-length bootstrap, calibration delays applied
verbatim (SURVEY.md Q3), DE with the reference's tol=0.01, and the
localization figure; and physical mode (``lag_mode='physical'``,
``LocalizationConfig``'s default) with its options — the Butterworth, FIR and
Wiener front ends; PHAT (band-limited or not), SCOT, Roth and CC
weightings; the 'gaussian', 'median' and 'adaptive' TDOA ladders, with a
``max_expected_delay`` window or without one; the permutation, block,
circular and noise bootstrap nulls (``analyze_correlation``); k-means or
DBSCAN initial guesses; the multi-start LM, plain or robust ('lm-robust'),
with the differential-evolution fallback; the SRP-PHAT grid solvers 'srp'
and 'srp+lm' (models/srp.py); the narrowband solvers 'beam', 'music' and
'capon' (models/beamformer.py, music.py, capon.py) with their
group-jackknife uncertainty; ``absorption_mode='per-bin'``; calibration
delays behind their SNR gate; and the Gauss-Markov uncertainty.  Figures
follow the JAX package's rules (utils/plotting.py, matplotlib imported
lazily; without matplotlib and with ``show_plots=False`` one warning names
it and no file is written).  Recorded audio (``use_simulation=False``
with ``audio_files``) is read, resampled, normalized and compressed on the
device (utils/audio_io.read_audio_files), then takes the injected-signal
route: the pre-sync or the trailing zero-pad, then either core.

Two estimation cores, dispatched as the JAX package dispatches them
(api.py:717-728 there): the windowed fast core (``_estimation_core_fast``:
no Butterworth pass, since PHAT cancels |H|^2 and the band mask zeroes the
rest; kernel K2's lag window and statistics; the collapsed single-peak
ladder) whenever ``_fast_path_eligible`` holds, else the full core (filter,
K1's full correlations, the full ladder, the bootstrap, then the LM or the
SRP search; for a narrowband solver the correlations, the ladder and the
bootstrap run only for ``analyze_correlation`` / ``visualize_correlation``,
and the estimator reads the filtered signals).  Eligibility
depends on the config, the dtype (the kernels take float32) and the
shapes, never on the device, so the CPU runs the path the card runs.

The pipeline runs on ``device`` (default ``cuda``; without a card the
caller must pass ``device="cpu"``) in ``dtype``; on a CUDA device in
float32 it goes through the hand-written kernels (ops/cuda_fft.py), on the
CPU through their plain PyTorch twins.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .models import acoustics
from .models import beamformer as beam_ops
from .models import capon as capon_ops
from .models import music as music_ops
from .models import solver as solver_ops
from .models import srp as srp_ops
from .models import tdoa as tdoa_ops
from .models import uncertainty as uncertainty_ops
from .models.calibration import (  # noqa: F401 (run_calibration: re-export)
    CALIBRATION_SNR_GATE, run_calibration)
from .models.simulator import simulate_signals, simulate_signals_fast
from .models.sync import synchronize_signals
from .ops import cuda_fft
from .ops import filters as filter_ops
from .ops import gccphat
from .ops.fftutils import fft_length
from .utils import plotting
from .utils.config import LocalizationConfig, SceneConfig
from .utils.audio_io import read_audio_files
from .utils.device import resolve_device
from .utils.materials import MaterialTable, default_table

logger = logging.getLogger(__name__)

_SOLVERS = ("lm", "lm-robust", "srp", "srp+lm", "beam", "music", "capon")
_NARROWBAND = ("beam", "music", "capon")
# Time chunks of the narrowband group jackknife (api.py:292-296 of the JAX
# package; models/uncertainty.group_jackknife_covariance).
_NB_GROUPS = 4


def simulate_signals_with_multipath(source_pos, mic_positions, fs, c,
                                    duration: float = 1.0,
                                    signal_type: str = "sine",
                                    freq: float = 1000.0,
                                    reflective_planes=None,
                                    material_properties: Optional[
                                        Mapping] = None,
                                    max_reflections: int = 2,
                                    absorption_threshold: float = 0.01,
                                    trim_to_duration: bool = True,
                                    generator: Optional[
                                        torch.Generator] = None,
                                    dtype=None,
                                    absorption_mode: str = "carrier",
                                    device=None) -> List[np.ndarray]:
    """Reference-signature wrapper (main.py:66-79; api.py:70-115 of the JAX
    package): the reference's exact-length scene simulation
    (``models/simulator.simulate_signals``) as a list of per-mic numpy
    arrays.  ``generator`` drives the stochastic signal types (default: a
    generator seeded 0, as the JAX package defaults to PRNGKey(0));
    ``device`` as ``localize_sound_source``'s."""
    table = (MaterialTable.from_dict(material_properties)
             if material_properties is not None else default_table())
    planes = reflective_planes or []
    coeffs = (np.array([pl["plane"] for pl in planes], float).reshape(
        len(planes), 4) if planes else np.zeros((0, 4)))
    mat_ids = np.array([table.id_of(pl.get("material", "air"), strict=True)
                        for pl in planes], np.int32)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    sigs = simulate_signals(
        source_pos, mic_positions, fs, c, duration, signal_type, freq,
        coeffs, mat_ids, table.absorption, table.freq, max_reflections,
        absorption_threshold, trim_to_duration, generator=generator,
        dtype=dtype, device=dev, absorption_mode=absorption_mode)
    return [s.cpu().numpy() for s in sigs]


def _check_supported(loc: LocalizationConfig) -> None:
    """The JAX package's ValueErrors for the localization settings
    (api.py:549-565 there).  Every mode of ``localize_sound_source`` runs
    in the port."""
    if loc.solver not in _SOLVERS:
        raise ValueError(f"Unknown solver {loc.solver!r}; expected one of "
                         f"{_SOLVERS}")
    if loc.solver != "lm" and loc.lag_mode == "reference":
        raise ValueError(
            "solver overrides are physical-mode extensions; reference-parity "
            "mode (lag_mode='reference') keeps the reference's LM -> DE "
            "chain (main.py:261-298)")
    if loc.gcc_weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError(
            f"Unknown gcc_weighting {loc.gcc_weighting!r}; the batch API "
            "supports 'phat', 'scot', 'roth', 'cc' ('ml' needs Welch-"
            "averaged spectra — use ops.gccphat.gcc_phat_streaming)")
    if loc.gcc_weighting != "phat" and loc.lag_mode == "reference":
        raise ValueError(
            "gcc_weighting is a physical-mode extension; reference-parity "
            "mode keeps PHAT (utils.py:116)")


def _calibration_delays(calibration_data, num_mics: int,
                        lag_mode: str) -> Optional[np.ndarray]:
    """The per-mic calibration delays (main.py:147-157), or None when there
    are none, their count is wrong, or — in physical mode, when every entry
    carries the correlation-peak 'snr' — the worst SNR is below the
    quality gate (a noise-dominated calibration gives random delays)."""
    if calibration_data is None:
        return None
    if len(calibration_data) != num_mics:
        logger.warning(
            "Number of calibration entries does not match the number of "
            "microphones. Ignoring calibration for this run.")
        return None
    try:
        delays = np.array([d.get("delay", 0.0) for d in calibration_data],
                          float)
        logger.info("Applying calibration correction.")
    except Exception as e:  # matches main.py:155-157
        logger.warning("Error processing calibration data: %s. Ignoring "
                       "calibration.", e)
        return None
    if lag_mode == "physical" and all("snr" in d for d in calibration_data):
        worst = min(float(d["snr"]) for d in calibration_data)
        if worst < CALIBRATION_SNR_GATE:
            logger.warning(
                "Calibration correlation-peak SNR %.1f below the quality "
                "gate %.1f (noise-dominated recording); ignoring "
                "calibration in physical mode.", worst, CALIBRATION_SNR_GATE)
            return None
    return delays


def _calibrated(td: torch.Tensor, calib: Optional[torch.Tensor], pairs_i,
                pairs_j) -> torch.Tensor:
    """td_p - (delay_j - delay_i): each mic's calibration delay removed."""
    if calib is None:
        return td
    return td - (calib[list(pairs_j)] - calib[list(pairs_i)])


def _resolve_threshold(loc: LocalizationConfig) -> str:
    if loc.threshold_method is not None:
        return loc.threshold_method
    return "median" if loc.lag_mode == "reference" else "gaussian"


def _resolve_phat_band(loc: LocalizationConfig):
    """'auto' follows the bandpass front end's passband in physical mode
    (SURVEY.md Q5 fix); None whitens every bin."""
    band = loc.phat_band
    if band == "auto":
        if loc.lag_mode == "physical" and loc.filter_method in ("butterworth",
                                                                "fir"):
            return (300.0, 3400.0)
        return None
    return tuple(band) if band is not None else None


def _physical_nfft(n: int, fs: float, max_expected_delay: Optional[float],
                   srp_lags: int = 0) -> int:
    """Circular next_pow2(n) transform when the consulted lag window (the
    max_expected_delay gate plus the ladder's dilation, and for the SRP
    solvers ``srp_lags``: the mic-diameter lag bound plus the max-pool
    width and margin) is alias-free, else — and always for
    max_expected_delay=None, whose ladder consults every lag — the
    alias-free next_pow2(2n-1) (api.py:697-713 of the JAX package)."""
    if max_expected_delay is None:
        return fft_length(n, n, "pow2")
    nfft = fft_length(n, n, "circular")
    dilation = 8 * max(int(fs * 0.001), 1)
    needed = int(np.ceil(max_expected_delay * fs)) + dilation + 1
    if nfft - n < max(needed, srp_lags):
        nfft = fft_length(n, n, "pow2")
    return nfft


def _resolve_search_box(scene: SceneConfig, loc: LocalizationConfig):
    """Host-side grid-search box: the configured ``search_box`` verbatim,
    else the mic array's bounding box expanded by max(array diameter,
    0.5 m) per side (api.py:483-499 of the JAX package)."""
    if loc.search_box is not None:
        lo = np.asarray(loc.search_box[0], float)
        hi = np.asarray(loc.search_box[1], float)
        if lo.shape != (3,) or hi.shape != (3,) or np.any(hi <= lo):
            raise ValueError("search_box must be ((x0,y0,z0),(x1,y1,z1)) "
                             "with hi > lo per axis")
        return lo, hi
    mics = np.asarray(scene.mic_positions, float)
    lo, hi = mics.min(0), mics.max(0)
    margin = max(float(np.linalg.norm(hi - lo)), 0.5)
    return lo - margin, hi + margin


def _srp_grid_knobs(scene: SceneConfig, loc: LocalizationConfig, fs: float,
                    c: float):
    """(box lo, box hi, max-pool half-width, mic-diameter lag bound) of the
    grid solvers' search, host-side (api.py:467-480 of the JAX package):
    the pool is a coarse cell's covering radius (0.866 of its widest edge)
    in samples of travel time.  One definition for the nfft rule and the
    search; the narrowband solvers read the box alone."""
    blo, bhi = _resolve_search_box(scene, loc)
    cell = float(np.max(bhi - blo)) / srp_ops.COARSE_N
    pool = max(1, int(np.ceil(0.866 * cell * fs / c)))
    mics = np.asarray(scene.mic_positions, float)
    diam = float(np.max(np.linalg.norm(mics[:, None, :] - mics[None, :, :],
                                       axis=-1)))
    return blo, bhi, pool, int(np.ceil(diam * fs / c))


def _estimation_core(signals: torch.Tensor, mic_positions: torch.Tensor,
                     c: float, generator: Optional[torch.Generator],
                     calib: Optional[torch.Tensor], *, fs: float, pairs_i,
                     pairs_j, nfft: int, loc: LocalizationConfig,
                     grid_knobs=None) -> Dict[str, torch.Tensor]:
    """Filter -> all-pairs GCC -> TDOA ladder -> (metrics) -> clustered
    multi-start LM (plain or robust), or for 'srp' / 'srp+lm' the SRP
    search with ``grid_knobs`` (``_srp_grid_knobs``), or a narrowband
    estimator on the box of ``grid_knobs``.  The narrowband solvers read no
    correlation: the GCC and the ladder run for them only when
    ``analyze_correlation`` or ``visualize_correlation`` reads them
    (api.py:740-742 of the JAX package); otherwise the TDOAs and the
    correlation matrix are zeros."""
    n = signals.shape[-1]
    num_mics = mic_positions.shape[0]
    pi = torch.as_tensor(pairs_i, dtype=torch.long, device=signals.device)
    pj = torch.as_tensor(pairs_j, dtype=torch.long, device=signals.device)
    band = _resolve_phat_band(loc)

    filtered = filter_ops.noise_reduction(signals, fs,
                                          method=loc.filter_method)
    corr_matrix = torch.zeros((num_mics, num_mics), dtype=signals.dtype,
                              device=signals.device)
    if (loc.solver not in _NARROWBAND or loc.analyze_correlation
            or loc.visualize_correlation):
        corr = gccphat.gcc_phat_all_pairs(filtered, pairs_i, pairs_j,
                                          nfft=nfft, band=band, fs=fs,
                                          weighting=loc.gcc_weighting)
        res = tdoa_ops.time_delays_from_corr(
            corr, n, n, fs, num_peaks=1,
            threshold_method=_resolve_threshold(loc),
            max_expected_delay=loc.max_expected_delay, lag_mode=loc.lag_mode)
        measured = res.delays[..., 0]
        # Physical convention: td = arrival_j - arrival_i = -(peak lag)/fs;
        # parity mode takes the reference's peak lag as it is.
        td = _calibrated(-measured if loc.lag_mode == "physical"
                         else measured, calib, pairs_i, pairs_j)
        peak_corr = torch.amax(corr, -1)
        corr_matrix[pi, pj] = peak_corr
        corr_matrix[pj, pi] = peak_corr
    else:
        corr = None
        measured = td = torch.zeros(len(pairs_i), dtype=signals.dtype,
                                    device=signals.device)

    out = {"corr": corr, "tdoas": td, "measured_delays": measured,
           "correlation_matrix": corr_matrix}
    if loc.analyze_correlation:
        snr = tdoa_ops.correlation_snr(corr)
        ppr = tdoa_ops.peak_to_peak_ratio(corr)
        # The null is calibrated at the real correlation's transform length.
        thresholds = torch.stack([
            tdoa_ops.bootstrap_significance(
                filtered[i], filtered[j], generator,
                num_bootstrap=loc.num_bootstrap, nfft=nfft,
                bootstrap_mode=loc.bootstrap_mode)
            for i, j in zip(pairs_i, pairs_j)])
        out.update(snr=snr, peak_to_peak_ratio=ppr,
                   significant=(peak_corr > thresholds) & (snr > 2.0))
        weights = tdoa_ops.compute_weights(snr)
    else:
        weights = torch.ones(len(pairs_i), dtype=signals.dtype,
                             device=signals.device)

    if loc.solver in ("srp", "srp+lm"):
        out.update(_solve_srp(corr, mic_positions, c, pairs_i, pairs_j, td,
                              weights, fs, loc.solver, *grid_knobs))
    elif loc.solver in _NARROWBAND:
        out.update(_solve_narrowband(filtered, mic_positions, c, fs, nfft,
                                     loc.solver, band, *grid_knobs[:2]))
    else:
        out.update(_solve(mic_positions, c, generator, pairs_i, pairs_j, td,
                          weights, loc))
    return out


def _solve_srp(corr, mic_positions, c, pairs_i, pairs_j, td, weights,
               fs: float, solver: str, blo, bhi, pool: int,
               max_lag: int) -> Dict[str, torch.Tensor]:
    """Two-stage SRP-PHAT over the box, and for 'srp+lm' the LM polish
    kept within one coarse cell (api.py:232-249 of the JAX package).  The
    cost is the negated SRP power unless the polish is kept."""
    srp = srp_ops.srp_phat_locate(
        corr, mic_positions, pairs_i, pairs_j, fs, c, blo, bhi,
        pool_samples=pool, max_lag_samples=max_lag)
    if solver == "srp":
        return dict(estimated_position=srp.position, cost=-srp.power)
    cell = float(np.linalg.norm((bhi - blo) / srp_ops.COARSE_N))
    x, cost = srp_ops.lm_polish(srp, mic_positions, pairs_i, pairs_j, td, c,
                                weights, cell)
    return dict(estimated_position=x, cost=cost)


def narrowband_locate(solver: str, mic_positions, fs: float, c, band,
                      nfft: int):
    """The api's narrowband estimator as ``locate(signals, lower, upper)``
    (api.py:263-275 of the JAX package): 'beam' at the GCC's transform
    length, 'music' / 'capon' at their default frames."""
    if solver == "beam":
        return lambda sig, lo, hi: beam_ops.beamform_locate(
            sig, mic_positions, fs, c, lo, hi, band=band, nfft=nfft)
    fn = music_ops.music_locate if solver == "music" else \
        capon_ops.capon_locate
    return lambda sig, lo, hi: fn(sig, mic_positions, fs, c, lo, hi,
                                  band=band)


def _solve_narrowband(filtered, mic_positions, c, fs: float, nfft: int,
                      solver: str, band, blo, bhi) -> Dict[str, torch.Tensor]:
    """'beam' / 'music' / 'capon' over the box (api.py:251-288 of the JAX
    package), then the group-jackknife covariance: the same estimator
    re-localizes each of ``_NB_GROUPS`` time chunks on a box of +-12 % of
    the search box around the fix, plus the fine grid's resolution floor,
    (box / 384)^2 per axis (the two-stage search quantizes to a fine cell
    of box / 96, and the quadratic refinement leaves a ~cell / 4 bias that
    no resampling sees).  The cost is the negated map value."""
    locate = narrowband_locate(solver, mic_positions, fs, c, band, nfft)
    lower, upper = srp_ops._box(blo, bhi, filtered)
    fix = locate(filtered, lower, upper)
    cov = uncertainty_ops.group_jackknife_covariance(
        filtered, lambda s, lo, hi: locate(s, lo, hi).position, fix.position,
        0.12 * (upper - lower), groups=_NB_GROUPS)
    floor = (upper - lower) / 384.0
    return dict(estimated_position=fix.position, cost=-fix.power,
                nb_covariance=cov + torch.diag(floor * floor))


def _fast_path_eligible(loc: LocalizationConfig, nfft: int, dtype,
                        fs: float) -> bool:
    """The JAX package's semantic conditions for the windowed core
    (api.py:438-459 there): physical single-peak 'gaussian' estimation with
    no full-correlation consumer downstream, a lag window that covers the
    max_expected_delay gate, and float32 (the kernels' type).  The TPU's
    VMEM rules do not apply."""
    if (loc.lag_mode != "physical" or loc.max_expected_delay is None
            or loc.solver != "lm" or loc.gcc_weighting != "phat"
            or loc.analyze_correlation or loc.visualize_correlation
            or _resolve_threshold(loc) != "gaussian"):
        return False
    return (tdoa_ops.window_half(fs, loc.max_expected_delay)
            <= (nfft // 256) * 128 and dtype == torch.float32)


def _solve(mic_positions, c, generator, pairs_i, pairs_j, td, weights,
           loc: LocalizationConfig) -> Dict[str, torch.Tensor]:
    """Clustered initial guesses -> bounds -> multi-start LM ('lm') or its
    leave-k-out consensus ('lm-robust')."""
    guesses, _ = solver_ops.heuristic_initial_guesses(
        mic_positions, pairs_i, pairs_j, td, c, generator,
        clustering_method=loc.clustering_method, eps=loc.clustering_eps,
        min_samples=loc.clustering_min_samples)
    lower, upper = solver_ops.dynamic_bounds(mic_positions, td, c)
    guesses = torch.clamp(guesses, lower[None, :], upper[None, :])
    solve = (solver_ops.multi_start_lm_robust if loc.solver == "lm-robust"
             else solver_ops.multi_start_lm)
    best = solve(guesses, mic_positions, pairs_i, pairs_j, td, c, weights,
                 lower, upper)
    return dict(estimated_position=best.x, cost=best.cost, weights=weights,
                lower=lower, upper=upper, initial_guesses=guesses)


def _estimation_core_fast(signals: torch.Tensor, mic_positions: torch.Tensor,
                          c: float, generator: Optional[torch.Generator],
                          calib: Optional[torch.Tensor], *, fs: float,
                          pairs_i, pairs_j, nfft: int, wq: int,
                          loc: LocalizationConfig
                          ) -> Dict[str, torch.Tensor]:
    """Windowed core (api.py:337-417 of the JAX package): K2 returns only
    the lag window and the global statistics of each pair's correlation,
    and the single-peak ladder runs on the window
    (models/tdoa.tdoa_single_from_window).  It builds no correlation
    matrix: ``visualize_correlation``, its only reader, selects the full
    core."""
    band = _resolve_phat_band(loc)
    if loc.filter_method in ("butterworth", "fir") and band is not None:
        filtered = signals          # PHAT cancels |H|^2 (module docstring)
    else:
        filtered = filter_ops.noise_reduction(signals, fs,
                                              method=loc.filter_method)
    mask = cuda_fft.band_mask(nfft, band, fs, dtype=signals.dtype,
                              device=signals.device)
    win, stats = cuda_fft.gcc_windowed(filtered.contiguous(), pairs_i,
                                       pairs_j, nfft, wq, mask)
    measured = tdoa_ops.tdoa_single_from_window(
        win, stats, wq, nfft, fs, loc.max_expected_delay)
    td = _calibrated(-measured, calib, pairs_i, pairs_j)   # as the full core
    weights = torch.ones(len(pairs_i), dtype=signals.dtype,
                         device=signals.device)
    out = {"tdoas": td, "measured_delays": measured}
    out.update(_solve(mic_positions, c, generator, pairs_i, pairs_j, td,
                      weights, loc))
    return out


def _de_fallback(core, mic_positions: torch.Tensor, c: float,
                 generator: Optional[torch.Generator], pairs_i, pairs_j,
                 tol: float) -> np.ndarray:
    """Differential evolution over the LM bounds with an L-BFGS-B polish
    (main.py:276-298; ``tol`` 0.01 in parity mode, the reference's scipy
    default, 1e-6 in physical mode), used when the LM returned no finite
    cost; the first initial guess when DE fails too."""
    logger.warning("Least-squares failed, trying differential evolution.")
    td, weights = core["tdoas"], core["weights"]
    lower, upper = core["lower"], core["upper"]

    def objective(x):
        r = solver_ops.tdoa_residuals(x, mic_positions, pairs_i, pairs_j,
                                      td, c, weights)
        return torch.sum(r * r, -1)

    def polish(x):
        res = solver_ops.lbfgsb_minimize(objective, x, lower, upper)
        return res.x, res.fun

    de = solver_ops.differential_evolution(objective, lower, upper,
                                           generator, tol=tol,
                                           polish_fn=polish)
    if np.isfinite(float(de.energy)):
        estimated = de.x.double().cpu().numpy()
        logger.info("Estimated source (differential evolution): %s",
                    estimated)
        return estimated
    logger.error("Differential evolution failed. Falling back to the first "
                 "initial guess.")
    return core["initial_guesses"][0].double().cpu().numpy()


def _figures(scene: SceneConfig, loc: LocalizationConfig, estimated,
             core, pairs, fs: float, show_plots: bool) -> None:
    """The JAX package's figures (utils/plotting.py): the localization
    scatter, and with ``visualize_correlation`` the peak-correlation
    heatmap and the correlations in 3-D.  Matplotlib is optional: without
    it ``show_plots=True`` raises ImportError, and otherwise one warning
    says that no figure is written."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if show_plots:
            raise
        logger.warning("matplotlib is not installed: the figures "
                       "(localization_result.png%s) are not written.",
                       ", heatmap.png, correlation_3d.png"
                       if loc.visualize_correlation else "")
        return
    plotting.plot_localization_3d(scene.mic_positions, scene.source_position,
                                  estimated, show_plot=show_plots)
    if loc.visualize_correlation:
        plotting.plot_correlation_heatmap(
            core["correlation_matrix"].double().cpu().numpy(),
            scene.mic_positions, show_plot=show_plots,
            save_path="heatmap.png")
        plotting.plot_correlation_3d(
            list(core["corr"].double().cpu().numpy()), list(pairs), fs,
            show_plot=show_plots, save_path="correlation_3d.png")


def localize_sound_source(config,
                          calibration_data=None,
                          audio_files=None,
                          use_simulation: bool = True,
                          show_plots: bool = False,
                          device=None,
                          dtype: Optional[torch.dtype] = None,
                          generator: Optional[torch.Generator] = None,
                          signals: Optional[Sequence] = None
                          ) -> Dict[str, Any]:
    """Localization pipeline with the reference's public contract
    (main.py:126-333): the same config keys and result-dict keys as the JAX
    package's ``localize_sound_source``.

    ``device`` / ``dtype`` place the computation (default: ``cuda`` and
    torch's default dtype; without a card, pass ``device="cpu"``); the
    kernels run on a CUDA device in float32.
    ``generator`` (a ``torch.Generator`` on ``device``) drives every random
    draw — noise sources, bootstrap permutations, k-means seeding; by
    default one is seeded from the scene's ``seed``.  ``signals`` injects
    per-mic waveforms in place of the simulation; with
    ``use_simulation=False`` and no ``signals``, ``audio_files`` (one file
    a mic) are read and resampled to ``fs`` on ``device``, and
    ``actual_position`` is None.  Figures as in the JAX
    package: parity mode always draws the localization figure (shown with
    ``show_plots``, else saved to ``localization_result.png`` in the
    working directory), as does any simulated run with ``show_plots`` or
    ``visualize_correlation``, which also saves ``heatmap.png`` and
    ``correlation_3d.png``.  Without matplotlib, ``show_plots=True`` raises
    ImportError and otherwise one warning replaces the files.
    """
    scene = (config if isinstance(config, SceneConfig)
             else SceneConfig.from_dict(config))
    loc = scene.localization
    _check_supported(loc)
    dev = resolve_device(device)
    dt = dtype if dtype is not None else torch.get_default_dtype()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(scene.seed)
    fs = scene.fs
    mic_positions = scene.mic_positions
    num_mics = scene.num_mics
    c = acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    logger.info("Computed speed of sound: %.2f m/s", c)

    rows = None
    if signals is not None:
        if len(signals) != num_mics:
            raise ValueError("The number of injected signals must match the "
                             "number of microphones.")
        rows = [torch.tensor(np.asarray(s), dtype=dt, device=dev)
                for s in signals]
        logger.info("Using injected signals.")
    elif not use_simulation:
        if audio_files is None:
            raise ValueError(
                "Audio files must be provided when use_simulation=False.")
        if len(audio_files) != num_mics:
            raise ValueError("The number of audio files must match the "
                             "number of microphones.")
        rows = read_audio_files(audio_files, fs, dtype=dt, device=dev)
        logger.info("Real audio data loaded.")
    else:
        if scene.source_position is None:
            raise ValueError(
                "source_position must be provided when use_simulation=True.")
        if loc.lag_mode == "physical":
            sigs = simulate_signals_fast(
                scene.source_position, mic_positions, fs, c, scene.duration,
                scene.signal_type, scene.freq, scene.plane_coeffs,
                scene.plane_material_ids, scene.materials.absorption,
                scene.materials.freq, loc.max_reflections,
                loc.absorption_threshold, generator=generator, dtype=dt,
                device=dev, absorption_mode=scene.absorption_mode)
        else:
            if scene.absorption_mode != "carrier":
                raise ValueError(
                    "absorption_mode is a physical-mode simulation "
                    "extension; reference-parity mode keeps the carrier-"
                    "frequency attenuation law (utils.py:50-65)")
            # The reference's concrete padding rule and exact 2N render.
            sigs = simulate_signals(
                scene.source_position, mic_positions, fs, c, scene.duration,
                scene.signal_type, scene.freq, scene.plane_coeffs,
                scene.plane_material_ids, scene.materials.absorption,
                scene.materials.freq, loc.max_reflections,
                loc.absorption_threshold, trim_to_duration=True,
                generator=generator, dtype=dt, device=dev)
        logger.info("Simulated signals generated.")
    if loc.sync_mode == "reference":
        rows = synchronize_signals(list(sigs) if rows is None else rows, fs)
        logger.info("Signals synchronized.")
    if rows is not None:
        # Equal lengths: the trailing zero-pad of the reference's
        # pad-align (utils.py:448-456).
        max_len = max(int(r.shape[-1]) for r in rows)
        sigs = torch.stack([torch.nn.functional.pad(
            r, (0, max_len - r.shape[-1])) for r in rows])

    pairs = scene.mic_pairs
    pairs_i = tuple(p[0] for p in pairs)
    pairs_j = tuple(p[1] for p in pairs)
    n = sigs.shape[-1]
    grid_knobs, srp_lags = None, 0
    if loc.solver not in ("lm", "lm-robust"):
        grid_knobs = _srp_grid_knobs(scene, loc, fs, c)
    if loc.solver in ("srp", "srp+lm"):
        _, _, pool, max_lag = grid_knobs
        # SRP reads lags up to the diameter bound plus the pool width.
        srp_lags = max_lag + pool + 3
    if loc.lag_mode == "reference":
        # The reference's exact length n1 + n2 - 1: never a power of two,
        # so the GCC and the bootstrap take their exact-length routes (K7).
        nfft = fft_length(n, n, "exact")
    else:
        nfft = _physical_nfft(n, fs, loc.max_expected_delay, srp_lags)
    mics_t = torch.as_tensor(mic_positions, dtype=dt, device=dev)
    calib = _calibration_delays(calibration_data, num_mics, loc.lag_mode)
    calib_t = (None if calib is None
               else torch.as_tensor(calib, dtype=dt, device=dev))
    if _fast_path_eligible(loc, nfft, sigs.dtype, fs):
        core = _estimation_core_fast(
            sigs, mics_t, c, generator, calib_t, fs=fs, pairs_i=pairs_i,
            pairs_j=pairs_j, nfft=nfft,
            wq=tdoa_ops.window_wq(fs, loc.max_expected_delay, nfft),
            loc=loc)
    else:
        core = _estimation_core(sigs, mics_t, c, generator, calib_t, fs=fs,
                                pairs_i=pairs_i, pairs_j=pairs_j, nfft=nfft,
                                loc=loc, grid_knobs=grid_knobs)

    estimated = core["estimated_position"].double().cpu().numpy()
    cost = float(core["cost"])
    td_np = core["tdoas"].double().cpu().numpy()
    for (i, j), td in zip(pairs, td_np):
        logger.info("Time difference for mic pair %d-%d: %.6f s", i + 1,
                    j + 1, td)
        logger.info("Distance difference for mic pair %d-%d: %.3f m", i + 1,
                    j + 1, c * td)
    # The DE fallback serves the LM solvers only: the SRP cost is a finite
    # steered power by construction (api.py:774-778 of the JAX package).
    fallback_used = (not np.isfinite(cost)
                     and loc.solver in ("lm", "lm-robust"))
    if fallback_used:
        # Parity mode keeps the reference's scipy default tol=0.01
        # (main.py:281-292); physical mode the tighter 1e-6.
        estimated = _de_fallback(core, mics_t, c, generator, pairs_i,
                                 pairs_j,
                                 0.01 if loc.lag_mode == "reference" else
                                 1e-6)
    else:
        logger.info("Estimated source: (%.3f, %.3f, %.3f) m", *estimated)

    snr_np = (core["snr"].double().cpu().numpy()
              if loc.analyze_correlation else None)
    w_np = (uncertainty_ops.weights_from_snr(snr_np)
            if loc.analyze_correlation else None)
    if loc.solver in _NARROWBAND:
        # No TDOA residuals: the group jackknife's covariance.
        uncertainty = uncertainty_ops.summary_from_covariance(
            core["nb_covariance"].double().cpu().numpy(),
            dof=_NB_GROUPS - 1)
        uncertainty["heuristic"] = False
        logger.info("Position 1-sigma (x,y,z): (%.4f, %.4f, %.4f) m "
                    "(group jackknife)", *uncertainty["std"])
    else:
        uncertainty = uncertainty_ops.position_uncertainty(
            estimated, mic_positions, pairs_i, pairs_j, td_np, c,
            weights=w_np)
        if uncertainty is not None:
            # Gauss-Markov assumes a stationary point of the TDOA
            # least-squares cost.  Pure-grid SRP cells, an srp+lm whose
            # polish was rejected (the cost stayed the negated SRP power)
            # and the fallback's fix are not; their sigma is an
            # approximation.
            uncertainty["heuristic"] = bool(
                loc.solver == "srp"
                or (loc.solver == "srp+lm" and cost < 0.0) or fallback_used)
            logger.info("Position 1-sigma (x,y,z): (%.4f, %.4f, %.4f) m",
                        *uncertainty["std"])

    correlation_metrics = None
    if loc.analyze_correlation:
        ppr_np = core["peak_to_peak_ratio"].double().cpu().numpy()
        sig_np = core["significant"].cpu().numpy()
        correlation_metrics = {
            (i, j): {"peak_to_peak_ratio": float(ppr_np[k]),
                     "snr": float(snr_np[k]),
                     "significant": bool(sig_np[k])}
            for k, (i, j) in enumerate(pairs)
        }
        for pair, metrics in correlation_metrics.items():
            logger.info("Cross-correlation metrics for mic pair %d-%d: %s",
                        pair[0] + 1, pair[1] + 1, metrics)

    # The reference plots the 3-D scatter on every simulated run
    # (main.py:300-315), so parity mode always draws it; physical mode
    # only when asked to (api.py:877-887 of the JAX package).
    if use_simulation and (show_plots or loc.visualize_correlation
                           or loc.lag_mode == "reference"):
        _figures(scene, loc, estimated, core, pairs, fs, show_plots)

    return {
        "estimated_position": estimated,
        "actual_position": scene.source_position if use_simulation else None,
        "mic_positions": mic_positions,
        "correlation_metrics": correlation_metrics,
        "correlation_matrix": (core["correlation_matrix"].double().cpu()
                               .numpy() if loc.visualize_correlation
                               else None),
        "calibration_data": calibration_data,
        "tdoas": td_np,
        "cost": cost,
        "uncertainty": uncertainty,
    }
