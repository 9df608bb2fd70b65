"""Drop-in compatibility layer: every reference function under its original
name and call signature (counterpart of the JAX package's compat.py).

A PyAudioLocalization user imports from ``main``, ``utils``,
``signal_processing``, ``calibration``, ``materials`` and ``plotting``; this
module collapses those surfaces into one:

    from pyaudiolocalization_tpu_torch import compat as utils
    delays, corr, lags = utils.get_time_delays_phat(s1, s2, fs)

Inputs and outputs are NumPy, converted at the boundary to torch's default
dtype (float32 unless the caller sets another, as the JAX package converts
to its default float) on ``device``, the one keyword each function adds:
``cuda`` by default, ``device="cpu"`` without a card
(utils/device.resolve_device).  On a card in float32 the math runs through
the port's kernels where the JAX package runs its Pallas ones: a PHAT
correlation at a power-of-two length n1 + n2 - 1 through K4a and K9, at any
other length through torch.fft and K7's whitening; the permutation null at
a power of two through K4a and K4b.  Functions keep the reference's
semantics, its documented defects included (SURVEY.md Q1-Q5): e.g.
``get_time_delays_phat`` uses the reference's scipy-'full' lag mapping.
The reference never seeds its global NumPy RNG; the stochastic functions
here draw from a module generator a device, which ``seed()`` resets
(deterministic by default).  Its streams are torch's, not ``jax.random``'s.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .api import (  # noqa: F401
    localize_sound_source, simulate_signals_with_multipath)
from .models import acoustics as _ac
from .models import calibration as _cal
from .models import solver as _solver
from .models import sync as _sync
from .models import tdoa as _tdoa
from .models.calibration import run_calibration  # noqa: F401
from .ops import delay as _delay
from .ops import filters as _filters
from .ops import gccphat as _gcc
from .ops import resample as _resample
from .ops import signal as _sig
from .utils.audio_io import read_audio_files as _read_audio_files
from .utils.device import resolve_device
from .utils.materials import MaterialTable, material_properties  # noqa: F401
from .utils.plotting import (  # noqa: F401
    plot_calibration_results, plot_correlation_3d, plot_correlation_heatmap)

logger = logging.getLogger(__name__)

_seed = 0
_generators: Dict[str, torch.Generator] = {}


def seed(n: int) -> None:
    """Reset the module generators (the reference relies on NumPy's
    unseeded global RNG; here randomness is explicit and deterministic):
    each device's generator restarts from ``n``."""
    global _seed
    _seed = int(n)
    _generators.clear()


def _generator(dev: torch.device) -> torch.Generator:
    key = str(dev)
    if key not in _generators:
        _generators[key] = torch.Generator(device=dev).manual_seed(_seed)
    return _generators[key]


def _t(x, dev: torch.device) -> torch.Tensor:
    # A copy: the caller's array may be read-only, and stays untouched.
    return torch.tensor(np.asarray(x), dtype=torch.get_default_dtype(),
                        device=dev)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _pairs(mic_pairs) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    return (tuple(int(p[0]) for p in mic_pairs),
            tuple(int(p[1]) for p in mic_pairs))


# ---------------------------------------------------------------------------
# utils.py counterparts
# ---------------------------------------------------------------------------

def speed_of_sound(temperature: float, humidity: float,
                   pressure: float = 101.325, *, device=None) -> float:
    """utils.py:15-27."""
    dev = resolve_device(device)
    return float(_ac.speed_of_sound(_t(temperature, dev), _t(humidity, dev),
                                    pressure))


def reflect_point_across_plane(point, plane, *, device=None) -> np.ndarray:
    """utils.py:29-42 (raises on a degenerate plane, like the reference)."""
    plane = np.asarray(plane, float)
    if np.allclose(plane[:3], 0.0):
        raise ValueError("Invalid plane: normal vector cannot be zero.")
    dev = resolve_device(device)
    return _np(_ac.reflect_point_across_plane(_t(point, dev), _t(plane, dev)))


def distance(point1, point2, *, device=None) -> float:
    """utils.py:44-48."""
    dev = resolve_device(device)
    return float(_ac.distance(_t(point1, dev), _t(point2, dev)))


def calculate_attenuation(distance_val: float, material: str,
                          frequency: float,
                          material_properties: Dict[str, Any], *,
                          device=None) -> float:
    """utils.py:50-65 (an unknown material warns and falls back to
    'air')."""
    dev = resolve_device(device)
    table = MaterialTable.from_dict(material_properties)
    if material not in table.ids:
        logger.warning("Material '%s' not defined; falling back to 'air'.",
                       material)
    mid = table.id_of(material, strict=False)
    return float(_ac.calculate_attenuation(
        _t(float(distance_val), dev), mid, float(frequency),
        _t(table.absorption, dev), _t(table.freq, dev)))


def generate_image_sources_iterative(source, planes, max_order: int,
                                     frequency: float,
                                     material_properties: Dict[str, Any],
                                     mic_positions,
                                     absorption_threshold: float = 0.01,
                                     round_decimals: int = 6, *,
                                     device=None) -> List[Dict[str, Any]]:
    """utils.py:67-106: [{'source': xyz, 'material': name}, ...] in the
    reference's BFS order (rejected nodes omitted)."""
    dev = resolve_device(device)
    table = MaterialTable.from_dict(material_properties)
    coeffs = np.array([p["plane"] for p in planes], float).reshape(
        len(planes), 4) if planes else np.zeros((0, 4))
    mat_ids = np.array([table.id_of(p.get("material", "air"), strict=True)
                        for p in planes], np.int64)
    img = _ac.image_sources(
        _t(source, dev), _t(coeffs, dev), torch.as_tensor(mat_ids,
                                                          device=dev),
        _t(mic_positions, dev), float(frequency), _t(table.absorption, dev),
        _t(table.freq, dev), int(max_order), float(absorption_threshold),
        round_decimals)
    positions = _np(img.positions)
    accepted = _np(img.accepted)
    ids = _np(img.material_ids)
    return [{"source": positions[i], "material": table.names[ids[i]]}
            for i in range(positions.shape[0]) if accepted[i]]


def phat_correlation(sig1, sig2, *, device=None) -> np.ndarray:
    """utils.py:108-119: circular-order whitened correlation at n1+n2-1."""
    dev = resolve_device(device)
    return _np(_gcc.phat_correlation(_t(sig1, dev), _t(sig2, dev)))


def get_time_delays_phat(sig1, sig2, fs: float, num_peaks: int = 1,
                         threshold_method: str = "median",
                         threshold_multiplier: float = 1.0,
                         max_expected_delay: Optional[float] = None,
                         *, lag_mode: str = "reference", device=None
                         ) -> Tuple[List[float], np.ndarray, np.ndarray]:
    """utils.py:121-181: (delays, corr, time_lags).  lag_mode='reference'
    reproduces defect Q1 exactly; pass 'physical' for correct lags."""
    dev = resolve_device(device)
    res = _tdoa.get_time_delays_phat(
        _t(sig1, dev), _t(sig2, dev), fs, num_peaks=num_peaks,
        threshold_method=threshold_method,
        threshold_multiplier=threshold_multiplier,
        max_expected_delay=max_expected_delay, lag_mode=lag_mode)
    delays = [float(d) for d, v in zip(_np(res.delays), _np(res.valid))
              if v]
    return delays, _np(res.corr), _np(res.time_lags)


def bootstrap_significance(sig1, sig2, fs: float, num_bootstrap: int = 1000,
                           alpha: float = 0.05,
                           bootstrap_mode: str = "permutation",
                           block_size: int = 50, *, device=None) -> float:
    """utils.py:183-216 (randomness from the module generator; see
    seed())."""
    dev = resolve_device(device)
    return float(_tdoa.bootstrap_significance(
        _t(sig1, dev), _t(sig2, dev), _generator(dev),
        num_bootstrap=num_bootstrap, alpha=alpha,
        bootstrap_mode=bootstrap_mode, block_size=block_size))


def perform_significance_test_bootstrap(sig1, sig2, fs: float,
                                        alpha: float = 0.05, *, device=None
                                        ) -> Tuple[float, bool]:
    """utils.py:218-226: (peak, significant against the bootstrap
    threshold)."""
    peak = float(np.max(phat_correlation(sig1, sig2, device=device)))
    thr = bootstrap_significance(sig1, sig2, fs, alpha=alpha, device=device)
    return peak, bool(peak > thr)


def compute_peak_to_peak_ratio(corr, *, device=None) -> float:
    """utils.py:228-236."""
    return float(_tdoa.peak_to_peak_ratio(_t(corr, resolve_device(device))))


def compute_snr(corr, *, device=None) -> float:
    """utils.py:238-250."""
    return float(_tdoa.correlation_snr(_t(corr, resolve_device(device))))


def perform_significance_test(corr, sig1, sig2, fs: float,
                              alpha: float = 0.05,
                              snr_threshold: float = 2.0, *, device=None
                              ) -> Tuple[float, bool]:
    """utils.py:252-259: (snr, significant)."""
    dev = resolve_device(device)
    snr, significant = _tdoa.significance_test(
        _t(corr, dev), _t(sig1, dev), _t(sig2, dev), _generator(dev),
        alpha=alpha, snr_threshold=snr_threshold)
    return float(snr), bool(significant)


def compute_cross_correlation_metrics(corr, sig1, sig2, fs: float,
                                      alpha: float = 0.05, *, device=None
                                      ) -> Dict[str, Any]:
    """utils.py:261-271."""
    dev = resolve_device(device)
    out = _tdoa.cross_correlation_metrics(
        _t(corr, dev), _t(sig1, dev), _t(sig2, dev), _generator(dev),
        alpha=alpha)
    return {"peak_to_peak_ratio": float(out["peak_to_peak_ratio"]),
            "snr": float(out["snr"]),
            "significant": bool(out["significant"])}


def determine_optimal_number_of_clusters(data, max_clusters: int = 5,
                                         method: str = "kmeans",
                                         eps: float = 0.001,
                                         min_samples: int = 2, *,
                                         device=None) -> int:
    """utils.py:273-302."""
    pts = np.asarray(data, float).reshape(-1, np.asarray(data).shape[-1]) \
        if len(data) else np.zeros((0, 3))
    if pts.shape[0] < 2:
        return 1
    dev = resolve_device(device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    return _solver.optimal_cluster_count(
        _t(pts, dev), valid, _generator(dev), max_clusters=max_clusters,
        method=method, eps=eps, min_samples=min_samples)


def heuristic_initialization_adaptive(mic_positions, mic_pairs, tdoas,
                                      c: float,
                                      clustering_method: str = "kmeans",
                                      eps: float = 0.001,
                                      min_samples: int = 2, *, device=None
                                      ) -> List[List[float]]:
    """utils.py:304-362: clustered initial guesses and the mic
    centroid."""
    dev = resolve_device(device)
    pi, pj = _pairs(mic_pairs)
    guesses, valid = _solver.heuristic_initial_guesses(
        _t(mic_positions, dev), pi, pj, _t(tdoas, dev), float(c),
        _generator(dev), clustering_method=clustering_method, eps=eps,
        min_samples=min_samples)
    g, v = _np(guesses), _np(valid)
    return [g[i].tolist() for i in range(g.shape[0]) if v[i]]


def dynamic_bounds_extended(mic_positions, tdoas, c: float,
                            buffer: float = 5.0, *, device=None
                            ) -> List[Tuple[float, float]]:
    """utils.py:364-382: per-axis (lower, upper) list."""
    dev = resolve_device(device)
    lower, upper = _solver.dynamic_bounds(_t(mic_positions, dev),
                                          _t(tdoas, dev), float(c),
                                          buffer=buffer)
    return list(zip(_np(lower).tolist(), _np(upper).tolist()))


def equations(vars, mic_positions, mic_pairs, tdoas, c: float,
              weights=None, *, device=None) -> List[float]:
    """utils.py:384-405: the weighted TDOA residual system."""
    if weights is not None and len(weights) != len(mic_pairs):
        raise ValueError(
            "Length of weights must match the number of microphone pairs.")
    dev = resolve_device(device)
    pi, pj = _pairs(mic_pairs)
    w = (_t(weights, dev) if weights is not None else
         torch.ones(len(mic_pairs), dtype=torch.get_default_dtype(),
                    device=dev))
    r = _solver.tdoa_residuals(_t(vars, dev), _t(mic_positions, dev), pi, pj,
                               _t(tdoas, dev), float(c), w)
    return _np(r).tolist()


def synchronize_signals_improved(signals, fs: float,
                                 use_interpolation: bool = True, *,
                                 device=None) -> List[np.ndarray]:
    """utils.py:407-457."""
    dev = resolve_device(device)
    return [_np(s) for s in _sync.synchronize_signals(
        [_t(s, dev) for s in signals], fs, use_interpolation)]


def read_audio_files(audio_files: List[str], expected_fs: float, *,
                     device=None) -> List[np.ndarray]:
    """utils.py:459-482 (resampling, normalization and compression on
    ``device``)."""
    return [_np(s) for s in _read_audio_files(audio_files, expected_fs,
                                              device=device)]


def compute_weights(correlation_metrics, mic_pairs, *,
                    device=None) -> np.ndarray:
    """utils.py:484-497: each pair's SNR weight (1.0 if missing),
    normalized by the mean."""
    weights = []
    for pair in mic_pairs:
        metrics = correlation_metrics.get(pair, None) \
            if correlation_metrics else None
        weights.append(metrics.get("snr", 1.0) if metrics is not None else 1.0)
    return _np(_tdoa.compute_weights(_t(weights, resolve_device(device))))


# ---------------------------------------------------------------------------
# signal_processing.py counterparts
# ---------------------------------------------------------------------------

def generate_pink_noise(fs: float, duration: float, *,
                        device=None) -> np.ndarray:
    """signal_processing.py:11-23."""
    dev = resolve_device(device)
    return _np(_sig.pink_noise(_generator(dev), fs, int(fs * duration),
                               torch.get_default_dtype(), dev))


def generate_signal(signal_type: str, fs: float, duration: float,
                    freq: float, *, device=None) -> np.ndarray:
    """signal_processing.py:25-36."""
    dev = resolve_device(device)
    return _np(_sig.generate_signal(signal_type, fs, duration, freq,
                                    generator=_generator(dev),
                                    dtype=torch.get_default_dtype(),
                                    device=dev))


def generate_realistic_speech(fs: float, duration: float, *,
                              device=None) -> np.ndarray:
    """signal_processing.py:38-64."""
    dev = resolve_device(device)
    return _np(_sig.realistic_speech(_generator(dev), fs, int(fs * duration),
                                     duration, torch.get_default_dtype(),
                                     dev))


def fractional_delay(signal, delay: float, fs: float, *,
                     device=None) -> np.ndarray:
    """signal_processing.py:66-80."""
    return _np(_delay.fractional_delay(_t(signal, resolve_device(device)),
                                       delay, fs))


def normalize_signal(signal, *, device=None) -> np.ndarray:
    """signal_processing.py:82-86."""
    return _np(_sig.normalize_signal(_t(signal, resolve_device(device))))


def dynamic_range_compression(signal, threshold: float = 0.8,
                              epsilon: float = 1e-8, *,
                              device=None) -> np.ndarray:
    """signal_processing.py:88-94."""
    return _np(_sig.dynamic_range_compression(
        _t(signal, resolve_device(device)), threshold, epsilon))


def dynamic_range_compression_soft_clip(signal, threshold: float = 0.8, *,
                                        device=None) -> np.ndarray:
    """signal_processing.py:96-103 (dead code in the reference)."""
    return _np(_sig.dynamic_range_compression_soft_clip(
        _t(signal, resolve_device(device)), threshold))


def resample_audio(data, original_fs: float, target_fs: float, *,
                   device=None) -> np.ndarray:
    """signal_processing.py:105-107 (resampy's kaiser_best
    construction)."""
    return _np(_resample.resample(_t(data, resolve_device(device)),
                                  original_fs, target_fs))


def noise_reduction(signal, fs: float, method: str = "butterworth",
                    lowcut: float = 300, highcut: float = 3400,
                    filter_order: int = 101, *, device=None) -> np.ndarray:
    """signal_processing.py:109-138."""
    return _np(_filters.noise_reduction(
        _t(signal, resolve_device(device)), fs, method=method, lowcut=lowcut,
        highcut=highcut, filter_order=filter_order))


# ---------------------------------------------------------------------------
# calibration.py counterparts (also re-exported above)
# ---------------------------------------------------------------------------

def generate_calibration_signal(fs, duration: float = 1.0,
                                signal_type: str = "chirp",
                                freq_start: float = 500,
                                freq_end: float = 5000, *,
                                device=None) -> np.ndarray:
    """calibration.py:10-21."""
    return _np(_cal.generate_calibration_signal(
        fs, duration, signal_type, freq_start, freq_end,
        device=resolve_device(device)))


def analyze_calibration(recorded_signals, calib_signal, fs, *,
                        device=None) -> List[Dict[str, float]]:
    """calibration.py:42-51: [{'delay': s, 'amplitude': a}, ...]."""
    dev = resolve_device(device)
    rec = torch.stack([_t(r, dev) for r in recorded_signals])
    out = _cal.analyze_calibration(rec, _t(calib_signal, dev), fs)
    return [{"delay": float(d), "amplitude": float(a)}
            for d, a in zip(_np(out.delays), _np(out.amplitudes))]


def simulate_calibration_recording(calib_signal, mic_positions,
                                   source_position, fs, c,
                                   attenuation_factor: float = 1.0,
                                   noise_level: float = 0.01,
                                   freq=None, material_properties=None, *,
                                   device=None) -> List[np.ndarray]:
    """calibration.py:23-40 (freq defaults to 1000 Hz, as in the
    reference)."""
    dev = resolve_device(device)
    if material_properties is not None:
        table = MaterialTable.from_dict(material_properties)
        absorption, ftab = table.absorption, table.freq
    else:
        absorption = ftab = None
    rec = _cal.simulate_calibration_recording(
        _t(calib_signal, dev), np.asarray(mic_positions, float),
        np.asarray(source_position, float), fs, c, _generator(dev),
        attenuation_factor=attenuation_factor, noise_level=noise_level,
        freq=1000.0 if freq is None else float(freq),
        absorption_table=absorption, freq_table=ftab)
    return [_np(rec[i]) for i in range(rec.shape[0])]
