"""Chirp-based microphone calibration (counterpart of the JAX package's
models/calibration.py; reference: calibration.py:10-105): generate a
calibration signal, simulate per-mic recordings (fractional delay + air
attenuation + Gaussian noise), estimate each mic's delay and amplitude by
plain cross-correlation.  The recording noise draws from an explicit
``torch.Generator`` (the reference uses the global NumPy RNG,
calibration.py:38).  Every transform is an exact-length ``torch.fft``
transform, the JAX package's XLA path: no TPU kernel took these lengths.

SURVEY.md Q2: with the reference's default material coefficients the air
attenuation underflows to ~1e-38, so simulated recordings are essentially
pure noise and the estimated delays are artifacts — reproduced faithfully
(the reference behaviour is the spec).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import signal as sig_ops
from ..ops.delay import delay_and_sum
from ..ops.fftutils import irfft_n, rfft_n
from ..utils.device import resolve_device
from . import acoustics
from .simulator import AIR_ID

# Correlation-peak SNR below which a calibration is noise, not signal: a
# matched chirp peak measures ~175 on this statistic even at unity
# signal/noise, while the max-of-noise artifact of a signal-free recording
# measures ~7 (sqrt(2 ln 2N) scaling).
CALIBRATION_SNR_GATE = 20.0


def generate_calibration_signal(fs: float, duration: float = 1.0,
                                signal_type: str = "chirp",
                                freq_start: float = 500.0,
                                freq_end: float = 5000.0, dtype=None,
                                device=None) -> torch.Tensor:
    """Chirp or unit impulse, normalized + compressed
    (calibration.py:10-21)."""
    n = int(fs * duration)
    dt = dtype if dtype is not None else torch.get_default_dtype()
    if signal_type == "chirp":
        sig = sig_ops.chirp_linear(fs, n, freq_start, freq_end, duration, dt,
                                   device)
    elif signal_type == "impulse":
        sig = torch.zeros(n, dtype=dt, device=device)
        sig[0] = 1.0
    else:
        raise ValueError(
            "Unsupported calibration signal type. Use 'chirp' or 'impulse'.")
    return sig_ops.dynamic_range_compression(sig_ops.normalize_signal(sig))


def simulate_calibration_recording(calib_signal: torch.Tensor,
                                   mic_positions, source_position,
                                   fs: float, c,
                                   generator: Optional[torch.Generator],
                                   attenuation_factor: float = 1.0,
                                   noise_level: float = 0.01,
                                   freq: float = 1000.0,
                                   absorption_table=None,
                                   freq_table=None) -> torch.Tensor:
    """Per-mic recordings (M, N): the calibration signal delayed by each
    mic's distance over c at the reference's 2N transform length (with its
    fade ramps) and attenuated as through air, plus noise_level times
    standard normal draws from ``generator`` (calibration.py:23-40)."""
    dt, dev = calib_signal.dtype, calib_signal.device
    if absorption_table is None:
        from ..utils.materials import default_table
        table = default_table()
        absorption_table, freq_table = table.absorption, table.freq
    mics = torch.as_tensor(np.asarray(mic_positions), dtype=dt, device=dev)
    src = torch.as_tensor(np.asarray(source_position), dtype=dt, device=dev)
    dists = torch.linalg.norm(src[None, :] - mics, dim=-1)        # (M,)
    delays = (dists / c)[:, None]                                 # (M, 1)
    atten = attenuation_factor * acoustics.calculate_attenuation(
        dists, AIR_ID, freq,
        torch.as_tensor(np.asarray(absorption_table), dtype=dt, device=dev),
        torch.as_tensor(np.asarray(freq_table), dtype=dt, device=dev))
    clean = delay_and_sum(calib_signal, delays, atten[:, None], fs,
                          pad_mode="exact")
    noise = torch.randn(clean.shape, generator=generator, dtype=dt,
                        device=dev)
    return clean + noise_level * noise


def full_cross_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """scipy.signal.correlate(a, b, mode='full') by exact-length transforms,
    batched over the leading axes of ``a``: out[k] = sum_m a[m] b[m - (k -
    (n_b - 1))]."""
    n1, n2 = a.shape[-1], b.shape[-1]
    n = n1 + n2 - 1
    circ = irfft_n(rfft_n(a, n) * torch.conj(rfft_n(b, n)), n)
    return torch.roll(circ, n2 - 1, dims=-1).to(a.dtype)


class CalibrationAnalysis(NamedTuple):
    delays: torch.Tensor      # (M,) seconds
    amplitudes: torch.Tensor  # (M,) peak |correlation|
    snr: torch.Tensor         # (M,) correlation-peak SNR (quality gate)


def analyze_calibration(recorded: torch.Tensor, calib_signal: torch.Tensor,
                        fs: float) -> CalibrationAnalysis:
    """Per-mic delay = lag of max |full correlation| / fs, amplitude = that
    peak (calibration.py:42-51, on scipy's consistent lag axis: no Q1
    defect here).  ``snr`` is the peak-over-off-peak-std statistic of
    |corr| (models/tdoa.correlation_snr), which separates a matched-filter
    peak (~175) from the max-of-noise artifact of a signal-free recording
    (~7); physical mode gates calibration on it."""
    from . import tdoa as tdoa_ops
    corr = full_cross_correlation(recorded, calib_signal)
    n2 = calib_signal.shape[-1]
    ac = torch.abs(corr)
    idx = torch.argmax(ac, dim=-1)
    lags = (idx - (n2 - 1)).to(ac.dtype)
    return CalibrationAnalysis(lags / fs, torch.amax(ac, dim=-1),
                               tdoa_ops.correlation_snr(ac))


def run_calibration(config, generator: Optional[torch.Generator] = None,
                    dtype=None, device=None
                    ) -> Tuple[List[dict], torch.Tensor, torch.Tensor]:
    """Reference-shaped orchestration (calibration.py:74-105): returns
    ([{'delay':, 'amplitude':, 'snr':}, ...], calib_signal, recordings).
    Runs on ``device`` (default ``cuda``; pass ``device="cpu"`` without a
    card); the recording noise draws from ``generator``, by default one
    seeded from the config's ``seed``."""
    dev = resolve_device(device)
    fs = config["fs"]
    duration = config["duration"]
    source_position = np.asarray(config["source_position"], float)
    mic_positions = np.asarray(config["mic_positions"], float)
    c = acoustics.speed_of_sound_host(config["celsius"], config["humidity"])
    cal = config.get("calibration", {})
    calib_signal = generate_calibration_signal(
        fs, duration, signal_type=cal.get("signal_type", "chirp"),
        freq_start=cal.get("freq_start", 500),
        freq_end=cal.get("freq_end", 5000), dtype=dtype, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(
            int(config.get("seed", 0)))
    recordings = simulate_calibration_recording(
        calib_signal, mic_positions, source_position, fs, c, generator,
        attenuation_factor=cal.get("attenuation_factor", 1.0),
        noise_level=cal.get("noise_level", 0.01))
    analysis = analyze_calibration(recordings, calib_signal, fs)
    results = [{"delay": float(d), "amplitude": float(a), "snr": float(s)}
               for d, a, s in zip(analysis.delays.tolist(),
                                  analysis.amplitudes.tolist(),
                                  analysis.snr.tolist())]
    return results, calib_signal, recordings
