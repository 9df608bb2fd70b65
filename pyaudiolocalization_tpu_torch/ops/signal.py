"""Signal generators and amplitude processing (counterpart of the JAX
package's ops/signal.py; reference: signal_processing.py:11-103).

Generators take an explicit ``dtype`` and ``device``; the stochastic types
('noise', 'speech') draw from an explicit ``torch.Generator``, in the JAX
package's order of draws.  The shaping after the draws is split into
private helpers that take the draws, so that tests can feed arrays drawn
on the JAX side.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .fftutils import irfft_n, rfft_n


def time_axis(fs: float, num_samples: int, dtype=None,
              device=None) -> torch.Tensor:
    """t = arange(N)/fs (signal_processing.py:26)."""
    return (torch.arange(num_samples, dtype=dtype, device=device)
            / torch.tensor(fs, dtype=dtype, device=device))


def normalize_signal(signal: torch.Tensor) -> torch.Tensor:
    """Peak-normalize along the last axis; silent signals pass through
    unchanged (signal_processing.py:82-86)."""
    max_val = torch.amax(torch.abs(signal), dim=-1, keepdim=True)
    safe = torch.where(max_val == 0, torch.ones_like(max_val), max_val)
    return torch.where(max_val == 0, signal, signal / safe)


def dynamic_range_compression(signal: torch.Tensor,
                              threshold: float = 0.8,
                              epsilon: float = 1e-8) -> torch.Tensor:
    """Logarithmic compression, re-peak-normalized
    (signal_processing.py:88-94)."""
    x = normalize_signal(signal)
    compressed = torch.sign(x) * torch.log1p(torch.abs(x) / threshold
                                             + epsilon)
    max_val = torch.amax(torch.abs(compressed), dim=-1, keepdim=True)
    safe = torch.where(max_val == 0, torch.ones_like(max_val), max_val)
    return torch.where(max_val > 0, compressed / safe, compressed)


def dynamic_range_compression_soft_clip(signal: torch.Tensor,
                                        threshold: float = 0.8
                                        ) -> torch.Tensor:
    """Piecewise soft clip above ``threshold`` of the peak-normalized
    signal (signal_processing.py:96-103; dead code in the reference, kept
    for the compat layer)."""
    x = normalize_signal(signal)
    return torch.where(
        torch.abs(x) > threshold,
        torch.sign(x) * (threshold + (torch.abs(x) - threshold) * 0.5), x)

def sine(fs: float, num_samples: int, freq, dtype=None,
         device=None) -> torch.Tensor:
    t = time_axis(fs, num_samples, dtype, device)
    return torch.sin(2 * math.pi * freq * t)


def chirp_linear(fs: float, num_samples: int, f0, f1, t1: float,
                 dtype=None, device=None) -> torch.Tensor:
    """Linear chirp with scipy.signal.chirp semantics (phi=0):
    cos(2*pi*(f0*t + (f1-f0)/(2*t1)*t^2)) (signal_processing.py:32)."""
    t = time_axis(fs, num_samples, dtype, device)
    phase = 2 * math.pi * (f0 * t + 0.5 * (f1 - f0) / t1 * t * t)
    return torch.cos(phase)


def white_noise(generator: torch.Generator, num_samples: int, dtype=None,
                device=None, batch: Optional[int] = None) -> torch.Tensor:
    shape = (num_samples,) if batch is None else (batch, num_samples)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def _pink_from_white(white: torch.Tensor, fs: float) -> torch.Tensor:
    """White noise (..., N) shaped by 1/sqrt(f) in the rfft domain, DC
    zeroed, then normalized and compressed (signal_processing.py:11-23)."""
    n = white.shape[-1]
    spec = rfft_n(white, n)
    freqs = torch.fft.rfftfreq(n, d=1.0 / fs, dtype=white.dtype,
                               device=white.device)
    positive = freqs > 0
    scaling = torch.where(positive, 1.0 / torch.sqrt(
        torch.where(positive, freqs, torch.ones_like(freqs))),
        torch.zeros_like(freqs))
    pink = irfft_n(spec * scaling, n).to(white.dtype)
    return dynamic_range_compression(normalize_signal(pink))


def pink_noise(generator: torch.Generator, fs: float, num_samples: int,
               dtype=None, device=None) -> torch.Tensor:
    """Pink noise: one white draw from ``generator`` through
    ``_pink_from_white``."""
    return _pink_from_white(white_noise(generator, num_samples, dtype,
                                        device), fs)


def _speech_from_draws(fs: float, num_samples: int, starts: torch.Tensor,
                       bursts: torch.Tensor,
                       white: torch.Tensor) -> torch.Tensor:
    """Synthetic speech from its draws: 3 Hann-windowed formants, the
    transient ``bursts`` (num_transients, int(0.01 fs), already drawn
    normal) windowed by the symmetric Hann and added at ``starts``, and 5 %
    pink noise from ``white`` (signal_processing.py:38-64)."""
    dt, dev = white.dtype, white.device
    t = time_axis(fs, num_samples, dt, dev)
    f = torch.tensor([800.0, 1150.0, 2900.0], dtype=dt, device=dev)
    a = torch.tensor([1.0, 0.8, 0.5], dtype=dt, device=dev)
    phi = torch.tensor([0.0, math.pi / 4, math.pi / 2], dtype=dt, device=dev)
    # scipy get_window('hann') is the periodic Hann (cos over N), unlike
    # np.hanning's symmetric one (cos over N - 1).
    idx = torch.arange(num_samples, dtype=dt, device=dev)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * idx / num_samples)
    s_formant = torch.sum(a[:, None] * torch.sin(
        2 * math.pi * f[:, None] * t[None, :] + phi[:, None]), 0) * window
    s_transient = torch.zeros(num_samples, dtype=dt, device=dev)
    if bursts.numel():
        length = bursts.shape[-1]
        hann = torch.as_tensor(np.hanning(length), dtype=dt, device=dev)
        pos = (starts.to(torch.long)[:, None]
               + torch.arange(length, device=dev)[None, :])
        s_transient.index_add_(0, pos.reshape(-1),
                               (bursts.to(dt) * hann).reshape(-1))
    s = s_formant + s_transient + _pink_from_white(white, fs) * 0.05
    return dynamic_range_compression(normalize_signal(s))


def realistic_speech(generator: torch.Generator, fs: float,
                     num_samples: int, duration: float, dtype=None,
                     device=None) -> torch.Tensor:
    """Synthetic speech (``_speech_from_draws``), drawing in the JAX
    package's order: the transients' starts, their normal bursts, then the
    pink noise's white draw."""
    num_transients = int(duration * 5)
    transient_samples = int(0.01 * fs)
    if num_transients > 0 and transient_samples > 0:
        starts = torch.randint(0, num_samples - transient_samples,
                               (num_transients,), generator=generator,
                               device=device)
        bursts = torch.randn((num_transients, transient_samples),
                             generator=generator, dtype=dtype, device=device)
    else:
        starts = torch.zeros(0, dtype=torch.long, device=device)
        bursts = torch.zeros((0, 0), dtype=dtype, device=device)
    white = white_noise(generator, num_samples, dtype, device)
    return _speech_from_draws(fs, num_samples, starts, bursts, white)


def generate_signal(signal_type: str, fs: float, duration: float, freq,
                    generator: Optional[torch.Generator] = None, dtype=None,
                    device=None, batch: Optional[int] = None) -> torch.Tensor:
    """Dispatcher matching generate_signal (signal_processing.py:25-36).
    ``freq`` may be a Python float or a 0-d tensor of ``dtype``.  With
    ``batch``, returns (batch, N): one draw of independent noise rows, or
    the deterministic signal repeated."""
    num_samples = int(fs * duration)
    if signal_type in ("noise", "speech") and generator is None:
        raise ValueError(f"signal_type {signal_type!r} requires a "
                         "torch.Generator")
    if signal_type == "noise":
        return white_noise(generator, num_samples, dtype, device, batch)
    if signal_type == "sine":
        out = sine(fs, num_samples, freq, dtype, device)
    elif signal_type == "chirp":
        out = chirp_linear(fs, num_samples, freq, freq * 5, duration, dtype,
                           device)
    elif signal_type == "speech":
        if batch is not None:
            return torch.stack([realistic_speech(generator, fs, num_samples,
                                                 duration, dtype, device)
                                for _ in range(batch)])
        return realistic_speech(generator, fs, num_samples, duration, dtype,
                                device)
    else:
        raise ValueError(
            "Unknown signal type. Available types: 'sine', 'noise', "
            "'chirp', 'speech'")
    return out if batch is None else out.expand(batch, num_samples)
