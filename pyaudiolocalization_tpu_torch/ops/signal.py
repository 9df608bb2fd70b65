"""Signal generators and amplitude processing (counterpart of the JAX
package's ops/signal.py; reference: signal_processing.py:11-103).

Generators take an explicit ``dtype`` and ``device``; the stochastic type
('noise') draws from an explicit ``torch.Generator``.  'speech' belongs to
a later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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


def generate_signal(signal_type: str, fs: float, duration: float, freq,
                    generator: Optional[torch.Generator] = None, dtype=None,
                    device=None, batch: Optional[int] = None) -> torch.Tensor:
    """Dispatcher matching generate_signal (signal_processing.py:25-36).
    ``freq`` may be a Python float or a 0-d tensor of ``dtype``.  With
    ``batch``, returns (batch, N): one draw of independent noise rows, or
    the deterministic signal repeated."""
    num_samples = int(fs * duration)
    if signal_type == "noise":
        if generator is None:
            raise ValueError("signal_type 'noise' requires a torch.Generator")
        return white_noise(generator, num_samples, dtype, device, batch)
    if signal_type == "sine":
        out = sine(fs, num_samples, freq, dtype, device)
    elif signal_type == "chirp":
        out = chirp_linear(fs, num_samples, freq, freq * 5, duration, dtype,
                           device)
    elif signal_type == "speech":
        raise NotImplementedError(
            "signal_type 'speech' is not ported yet; it follows with the "
            "parity-mode slice")
    else:
        raise ValueError(
            "Unknown signal type. Available types: 'sine', 'noise', "
            "'chirp', 'speech'")
    return out if batch is None else out.expand(batch, num_samples)
