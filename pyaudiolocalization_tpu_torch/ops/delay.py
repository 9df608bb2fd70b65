"""Fractional delays and the batched delay-and-sum render (counterpart of
the JAX package's ops/delay.py; reference: signal_processing.py:66-80).

The power-of-two renders ('pow2-circular', the physical path's, and
'pow2') go through ``ops/cuda_fft.delay_sum`` (its plain twin on the CPU,
kernel K3 on the card), as the JAX package's ``bfly_render_eligible``
sends a power-of-two length to its Pallas render.  The reference's exact
2N render ('exact', parity mode and calibration) is plain PyTorch, the
JAX package's XLA path: one rfft of the base, the per-mic sums of phase
ramps exp(-i 2 pi f delay), one irfft per mic.  So is a render with
per-bin absorption (``freq_slopes``) at any length: the JAX package's
Pallas render synthesizes scalar gains only, and sends such renders to
XLA (ops/delay.py:114 there).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import cuda_fft
from .fftutils import irfft_n, next_pow2, rfft_n


def fade_window(num_samples: int, fraction: float = 0.01, dtype=None,
                device=None) -> torch.Tensor:
    """Linear fade-in/out ramps over the first/last ``int(fraction*N)``
    samples (signal_processing.py:75-78)."""
    fade_length = int(fraction * num_samples)
    window = torch.ones(num_samples, dtype=dtype, device=device)
    if fade_length > 0:
        ramp = torch.linspace(0.0, 1.0, fade_length, dtype=dtype,
                              device=device)
        window[:fade_length] *= ramp
        window[num_samples - fade_length:] *= torch.flip(ramp, [0])
    return window


def _phase_ramp(padded_length: int, delays: torch.Tensor,
                fs: float) -> torch.Tensor:
    """exp(-i 2 pi f delay) over the rfft bins of ``padded_length``;
    ``delays`` of any batch shape gains a trailing frequency axis."""
    freqs = torch.fft.rfftfreq(padded_length, d=1.0 / fs,
                               dtype=delays.dtype, device=delays.device)
    theta = 2 * math.pi * freqs * delays[..., None]
    return torch.complex(torch.cos(theta), -torch.sin(theta))


def fractional_delay(signal: torch.Tensor, delay, fs: float) -> torch.Tensor:
    """Delay one 1-D signal by ``delay`` seconds: the phase ramp at the
    reference's 2N transform length, then the fade ramps
    (signal_processing.py:66-80)."""
    n = signal.shape[-1]
    padded = 2 * n
    ramp = _phase_ramp(padded, torch.as_tensor(delay, dtype=signal.dtype,
                                               device=signal.device), fs)
    out = irfft_n(rfft_n(signal, padded) * ramp, padded)[..., :n]
    return out.to(signal.dtype) * fade_window(n, dtype=signal.dtype,
                                              device=signal.device)

def delay_and_sum(base: torch.Tensor, delays: torch.Tensor,
                  gains: torch.Tensor, fs: float, apply_fade: bool = True,
                  pad_mode: str = "pow2-circular",
                  freq_slopes: Optional[torch.Tensor] = None,
                  freq_ref: float = 0.0) -> torch.Tensor:
    """Batched multipath render: for each channel m,
    ``out[m] = fade * sum_p gains[m, p] * delay(base, delays[m, p])``.

    base (..., N) real, delays (..., M, P) seconds, gains (..., M, P) ->
    (..., M, N).
    ``pad_mode``: 'exact' transforms at the reference's 2N; 'pow2' at
    next_pow2(2N), alias-free for any delay below N samples like 'exact';
    'pow2-circular' at next_pow2(N), circular: the caller guarantees the
    longest delay fits the padding.

    ``freq_slopes`` (..., M, P) shapes each path's gain per rfft bin by
    exp(-freq_slopes * (f - freq_ref)), the reference's exp(-freq_coeff *
    f * d) term at every bin instead of one carrier.  The caller references
    ``gains`` at or below the band's strongest-response frequency (the
    simulator passes f = 0 gains with ``freq_ref`` 0, so the exponent is
    never positive); for other references the exponent is clamped to an
    exp-safe value so that a dead path (gain 0, finite slope) stays 0, not
    0 * inf."""
    n = base.shape[-1]
    if pad_mode == "exact":
        padded = 2 * n
    elif pad_mode == "pow2":
        padded = next_pow2(2 * n)
    elif pad_mode == "pow2-circular":
        padded = next_pow2(n)
    else:
        raise ValueError(
            f"pad_mode must be 'exact', 'pow2' or 'pow2-circular', got "
            f"{pad_mode!r}")
    fade = (fade_window(n, dtype=base.dtype, device=base.device)
            if apply_fade else
            torch.ones(n, dtype=base.dtype, device=base.device))
    if pad_mode != "exact" and freq_slopes is None:
        return cuda_fft.delay_sum(
            base, (delays * fs).to(base.dtype).contiguous(),
            gains.to(base.dtype).contiguous(), padded, n, fade,
            finalize=False)
    spec = rfft_n(base, padded)                              # (..., F)
    ramps = _phase_ramp(padded, delays.to(base.dtype), fs)   # (..., M, P, F)
    if freq_slopes is None:
        mixed = torch.einsum("...mp,...mpf->...mf", gains.to(ramps.dtype),
                             ramps) * spec[..., None, :]
    else:
        freqs = torch.fft.rfftfreq(padded, d=1.0 / fs, dtype=base.dtype,
                                   device=base.device)
        arg = -freq_slopes.to(base.dtype)[..., None] * (freqs - freq_ref)
        max_arg = float(np.log(torch.finfo(base.dtype).max)) - 8.0
        shaped = gains.to(base.dtype)[..., None] * torch.exp(
            torch.clamp(arg, max=max_arg))
        mixed = torch.einsum("...mpf,...mpf->...mf", shaped.to(ramps.dtype),
                             ramps) * spec[..., None, :]
    return irfft_n(mixed, padded)[..., :n].to(base.dtype) * fade
