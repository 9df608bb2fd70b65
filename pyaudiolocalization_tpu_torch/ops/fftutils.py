"""FFT length helpers and exact-length real transforms (counterpart of the
JAX package's ops/fftutils.py).

``torch.fft`` takes any length on both devices, so the TPU's Bluestein
chirp-z transform and packed-pair helpers have no counterpart here, and
the kernels carry their own power-of-two transforms (ops/cuda_fft.py).
``rfft_n`` / ``irfft_n`` serve only the stages where the JAX package ran
no TPU kernel either (the unfused GCC branch, any length).
"""

from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def fft_length(n1: int, n2: int, mode: str = "pow2") -> int:
    """Linear-correlation FFT length for signals of length n1 and n2.

    mode='exact' is the reference's n1+n2-1; mode='pow2' rounds it up to a
    power of two; mode='circular' is next_pow2(max(n1, n2)), a circular
    correlation whose far lags alias (physical mode only).
    """
    n = n1 + n2 - 1
    if mode == "exact":
        return n
    if mode == "pow2":
        return next_pow2(n)
    if mode == "circular":
        return next_pow2(max(n1, n2))
    raise ValueError(f"unknown fft length mode {mode!r}")


def rfft_n(x: torch.Tensor, n: int) -> torch.Tensor:
    """``np.fft.rfft(x, n=n)``: the last axis zero-padded or truncated to
    n samples."""
    return torch.fft.rfft(x, n=n)


def irfft_n(spec: torch.Tensor, n: int) -> torch.Tensor:
    """``np.fft.irfft(spec, n=n)``: the half spectrum truncated or
    zero-padded to n//2 + 1 bins, the imaginary parts of DC and (even n)
    Nyquist ignored.  Those are zeroed explicitly: cuFFT's float32 inverse
    does not ignore an imaginary Nyquist part."""
    bins = n // 2 + 1
    spec = spec[..., :bins]
    if spec.shape[-1] < bins:
        pad = torch.zeros(spec.shape[:-1] + (bins - spec.shape[-1],),
                          dtype=spec.dtype, device=spec.device)
        spec = torch.cat([spec, pad], -1)
    else:
        spec = spec.clone()
    spec.imag[..., 0] = 0.0
    if n % 2 == 0:
        spec.imag[..., n // 2] = 0.0
    return torch.fft.irfft(spec, n=n)
