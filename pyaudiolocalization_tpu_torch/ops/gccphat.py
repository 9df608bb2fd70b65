"""Generalized cross-correlation (counterpart of the JAX package's
ops/gccphat.py; reference: utils.py:108-119).

``corr = irfft( weight(F s_i * conj F s_j) * band )``.  Two branches, as
in the JAX package:

* fused: PHAT for every pair in one call to kernel K1
  (ops/cuda_fft.gcc_all_pairs) when the transform length is a power of two
  no shorter than the signals and ``use_pallas != 'never'``;
* unfused: ``torch.fft`` spectra, the weighting (PHAT through kernel K7,
  ``cuda_fft.whiten``; SCOT, Roth, CC and ML as plain tensor arithmetic,
  which had no TPU kernel either), the band mask, the inverse.  It is
  taken for the other weightings, for ``use_pallas='never'`` and for the
  lengths K1 cannot take.

K1 takes any leading (scene) axes, so the sweep's full-correlation branch
runs it over every scene in one launch.  ``phat_correlation`` (one
pair) at a power-of-two length no shorter than both signals runs K4a (both
spectra in one launch) and K9 (``cuda_fft.whitened_corr``); at any other
length it takes the unfused route.  Parity mode's exact length 2n - 1 is
never a power of two, so its correlations always take the unfused route
(K7).  On the CPU the kernels' plain twins run.  Both lag conventions are
here: the reference's positional axis (``lags_reference``, SURVEY.md Q1)
and the physical decoding.

``gcc_phat_streaming`` is the Welch-averaged GCC of long captures: Hann
(or rectangular) frames cut by one ``unfold``, the mean cross and auto
spectra over frames, any weighting (PHAT through K7 on a CUDA tensor, as
parity mode's; the JAX package whitens on XLA there by default), the
inverse at the frame length and the centred +-``max_lag`` slice.
``tdoa_from_streaming`` reads its peak with parabolic refinement.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from . import cuda_fft
from .fftutils import fft_length, irfft_n, rfft_n

PHAT_EPS = cuda_fft.PHAT_EPS

#: Generalized cross-correlation weightings (Knapp & Carter 1976): 'phat'
#: is the reference's estimator; 'cc' unweighted; 'roth' divides by the
#: first channel's auto-spectrum; 'scot' by the geometric mean of both;
#: 'ml' is Hannan-Thomson, meaningful only with averaged spectra.
GCC_WEIGHTINGS = ("phat", "scot", "roth", "cc", "ml")


def _is_pow2(n: int) -> bool:
    return n >= 4 and not n & (n - 1)


def _weight_cross(cross: torch.Tensor, auto_i: Optional[torch.Tensor],
                  auto_j: Optional[torch.Tensor], weighting: str, eps: float,
                  inplace: bool = False) -> torch.Tensor:
    """A cross-spectrum under a GCC frequency weighting; ``auto_i`` /
    ``auto_j`` are the channels' (real, >= 0) auto power spectra on the
    same bins, read only by the weightings that need them.  PHAT whitens
    through kernel K7 (its twin on the CPU), in place only with
    ``inplace`` (for a caller that owns ``cross`` and reads it no more);
    the other weightings are plain tensor arithmetic."""
    if weighting not in GCC_WEIGHTINGS:
        raise ValueError(f"unknown GCC weighting {weighting!r}; expected one "
                         f"of {GCC_WEIGHTINGS}")
    if weighting == "phat":
        return cuda_fft.whiten(cross.contiguous(), eps, inplace=inplace)
    if weighting == "cc":
        return cross
    if weighting == "roth":
        return cross / (auto_i + eps)
    if weighting == "scot":
        return cross / (torch.sqrt(auto_i * auto_j) + eps)
    mag2 = cross.real ** 2 + cross.imag ** 2                    # 'ml'
    # Coherence clamped away from 1, where the weight diverges.
    coh2 = torch.clamp(mag2 / torch.clamp(auto_i * auto_j, min=eps),
                       max=1.0 - 1e-4)
    return cross * (coh2 / (torch.sqrt(mag2) * (1.0 - coh2) + eps))


def _auto(spec: torch.Tensor) -> torch.Tensor:
    return spec.real ** 2 + spec.imag ** 2


def _weighted_cross(s_i: torch.Tensor, s_j: torch.Tensor, weighting: str,
                    eps: float) -> torch.Tensor:
    """s_i * conj(s_j) under a GCC frequency weighting (``_weight_cross``);
    PHAT whitens the fresh cross-spectrum in place."""
    ratio = weighting not in ("phat", "cc")
    return _weight_cross(s_i * torch.conj(s_j),
                         _auto(s_i) if ratio else None,
                         _auto(s_j) if ratio else None, weighting, eps,
                         inplace=True)


def phat_correlation(sig1: torch.Tensor, sig2: torch.Tensor,
                     nfft: Optional[int] = None, eps: float = PHAT_EPS,
                     weighting: str = "phat") -> torch.Tensor:
    """Weighted cross-correlation of two signals (leading axes broadcast),
    circular order; nfft=None is the reference's exact length n1+n2-1."""
    n1, n2 = sig1.shape[-1], sig2.shape[-1]
    n = nfft if nfft is not None else fft_length(n1, n2, "exact")
    if (weighting == "phat" and _is_pow2(n) and max(n1, n2) <= n
            and sig1.dtype == torch.float32 and sig2.dtype == torch.float32):
        # numpy's rule, not torch.broadcast_shapes: that one imports
        # torch.fx's symbolic shapes (and sympy) on first use, seconds of a
        # cold call.
        lead = np.broadcast_shapes(sig1.shape[:-1], sig2.shape[:-1])
        width = max(n1, n2)
        rows = [torch.nn.functional.pad(
            s.expand(lead + s.shape[-1:]).reshape(-1, s.shape[-1]),
            (0, width - s.shape[-1])) for s in (sig1, sig2)]
        spec = cuda_fft.fft_real(torch.cat(rows).contiguous(), n)
        b = rows[0].shape[0]
        mask = cuda_fft.band_mask(n, None, None, device=sig1.device)
        corr = cuda_fft.whitened_corr(spec[:b], spec[b:], mask, n, eps)
        return corr.reshape(lead + (n,))
    r = _weighted_cross(rfft_n(sig1, n), rfft_n(sig2, n), weighting, eps)
    return irfft_n(r, n).to(sig1.dtype)


def gcc_phat_all_pairs(signals: torch.Tensor,
                       pairs_i: Sequence[int],
                       pairs_j: Sequence[int],
                       nfft: Optional[int] = None,
                       eps: float = PHAT_EPS,
                       use_pallas: str = "auto",
                       band: Optional[Tuple[float, float]] = None,
                       fs: Optional[float] = None,
                       weighting: str = "phat") -> torch.Tensor:
    """GCC for every pair: signals (..., M, N) -> (..., P, nfft), circular
    order, PHAT-weighted by default.  ``band=(lo_hz, hi_hz)`` with ``fs``
    zeroes the weighted bins outside the band (band-limited PHAT,
    SURVEY.md Q5).  K1 runs for PHAT at a power-of-two nfft >= N unless
    ``use_pallas='never'``; the other weightings, 'never' and the other
    lengths take the unfused branch."""
    n_samp = signals.shape[-1]
    n = nfft if nfft is not None else fft_length(n_samp, n_samp, "exact")
    if band is not None and fs is None:
        raise ValueError("band-limited PHAT requires fs")
    real = signals.real.dtype if signals.is_complex() else signals.dtype
    mask = cuda_fft.band_mask(n, band, fs, dtype=real, device=signals.device)
    if (use_pallas != "never" and weighting == "phat" and n_samp <= n
            and _is_pow2(n)):
        return cuda_fft.gcc_all_pairs(signals.contiguous(), pairs_i, pairs_j,
                                      n, mask, eps)
    pi = torch.as_tensor(list(pairs_i), dtype=torch.long,
                         device=signals.device)
    pj = torch.as_tensor(list(pairs_j), dtype=torch.long,
                         device=signals.device)
    spec = rfft_n(signals, n)
    white = _weighted_cross(spec[..., pi, :], spec[..., pj, :], weighting,
                            eps)
    if band is not None:
        white = white * mask
    return irfft_n(white, n).to(signals.dtype)


def gcc_phat_streaming(signals, pairs_i: Sequence[int],
                       pairs_j: Sequence[int], frame: int = 8192,
                       hop: Optional[int] = None,
                       max_lag: Optional[int] = None, eps: float = PHAT_EPS,
                       window: str = "hann", weighting: str = "phat",
                       device=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Blockwise (Welch-averaged) GCC of long recordings, the JAX
    package's ``gcc_phat_streaming`` (ops/gccphat.py:183 there): frames of
    ``frame`` samples (a power of two) every ``hop`` (default frame // 2),
    Hann-windowed or ``window='rect'``; the cross and auto power spectra
    averaged over frames; ``weighting`` (GCC_WEIGHTINGS: 'ml' is
    meaningful here, its coherence estimate being averaged) applied to the
    averages; the inverse at ``frame``.  signals (..., M, T) go to
    ``device`` (``utils.device.resolve_device``: the card unless named).
    Returns (corr (..., P, 2 * max_lag + 1) with lag 0 centred, lags
    (2 * max_lag + 1,)); ``max_lag`` defaults to frame // 4 and must lie
    in (0, frame // 2)."""
    if frame & (frame - 1):
        raise ValueError("frame must be a power of two")
    hop = frame // 2 if hop is None else hop
    max_lag = frame // 4 if max_lag is None else max_lag
    if not 0 < max_lag < frame // 2:
        # The centred slice needs 2 * max_lag + 1 <= frame, and at
        # frame // 2 the +max_lag label would alias -max_lag.
        raise ValueError("max_lag must be in (0, frame//2)")
    if window not in ("hann", "rect"):
        raise ValueError("window must be 'hann' or 'rect'")
    if weighting not in GCC_WEIGHTINGS:
        raise ValueError(f"unknown GCC weighting {weighting!r}; expected one "
                         f"of {GCC_WEIGHTINGS}")
    dev = resolve_device(device)
    x = (signals.to(dev) if torch.is_tensor(signals)
         else torch.as_tensor(np.array(signals), device=dev))
    t = x.shape[-1]
    if t < frame:
        raise ValueError("signal shorter than one frame")
    num_frames = 1 + (t - frame) // hop
    if window == "hann":
        n_ = torch.arange(frame, dtype=x.dtype, device=x.device)
        win = 0.5 - 0.5 * torch.cos(2.0 * np.pi * n_ / frame)
    else:
        win = torch.ones(frame, dtype=x.dtype, device=x.device)
    frames = x.unfold(-1, frame, hop)[..., :num_frames, :] * win
    spec = torch.fft.rfft(frames, n=frame)                 # (..., M, F, bins)
    pi = torch.as_tensor(np.asarray(pairs_i), dtype=torch.long,
                         device=x.device)
    pj = torch.as_tensor(np.asarray(pairs_j), dtype=torch.long,
                         device=x.device)
    cross = torch.mean(spec[..., pi, :, :] * torch.conj(spec[..., pj, :, :]),
                       -2)                                 # (..., P, bins)
    auto_i = auto_j = None
    if weighting not in ("phat", "cc"):
        auto = torch.mean(_auto(spec), -2)                 # (..., M, bins)
        auto_i, auto_j = auto[..., pi, :], auto[..., pj, :]
    # The mean is a fresh tensor that nothing reads again.
    white = _weight_cross(cross, auto_i, auto_j, weighting, eps,
                          inplace=True)
    corr = torch.fft.irfft(white, n=frame).to(x.dtype)
    centred = torch.roll(corr, max_lag, -1)[..., :2 * max_lag + 1]
    return centred, np.arange(-max_lag, max_lag + 1)


def tdoa_from_streaming(corr: torch.Tensor, lags, fs: float) -> torch.Tensor:
    """Peak lag (seconds) of a centred streaming correlation, refined by a
    parabola through the peak and its neighbours (a peak on an edge keeps
    its whole lag)."""
    idx = torch.argmax(corr, -1)
    i = torch.clamp(idx, 1, corr.shape[-1] - 2)
    ym = torch.gather(corr, -1, (i - 1)[..., None])[..., 0]
    y0 = torch.gather(corr, -1, i[..., None])[..., 0]
    yp = torch.gather(corr, -1, (i + 1)[..., None])[..., 0]
    denom = ym - 2.0 * y0 + yp
    frac = torch.where(torch.abs(denom) > 1e-12,
                       0.5 * (ym - yp) / torch.where(
                           denom == 0, torch.ones_like(denom), denom),
                       torch.zeros_like(denom))
    base = torch.as_tensor(np.asarray(lags), dtype=corr.dtype,
                           device=corr.device)[idx]
    return (base + torch.where(idx == i, frac, torch.zeros_like(frac))) / fs


def lags_reference(n1: int, n2: int, n: int) -> np.ndarray:
    """The reference's (defective, Q1) lag axis: scipy correlation_lags
    'full' values indexed positionally against the circular array
    (utils.py:141-142): lag[k] = k - (n2 - 1), extended to length n."""
    return np.arange(n) - (n2 - 1)


def lags_physical(n1: int, n: int) -> np.ndarray:
    """Correct circular decoding: index k holds linear-correlation lag
    m = k for k < n1 and m = k - n otherwise."""
    k = np.arange(n)
    return np.where(k < n1, k, k - n)


def lag_axis(mode: str, n1: int, n2: int, n: int) -> np.ndarray:
    """The lag of each circular index under ``mode``: 'reference' (or its
    alias 'compat') or 'physical'."""
    if mode in ("reference", "compat"):
        return lags_reference(n1, n2, n)
    if mode == "physical":
        return lags_physical(n1, n)
    raise ValueError(f"unknown lag mode {mode!r}")
