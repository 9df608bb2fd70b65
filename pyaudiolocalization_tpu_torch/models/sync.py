"""Signal synchronization before TDOA estimation (counterpart of the JAX
package's models/sync.py; reference: ``synchronize_signals_improved``,
utils.py:407-457).

Every signal is aligned to the highest-energy one by full cross-correlation
with cubic-spline sub-sample refinement, gated by a 0.3 x
autocorrelation-peak check and a 50 ms plausibility window, then
pad-aligned.  SURVEY.md Q4: this step cancels the TDOAs the pipeline then
measures; it is the reference's observable behaviour, so
``sync_mode='reference'`` reproduces it.

The numerics (energies, the (M, 2N-1) correlations, peak picking, spline
refinement, the gates) are batched tensor ops; one (M,) vector of shifts
crosses to the host and drives the data-dependent pad-align.  The
correlations are exact-length ``torch.fft`` transforms, the JAX package's
XLA path: no TPU kernel took that length.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.interp import refine_peak_cubic
from .calibration import full_cross_correlation


def _sync_shifts(signals: torch.Tensor, fs: float,
                 use_interpolation: bool) -> torch.Tensor:
    """Per-signal shifts (samples, float) against the highest-energy
    reference.  signals: (M, N), equal lengths (callers zero-pad: trailing
    zeros extend the correlation but leave the peaks and the lag origin
    where they were)."""
    n = signals.shape[-1]
    energies = torch.sum(signals * signals, -1)
    ref_idx = int(torch.argmax(energies))
    corr = full_cross_correlation(signals, signals[ref_idx])   # (M, 2N-1)
    length = corr.shape[-1]
    abs_corr = torch.abs(corr)
    peak_idx = torch.argmax(abs_corr, -1)
    peak_val = torch.gather(abs_corr, -1, peak_idx[:, None])[:, 0]
    ref_peak = peak_val[ref_idx]   # the reference's autocorrelation peak
    refined = peak_idx.to(corr.dtype)
    if use_interpolation:
        interior = (peak_idx > 1) & (peak_idx < length - 2)
        safe = torch.clamp(peak_idx, 2, length - 3)
        window = torch.gather(
            corr, -1, safe[:, None] + torch.arange(-2, 3,
                                                   device=corr.device))
        fine = refine_peak_cubic(window, safe.to(corr.dtype))
        confident = peak_val >= 0.3 * ref_peak            # utils.py:428-430
        refined = torch.where(confident & interior, fine, refined)
    shift = refined - (n - 1)
    max_shift = fs * 0.05                                 # utils.py:421
    shift = torch.where(torch.abs(shift) > max_shift,
                        torch.zeros_like(shift), shift)
    shift[ref_idx] = 0.0
    return shift


def synchronize_signals(signals, fs: float,
                        use_interpolation: bool = True
                        ) -> List[torch.Tensor]:
    """Behaviour port of utils.py:407-457 over a list (or stack) of equal-
    or unequal-length 1-D signals: each is left-padded by round(shift -
    min shift) samples, then all are zero-padded at the end to the longest.
    Returns a list of tensors on the signals' device."""
    signals = [torch.as_tensor(s) for s in signals]
    max_in = max(s.shape[-1] for s in signals)
    stacked = torch.stack([torch.nn.functional.pad(s, (0, max_in
                                                       - s.shape[-1]))
                           for s in signals])
    shifts = _sync_shifts(stacked, fs, use_interpolation).tolist()
    min_shift = min(shifts)
    adjusted = [torch.nn.functional.pad(
        sig, (max(0, int(round(shift - min_shift))), 0))
        for sig, shift in zip(signals, shifts)]
    max_len = max(s.shape[-1] for s in adjusted)
    return [torch.nn.functional.pad(s, (0, max_len - s.shape[-1]))
            for s in adjusted]
