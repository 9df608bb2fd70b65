"""Peak detection with scipy.signal.find_peaks semantics (counterpart of
the JAX package's ops/peaks.py; reference: utils.py:151-152).

Ported: the strict three-point local maxima and, with ``plateaus=True``
(parity mode), scipy's plateau peaks at the midpoint ``(left + right) //
2``; the full-row top-k candidate selection with an optional lag-window
merge, and the two-threshold selection of the windowed ladder.
Candidates are the top-k local maxima by height (a stable sort, ties to
the lower index like ``jax.lax.top_k``); distance pruning removes smaller
peaks first, with scipy's strict ``< distance`` rule.
"""

from __future__ import annotations

from typing import Optional

import torch


def local_maxima(x: torch.Tensor, plateaus: bool = False) -> torch.Tensor:
    """Local maxima along the last axis.

    ``plateaus=False``: strict interior three-point maxima.
    ``plateaus=True``: scipy.signal.find_peaks semantics — an equal-valued
    run whose left edge rises and right edge falls marks one peak at its
    midpoint ``(start + end) // 2`` (utils.py:152).  Each sample's run
    start and end come from running maxima of the run-boundary indices
    (the JAX package's two segmented scans)."""
    if not plateaus:
        core = (x[..., 1:-1] > x[..., :-2]) & (x[..., 1:-1] > x[..., 2:])
        return torch.nn.functional.pad(core, (1, 1), value=False)
    n = x.shape[-1]
    if n < 3:
        return torch.zeros_like(x, dtype=torch.bool)
    pad = torch.nn.functional.pad
    t = torch.arange(n, device=x.device).expand(x.shape)
    change = pad(x[..., 1:] != x[..., :-1], (1, 0), value=True)
    rising = pad(x[..., 1:] > x[..., :-1], (1, 0), value=False)
    endb = pad(x[..., :-1] != x[..., 1:], (0, 1), value=True)
    falling = pad(x[..., :-1] > x[..., 1:], (0, 1), value=False)
    zero = torch.zeros_like(t)
    start = torch.cummax(torch.where(change, t, zero), -1).values
    # The last sample of each run: the same running maximum over the
    # reversed row, in reversed coordinates.
    rev = torch.cummax(torch.where(torch.flip(endb, [-1]), t, zero),
                       -1).values
    end = n - 1 - torch.flip(rev, [-1])
    ok_left = torch.gather(rising, -1, start)
    ok_right = torch.gather(falling, -1, end)
    return ok_left & ok_right & (t == (start + end) // 2)


def _top_k(vals: torch.Tensor, k: int):
    heights, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return heights[..., :k], pos[..., :k]


def compact_valid(pos: torch.Tensor, heights: torch.Tensor,
                  keep: torch.Tensor):
    """Stable-compact valid candidates to the front (height order kept)."""
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    return (torch.gather(pos, -1, order), torch.gather(heights, -1, order),
            torch.gather(keep, -1, order))


def select_peaks(x: torch.Tensor, threshold: torch.Tensor, distance: int,
                 k: int = 128, window_mask: Optional[torch.Tensor] = None,
                 plateaus: bool = False):
    """Top-k local maxima of ``x`` (``local_maxima(x, plateaus)``) with
    height >= ``threshold`` and a minimum separation ``distance``.  Returns (pos, heights, keep),
    ordered by descending height (stable); ``keep`` marks candidates that
    exist and survive distance pruning.  With ``window_mask`` (pre-dilated
    by the caller) the top-k inside the window are merged in, so the
    tallest surviving in-window peak is present even when it is globally
    short; a duplicate position is suppressed by its earlier copy."""
    mask = local_maxima(x, plateaus) & (x >= threshold)
    neg = torch.full_like(x, -float("inf"))
    vals = torch.where(mask, x, neg)
    heights, pos = _top_k(vals, k)
    if window_mask is not None:
        h2, p2 = _top_k(torch.where(window_mask, vals, neg), k)
        heights, order = torch.sort(torch.cat([heights, h2], -1), dim=-1,
                                    descending=True, stable=True)
        pos = torch.gather(torch.cat([pos, p2], -1), -1, order)
    keep = torch.isfinite(heights)
    later = torch.arange(heights.shape[-1], device=x.device)
    for r in range(heights.shape[-1]):
        close = ((pos - pos[..., r:r + 1]).abs() < distance) & (later > r)
        keep = keep & ~(close & keep[..., r:r + 1])
    return pos, heights, keep


def select_peaks_two(x: torch.Tensor, thr_a: torch.Tensor,
                     thr_b: torch.Tensor, distance: int, k: int = 128):
    """Top-k local maxima of ``x`` with two height thresholds sharing one
    candidate set.  Returns (pos, heights, keep_a, keep_b), ordered by
    descending height; ``keep_*`` marks candidates that exist, pass the
    threshold and survive distance pruning under that threshold."""
    vals = torch.where(local_maxima(x), x, torch.full_like(x, -float("inf")))
    heights, pos = _top_k(vals, k)
    exists = torch.isfinite(heights)
    keep_a = exists & (heights >= thr_a)
    keep_b = exists & (heights >= thr_b)
    later = torch.arange(k, device=x.device)
    for r in range(k):
        close = ((pos - pos[..., r:r + 1]).abs() < distance) & (later > r)
        keep_a = keep_a & ~(close & keep_a[..., r:r + 1])
        keep_b = keep_b & ~(close & keep_b[..., r:r + 1])
    return pos, heights, keep_a, keep_b
