"""Exact order statistics of non-negative floats (counterpart of the JAX
package's ops/quantile.py).

The JAX package finds them by bisection over IEEE bit patterns, a TPU
answer to sorting; here ``torch.kthvalue`` (one selection per row) gives
the same exact elements.
The even-length median is the mean of the two middle elements, as
``np.median`` and the JAX function take it.  Used for the 'median'
threshold of the TDOA ladder (reference utils.py:144-149: median of
|corr|) and the robust solver's residual medians.
"""

from __future__ import annotations

import torch


def kth_smallest_nonneg(x: torch.Tensor, k: int,
                        axis: int = -1) -> torch.Tensor:
    """Exact k-th smallest (1-indexed) along ``axis``."""
    return torch.kthvalue(torch.movedim(x, axis, -1), k, dim=-1).values


def median_nonneg(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exact ``np.median`` along ``axis``: the middle order statistic, or
    the mean of the two middle ones for even length."""
    n = x.shape[axis]
    if n % 2 == 1:
        return kth_smallest_nonneg(x, (n + 1) // 2, axis)
    a = kth_smallest_nonneg(x, n // 2, axis)
    b = kth_smallest_nonneg(x, n // 2 + 1, axis)
    return (a + b) / 2
