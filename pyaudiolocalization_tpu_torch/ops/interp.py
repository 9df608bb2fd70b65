"""Small interpolation utilities (counterpart of the JAX package's
ops/interp.py): the not-a-knot cubic spline (scipy CubicSpline's default
boundary condition) for sub-sample peak refinement.

The reference refines correlation peaks by fitting scipy's CubicSpline over
a 5-point window and scanning 100 fine points (utils.py:431-438).  The
spline is a small dense solve, batched over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch


def cubic_spline_coeffs(x: torch.Tensor, y: torch.Tensor):
    """Not-a-knot cubic spline through (x_i, y_i), n >= 3 points, over any
    leading axes of ``x`` and ``y``.

    Returns per-interval coefficients (c3, c2, c1, c0) such that on
    [x_i, x_{i+1}]: s(t) = c3_i (t-x_i)^3 + c2_i (t-x_i)^2 + c1_i (t-x_i)
    + c0_i.  Solves the second-derivative system with not-a-knot end
    conditions densely (windows are tiny: n = 5 in the pipeline)."""
    n = x.shape[-1]
    batch = tuple(np.broadcast_shapes(x.shape[:-1], y.shape[:-1]))
    h = (x[..., 1:] - x[..., :-1]).expand(batch + (n - 1,))
    dy = (y[..., 1:] - y[..., :-1]) / h
    a = torch.zeros(batch + (n, n), dtype=y.dtype, device=y.device)
    b = torch.zeros(batch + (n,), dtype=y.dtype, device=y.device)
    # Interior continuity rows i = 1..n-2.
    for i in range(1, n - 1):
        a[..., i, i - 1] = h[..., i - 1]
        a[..., i, i] = 2.0 * (h[..., i - 1] + h[..., i])
        a[..., i, i + 1] = h[..., i]
        b[..., i] = 6.0 * (dy[..., i] - dy[..., i - 1])
    # Not-a-knot: the third derivative is continuous across x_1 and
    # x_{n-2}: h1*m0 - (h0+h1)*m1 + h0*m2 = 0, likewise at the other end.
    a[..., 0, 0] = h[..., 1]
    a[..., 0, 1] = -(h[..., 0] + h[..., 1])
    a[..., 0, 2] = h[..., 0]
    a[..., n - 1, n - 3] = h[..., n - 2]
    a[..., n - 1, n - 2] = -(h[..., n - 3] + h[..., n - 2])
    a[..., n - 1, n - 1] = h[..., n - 3]
    m = torch.linalg.solve(a, b[..., None])[..., 0]
    c0 = y[..., :-1].expand(batch + (n - 1,))
    c1 = dy - h * (2.0 * m[..., :-1] + m[..., 1:]) / 6.0
    c2 = m[..., :-1] / 2.0
    c3 = (m[..., 1:] - m[..., :-1]) / (6.0 * h)
    return c3, c2, c1, c0


def cubic_spline_eval(x: torch.Tensor, coeffs, t: torch.Tensor
                      ) -> torch.Tensor:
    """The spline on knots ``x`` (n,) at points ``t`` (K,) -> (..., K) over
    the coefficients' leading axes; extrapolates with the edge intervals,
    like scipy's default."""
    c3, c2, c1, c0 = coeffs
    n = x.shape[-1]
    idx = torch.clamp(torch.searchsorted(x, t, right=True) - 1, 0, n - 2)
    dx = t - x[idx]
    return (c3[..., idx] * dx ** 3 + c2[..., idx] * dx ** 2
            + c1[..., idx] * dx + c0[..., idx])


def refine_peak_cubic(corr_window: torch.Tensor, center_index,
                      num_fine: int = 100) -> torch.Tensor:
    """Sub-sample peak refinement over 5-sample windows (..., 5) centred
    at ``center_index`` (...,) (reference utils.py:431-438): fit a
    not-a-knot cubic spline over indices [c-2, c+2], evaluate |s| on
    linspace(c-2, c+2, num_fine), return the abscissa of the maximum (the
    first on ties)."""
    dt, dev = corr_window.dtype, corr_window.device
    base = torch.arange(-2.0, 3.0, dtype=dt, device=dev)
    coeffs = cubic_spline_coeffs(base, corr_window)
    fine = torch.linspace(-2.0, 2.0, num_fine, dtype=dt, device=dev)
    vals = cubic_spline_eval(base, coeffs, fine)
    best = torch.argmax(torch.abs(vals), dim=-1)
    return center_index + fine[best]
