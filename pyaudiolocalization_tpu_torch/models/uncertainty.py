"""Position uncertainty of the TDOA fix (counterpart of the JAX package's
models/uncertainty.py; a rebuild extension with no reference counterpart).

The solver minimizes ``sum_p (w_p * r_p)^2`` with
``r_p = (||x - m_j|| - ||x - m_i||) - c * tau_p``; the first-order
(Gauss-Markov) covariance of the weighted-least-squares fix is the sandwich
``A J^T W^2 S W^2 J A`` with ``A = (J^T W^2 J)^{-1}``, which for the default
residual-estimated noise scale collapses to ``sigma_hat^2 * A``.
``position_uncertainty`` is host-side NumPy on (P, 3)-sized arrays, run
after the estimate is fetched: the same code as the JAX package's host
path.  ``position_covariance`` is its batched device form, which the sweep
attaches to every scene.  The narrowband solvers have no TDOA residuals:
``group_jackknife_covariance`` re-runs their estimator on time chunks of
the capture (the chunks one leading batch axis of the locate function),
and ``summary_from_covariance`` turns its covariance into the same dict.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

# chi-square quantiles for 3 degrees of freedom (position ellipsoid).
_CHI2_3 = {0.68: 3.505915, 0.90: 6.251389, 0.95: 7.814728, 0.99: 11.344867}


def weights_from_snr(snr: np.ndarray) -> np.ndarray:
    """Host-side mirror of models/tdoa.compute_weights (reference
    utils.py:484-497): per-pair SNR normalized by the mean weight."""
    snr = np.asarray(snr, np.float64)
    mean = snr.mean() if snr.size else 0.0
    return snr / mean if mean != 0 else snr


def tdoa_jacobian(x: np.ndarray, mic_positions: np.ndarray,
                  pairs_i: Sequence[int],
                  pairs_j: Sequence[int]) -> np.ndarray:
    """(P, 3) Jacobian of the range-difference residuals at ``x``: row p
    is ``u_j - u_i`` (unit vectors mic -> x; models/solver.py:45)."""
    x = np.asarray(x, np.float64)
    mics = np.asarray(mic_positions, np.float64)
    diff = x[None, :] - mics                     # (M, 3)
    dist = np.linalg.norm(diff, axis=1)
    unit = diff / np.maximum(dist, 1e-12)[:, None]
    pi = np.asarray(pairs_i, np.intp)
    pj = np.asarray(pairs_j, np.intp)
    return unit[pj] - unit[pi]


def _inv3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate over (..., 3, 3); a
    singular input returns inf/NaN entries."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    adj = torch.stack([
        torch.stack([c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11], -1),
        torch.stack([c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12], -1),
        torch.stack([c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10], -1),
    ], -2)
    return adj / det[..., None, None]


def position_covariance(x_hat: torch.Tensor, mic_positions: torch.Tensor,
                        pairs_i: Sequence[int], pairs_j: Sequence[int],
                        tdoas: torch.Tensor, c,
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Residual-estimated Gauss-Markov covariance of TDOA fixes, batched:
    ``sigma_hat^2 (J^T W^2 J)^{-1}`` with ``sigma_hat^2 = sum (w_p r_p)^2 /
    (P - 3)``.  x_hat (..., 3), mics (..., M, 3) or (M, 3), tdoas (..., P)
    -> (..., 3, 3).  As in the JAX package (models/uncertainty.py:101
    there): no null-space analysis (a degenerate array gives inf/NaN
    entries) and all-NaN when P <= 3."""
    num_pairs = len(pairs_i)
    if num_pairs - 3 < 1:
        return torch.full(x_hat.shape[:-1] + (3, 3), float("nan"),
                          dtype=tdoas.dtype, device=tdoas.device)
    pi = torch.as_tensor(list(pairs_i), device=x_hat.device)
    pj = torch.as_tensor(list(pairs_j), device=x_hat.device)
    diff = x_hat[..., None, :] - mic_positions                   # (..., M, 3)
    dist = torch.linalg.norm(diff, dim=-1)
    unit = diff / torch.clamp(dist, min=1e-12)[..., None]
    jac = unit[..., pj, :] - unit[..., pi, :]                    # (..., P, 3)
    w = (torch.ones(num_pairs, dtype=tdoas.dtype, device=tdoas.device)
         if weights is None else weights)
    w2 = w * w
    normal = jac.transpose(-1, -2) @ (w2[..., None] * jac)
    r = (dist[..., pj] - dist[..., pi]) - c * tdoas
    sigma2_hat = torch.sum((w * r) ** 2, -1) / (num_pairs - 3)
    cov = sigma2_hat[..., None, None] * _inv3(normal)
    return 0.5 * (cov + cov.transpose(-1, -2))


def position_uncertainty(x_hat: np.ndarray,
                         mic_positions: np.ndarray,
                         pairs_i: Sequence[int],
                         pairs_j: Sequence[int],
                         tdoas: np.ndarray,
                         c: float,
                         weights: Optional[np.ndarray] = None,
                         sigma_td: Optional[float] = None,
                         confidence: float = 0.95,
                         ) -> Optional[Dict[str, np.ndarray]]:
    """Gauss-Markov uncertainty of a TDOA fix (see module docstring).

    Returns ``None`` when no noise scale is obtainable (``sigma_td`` not
    given and ``P <= 3`` leaves zero residual degrees of freedom).
    Otherwise a dict with:

    * ``covariance`` — (3, 3) position covariance (m^2), symmetric PSD.
    * ``std`` — (3,) per-axis standard deviations (m).
    * ``sigma_td`` — the per-pair TDOA noise scale used (s); for the
      residual-estimated path this is ``sigma_hat / c`` (the w_p=1
      equivalent scale).
    * ``ellipsoid_radii`` / ``ellipsoid_axes`` — semi-axis lengths (m)
      and unit axes (columns) of the ``confidence`` ellipsoid
      (chi-square with 3 dof; supported levels 0.68/0.90/0.95/0.99).
    * ``dof`` — residual degrees of freedom ``P - 3`` (0 when
      ``sigma_td`` was supplied and residuals were not consulted).
    * ``unobservable_axes`` — (3, k) orthonormal columns spanning the
      null space of ``J^T W^2 J`` (k=0 for a well-conditioned geometry).

    A geometrically degenerate array (coplanar mics with an in-plane
    source, or a collinear array) makes ``J^T W^2 J`` singular: the TDOA
    data carry NO information along the null direction(s).  Eigenvalues
    below ``1e-8`` of the largest are treated as exactly zero; the
    returned ``std`` is ``inf`` on every axis with a null-space
    component, the matching ``ellipsoid_radii`` are ``inf``, and
    ``covariance`` holds the observable-subspace covariance only (its
    finite entries must not be read as certainty along
    ``unobservable_axes`` — consult ``std``/``unobservable_axes``).
    """
    if confidence not in _CHI2_3:
        raise ValueError(f"confidence must be one of {sorted(_CHI2_3)}")
    x_hat = np.asarray(x_hat, np.float64)
    tdoas = np.asarray(tdoas, np.float64)
    P = tdoas.shape[0]
    w = (np.ones(P) if weights is None
         else np.asarray(weights, np.float64))
    jac = tdoa_jacobian(x_hat, mic_positions, pairs_i, pairs_j)
    w2 = w * w
    normal = jac.T @ (w2[:, None] * jac)          # J^T W^2 J
    # Null-space aware inverse: np.linalg.pinv would ZERO the variance
    # along an unobservable eigendirection (reporting perfect certainty
    # exactly where the data say nothing — e.g. the out-of-plane axis of
    # a coplanar array).  Detect near-zero eigenvalues explicitly and
    # report infinite variance there instead.
    n_evals, n_evecs = np.linalg.eigh(normal)
    observable = n_evals > max(float(n_evals[-1]), 0.0) * 1e-8
    null_basis = n_evecs[:, ~observable]          # (3, k)
    inv_evals = np.where(observable,
                         1.0 / np.where(observable, n_evals, 1.0), 0.0)
    a_inv = (n_evecs * inv_evals) @ n_evecs.T

    if sigma_td is not None:
        # Homoscedastic known noise: full sandwich (exact even when the
        # solve's weights were not inverse-variance).
        s2 = (float(c) * float(sigma_td)) ** 2
        meat = jac.T @ ((w2 * w2)[:, None] * jac)  # J^T W^4 J
        cov = s2 * (a_inv @ meat @ a_inv)
        dof = 0
        sigma_used = float(sigma_td)
    else:
        dof = P - 3
        if dof < 1:
            logger.warning(
                "position_uncertainty: %d pairs leave no residual degrees "
                "of freedom (need > 3 pairs); pass sigma_td explicitly.", P)
            return None
        mics = np.asarray(mic_positions, np.float64)
        di = np.linalg.norm(x_hat[None, :] - mics, axis=1)
        pi = np.asarray(pairs_i, np.intp)
        pj = np.asarray(pairs_j, np.intp)
        r = (di[pj] - di[pi]) - float(c) * tdoas
        sigma2_hat = float(np.sum((w * r) ** 2)) / dof
        cov = sigma2_hat * a_inv
        sigma_used = float(np.sqrt(sigma2_hat)) / float(c)

    cov = 0.5 * (cov + cov.T)
    evals, evecs = np.linalg.eigh(cov)
    evals = np.maximum(evals, 0.0)
    radii = np.sqrt(evals * _CHI2_3[confidence])
    std = np.sqrt(np.maximum(np.diag(cov), 0.0))
    if null_basis.shape[1]:
        # Infinite variance along unobservable directions: every axis
        # with a null-space component, and every covariance eigenvector
        # lying in the null space (cov annihilates it, so eigh returns
        # the null directions as zero-eigenvalue eigenvectors).
        std = np.where((null_basis ** 2).sum(axis=1) > 1e-12, np.inf, std)
        in_null = (null_basis.T @ evecs) ** 2   # (k, 3)
        radii = np.where(in_null.sum(axis=0) > 0.5, np.inf, radii)
    return {
        "covariance": cov,
        "std": std,
        "sigma_td": sigma_used,
        "ellipsoid_radii": radii,
        "ellipsoid_axes": evecs,
        "confidence": confidence,
        "dof": dof,
        "unobservable_axes": null_basis,
    }


def group_jackknife_covariance(signals: torch.Tensor,
                               locate_fn: Callable,
                               x_hat: torch.Tensor,
                               radius: torch.Tensor,
                               groups: int = 4) -> torch.Tensor:
    """Group-jackknife covariance of a grid-search fix: the capture
    (..., M, N) splits into ``groups`` equal time chunks, each chunk is
    re-localized by the same estimator on the box ``x_hat +- radius``, and
    the scatter of the chunk fixes about their mean, divided by
    ``groups``, estimates Cov(x_hat) under the 1/sqrt(T) scaling of
    independent snapshots.  ``locate_fn(chunks, lower, upper)`` takes the
    chunks as one leading axis, (groups, ..., M, chunk), and returns
    (groups, ..., 3).  Returns (..., 3, 3).  Below the estimator's
    breakdown SNR the chunk fixes rail against the box and the estimate
    saturates."""
    n = signals.shape[-1]
    chunk = n // groups
    parts = signals[..., :groups * chunk].reshape(
        signals.shape[:-1] + (groups, chunk))
    parts = torch.movedim(parts, -2, 0)              # (groups, ..., M, chunk)
    xs = locate_fn(parts, x_hat - radius, x_hat + radius)
    d = xs - torch.mean(xs, 0)
    cov_groups = torch.einsum("g...i,g...j->...ij", d, d) / (groups - 1)
    return cov_groups / groups


def summary_from_covariance(cov: np.ndarray, dof: int,
                            confidence: float = 0.95
                            ) -> Dict[str, np.ndarray]:
    """Host-side uncertainty dict from a (3, 3) covariance, with
    ``position_uncertainty``'s keys (``sigma_td`` None: no TDOA noise scale
    exists; ``unobservable_axes`` empty: a resampling scatter has no null
    space)."""
    if confidence not in _CHI2_3:
        raise ValueError(f"confidence must be one of {sorted(_CHI2_3)}")
    cov = np.asarray(cov, np.float64)
    cov = 0.5 * (cov + cov.T)
    evals, evecs = np.linalg.eigh(cov)
    evals = np.maximum(evals, 0.0)
    return {
        "covariance": cov,
        "std": np.sqrt(np.maximum(np.diag(cov), 0.0)),
        "sigma_td": None,
        "ellipsoid_radii": np.sqrt(evals * _CHI2_3[confidence]),
        "ellipsoid_axes": evecs,
        "confidence": confidence,
        "dof": dof,
        "unobservable_axes": np.zeros((3, 0)),
    }
