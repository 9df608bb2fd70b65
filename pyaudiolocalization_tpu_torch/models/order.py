"""Model-order estimation: how many simultaneous sources are active
(counterpart of the JAX package's models/order.py; no reference
counterpart).

The Wax & Kailath (1985) criteria: for M sensors and F snapshots with
covariance eigenvalues l_1 >= ... >= l_M, the negative log-likelihood that
the smallest M - k are equal is

    L(k) = -F (M-k) log( geometric mean / arithmetic mean
                         of the M-k smallest eigenvalues )

and AIC(k) = 2 L(k) + 2 k (2M - k), MDL(k) = L(k) + 0.5 k (2M - k) log F;
the order is the argmin.  Bins combine incoherently: likelihoods add and
the penalty scales with the bin count.  Everything runs on the real 2M x 2M
embedding of models/music.py, whose ascending spectrum is the complex one
with every eigenvalue doubled.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import beamformer as beam_ops
from . import music as music_ops


def complex_eigvals_from_embedded(emb: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of the Hermitian C from its real embedding: every other
    value of the ascending embedded spectrum.  (..., 2M, 2M) -> (..., M),
    descending."""
    return torch.linalg.eigvalsh(emb)[..., ::2].flip(-1)


def information_criteria(eigvals: torch.Tensor, num_snapshots: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AIC(k) and MDL(k) for k = 0..M-1 from descending eigenvalues
    (..., M); each (..., M).  Callers combine bins by adding along a
    leading axis (``order_from_eigvals``)."""
    m = eigvals.shape[-1]
    f = float(num_snapshots)
    lam = torch.clamp(eigvals, min=1e-30)
    rev = lam.flip(-1)                                      # ascending
    sizes = torch.arange(1, m + 1, dtype=lam.dtype, device=lam.device)
    arith = torch.cumsum(rev, -1) / sizes              # mean of j smallest
    geom = torch.cumsum(torch.log(rev), -1) / sizes         # log geo-mean
    j = m - torch.arange(m, device=lam.device)              # k = 0..M-1
    ratio = geom[..., j - 1] - torch.log(torch.clamp(arith[..., j - 1],
                                                     min=1e-30))
    log_l = -f * j.to(lam.dtype) * ratio                    # L(k) >= 0
    k = torch.arange(m, dtype=lam.dtype, device=lam.device)
    aic = 2.0 * log_l + 2.0 * k * (2 * m - k)
    mdl = log_l + 0.5 * k * (2 * m - k) * np.log(f)
    return aic, mdl


def order_from_eigvals(eigvals: torch.Tensor, num_snapshots: int,
                       method: str = "mdl",
                       max_sources: Optional[int] = None) -> torch.Tensor:
    """Source count from the descending eigenvalues of one covariance (M,)
    or of B bins combined incoherently (B, M)."""
    ev = torch.atleast_2d(eigvals)
    m = ev.shape[-1]
    aic, mdl = information_criteria(ev, num_snapshots)
    crit = {"aic": aic, "mdl": mdl}.get(method)
    if crit is None:
        raise ValueError(f"method must be 'aic' or 'mdl'; got {method!r}")
    total = torch.sum(crit, 0)
    if max_sources is not None:
        keep = torch.arange(m, device=total.device) <= int(max_sources)
        total = torch.where(keep, total, torch.full_like(total, np.inf))
    return torch.argmin(total)


def estimate_num_sources(signals: torch.Tensor, fs: float, frame: int = 1024,
                         hop: Optional[int] = None, num_bins: int = 8,
                         band: Optional[Tuple[float, float]] = None,
                         method: str = "mdl",
                         max_sources: Optional[int] = None) -> int:
    """Count simultaneous broadband sources of one scene's (M, N) signals:
    the MUSIC/Capon snapshots and embedded covariances, the criterion
    ``method`` over the ``num_bins`` strongest bins jointly; a Python int.
    Non-overlapping 1024-sample frames by default (short frames and
    overlapping snapshots over-count; see the JAX package's docstring).
    Spectrally disjoint tones are each rank 1 in their own bin, so the
    joint order is 1 for them."""
    if method not in ("aic", "mdl"):
        raise ValueError(f"method must be 'aic' or 'mdl'; got {method!r}")
    m = signals.shape[0]
    cap = m - 1 if max_sources is None else min(int(max_sources), m - 1)
    hop = frame if hop is None else int(hop)
    snaps = music_ops.snapshot_frames(signals, frame, hop)  # (M, F, bins)
    bin_idx, _ = beam_ops.select_bins(torch.mean(torch.abs(snaps), -2), fs,
                                      frame, num_bins, band)
    emb = music_ops.embedded_covariances(snaps, bin_idx)    # (B, 2M, 2M)
    ev = complex_eigvals_from_embedded(emb)
    return int(order_from_eigvals(ev, snaps.shape[-2], method=method,
                                  max_sources=cap))
