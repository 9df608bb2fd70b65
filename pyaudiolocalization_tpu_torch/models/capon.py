"""Capon / MVDR (minimum-variance distortionless response) localization
(counterpart of the JAX package's models/capon.py; no reference
counterpart):

    P_capon(x) = 1 / (a(x)^H R^-1 a(x))

The adaptive weights null a loud interferer elsewhere instead of leaking
it through sidelobes; unlike MUSIC the map needs no source count.  The
covariances and steering stay in the real 2M x 2M embedding of
models/music.py, whose inverses embed the complex inverses, so the
quadratic form is the embedded one exactly.  Diagonal loading relative to
the mean eigenvalue keeps every bin invertible.  Leading scene axes as in
models/music.py; the inverse is ``torch.linalg.inv``, as the JAX side's is
XLA's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .beamformer import clip_box
from .music import (_stages, embedded_covariances, embedded_steering,
                    resolve_auto_sources)
from .srp import _box, suppressed_multi_search, two_stage_search


class CaponResult(NamedTuple):
    position: torch.Tensor   # (..., 3)
    power: torch.Tensor      # (...,) Capon spectrum value at the estimate
    coarse: torch.Tensor     # (..., 3) stage-1 cell center (diagnostics)


class MultiCaponResult(NamedTuple):
    positions: torch.Tensor  # (..., K, 3) in coarse extraction order
    powers: torch.Tensor     # (..., K) fine-stage Capon spectrum values


def loaded_inverse(cov: torch.Tensor, loading: float) -> torch.Tensor:
    """Inverses of the diagonally loaded embedded covariances (..., 2M,
    2M): the loading is ``loading`` times the mean eigenvalue (trace / 2M),
    floored at 1e-30 so that digital silence inverts to a large but finite
    matrix."""
    two_m = cov.shape[-1]
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / two_m
    tr = torch.clamp(tr, min=1e-30)
    eye = torch.eye(two_m, dtype=cov.dtype, device=cov.device)
    return torch.linalg.inv(cov + loading * tr[..., None, None] * eye)


def capon_map_bins(cov_inv: torch.Tensor, omega: torch.Tensor,
                   points: torch.Tensor, mic_positions: torch.Tensor,
                   c) -> torch.Tensor:
    """Per-bin Capon spectra (..., G, B): 1 / (a^T R_b^-1 a) in the
    embedding, floored at 1e-30 (``capon_map`` is their weighted sum)."""
    a_emb = embedded_steering(points, mic_positions, omega, c)
    # a_emb (..., G, 2M, B)
    r_a = torch.einsum("...bmn,...gnb->...gmb", cov_inv, a_emb)
    q = torch.sum(a_emb * r_a, -2)                              # (..., G, B)
    return 1.0 / torch.clamp(q, min=1e-30)


def capon_map(cov_inv: torch.Tensor, omega: torch.Tensor,
              bin_w: torch.Tensor, points: torch.Tensor,
              mic_positions: torch.Tensor, c) -> torch.Tensor:
    """Capon spectrum (..., G): sum_b w_b / (a^H R_b^-1 a)."""
    per_bin = capon_map_bins(cov_inv, omega, points, mic_positions, c)
    return torch.sum(bin_w[..., None, :] * per_bin, -1)


def capon_locate(signals: torch.Tensor, mic_positions: torch.Tensor,
                 fs: float, c, lower, upper, frame: int = 256,
                 hop: Optional[int] = None, num_bins: int = 8,
                 band: Optional[Tuple[float, float]] = None,
                 loading: float = 1e-3, coarse_n: int = 24,
                 fine_n: int = 12) -> CaponResult:
    """Two-stage Capon/MVDR grid search over the box [lower, upper]:
    signals (..., M, N); ``loading`` is the diagonal loading fraction."""
    snaps, bin_idx, bin_w, omega, mics = _stages(
        signals, mic_positions, fs, frame, hop, num_bins, band)
    cov_inv = loaded_inverse(embedded_covariances(snaps, bin_idx),
                             float(loading))
    lower, upper = _box(lower, upper, signals)

    def map_fn(p):
        return capon_map(cov_inv, omega, bin_w, p, mics, c)

    pos, power, center, _ = two_stage_search(map_fn, map_fn, lower, upper,
                                             coarse_n, fine_n)
    return CaponResult(clip_box(pos, lower, upper), power, center)


def capon_locate_multi(signals: torch.Tensor, mic_positions: torch.Tensor,
                       fs: float, c, lower, upper, num_sources,
                       frame: int = 256, hop: Optional[int] = None,
                       num_bins: int = 8,
                       band: Optional[Tuple[float, float]] = None,
                       loading: float = 1e-3, coarse_n: int = 24,
                       fine_n: int = 12,
                       min_separation: Optional[float] = None
                       ) -> MultiCaponResult:
    """``num_sources`` peaks of the Capon map by the argmax-suppression
    protocol of models/srp.py; the map does not depend on the count.
    ``num_sources='auto'`` counts the sources of one scene first."""
    num_sources = resolve_auto_sources(num_sources, signals, fs, num_bins,
                                       band)
    snaps, bin_idx, bin_w, omega, mics = _stages(
        signals, mic_positions, fs, frame, hop, num_bins, band)
    cov_inv = loaded_inverse(embedded_covariances(snaps, bin_idx),
                             float(loading))
    lower, upper = _box(lower, upper, signals)

    def map_fn(p):
        return capon_map(cov_inv, omega, bin_w, p, mics, c)

    positions, powers = suppressed_multi_search(
        map_fn, map_fn, lower, upper, coarse_n, fine_n, num_sources,
        min_separation)
    return MultiCaponResult(positions, powers)
