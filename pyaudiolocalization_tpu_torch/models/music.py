"""MUSIC (MUltiple SIgnal Classification) narrowband localization
(counterpart of the JAX package's models/music.py; no reference
counterpart).

Incoherent wideband MUSIC over the selected rfft bins k:

    R_k   = (1/F) sum_f  x_f(k) x_f(k)^H          (M x M snapshot covariance)
    E_n,k = all-but-top-num_sources eigenvectors  (noise subspace)
    P(x)  = sum_k w_k / max(||E_n,k^H a_k(x)||^2, eps)

with near-field phase-only steering a_m(x) = exp(-i w_k d_m(x) / c).  As in
the JAX package there is no complex linear algebra: the Hermitian
C = A + iB embeds as the real symmetric (2M, 2M) [[A, -B], [B, A]], whose
spectrum is C's doubled, and the projection onto the noise subspace is
taken directly (the complement ||a||^2 - ||E_s^H a||^2 cancels
catastrophically in float32).  The embedding doubles every eigenvalue, so
``eigh`` may return any rotation inside a pair: projections and
pseudo-spectra are unique, the eigenvectors are not.

Leading scene (or jackknife-group) axes are written out as in
models/beamformer.py: signals (..., M, N), snapshots (..., M, F, bins),
subspaces (..., B, 2M, 2M - 2K).  The STFT is ``torch.fft.rfft`` and the
eigendecomposition ``torch.linalg.eigh``, as the JAX side's are XLA's: no
TPU kernel ran on this path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .beamformer import clip_box, mic_distances, select_bins
from .srp import _box, suppressed_multi_search, two_stage_search


class MusicResult(NamedTuple):
    position: torch.Tensor   # (..., 3)
    power: torch.Tensor      # (...,) pseudo-spectrum value at the estimate
    coarse: torch.Tensor     # (..., 3) stage-1 cell center (diagnostics)


class MultiMusicResult(NamedTuple):
    positions: torch.Tensor  # (..., K, 3) in coarse extraction order
    powers: torch.Tensor     # (..., K) fine-stage pseudo-spectrum values


def snapshot_frames(signals: torch.Tensor, frame: int,
                    hop: Optional[int] = None) -> torch.Tensor:
    """(..., M, N) signals -> (..., M, F, frame//2 + 1) Hann-windowed rfft
    snapshots of frames starting every ``hop`` samples (default frame//2)."""
    n = signals.shape[-1]
    h = frame // 2 if hop is None else int(hop)
    if n < frame:
        raise ValueError(
            f"signals ({n} samples) shorter than the analysis frame "
            f"({frame}).")
    num = 1 + (n - frame) // h
    frames = signals.unfold(-1, frame, h)[..., :num, :]     # (..., M, F, L)
    win = torch.as_tensor(np.hanning(frame), dtype=signals.dtype,
                          device=signals.device)
    return torch.fft.rfft(frames * win, dim=-1)


def embed_planes(a_mat: torch.Tensor, b_mat: torch.Tensor) -> torch.Tensor:
    """Hermitian C = A + iB as the real symmetric [[A, -B], [B, A]]:
    (..., M, M) -> (..., 2M, 2M).  Products and inverses of embeddings
    embed the complex products and inverses."""
    top = torch.cat([a_mat, -b_mat], -1)
    bot = torch.cat([b_mat, a_mat], -1)
    return torch.cat([top, bot], -2)


def _selected(snaps: torch.Tensor, bin_idx: torch.Tensor) -> torch.Tensor:
    """snaps (..., M, F, bins) at bin_idx (..., B) -> (..., M, F, B)."""
    m, f = snaps.shape[-3:-1]
    index = bin_idx[..., None, None, :].expand(
        bin_idx.shape[:-1] + (m, f, bin_idx.shape[-1]))
    return torch.gather(snaps.expand(index.shape[:-1] + snaps.shape[-1:]),
                        -1, index)


def embedded_covariances(snaps: torch.Tensor,
                         bin_idx: torch.Tensor) -> torch.Tensor:
    """Real-embedded snapshot covariances C = (1/F) X X^H of each selected
    bin: snaps (..., M, F, bins), bin_idx (..., B) -> (..., B, 2M, 2M)."""
    sel = _selected(snaps, bin_idx)                         # (..., M, F, B)
    xr = torch.movedim(sel.real, -1, -3)                    # (..., B, M, F)
    xi = torch.movedim(sel.imag, -1, -3)
    f = sel.shape[-2]
    # A = (xr xr^T + xi xi^T)/F (symmetric), B = (xi xr^T - xr xi^T)/F.
    a_mat = (xr @ xr.transpose(-1, -2) + xi @ xi.transpose(-1, -2)) / f
    b_mat = (xi @ xr.transpose(-1, -2) - xr @ xi.transpose(-1, -2)) / f
    return embed_planes(a_mat, b_mat)


def embedded_steering(points: torch.Tensor, mic_positions: torch.Tensor,
                      omega: torch.Tensor, c) -> torch.Tensor:
    """Embedded phase-only steering [Re a; Im a] = [cos; -sin] of
    a_m(x) = exp(-i omega d_m(x) / c): points (..., G, 3), omega (..., B)
    rad/s -> (..., G, 2M, B)."""
    d = mic_distances(points, mic_positions)                    # (..., G, M)
    theta = (d[..., None] / c) * omega.to(d.dtype)[..., None, None, :]
    return torch.cat([torch.cos(theta), -torch.sin(theta)], -2)


def _noise_subspaces(snaps: torch.Tensor, bin_idx: torch.Tensor,
                     num_sources: int) -> torch.Tensor:
    """Embedded noise subspaces of each selected bin: (..., B, 2M, 2M - 2K)
    orthonormal columns spanning everything below the top K (ascending
    ``eigh``)."""
    m = snaps.shape[-3]
    _, vecs = torch.linalg.eigh(embedded_covariances(snaps, bin_idx))
    return vecs[..., :2 * m - 2 * num_sources]


def refine_bin_freqs(snaps: torch.Tensor, bin_idx: torch.Tensor, fs: float,
                     nfft: int, hop: int) -> torch.Tensor:
    """Per-bin tone frequencies by the phase-vocoder estimator: the mean
    inter-frame phase advance of each selected bin, summed over mics and
    frame pairs, with the offset from the bin centre clamped to +-0.55 bin.
    Returns angular frequencies (..., B) rad/s; the bin centres when there
    is one frame or ``hop`` > nfft / 1.1 (the advance aliases there)."""
    base = 2.0 * math.pi * bin_idx.to(snaps.real.dtype) / nfft  # rad/sample
    if snaps.shape[-2] < 2 or hop > nfft / 1.1:
        return base * fs
    sel = _selected(snaps, bin_idx)                         # (..., M, F, B)
    prod = sel[..., 1:, :] * torch.conj(sel[..., :-1, :])
    s_sum = torch.sum(prod, (-3, -2))                           # (..., B)
    adv = torch.atan2(s_sum.imag, s_sum.real)
    two_pi = 2.0 * math.pi
    delta = torch.remainder(adv - base * hop + math.pi, two_pi) - math.pi
    half_bin = 0.55 * two_pi / nfft
    delta = torch.clamp(delta / hop, -half_bin, half_bin)
    return (base + delta) * fs


def music_map_bins(subspaces: torch.Tensor, omega: torch.Tensor,
                   points: torch.Tensor, mic_positions: torch.Tensor,
                   c) -> torch.Tensor:
    """Per-bin MUSIC pseudo-spectra (..., G, B): 1 / ||E_n^H a||^2, the
    projection floored at 1e-7 M (``music_map`` is their weighted sum)."""
    m = mic_positions.shape[-2]
    a_emb = embedded_steering(points, mic_positions, omega, c)
    # a_emb (..., G, 2M, B)
    proj = torch.einsum("...bmk,...gmb->...gbk", subspaces, a_emb)
    noise = torch.clamp(torch.sum(proj * proj, -1), min=1e-7 * m)
    return 1.0 / noise


def music_map(subspaces: torch.Tensor, omega: torch.Tensor,
              bin_w: torch.Tensor, points: torch.Tensor,
              mic_positions: torch.Tensor, c) -> torch.Tensor:
    """MUSIC pseudo-spectrum (..., G) at points (..., G, 3): the selected
    bins' pseudo-spectra weighted by ``bin_w`` (..., B)."""
    per_bin = music_map_bins(subspaces, omega, points, mic_positions, c)
    return torch.sum(bin_w[..., None, :] * per_bin, -1)


def _check_num_sources(num_sources: int, num_mics: int) -> None:
    """MUSIC needs a non-empty noise subspace: 1 <= K < M."""
    if not 1 <= num_sources < num_mics:
        raise ValueError(
            f"num_sources must satisfy 1 <= num_sources < num_mics "
            f"({num_mics}); got {num_sources} — MUSIC requires at least one "
            f"noise-subspace dimension.")


def _stages(signals, mic_positions, fs, frame, hop, num_bins, band):
    """The shared front of MUSIC and Capon: (snapshots, bin indices,
    weights, refined angular frequencies, mics as tensors)."""
    snaps = snapshot_frames(signals, frame, hop)
    bin_idx, bin_w = select_bins(torch.mean(torch.abs(snaps), -2), fs,
                                 frame, num_bins, band)
    omega = refine_bin_freqs(snaps, bin_idx, fs, frame,
                             frame // 2 if hop is None else int(hop))
    mics = torch.as_tensor(mic_positions, dtype=signals.dtype,
                           device=signals.device)
    return snaps, bin_idx, bin_w, omega, mics


def music_locate(signals: torch.Tensor, mic_positions: torch.Tensor,
                 fs: float, c, lower, upper, num_sources: int = 1,
                 frame: int = 256, hop: Optional[int] = None,
                 num_bins: int = 8,
                 band: Optional[Tuple[float, float]] = None,
                 coarse_n: int = 24, fine_n: int = 12) -> MusicResult:
    """Two-stage MUSIC grid search over the box [lower, upper]: signals
    (..., M, N).  ``num_sources`` protects that many emitters' subspace;
    the estimate is the strongest peak (``music_locate_multi`` extracts
    them all)."""
    _check_num_sources(num_sources, signals.shape[-2])
    snaps, bin_idx, bin_w, omega, mics = _stages(
        signals, mic_positions, fs, frame, hop, num_bins, band)
    subs = _noise_subspaces(snaps, bin_idx, num_sources)
    lower, upper = _box(lower, upper, signals)

    def map_fn(p):
        return music_map(subs, omega, bin_w, p, mics, c)

    pos, power, center, _ = two_stage_search(map_fn, map_fn, lower, upper,
                                             coarse_n, fine_n)
    return MusicResult(clip_box(pos, lower, upper), power, center)


def resolve_auto_sources(num_sources, signals: torch.Tensor, fs: float,
                         num_bins: int, band) -> int:
    """``num_sources='auto'``: the Wax-Kailath MDL count of one scene's
    broadband sources (models/order.estimate_num_sources), at least 1."""
    if num_sources != "auto":
        return num_sources
    if signals.dim() != 2:
        raise ValueError("num_sources='auto' counts the sources of one "
                         "scene: signals (M, N)")
    from .order import estimate_num_sources
    return max(1, estimate_num_sources(signals, fs, num_bins=num_bins,
                                       band=band,
                                       max_sources=signals.shape[0] - 1))


def music_locate_multi(signals: torch.Tensor, mic_positions: torch.Tensor,
                       fs: float, c, lower, upper, num_sources,
                       frame: int = 256, hop: Optional[int] = None,
                       num_bins: int = 8,
                       band: Optional[Tuple[float, float]] = None,
                       coarse_n: int = 24, fine_n: int = 12,
                       min_separation: Optional[float] = None
                       ) -> MultiMusicResult:
    """``num_sources`` peaks of the MUSIC map: iterative coarse argmax with
    spatial suppression (radius three coarse cells, or ``min_separation``),
    then a fine re-grid around each peak (models/srp.py's protocol).
    ``num_sources='auto'`` counts the sources of one scene first
    (``resolve_auto_sources``)."""
    num_sources = resolve_auto_sources(num_sources, signals, fs, num_bins,
                                       band)
    _check_num_sources(num_sources, signals.shape[-2])
    snaps, bin_idx, bin_w, omega, mics = _stages(
        signals, mic_positions, fs, frame, hop, num_bins, band)
    subs = _noise_subspaces(snaps, bin_idx, num_sources)
    lower, upper = _box(lower, upper, signals)

    def map_fn(p):
        return music_map(subs, omega, bin_w, p, mics, c)

    positions, powers = suppressed_multi_search(
        map_fn, map_fn, lower, upper, coarse_n, fine_n, num_sources,
        min_separation)
    return MultiMusicResult(positions, powers)
