"""Narrowband steered-power (Bartlett) localization, the locating half
(counterpart of the JAX package's models/beamformer.py:49-135; no
reference counterpart).

GCC-PHAT on a narrowband source has a periodic correlation, so its TDOA
peaks are ambiguous modulo the carrier period.  A steered beamformer uses
the array's phase response directly: for a candidate position x and the
selected rfft bins k,

    P(x) = sum_k w_k | (1/M) sum_m S_m(k) exp(+i w_k d_m(x) / c) |^2 / |S(k)|^2

which is unambiguous while the array samples space densely enough.  The
map is dense linear algebra over (G, M) distance planes; the bins are the
top-energy bins of the mean spectrum; the search is the two-stage grid of
models/srp.py.

Every function takes leading scene (or jackknife-group) axes written out
where the JAX package ``vmap``s one scene: signals (..., M, N), spectra
(..., M, bins), mic positions (..., M, 3) and points (..., G, 3) broadcast
against each other.  The spectra are ``torch.fft.rfft``, as the JAX side's
are ``jnp.fft.rfft``: no TPU kernel ran on this path.

The extraction half (the JAX package's models/beamformer.py:137-494) is
the listening half of localize -> listen: ``extract_source``
(delay-and-sum toward a position), ``align_to_position``, the sqrt-Hann
STFT / WOLA pair (``stft_analysis``, ``wola_synthesis``), ``stack_taps``,
the per-bin MVDR / multi-tap LCMV weights (``mvdr_weights``) and
``extract_source_mvdr``.  Its transforms are ``torch.fft``, as the JAX
side's are XLA's; its per-bin inverses and Gram solves are
``torch.linalg``.  The extraction entry points run on ``device``
(``utils.device.resolve_device``: the card unless named).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.fftutils import irfft_n, next_pow2, rfft_n
from ..utils.device import as_tensor
from .srp import _box, two_stage_search


class BeamResult(NamedTuple):
    position: torch.Tensor   # (..., 3)
    power: torch.Tensor      # (...,) steered power at the estimate
    coarse: torch.Tensor     # (..., 3) stage-1 cell center (diagnostics)


def select_bins(spectra: torch.Tensor, fs: float, nfft: int, num_bins: int,
                band: Optional[Tuple[float, float]] = None,
                weight_exponent: float = 0.3):
    """The ``num_bins`` strongest rfft bins of the mean power spectrum over
    the mics (within ``band`` Hz when given): spectra (..., M, bins) ->
    (bin indices (..., B), weights (..., B)).  The weights are the powers
    raised to ``weight_exponent`` and normalized: tempered weights let a
    tone's harmonics veto a grating lobe that the fundamental alone would
    pick.  Equal powers (band-masked bins are all 0) keep index order, as
    ``jax.lax.top_k`` does."""
    power = torch.mean(torch.abs(spectra) ** 2, -2)              # (..., bins)
    if band is not None:
        freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
        mask = torch.as_tensor((freqs >= band[0]) & (freqs <= band[1]),
                               dtype=power.dtype, device=power.device)
        power = power * mask
    vals, idx = torch.sort(power, stable=True, dim=-1, descending=True)
    vals, idx = vals[..., :num_bins], idx[..., :num_bins]
    tempered = torch.clamp(vals, min=0.0) ** weight_exponent
    tempered = torch.where(vals > 0, tempered, torch.zeros_like(tempered))
    w = tempered / torch.clamp(torch.sum(tempered, -1, keepdim=True),
                               min=1e-30)
    return idx, w


def mic_distances(points: torch.Tensor,
                  mic_positions: torch.Tensor) -> torch.Tensor:
    """(..., G, M) distances of points (..., G, 3) to mics (..., M, 3)."""
    return torch.linalg.norm(points[..., :, None, :]
                             - mic_positions[..., None, :, :], dim=-1)


def steered_power_map(spectra: torch.Tensor, bin_idx: torch.Tensor,
                      bin_w: torch.Tensor, points: torch.Tensor,
                      mic_positions: torch.Tensor, fs: float, nfft: int,
                      c) -> torch.Tensor:
    """Bartlett steered power at each candidate point: spectra (..., M,
    bins), the selected bins and weights (..., B), points (..., G, 3) ->
    (..., G).  Each mic's spectrum is rotated by exp(+i w d_m / c) back to
    the source and averaged over the mics; each bin's magnitude is
    normalized out (a phase-coherence metric)."""
    m = spectra.shape[-2]
    d = mic_distances(points, mic_positions)                     # (..., G, M)
    omega = 2.0 * math.pi * bin_idx.to(d.dtype) * (fs / nfft)    # (..., B)
    index = bin_idx[..., None, :].expand(
        bin_idx.shape[:-1] + (m, bin_idx.shape[-1]))
    s_sel = torch.gather(spectra.expand(index.shape[:-1]
                                        + spectra.shape[-1:]), -1, index)
    sr, si = s_sel.real, s_sel.imag                              # (..., M, B)
    theta = (d[..., None] / c) * omega[..., None, None, :]   # (..., G, M, B)
    ct, st = torch.cos(theta), torch.sin(theta)
    yr = (torch.einsum("...gmb,...mb->...gb", ct, sr)
          - torch.einsum("...gmb,...mb->...gb", st, si))
    yi = (torch.einsum("...gmb,...mb->...gb", ct, si)
          + torch.einsum("...gmb,...mb->...gb", st, sr))
    mag2 = torch.sum(sr * sr + si * si, -2) + 1e-30              # (..., B)
    return torch.sum(bin_w[..., None, :] * (yr * yr + yi * yi)
                     / mag2[..., None, :], -1) / m


def clip_box(pos: torch.Tensor, lower: torch.Tensor,
             upper: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(pos, lower), upper)


def beamform_locate(signals: torch.Tensor, mic_positions: torch.Tensor,
                    fs: float, c, lower, upper, num_bins: int = 12,
                    band: Optional[Tuple[float, float]] = None,
                    coarse_n: int = 24, fine_n: int = 12,
                    nfft: Optional[int] = None) -> BeamResult:
    """Two-stage steered-power grid search over the box [lower, upper]:
    signals (..., M, N), mic positions (..., M, 3), the box (3,) or
    (..., 3).  Needs no whitening and no lag decoding, and localizes the
    single tones that defeat correlation-based TDOAs."""
    nf = int(nfft) if nfft is not None else signals.shape[-1]
    spectra = torch.fft.rfft(signals, n=nf)
    bin_idx, bin_w = select_bins(spectra, fs, nf, num_bins, band)
    mics = torch.as_tensor(mic_positions, dtype=signals.dtype,
                           device=signals.device)
    lower, upper = _box(lower, upper, signals)

    def map_fn(p):
        return steered_power_map(spectra, bin_idx, bin_w, p, mics, fs, nf, c)

    pos, power, center, _ = two_stage_search(map_fn, map_fn, lower, upper,
                                             coarse_n, fine_n)
    return BeamResult(clip_box(pos, lower, upper), power, center)


# ---------------------------------------------------------------------------
# Extraction: delay-and-sum, and STFT analysis -> per-bin MVDR -> WOLA
# ---------------------------------------------------------------------------

def _inputs(signals, mic_positions, position, device):
    """signals, mics and position as tensors on ``device`` (the card unless
    named), in the signals' dtype (numpy float64 stays float64)."""
    x = as_tensor(signals, device=device)
    return x, as_tensor(mic_positions, x), as_tensor(position, x)


def _advance_ramp(mics: torch.Tensor, position: torch.Tensor, fs: float, c,
                  nfft: int) -> torch.Tensor:
    """(M, nfft//2 + 1) phase ramps advancing each mic by its extra
    propagation delay toward ``position``, relative to the closest mic."""
    d = torch.linalg.norm(position[None, :] - mics, dim=-1)     # (M,)
    tau = (d - torch.min(d)) / c
    freqs = torch.arange(nfft // 2 + 1, dtype=mics.dtype,
                         device=mics.device) * (fs / nfft)
    pha = 2.0 * math.pi * freqs[None, :] * tau[:, None]
    return torch.complex(torch.cos(pha), torch.sin(pha))


def extract_source(signals, mic_positions, position, fs: float, c,
                   mic_weights=None, device=None) -> torch.Tensor:
    """Delay-and-sum the array toward ``position``: each mic is advanced by
    its extra propagation delay relative to the closest mic (a phase ramp
    at nfft = next_pow2(2N)), weighted by ``mic_weights`` (M,) normalized
    to sum 1 (default uniform 1/M) and summed.  The target adds
    coherently and incoherent noise in power (array gain ~M).  signals
    (..., M, N) -> (..., N), aligned to the closest mic's arrival."""
    x, mics, p = _inputs(signals, mic_positions, position, device)
    n, m = x.shape[-1], mics.shape[0]
    nfft = next_pow2(2 * n)
    if mic_weights is None:
        w = torch.full((m,), 1.0 / m, dtype=x.dtype, device=x.device)
    else:
        w = as_tensor(mic_weights, x)
        w = w / torch.clamp(torch.sum(w), min=torch.finfo(x.dtype).tiny)
    ramp = _advance_ramp(mics, p, fs, c, nfft)
    summed = torch.sum(rfft_n(x, nfft) * (w[:, None] * ramp), -2)
    return irfft_n(summed, nfft)[..., :n].to(x.dtype)


def align_to_position(signals, mic_positions, position, fs: float, c,
                      device=None) -> torch.Tensor:
    """Advance each mic by its extra propagation delay toward ``position``
    (the ramp of ``extract_source``), so that the target's wavefront is
    aligned across mics on the closest mic's arrival: (..., M, N) -> the
    same shape.  ``extract_source`` is the weighted mean of these
    channels."""
    x, mics, p = _inputs(signals, mic_positions, position, device)
    n = x.shape[-1]
    nfft = next_pow2(2 * n)
    ramp = _advance_ramp(mics, p, fs, c, nfft)
    return irfft_n(rfft_n(x, nfft) * ramp, nfft)[..., :n].to(x.dtype)


def _sqrt_hann(frame: int, dtype, device=None) -> torch.Tensor:
    """sqrt of the periodic Hann window (denominator ``frame``): its square
    overlap-adds to the constant L/2 at hop = frame/L for any integer
    L >= 2, the WOLA reconstruction condition (the symmetric window does
    not)."""
    idx = np.arange(frame)
    h = 0.5 - 0.5 * np.cos(2.0 * np.pi * idx / frame)
    return torch.as_tensor(np.sqrt(h), dtype=dtype, device=device)


def _wola_layout(n: int, frame: int, hop: int) -> Tuple[int, int, int]:
    """(num_frames, pad_left, pad_right) covering ``n`` samples with every
    sample under all frame/hop overlapping windows."""
    if frame % hop != 0 or frame // hop < 2:
        raise ValueError(
            f"WOLA needs hop dividing frame with frame/hop >= 2 "
            f"(got frame={frame}, hop={hop}).")
    pad_left = frame - hop
    num = (pad_left + n - 1) // hop + 1
    pad_right = (num - 1) * hop + frame - pad_left - n
    return num, pad_left, pad_right


def stft_analysis(signals: torch.Tensor, frame: int,
                  hop: int) -> torch.Tensor:
    """sqrt-Hann STFT of (..., N) real signals -> (..., T, frame//2 + 1),
    padded by ``_wola_layout`` so that ``wola_synthesis`` reconstructs the
    interior exactly."""
    num, pad_left, pad_right = _wola_layout(signals.shape[-1], frame, hop)
    padded = torch.nn.functional.pad(signals, (pad_left, pad_right))
    frames = padded.unfold(-1, frame, hop)                   # (..., T, frame)
    win = _sqrt_hann(frame, signals.dtype, signals.device)
    return torch.fft.rfft(frames * win, dim=-1)


def wola_synthesis(spectra: torch.Tensor, frame: int, hop: int,
                   n: int) -> torch.Tensor:
    """Inverse of ``stft_analysis``: (..., T, frame//2 + 1) -> (..., n) by
    sqrt-Hann weighted overlap-add (``fold``), scaled by 2/L."""
    num, pad_left, _ = _wola_layout(n, frame, hop)
    frames = irfft_n(spectra, frame)
    win = _sqrt_hann(frame, frames.dtype, frames.device)
    frames = frames * (win * (2.0 / (frame // hop)))
    lead = frames.shape[:-2]
    total = (num - 1) * hop + frame
    out = torch.nn.functional.fold(
        frames.reshape((-1, num, frame)).transpose(1, 2),
        output_size=(1, total), kernel_size=(1, frame), stride=(1, hop))
    return out.reshape(lead + (total,))[..., pad_left:pad_left + n]


def stack_taps(spectra: torch.Tensor, taps: int,
               valid: bool) -> torch.Tensor:
    """Stack ``taps`` delayed STFT frames a snapshot: (M, T, F) ->
    (taps*M, T', F), rows [x_t; x_{t-1}; ...; x_{t-taps+1}].
    ``valid=True`` keeps the snapshots with a full history (T' = T - taps
    + 1: the covariance must not see fabricated zeros); ``valid=False``
    zero-pads the history before the capture (T' = T: the synthesis needs
    an output a frame)."""
    m, t, f = spectra.shape
    if taps == 1:
        return spectra
    if valid:
        blocks = [spectra[:, taps - 1 - k:t - k, :] for k in range(taps)]
    else:
        pad = torch.zeros((m, taps - 1, f), dtype=spectra.dtype,
                          device=spectra.device)
        ext = torch.cat([pad, spectra], 1)
        blocks = [ext[:, taps - 1 - k:taps - 1 - k + t, :]
                  for k in range(taps)]
    return torch.cat(blocks, 0)


def mvdr_weights(spectra: torch.Tensor, tau: torch.Tensor, fs: float,
                 frame: int, loading: float,
                 taps: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bin MVDR weights toward relative delays ``tau`` (M,) seconds:
    spectra (taps*M, T, F) (``stack_taps``, tap 0 rows first) -> (wr, wi),
    the (taps*M, F) real and imaginary planes of w_k = R_k^-1 a_k /
    (a_k^H R_k^-1 a_k), with R_k the diagonally loaded snapshot
    covariance.  The linear algebra stays in the real 2M x 2M embedding
    (models/music.embed_planes), whose inverse embeds the complex one.

    For ``taps > 1`` a tap-0 constraint alone lets the minimizer cancel
    the target through its own overlapped history, so the weights are
    LCMV with ``taps`` constraints: unit response to the target on tap 0,
    zero on every delayed tap, w = R^-1 C (C^H R^-1 C)^-1 e_0 with C =
    I_taps (x) a_k; the Gram matrix carries a ridge of 1e-7 of its mean
    diagonal.  taps = 1 is MVDR exactly."""
    from .capon import loaded_inverse
    from .music import embed_planes
    xr, xi = spectra.real, spectra.imag                     # (L*M, T, F)
    t = spectra.shape[1]
    # C_k = (1/T) X X^H = A + iB per bin.
    a_mat = (torch.einsum("mtf,ntf->fmn", xr, xr)
             + torch.einsum("mtf,ntf->fmn", xi, xi)) / t
    b_mat = (torch.einsum("mtf,ntf->fmn", xi, xr)
             - torch.einsum("mtf,ntf->fmn", xr, xi)) / t
    r_inv = loaded_inverse(embed_planes(a_mat, b_mat), loading)
    lm = spectra.shape[0]
    f_bins = frame // 2 + 1
    omega = (2.0 * math.pi * fs / frame) * torch.arange(
        f_bins, dtype=xr.dtype, device=xr.device)           # (F,)
    theta = tau[:, None].to(xr.dtype) * omega[None, :]      # (M, F)
    floor = torch.tensor(1e-30, dtype=xr.dtype, device=xr.device)
    if taps == 1:
        # a = exp(-i omega tau) embeds as [cos; -sin].
        a_emb = torch.cat([torch.cos(theta), -torch.sin(theta)], 0)
        n_emb = torch.einsum("fmn,nf->mf", r_inv, a_emb)    # (2M, F)
        denom = torch.maximum(torch.einsum("mf,mf->f", a_emb, n_emb), floor)
        w_emb = n_emb / denom[None, :]
        return w_emb[:lm], w_emb[lm:]
    # The constraint matrix C = I_taps (x) a_k embeds per bin as the
    # (2LM, 2L) block matrix [[Cr, -Ci], [Ci, Cr]].
    eye_t = torch.eye(taps, dtype=xr.dtype, device=xr.device)
    c_r = torch.einsum("lk,mf->flmk", eye_t,
                       torch.cos(theta)).reshape(f_bins, lm, taps)
    c_i = torch.einsum("lk,mf->flmk", eye_t,
                       -torch.sin(theta)).reshape(f_bins, lm, taps)
    c_emb = torch.cat([torch.cat([c_r, -c_i], -1),
                       torch.cat([c_i, c_r], -1)], -2)      # (F, 2LM, 2L)
    n_c = torch.einsum("fmn,fnl->fml", r_inv, c_emb)        # (F, 2LM, 2L)
    gram = torch.einsum("fml,fmk->flk", c_emb, n_c)         # (F, 2L, 2L)
    tr_g = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / (2 * taps)
    ridge = 1e-7 * torch.maximum(tr_g, floor)
    eye = torch.eye(2 * taps, dtype=xr.dtype, device=xr.device)
    gram = gram + ridge[:, None, None] * eye
    # Response e_0: unit tap-0 target gain, zero delayed-tap target gain.
    e0 = eye[0].expand(f_bins, 2 * taps)[..., None]
    sol = torch.linalg.solve(gram, e0)[..., 0]              # (F, 2L)
    w_emb = torch.einsum("fml,fl->mf", n_c, sol)            # (2LM, F)
    return w_emb[:lm], w_emb[lm:]


def apply_weights(wr: torch.Tensor, wi: torch.Tensor,
                  stacked: torch.Tensor) -> torch.Tensor:
    """y = w^H x a frame and bin: weights (L*M, F), snapshots (L*M, T, F)
    -> (T, F) complex."""
    xr, xi = stacked.real, stacked.imag
    y_r = (torch.einsum("mf,mtf->tf", wr, xr)
           + torch.einsum("mf,mtf->tf", wi, xi))
    y_i = (torch.einsum("mf,mtf->tf", wr, xi)
           - torch.einsum("mf,mtf->tf", wi, xr))
    return torch.complex(y_r, y_i)


def extract_source_mvdr(signals, mic_positions, position, fs: float, c,
                        frame: int = 256, hop: Optional[int] = None,
                        loading: float = 0.3, taps: int = 1,
                        device=None) -> torch.Tensor:
    """Adaptive extraction toward ``position``: ``align_to_position`` (the
    target's steering vector becomes exactly ones) -> sqrt-Hann STFT ->
    per-bin MVDR weights (``taps > 1``: convolutive LCMV over stacked
    frames) from the full-history snapshots, with ``loading`` the diagonal
    loading fraction of the mean eigenvalue -> the weighted frames ->
    WOLA.  The minimum-output-power objective nulls directional
    interferers that delay-and-sum passes; the stiff default loading
    (0.3) keeps the target, which is in the covariance.  signals (M, N) ->
    (N,); hop defaults to frame // 4."""
    h = frame // 4 if hop is None else int(hop)
    if taps < 1:
        raise ValueError("taps must be >= 1")
    x, mics, p = _inputs(signals, mic_positions, position, device)
    n, m = x.shape[-1], x.shape[-2]
    aligned = align_to_position(x, mics, p, fs, c, device=x.device)
    spectra = stft_analysis(aligned, frame, h)              # (M, T, F)
    tau0 = torch.zeros((m,), dtype=x.dtype, device=x.device)
    wr, wi = mvdr_weights(stack_taps(spectra, taps, valid=True), tau0,
                          float(fs), frame, float(loading), taps=taps)
    y = apply_weights(wr, wi, stack_taps(spectra, taps, valid=False))
    return wola_synthesis(y, frame, h, n).to(x.dtype)
