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
are ``jnp.fft.rfft``: no TPU kernel ran on this path.  The extraction half
(``extract_source``, the STFT/WOLA pair, MVDR weights) belongs to a later
slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

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
