"""Moving-source tracking: segment-wise localization over time (counterpart
of the JAX package's models/tracking.py; no reference counterpart).

A long capture is cut into overlapping segments (one ``unfold``), and each
segment localizes on its own: GCC-PHAT then SRP-PHAT (kernel K1 over every
segment at ``next_pow2(segment)``, then ``models/srp.py`` over the segment
axis), or the narrowband Capon / MUSIC scans.  The JAX package ``vmap``s
one segment; here the segments are a leading scene axis of the same
functions.  A ``lax.scan`` over time is a Python loop over the short axis
(segments, extractions, tracks); no host read happens inside it.

``smoother='kalman'`` is the constant-velocity Kalman filter with the
Rauch-Tung-Striebel backward pass (``kalman_rts_smooth``): per-segment SRP
power weights the measurement covariance, and the measurement noise comes
from the robust second difference of the raw track.  ``motion=
'compensated'`` estimates each pair's delay rate from subframe GCCs (K1
over segments x subframes) and aligns the subframe correlations to the
segment centre before the SRP.

``track_multiple`` follows K sources with identities: K-source SRP per
segment (or, compensated, a delay-rate matched-filter bank with lag
claiming), the exact K! momentum-gated assignment over segments
(``associate_detections``), Kalman/RTS smoothing per track and, when
compensated, a rate-steered re-detection per (segment, track).

Three faults of the JAX package are repaired here, each pinned by a test
of ``tests/test_torch_tracking.py``: the rate bank's coarse SRP pools over
a cell's covering radius less the envelope peak's half-width
(``_rate_bank_pool``; its pool and lag bound are computed on the host;
the JAX package's traced bounds fall back to a pool of 2,
tracking.py:465 there); the re-detection pools a ``pool_w``-padded slice
of the aligned window, so that the linear +-``w_half`` window never wraps
(tracking.py:542 there); and after that re-detection every emitted
detection is flagged associated (tracking.py:895 there).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import gccphat
from ..ops.fftutils import next_pow2
from ..utils.device import resolve_device
from . import capon as capon_ops
from . import music as music_ops
from . import srp as srp_ops

#: Half-width (samples) of the lag-claiming null around an extracted
#: source's per-pair lag: the whitened peak (~2 lags), the rate envelope's
#: plateau (+-1 candidate spacing) and the fine stage's position error.
_CLAIM_LAGS = 6.0

#: Bytes of the rate bank's aligned spectra a chunk of segments may hold
#: (the JAX package computes every segment in one graph).
RATE_BANK_CHUNK_BYTES = 1 << 30


class Track(NamedTuple):
    times: torch.Tensor       # (S,) segment-centre times, seconds
    positions: torch.Tensor   # (S, 3) raw per-segment estimates
    smoothed: torch.Tensor    # (S, 3) smoothed track (EMA or Kalman/RTS)
    powers: torch.Tensor      # (S,) SRP power per segment (confidence)
    velocities: Optional[torch.Tensor] = None  # (S, 3) m/s, compensated only


class MultiTrack(NamedTuple):
    """``track_multiple``'s output: axis 1 is the track axis (detection k
    of every segment belongs to the same source)."""
    times: torch.Tensor       # (S,)
    positions: torch.Tensor   # (S, K, 3) associated raw detections
    smoothed: torch.Tensor    # (S, K, 3) per-track Kalman/RTS smoothing
    powers: torch.Tensor      # (S, K) fine-stage SRP power per detection
    velocities: torch.Tensor  # (S, K, 3) smoothed track velocities (m/s)
    associated: torch.Tensor  # (S, K) bool: the detection describes its track


def _median(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Median over the last ``dims`` axes, the mean of the two middle
    values for an even count (numpy's, and ``jnp.median``'s)."""
    flat = torch.sort(x.reshape(x.shape[:x.dim() - dims] + (-1,)), -1)[0]
    n = flat.shape[-1]
    return 0.5 * (flat[..., (n - 1) // 2] + flat[..., n // 2])


def kalman_rts_smooth(positions: torch.Tensor, dt,
                      powers: Optional[torch.Tensor] = None,
                      accel_std: float = 0.5,
                      meas_std: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constant-velocity Kalman filter + RTS smoother of a position track:
    positions (..., S, D) sampled every ``dt`` seconds (leading axes are
    independent tracks).  ``powers`` (..., S) weight each measurement: its
    variance is scaled by median(powers) / power, clipped to [0.1, 10].
    ``accel_std`` (m/s^2) is the white-acceleration process noise;
    ``meas_std`` (m) defaults to 1.4826 * MAD / sqrt(6) of the track's
    second difference (zero for constant-velocity truth), floored at
    1e-4.  The D axes decouple into closed-form 2-state filters.  Returns
    (smoothed positions, velocities), both (..., S, D)."""
    z = torch.as_tensor(positions)
    s, d = z.shape[-2:]
    lead = z.shape[:-2]
    if s < 2:
        return z, torch.zeros_like(z)
    dtype, dev = z.dtype, z.device
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    if meas_std is None:
        if s >= 4:
            d2 = z[..., 2:, :] - 2.0 * z[..., 1:-1, :] + z[..., :-2, :]
            sigma = 1.4826 * _median(torch.abs(d2), 2) / np.sqrt(6.0)
        else:
            sigma = torch.full(lead, 0.02, dtype=dtype, device=dev)
        meas_var = torch.clamp(sigma, min=1e-4) ** 2             # (...)
    else:
        meas_var = torch.full(lead, float(meas_std), dtype=dtype,
                              device=dev) ** 2
    if powers is None:
        w = torch.ones(lead + (s,), dtype=dtype, device=dev)
    else:
        p = torch.as_tensor(powers, dtype=dtype, device=dev)
        ref = torch.clamp(_median(p, 1), min=1e-30)
        w = torch.clamp(p / ref[..., None], 0.1, 10.0)
    r_t = meas_var[..., None] / w                                # (..., S)
    q = torch.as_tensor(accel_std, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    f_mat = torch.stack([torch.stack([one, dt]), torch.stack([zero, one])])
    q_mat = (q * q) * torch.tensor([[0.25, 0.5], [0.5, 1.0]], dtype=dtype,
                                   device=dev) * torch.stack(
        [torch.stack([dt ** 4, dt ** 3]), torch.stack([dt ** 3, dt ** 2])])

    def inv2(a):
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        adj = torch.stack(
            [torch.stack([a[..., 1, 1], -a[..., 0, 1]], -1),
             torch.stack([-a[..., 1, 0], a[..., 0, 0]], -1)], -2)
        return adj / det[..., None, None]

    m = torch.stack([z[..., 0, :], torch.zeros_like(z[..., 0, :])], -1)
    big = 100.0 * meas_var                                        # (...)
    p = torch.zeros(lead + (d, 2, 2), dtype=dtype, device=dev)
    p[..., 0, 0] = big[..., None]
    p[..., 1, 1] = (big / (dt * dt))[..., None]
    ms, ps, mps, pps = [], [], [], []
    for t in range(s):
        m_pred = m @ f_mat.T
        p_pred = torch.einsum("ij,...djk,lk->...dil", f_mat, p, f_mat) + q_mat
        # H = [1, 0]: a scalar innovation per axis.
        innov = z[..., t, :] - m_pred[..., 0]
        s_cov = p_pred[..., 0, 0] + r_t[..., t, None]
        k = p_pred[..., :, 0] / s_cov[..., None]
        m = m_pred + k * innov[..., None]
        p = p_pred - k[..., :, None] * p_pred[..., None, 0, :]
        ms.append(m)
        ps.append(p)
        mps.append(m_pred)
        pps.append(p_pred)
    # RTS from t = S - 2 down to 0, against the prediction made for t + 1.
    x_next = ms[-1]
    out = [x_next]
    for t in range(s - 2, -1, -1):
        gain = torch.einsum("...dij,kj,...dkl->...dil", ps[t], f_mat,
                            inv2(pps[t + 1]))
        x_next = ms[t] + torch.einsum("...dij,...dj->...di", gain,
                                      x_next - mps[t + 1])
        out.append(x_next)
    x_smooth = torch.stack(out[::-1], -3)                       # (..., S, D, 2)
    return x_smooth[..., 0], x_smooth[..., 1]


def _pairs(m: int):
    pi, pj = np.triu_indices(m, 1)
    return pi.astype(np.int64), pj.astype(np.int64)


def _segments(signals: torch.Tensor, segment: int, hop: int):
    """(S, M, segment) segments every ``hop`` samples, and their starts."""
    t = signals.shape[-1]
    if t < segment:
        raise ValueError("signal shorter than one segment")
    num_seg = 1 + (t - segment) // hop
    segs = signals.unfold(-1, segment, hop)[:, :num_seg]        # (M, S, L)
    return segs.transpose(0, 1).contiguous(), np.arange(num_seg) * hop


def _irfft_real_ends(spec: torch.Tensor, n: int) -> torch.Tensor:
    """irfft of a half spectrum whose DC and Nyquist bins carry an
    imaginary part (a phase-shifted real spectrum): that part is dropped,
    as numpy's and XLA's inverse drop it; cuFFT's float32 inverse would
    not."""
    spec = spec.clone()
    spec[..., 0] = spec[..., 0].real.to(spec.dtype)
    if n % 2 == 0:
        spec[..., n // 2] = spec[..., n // 2].real.to(spec.dtype)
    return torch.fft.irfft(spec, n=n)


def _phase(k_bins: torch.Tensor, shift: torch.Tensor,
           npad: int) -> torch.Tensor:
    """exp(i 2 pi k shift / npad): the spectrum of a delay of -shift
    samples; shift (...) -> (..., bins)."""
    phase = (2.0 * np.pi / npad) * k_bins * shift[..., None]
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _compensated_sizes(mic_positions, fs: float, c, segment: int,
                       motion_subframes: int, max_speed: float):
    """Host-side sizes of the compensated path: (lf, nfft_f, w_half,
    s_max), raising where the alignment window exceeds the subframe
    transform."""
    lf = segment // motion_subframes
    if lf < 64:
        raise ValueError("segment // motion_subframes must be >= 64")
    nfft_f = next_pow2(2 * lf)
    mics = np.asarray(torch.as_tensor(mic_positions).detach().cpu(), float)
    diam = float(np.max(np.linalg.norm(mics[:, None, :] - mics[None, :, :],
                                       axis=-1)))
    w_half = int(np.ceil(diam * float(fs) / float(c))) + 12
    s_max = int(np.ceil(2.0 * max_speed / float(c) * segment / 2.0)) + 2
    if 2 * (w_half + s_max) + 1 > nfft_f:
        raise ValueError(
            "motion='compensated' alignment window (mic diameter "
            f"{w_half} + drift margin {s_max} lags) exceeds the "
            f"subframe transform {nfft_f}: use a longer segment, "
            "fewer motion_subframes, or a smaller max_speed")
    return lf, nfft_f, w_half, s_max


def _subframe_offsets(nsub: int, lf: int) -> np.ndarray:
    """Subframe-centre offsets from the segment centre (samples), (nsub,),
    on the host."""
    return (np.arange(nsub) + 0.5) * lf - (nsub * lf) / 2.0


def _subframe_windows(segs: torch.Tensor, pi, pj, fs: float, band,
                      weighting: str, nsub: int, wn: int,
                      nfft_f: int) -> torch.Tensor:
    """Per-subframe GCC lag windows (S, nsub, P, 2 wn + 1), lag 0 at index
    wn: every segment cut into ``nsub`` subframes, the all-pairs GCC of
    every (segment, subframe) at ``nfft_f`` (K1 over both leading axes for
    PHAT), the +-wn lags in linear order."""
    s_dim, m, seg_len = segs.shape
    lf = seg_len // nsub
    sub = segs[..., :nsub * lf].reshape(s_dim, m, nsub, lf).transpose(1, 2)
    corr = gccphat.gcc_phat_all_pairs(sub.contiguous(), pi, pj, nfft=nfft_f,
                                      band=band, fs=fs, weighting=weighting)
    return torch.cat([corr[..., nfft_f - wn:], corr[..., :wn + 1]], -1)


def _circular(comp: torch.Tensor, w_half: int, nfft_f: int) -> torch.Tensor:
    """A centred +-w_half window back in circular lag order at nfft_f."""
    zeros = torch.zeros(comp.shape[:-1] + (nfft_f - 2 * w_half - 1,),
                        dtype=comp.dtype, device=comp.device)
    return torch.cat([comp[..., w_half:], zeros, comp[..., :w_half]], -1)


def _motion_compensated_corr(segs: torch.Tensor, pi, pj, fs: float, band,
                             weighting: str, nsub: int, w_half: int,
                             s_max: int, nfft_f: int):
    """Per-(segment, pair) delay rate from the subframe peaks and the
    rate-aligned correlation: the subframe windows (+-(w_half + s_max)
    lags), each subframe's parabolic peak and squared-peak weight, a
    weighted line lag(f) = tau_c + tau_dot * dt_f over the subframe-centre
    offsets dt_f, then every window Fourier-shifted by -tau_dot * dt_f and
    summed.  Returns (circ (S, P, nfft_f) in circular lag order, tau_dot
    (S, P) dimensionless, the fit's weight sum (S, P))."""
    wn = w_half + s_max
    win = _subframe_windows(segs, pi, pj, fs, band, weighting, nsub, wn,
                            nfft_f)                          # (S, K, P, wlen)
    dtype, dev = win.dtype, win.device
    lf = segs.shape[-1] // nsub
    wlen = 2 * wn + 1
    pk = torch.argmax(win, -1)
    pk_c = torch.clamp(pk, 1, wlen - 2)
    v0 = torch.gather(win, -1, pk_c[..., None])[..., 0]
    vm = torch.gather(win, -1, (pk_c - 1)[..., None])[..., 0]
    vp = torch.gather(win, -1, (pk_c + 1)[..., None])[..., 0]
    denom = vm - 2.0 * v0 + vp
    delta = torch.where(torch.abs(denom) > 1e-12,
                        0.5 * (vm - vp) / torch.where(
                            denom == 0, torch.ones_like(denom), denom),
                        torch.zeros_like(denom))
    lag_f = pk_c.to(dtype) + torch.clamp(delta, -1.0, 1.0) - wn
    wt = torch.clamp(v0, min=0.0) ** 2 + 1e-12                  # (S, K, P)
    offsets = _subframe_offsets(nsub, lf)
    dt_f = torch.as_tensor(offsets, dtype=dtype, device=dev)[None, :, None]
    sw = torch.sum(wt, 1)
    swx = torch.sum(wt * dt_f, 1)
    swxx = torch.sum(wt * dt_f * dt_f, 1)
    swy = torch.sum(wt * lag_f, 1)
    swxy = torch.sum(wt * dt_f * lag_f, 1)
    det = sw * swxx - swx * swx
    tau_dot = torch.where(torch.abs(det) > 1e-20,
                          (sw * swxy - swx * swy) / torch.where(
                              det == 0, torch.ones_like(det), det),
                          torch.zeros_like(det))               # (S, P)
    # |shift| <= s_max by the clip, inside the window's margin.
    rmax = s_max / max(float(offsets[-1]), 1.0)
    tau_dot = torch.clamp(tau_dot, -rmax, rmax)
    shift = tau_dot[:, None, :] * dt_f                          # (S, K, P)
    npad = next_pow2(wlen)
    spec = torch.fft.rfft(win, n=npad)
    k_bins = torch.arange(spec.shape[-1], dtype=dtype, device=dev)
    shifted = _irfft_real_ends(spec * _phase(k_bins, shift, npad),
                               npad)[..., :wlen]
    comp = torch.sum(shifted, 1)[..., s_max:s_max + 2 * w_half + 1]
    return _circular(comp, w_half, nfft_f), tau_dot, sw


def _velocity_lsq(pos: torch.Tensor, mics: torch.Tensor, pi, pj, c,
                  tau_dot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Source velocity from per-pair delay rates at the estimated position:
    pair (i, j)'s dimensionless rate is (u_i - u_j) . v / c (u the
    source-to-mic bearings), solved by weighted 3x3 least squares with a
    trace-relative ridge (an unobservable axis shrinks to 0).  pos (..., 3),
    tau_dot and w (..., P) -> (..., 3)."""
    d = pos[..., None, :] - mics
    u = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                        min=1e-9)
    a = (u[..., pi, :] - u[..., pj, :]) / c                     # (..., P, 3)
    aw = a * w[..., None]
    n_mat = aw.transpose(-1, -2) @ a
    lam = 1e-6 * (torch.diagonal(n_mat, dim1=-2, dim2=-1).sum(-1)
                  / 3.0) + 1e-30
    n_mat = n_mat + lam[..., None, None] * torch.eye(3, dtype=pos.dtype,
                                                     device=pos.device)
    rhs = (aw.transpose(-1, -2) @ tau_dot[..., None])[..., 0]
    return torch.linalg.solve(n_mat, rhs)


def _ema(positions: torch.Tensor, smoothing: float) -> torch.Tensor:
    prev = positions[0]
    out = []
    for t in range(positions.shape[0]):
        prev = smoothing * prev + (1.0 - smoothing) * positions[t]
        out.append(prev)
    return torch.stack(out)


def _check_weighting(weighting: str) -> None:
    if weighting not in ("phat", "scot", "roth", "cc"):
        raise ValueError("weighting must be 'phat', 'scot', 'roth', or "
                         "'cc' for segment tracking")


def _inputs(signals, mic_positions, device):
    dev = resolve_device(device)
    x = (signals.to(dev) if torch.is_tensor(signals)
         else torch.as_tensor(np.array(signals), device=dev))
    mics = torch.as_tensor(mic_positions).to(dtype=x.dtype, device=x.device)
    return x, mics


def localize_trajectory(signals, mic_positions, fs: float, c, lower, upper,
                        segment: int = 4096, hop: Optional[int] = None,
                        band: Optional[Tuple[float, float]] = None,
                        smoothing: float = 0.6, coarse_n: int = 20,
                        fine_n: int = 10, method: str = "srp",
                        smoother: str = "ema", accel_std: float = 0.5,
                        weighting: str = "phat", motion: str = "static",
                        motion_subframes: int = 8, max_speed: float = 5.0,
                        device=None) -> Track:
    """Track a moving source through a capture (M, T), the JAX package's
    ``localize_trajectory`` (models/tracking.py:304 there): segments of
    ``segment`` samples every ``hop`` (default segment // 2), each
    localized over the box [lower, upper] by SRP-PHAT (``method='srp'``,
    K1 over the segments at next_pow2(segment) for PHAT) or the
    narrowband Capon / MUSIC scans (frames of segment // 4 rounded down to
    a power of two); then the EMA (``smoothing``, 0 disables) or
    ``smoother='kalman'`` (``kalman_rts_smooth``, ``accel_std``).
    ``motion='compensated'`` (srp only) aligns ``motion_subframes``
    subframe GCCs by each pair's delay rate (bounded by ``max_speed``)
    and solves the per-segment velocity (``Track.velocities``).  Runs on
    ``device`` (``utils.device.resolve_device``: the card unless named)."""
    if method not in ("srp", "capon", "music"):
        raise ValueError("method must be 'srp', 'capon', or 'music'")
    _check_weighting(weighting)
    if weighting != "phat" and method != "srp":
        raise ValueError("weighting applies to method='srp' only")
    if smoother not in ("ema", "kalman"):
        raise ValueError("smoother must be 'ema' or 'kalman'")
    if motion not in ("static", "compensated"):
        raise ValueError("motion must be 'static' or 'compensated'")
    if motion == "compensated" and method != "srp":
        raise ValueError("motion='compensated' requires method='srp'")
    x, mics = _inputs(signals, mic_positions, device)
    m = x.shape[0]
    hop = segment // 2 if hop is None else hop
    segs, starts = _segments(x, segment, hop)
    pi, pj = _pairs(m)
    velocities = None
    if method == "srp" and motion == "compensated":
        _, nfft_f, w_half, s_max = _compensated_sizes(
            mics, fs, c, segment, motion_subframes, max_speed)
        circ, tau_dot, wts = _motion_compensated_corr(
            segs, pi, pj, float(fs), band, weighting, motion_subframes,
            w_half, s_max, nfft_f)
        out = srp_ops.srp_phat_locate(circ, mics, pi, pj, fs, c, lower,
                                      upper, coarse_n=coarse_n,
                                      fine_n=fine_n)
        positions, powers = out.position, out.power
        velocities = _velocity_lsq(positions, mics, pi, pj, c, tau_dot, wts)
    elif method == "srp":
        corr = gccphat.gcc_phat_all_pairs(segs, pi, pj,
                                          nfft=next_pow2(segment), band=band,
                                          fs=fs, weighting=weighting)
        out = srp_ops.srp_phat_locate(corr, mics, pi, pj, fs, c, lower,
                                      upper, coarse_n=coarse_n,
                                      fine_n=fine_n)
        positions, powers = out.position, out.power
    else:
        # >= 7 snapshots a segment, rounded down to a power of two.
        frame = 1 << max(int(np.log2(max(segment // 4, 64))), 6)
        locate = (capon_ops.capon_locate if method == "capon"
                  else music_ops.music_locate)
        out = locate(segs, mics, fs, c, lower, upper, frame=frame, band=band,
                     coarse_n=coarse_n, fine_n=fine_n)
        positions, powers = out.position, out.power
    if smoother == "kalman":
        smoothed, _ = kalman_rts_smooth(positions, hop / fs, powers=powers,
                                        accel_std=accel_std)
    elif smoothing > 0:
        smoothed = _ema(positions, smoothing)
    else:
        smoothed = positions
    times = torch.as_tensor((starts + segment / 2.0) / fs,
                            dtype=positions.dtype, device=positions.device)
    return Track(times, positions, smoothed, powers, velocities)


def _rate_bank_chunk(segments: int, rates: int, pairs: int, bins: int,
                     itemsize: int) -> int:
    """Segments a chunk of the rate bank holds within
    ``RATE_BANK_CHUNK_BYTES``: its aligned spectra are (chunk, R, P, NB)
    complex values."""
    per_seg = rates * pairs * bins * 2 * itemsize
    return max(1, min(segments, RATE_BANK_CHUNK_BYTES // max(per_seg, 1)))


#: Half-width (samples) of a rate-envelope peak: the envelope is the
#: per-lag maximum over candidate rates one sample of drift apart, on an
#: integer lag axis, so a peak stands one lag wide (at half its height, on
#: every segment and pair of the crossing walkers) and reaches half a lag
#: either side.
_ENVELOPE_HALF_WIDTH = 0.5


def _rate_bank_pool(lower, upper, coarse_n: int, fs: float, c) -> int:
    """The rate bank's coarse pool (samples), on the host: a coarse cell's
    covering radius over the box (0.866 of its widest edge in samples of
    travel time, ``srp._resolve_pool``'s radius) less the half-width its
    envelope peaks already span, at least 1: the pooled map then reaches
    the covering radius.  On the crossing walkers (3.2 m box, coarse_n 32,
    radius 4.04 samples) that is pool 4 (float32, CPU: 0.032 / 0.014 m a
    track; the full radius's pool 5 reads 0.055 / 0.066 m, and pool 3
    swaps the walkers' identities)."""
    extent = np.asarray(torch.as_tensor(upper).detach().cpu(), float) \
        - np.asarray(torch.as_tensor(lower).detach().cpu(), float)
    radius = 0.866 * float(np.max(extent)) / coarse_n * fs / float(c)
    return max(1, int(np.ceil(radius - _ENVELOPE_HALF_WIDTH)))


def _detect_rate_envelope(spec: torch.Tensor, mics: torch.Tensor, pi, pj,
                          fs: float, c, lower, upper, num_sources: int,
                          dt_f: np.ndarray, npad: int, wlen: int,
                          w_half: int, s_max: int, nfft_f: int,
                          coarse_n: int, fine_n: int, pool: int):
    """Motion-robust K-source detection by a delay-rate matched-filter
    bank (the JAX package's ``_detect_rate_envelope``, models/
    tracking.py:467 there).  Per pair, the subframe windows are aligned
    under each of 2 s_max + 1 candidate rates (one sample of end-to-end
    drift apart) and summed, and the per-lag maximum over rates is an
    envelope where any bounded-rate mover stands at full height at its
    segment-centre lag.  K searches follow, each a two-stage SRP on the
    envelope in circular order, then +-``_CLAIM_LAGS`` lags nulled around
    the found position's per-pair lags.  spec (S, nsub, P, NB): the rfft
    of the subframe windows at ``npad``; dt_f (nsub,): the subframe
    offsets (``_subframe_offsets``).  Returns detections (S, K, 3) and
    powers (S, K) in extraction order.

    The coarse SRP stage pools over ``pool`` samples, which the caller
    computes on the host from the box (``_rate_bank_pool``); the lag
    bound comes from the mics.  The JAX package calls its SRP with traced
    bounds here, where both fall back (pool 2, the circular gather;
    tracking.py:465 there).  The subframe sum is taken before the inverse
    (the inverse is linear), one inverse a (segment, rate, pair)."""
    dtype, dev = spec.real.dtype, spec.device
    rmax = max(float(dt_f[-1]), 1.0)
    n_r = 2 * s_max + 1
    r_cand = (torch.arange(n_r, dtype=dtype, device=dev) - s_max) / rmax
    k_bins = torch.arange(npad // 2 + 1, dtype=dtype, device=dev)
    offsets = torch.as_tensor(dt_f, dtype=dtype, device=dev)
    ramps = _phase(k_bins, r_cand[:, None] * offsets, npad)  # (R, nsub, NB)
    chunk = _rate_bank_chunk(spec.shape[0], n_r, spec.shape[2],
                             spec.shape[3], spec.real.element_size())
    env = []
    for s0 in range(0, spec.shape[0], chunk):
        aligned = torch.einsum("snpk,rnk->srpk", spec[s0:s0 + chunk], ramps)
        env.append(torch.amax(_irfft_real_ends(aligned, npad)[..., :wlen],
                              1))                            # (s, P, wlen)
    env = torch.cat(env)
    ell = torch.arange(wlen, dtype=dtype, device=dev) - (w_half + s_max)
    positions, powers = [], []
    for _ in range(num_sources):
        circ = _circular(env[..., s_max:s_max + 2 * w_half + 1], w_half,
                         nfft_f)
        out = srp_ops.srp_phat_locate(circ, mics, pi, pj, fs, c, lower,
                                      upper, coarse_n=coarse_n,
                                      fine_n=fine_n, pool_samples=pool)
        dist = torch.linalg.norm(out.position[..., None, :] - mics, dim=-1)
        lag_p = (dist[..., pi] - dist[..., pj]) * fs / c          # (S, P)
        env = env * (torch.abs(ell - lag_p[..., None])
                     > _CLAIM_LAGS).to(dtype)
        positions.append(out.position)
        powers.append(out.power)
    return torch.stack(positions, 1), torch.stack(powers, 1)


def _pooled_linear_window(comp_wide: torch.Tensor, s_max: int, w_half: int,
                          pool_w: int) -> torch.Tensor:
    """The +-w_half window of a linear +-(w_half + s_max) lag window,
    max-pooled over +-pool_w lags without wrapping: pooled on the
    +-(w_half + pool_w) slice (zeros beyond the window where pool_w >
    s_max), the slice's circular ends then trimmed away, as
    ``srp._pooled_window`` does for a circular correlation.  The JAX
    package pools the +-w_half window itself circularly, so its two ends
    reach into each other once pool_w exceeds the 12-lag margin of w_half
    (tracking.py:542 there)."""
    extra = max(0, pool_w - s_max)
    if extra:
        comp_wide = torch.nn.functional.pad(comp_wide, (extra, extra))
    lo = s_max + extra - pool_w
    sl = comp_wide[..., lo:lo + 2 * (w_half + pool_w) + 1]
    return srp_ops.max_pool_corr(sl, pool_w)[..., pool_w:-pool_w]


def _refine_tracks_compensated(spec: torch.Tensor, smoothed: torch.Tensor,
                               vels: torch.Tensor, mics: torch.Tensor, pi,
                               pj, fs: float, c, lower: torch.Tensor,
                               upper: torch.Tensor, dt_f: np.ndarray,
                               npad: int, wlen: int, w_half: int, s_max: int,
                               box: float, box_coarse_n: int, fine_n: int,
                               pool_w: int):
    """Rate-steered re-detection of every (segment, track) (the JAX
    package's ``_refine_tracks_compensated``, models/tracking.py:552
    there): each track's smoothed position and velocity predict every
    pair's delay rate; the segment's subframe windows are aligned by it
    and summed; the other tracks' predicted lags are claimed away; and a
    two-stage SRP searches +-``box`` m around the smoothed position, its
    coarse stage on the window pooled over ``pool_w`` lags
    (``_pooled_linear_window``).  spec (S, nsub, P, NB), smoothed / vels
    (S, K, 3) -> refined (S, K, 3) positions and (S, K) powers."""
    dtype, dev = smoothed.dtype, smoothed.device
    num_sources = smoothed.shape[1]
    rmax = max(float(dt_f[-1]), 1.0)
    k_bins = torch.arange(npad // 2 + 1, dtype=dtype, device=dev)
    offsets = torch.as_tensor(dt_f, dtype=dtype, device=dev)
    wn = w_half + s_max
    ell = torch.arange(wlen, dtype=dtype, device=dev) - wn
    d = smoothed[..., None, :] - mics                           # (S, K, M, 3)
    u = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                        min=1e-9)
    tau_dot = torch.einsum("skpd,skd->skp", u[..., pi, :] - u[..., pj, :],
                           vels) / c
    tau_dot = torch.clamp(tau_dot, -s_max / rmax, s_max / rmax)
    shift = tau_dot[:, :, None, :] * offsets[:, None]           # (S, K, n, P)
    aligned = torch.einsum("snpk,sunpk->supk", spec,
                           _phase(k_bins, shift, npad))
    comp_wide = _irfft_real_ends(aligned, npad)[..., :wlen]     # (S, K, P, wl)
    # Claim away the other tracks' predicted lags, so that a louder
    # neighbour cannot capture this track's box search near a crossing.
    dists = torch.linalg.norm(d, dim=-1)                        # (S, K, M)
    lag_all = (dists[..., pi] - dists[..., pj]) * fs / c        # (S, K, P)
    keep = torch.abs(ell - lag_all[..., None]) > _CLAIM_LAGS    # (S, K, P, wl)
    own = torch.eye(num_sources, dtype=torch.bool, device=dev)  # (track, other)
    keep = torch.all(keep[:, None] | own[None, :, :, None, None], 2)
    comp_wide = comp_wide * keep.to(dtype)
    comp = comp_wide[..., s_max:s_max + 2 * w_half + 1]
    pooled = _pooled_linear_window(comp_wide, s_max, w_half, pool_w)

    def coarse_fn(pts):
        return srp_ops.srp_map(pooled, pts, mics, pi, pj, fs, c,
                               max_lag=w_half, pre_windowed=True)

    def fine_fn(pts):
        return srp_ops.srp_map(comp, pts, mics, pi, pj, fs, c,
                               max_lag=w_half, pre_windowed=True)

    center = torch.minimum(torch.maximum(smoothed, lower), upper)
    lo = torch.maximum(lower, center - box)
    hi = torch.minimum(upper, center + box)
    pos, power, _, _ = srp_ops.two_stage_search(coarse_fn, fine_fn, lo, hi,
                                                box_coarse_n, fine_n)
    return torch.minimum(torch.maximum(pos, lower), upper), power


def association_step(pos: torch.Tensor, vel: torch.Tensor, det: torch.Tensor,
                     pw: torch.Tensor, dt_s: float, gate: float,
                     alpha: float = 0.7, beta: float = 0.4):
    """One momentum-gated K! assignment and alpha-beta update (the JAX
    package's ``association_step``, models/tracking.py:675 there): each
    track (pos, vel (K, 3)) predicts forward by ``dt_s``; the assignment
    of the K detections (K, 3) with powers (K,) of least summed squared
    distance, each distance capped at ``gate``^2, is taken; a detection
    within the gate updates its track, a farther one leaves it coasting.
    Returns ((pos_new, vel_new), (z, zp, ok)) with z / zp the detections
    and powers in track order and ok (K,) the gate flags."""
    num_sources = det.shape[0]
    dtype = det.dtype
    perms = torch.as_tensor(
        np.array(list(itertools.permutations(range(num_sources)))),
        dtype=torch.long, device=det.device)
    gate2 = torch.as_tensor(gate * gate, dtype=dtype, device=det.device)
    pred = pos + vel * dt_s
    d2 = torch.sum((pred[:, None, :] - det[None, :, :]) ** 2, -1)
    d2g = torch.minimum(d2, gate2)
    costs = torch.sum(d2g[torch.arange(num_sources, device=det.device)[
        None, :], perms], -1)                                   # (K!,)
    best = perms[torch.argmin(costs)]                           # det a track
    z = det[best]
    zp = pw[best]
    innov = z - pred
    ok = torch.sum(innov * innov, -1) < gate2
    alpha_t = torch.as_tensor(alpha, dtype=dtype, device=det.device)
    beta_t = torch.as_tensor(beta, dtype=dtype, device=det.device)
    pos_new = torch.where(ok[:, None], pred + alpha_t * innov, pred)
    vel_new = torch.where(ok[:, None], vel + (beta_t / dt_s) * innov, vel)
    return (pos_new, vel_new), (z, zp, ok)


def associate_detections(dets: torch.Tensor, powers: torch.Tensor,
                         dt_s: float, gate: float):
    """Associate per-segment detection sets (S, K, 3) with powers (S, K)
    to K tracks by ``association_step`` over the segments, the tracks
    starting at the first segment's detections with zero velocity.
    Returns (positions (S, K, 3), powers (S, K), ok (S, K)) with axis 1 in
    track order; a gated-out detection keeps its value with ok False."""
    pos = dets[0]
    vel = torch.zeros_like(pos)
    zs, zps, oks = [], [], []
    for t in range(dets.shape[0]):
        (pos, vel), (z, zp, ok) = association_step(pos, vel, dets[t],
                                                   powers[t], dt_s, gate)
        zs.append(z)
        zps.append(zp)
        oks.append(ok)
    return torch.stack(zs), torch.stack(zps), torch.stack(oks)


def track_multiple(signals, mic_positions, fs: float, c, lower, upper,
                   num_sources: int, segment: int = 4096,
                   hop: Optional[int] = None,
                   band: Optional[Tuple[float, float]] = None,
                   coarse_n: int = 24, fine_n: int = 12,
                   min_separation: Optional[float] = None,
                   weighting: str = "phat", accel_std: float = 0.5,
                   gate: Optional[float] = None, max_speed: float = 5.0,
                   motion: str = "static", motion_subframes: int = 8,
                   motion_iterations: int = 2,
                   suppression: str = "spatial", device=None) -> MultiTrack:
    """Track ``num_sources`` simultaneous movers with identities, the JAX
    package's ``track_multiple`` (models/tracking.py:713 there): K-source
    SRP per segment (``suppression`` 'spatial' or 'claim'; K1 over the
    segments), the momentum-gated K! association (``gate`` defaults to
    max_speed * dt + 0.3 m, dt = hop / fs), and Kalman/RTS smoothing per
    track.  ``motion='compensated'`` detects by the delay-rate bank with
    lag claiming (``_detect_rate_envelope``; K1 over segments x
    subframes), then ``motion_iterations`` times re-detects every
    (segment, track) rate-steered within +-gate m of its smoothed position
    and re-smooths; its ``associated`` flags are then all True (each
    refined detection belongs to its track by construction).  Runs on
    ``device`` (``utils.device.resolve_device``: the card unless named)."""
    if num_sources < 1:
        raise ValueError("num_sources must be >= 1")
    if num_sources > 5:
        raise ValueError("track_multiple enumerates K! assignments; "
                         "num_sources > 5 is unsupported")
    _check_weighting(weighting)
    if motion not in ("static", "compensated"):
        raise ValueError("motion must be 'static' or 'compensated'")
    x, mics = _inputs(signals, mic_positions, device)
    m = x.shape[0]
    hop = segment // 2 if hop is None else hop
    segs, starts = _segments(x, segment, hop)
    pi, pj = _pairs(m)
    dt_s = hop / float(fs)
    gate = (max_speed * dt_s + 0.3) if gate is None else float(gate)
    lo_d, hi_d = srp_ops._box(lower, upper, x)
    if motion == "compensated":
        lf, nfft_f, w_half, s_max = _compensated_sizes(
            mics, fs, c, segment, motion_subframes, max_speed)
        wlen = 2 * (w_half + s_max) + 1
        win = _subframe_windows(segs, pi, pj, float(fs), band, weighting,
                                motion_subframes, w_half + s_max, nfft_f)
        npad = next_pow2(wlen)
        spec = torch.fft.rfft(win, n=npad)
        dt_f = _subframe_offsets(motion_subframes, lf)
        pool = _rate_bank_pool(lower, upper, coarse_n, fs, c)
        dets, powers = _detect_rate_envelope(
            spec, mics, pi, pj, float(fs), c, lo_d, hi_d, num_sources, dt_f,
            npad, wlen, w_half, s_max, nfft_f, coarse_n, fine_n, pool)
    else:
        corr = gccphat.gcc_phat_all_pairs(segs, pi, pj,
                                          nfft=next_pow2(segment), band=band,
                                          fs=fs, weighting=weighting)
        out = srp_ops.srp_phat_locate_multi(
            corr, mics, pi, pj, fs, c, lower, upper, num_sources=num_sources,
            coarse_n=coarse_n, fine_n=fine_n, min_separation=min_separation,
            suppression=suppression)
        dets, powers = out.positions, out.powers         # (S, K, 3), (S, K)
    assoc_pos, assoc_pow, assoc_ok = associate_detections(dets, powers, dt_s,
                                                          gate)

    def smooth(p, w):
        sm, vel = kalman_rts_smooth(p.transpose(0, 1), dt_s,
                                    powers=w.transpose(0, 1),
                                    accel_std=accel_std)
        return sm.transpose(0, 1), vel.transpose(0, 1)

    smoothed, vels = smooth(assoc_pos, assoc_pow)
    if motion == "compensated":
        box_coarse_n = 12
        pool_w = max(1, int(np.ceil(0.866 * (2.0 * gate / box_coarse_n)
                                    * float(fs) / float(c))))
        for _ in range(max(int(motion_iterations), 0)):
            assoc_pos, assoc_pow = _refine_tracks_compensated(
                spec, smoothed, vels, mics, pi, pj, float(fs), c, lo_d,
                hi_d, dt_f, npad, wlen, w_half, s_max, gate,
                box_coarse_n=box_coarse_n, fine_n=fine_n, pool_w=pool_w)
            smoothed, vels = smooth(assoc_pos, assoc_pow)
            assoc_ok = torch.ones_like(assoc_ok)
    times = torch.as_tensor((starts + segment / 2.0) / fs, dtype=dets.dtype,
                            device=dets.device)
    return MultiTrack(times, assoc_pos, smoothed, assoc_pow, vels, assoc_ok)
