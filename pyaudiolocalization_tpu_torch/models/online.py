"""Online (streaming) localization: feed fixed-size sample blocks, get a
position per block (counterpart of the JAX package's models/online.py; no
reference counterpart).

The state is the last ``frame`` samples per mic and an exponential moving
average of the cross-power spectra (broadband ``method='srp'``):

    rfft(window * frame) -> cross-spectra -> EMA -> weighting -> irfft ->
    SRP-PHAT box search -> position

PHAT whitens a new complex tensor built from the EMA planes through kernel
K7 (the EMA state itself is never whitened in place: the next hop reads
it).  The narrowband methods ('capon', 'music') keep an EMA of the full
per-bin spatial covariance of coarse ``nb_frame`` snapshots instead, with
the phase-advance sums of the phase-vocoder refinement.  State is float32,
as in the JAX package.  ``run`` is a loop over hops whose outputs stay on
the device until the end; the static 'srp' step reads nothing back to the
host.  ``motion='compensated'`` detects on the live frame with the
delay-rate bank of ``models/tracking.py`` (K1 over its subframes).

``OnlineTracker`` holds K identities causally with the momentum-gated K!
assignment of ``tracking.association_step``.

One fault of the JAX package is repaired: ``suppression='claim'`` with
``method='capon'`` or ``'music'`` raises ``ValueError`` (the JAX package
ignores it silently, online.py:185 there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import gccphat
from ..utils.device import resolve_device
from . import capon as capon_ops
from . import music as music_ops
from . import srp as srp_ops
from . import tracking as tracking_ops
from .srp import two_stage_search

F32 = torch.float32


class StreamState(NamedTuple):
    buffer: torch.Tensor     # (M, frame) most recent samples
    cross_r: torch.Tensor    # (P, bins) EMA cross-spectrum, real plane
    cross_i: torch.Tensor    # (P, bins) imaginary plane
    auto: torch.Tensor       # (M, bins) EMA auto power spectra (ratio
    # weightings only; PHAT and CC carry it unchanged)
    count: torch.Tensor      # () blocks absorbed


class CovStreamState(NamedTuple):
    """State of the narrowband methods: the EMA of the per-bin spatial
    covariance at the ``nb_frame`` resolution (all M x M products as
    real / imaginary planes) and of the per-bin inter-frame phase-advance
    sums that refine the bin frequencies."""
    buffer: torch.Tensor     # (M, frame) most recent samples
    cov_r: torch.Tensor      # (nb_bins, M, M) EMA covariance, real plane
    cov_i: torch.Tensor      # (nb_bins, M, M) imaginary plane
    shift_r: torch.Tensor    # (nb_bins,) EMA phase-advance sum, real plane
    shift_i: torch.Tensor    # (nb_bins,) imaginary plane
    count: torch.Tensor      # () blocks absorbed


class StreamOutput(NamedTuple):
    position: torch.Tensor   # (3,), or (K, 3) for num_sources=K > 1
    power: torch.Tensor      # () SRP confidence, or (K,)
    state: tuple


class StreamingLocalizer:
    """Stateful online localizer, the JAX package's ``StreamingLocalizer``
    (models/online.py:76 there).  ``frame`` is a power of two and a
    multiple of ``hop``; positions are searched over the box [lower,
    upper].  ``method`` 'srp' (broadband GCC + SRP over the EMA
    cross-spectra, any GCC weighting, ``num_sources`` talkers by
    ``suppression`` 'spatial' or 'claim') or 'capon' / 'music' (the
    narrowband covariance scans at the tempered top-``num_bins`` coarse
    bins with ``loading``, their own bin claiming for several talkers).
    ``motion='compensated'`` (srp) detects on the live frame by the
    delay-rate bank.  The state and the estimates are float32 on
    ``device`` (``utils.device.resolve_device``: the card unless named)."""

    def __init__(self, mic_positions, fs: float, c: float, lower, upper,
                 frame: int = 4096, hop: int = 1024, ema: float = 0.7,
                 band: Optional[Tuple[float, float]] = None,
                 coarse_n: Optional[int] = None,
                 fine_n: Optional[int] = None, num_sources: int = 1,
                 min_separation: Optional[float] = None,
                 method: str = "srp", num_bins: int = 8,
                 loading: float = 1e-3, nb_frame: int = 256,
                 weighting: str = "phat", suppression: str = "spatial",
                 motion: str = "static", motion_subframes: int = 8,
                 max_speed: float = 5.0, device=None):
        if frame & (frame - 1):
            raise ValueError("frame must be a power of two")
        if frame % hop:
            raise ValueError("frame must be a multiple of hop")
        if nb_frame & (nb_frame - 1) or not 0 < nb_frame <= frame:
            raise ValueError("nb_frame must be a power of two <= frame")
        if method not in ("srp", "capon", "music"):
            raise ValueError(
                "method must be 'srp' (broadband GCC-PHAT), 'capon', or "
                "'music' (narrowband covariance estimators)")
        if weighting not in gccphat.GCC_WEIGHTINGS:
            raise ValueError(f"unknown weighting {weighting!r}; expected "
                             f"one of {gccphat.GCC_WEIGHTINGS}")
        if weighting != "phat" and method != "srp":
            raise ValueError("weighting applies to the broadband 'srp' "
                             "method only (capon/music are covariance "
                             "estimators with no GCC stage)")
        mics_np = np.asarray(torch.as_tensor(mic_positions).detach().cpu(),
                             np.float32)
        m = mics_np.shape[0]
        if num_sources < 1:
            raise ValueError("num_sources must be >= 1")
        if method == "music" and num_sources >= m:
            raise ValueError("music needs num_sources < num_mics (noise "
                             "subspace must be non-empty)")
        if suppression not in ("spatial", "claim"):
            raise ValueError("suppression must be 'spatial' or 'claim'")
        if suppression == "claim" and method != "srp":
            # The JAX package ignores it here (online.py:185 there); the
            # narrowband methods claim bins of their own.
            raise ValueError("suppression='claim' applies to method='srp' "
                             "only (capon/music claim bins of their own)")
        if motion not in ("static", "compensated"):
            raise ValueError("motion must be 'static' or 'compensated'")
        if motion == "compensated" and method != "srp":
            raise ValueError("motion='compensated' requires method='srp'")
        if motion == "compensated" and weighting == "ml":
            raise ValueError("motion='compensated' uses single-snapshot "
                             "subframe GCCs — 'ml' needs Welch-averaged "
                             "coherence")
        self.device = resolve_device(device)
        dev = self.device
        self.weighting = weighting
        self.mics = torch.as_tensor(mics_np, device=dev)
        pi, pj = np.triu_indices(m, 1)
        self.pi = pi.astype(np.int64)
        self.pj = pj.astype(np.int64)
        self._pi = torch.as_tensor(self.pi, device=dev)
        self._pj = torch.as_tensor(self.pj, device=dev)
        self.fs = float(fs)
        self.c = float(c)
        self.lower = torch.as_tensor(np.asarray(lower, np.float32),
                                     device=dev)
        self.upper = torch.as_tensor(np.asarray(upper, np.float32),
                                     device=dev)
        self.frame = frame
        self.hop = hop
        self.ema = float(ema)
        self.band = band
        narrow = method in ("capon", "music")
        self.coarse_n = coarse_n if coarse_n is not None else (
            24 if narrow else 20)
        self.fine_n = fine_n if fine_n is not None else (12 if narrow
                                                         else 10)
        self.num_sources = num_sources
        self.min_separation = min_separation
        self.suppression = suppression
        self.method = method
        self.num_bins = int(num_bins)
        self.loading = float(loading)
        self.nb_frame = int(nb_frame)
        self.nb_hop = self.nb_frame // 2
        # The coarse pool: the rate bank's where it detects, else the
        # SRP's covering radius (the JAX package's, online.py:201 there).
        pool_rule = (tracking_ops._rate_bank_pool if motion == "compensated"
                     else lambda *box: srp_ops._resolve_pool(None, *box))
        self.pool = pool_rule(np.asarray(lower, np.float32),
                              np.asarray(upper, np.float32), self.coarse_n,
                              self.fs, self.c)
        # The SRP's lag bound from the mics, here once: the step then
        # reads nothing back from the device.
        diam = float(np.max(np.linalg.norm(
            mics_np.astype(float)[:, None, :] - mics_np[None, :, :], axis=-1)))
        self._max_lag = int(np.ceil(diam * self.fs / self.c))
        n_ = np.arange(frame)
        self._window = torch.as_tensor(
            (0.5 - 0.5 * np.cos(2 * np.pi * n_ / frame)).astype(np.float32),
            device=dev)
        self._mask = self._mask_nb = None
        if band is not None:
            freqs = np.fft.rfftfreq(frame, d=1.0 / fs)
            self._mask = torch.as_tensor(
                ((freqs >= band[0]) & (freqs <= band[1])).astype(np.float32),
                device=dev)
            nb_freqs = np.fft.rfftfreq(self.nb_frame, d=1.0 / fs)
            self._n_inband = int(np.count_nonzero(
                (nb_freqs >= band[0]) & (nb_freqs <= band[1])))
            self._mask_nb = torch.as_tensor(
                ((nb_freqs >= band[0])
                 & (nb_freqs <= band[1])).astype(np.float32), device=dev)
        self.motion = motion
        if motion == "compensated":
            # Sized as track_multiple's, on the host.
            lf, nfft, whalf, smax = tracking_ops._compensated_sizes(
                mics_np, fs, c, frame, motion_subframes, max_speed)
            self._mc_nsub = int(motion_subframes)
            self._mc_nfft = nfft
            self._mc_whalf = whalf
            self._mc_smax = smax
            self._mc_wlen = 2 * (whalf + smax) + 1
            self._mc_npad = 1 << int(np.ceil(np.log2(self._mc_wlen)))
            self._mc_dtf = tracking_ops._subframe_offsets(motion_subframes,
                                                          lf)

    def init_state(self):
        m = self.mics.shape[0]
        p = self.pi.shape[0]
        bins = self.frame // 2 + 1
        dev = self.device
        if self.method != "srp":
            nb_bins = self.nb_frame // 2 + 1
            return CovStreamState(
                buffer=torch.zeros((m, self.frame), dtype=F32, device=dev),
                cov_r=torch.zeros((nb_bins, m, m), dtype=F32, device=dev),
                cov_i=torch.zeros((nb_bins, m, m), dtype=F32, device=dev),
                shift_r=torch.zeros((nb_bins,), dtype=F32, device=dev),
                shift_i=torch.zeros((nb_bins,), dtype=F32, device=dev),
                count=torch.zeros((), dtype=torch.int32, device=dev))
        return StreamState(
            buffer=torch.zeros((m, self.frame), dtype=F32, device=dev),
            cross_r=torch.zeros((p, bins), dtype=F32, device=dev),
            cross_i=torch.zeros((p, bins), dtype=F32, device=dev),
            auto=torch.zeros((m, bins), dtype=F32, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev))

    # -- narrowband -------------------------------------------------------

    def _step_cov(self, state: CovStreamState,
                  block: torch.Tensor) -> StreamOutput:
        """Narrowband step: overlapping ``nb_frame`` snapshots of the
        buffer (the batch estimators' STFT), the EMA of their per-bin
        covariances and phase-advance sums, then the Capon / MUSIC map at
        the selected bins (the JAX package's ``_step_cov_impl``,
        online.py:273 there)."""
        m = self.mics.shape[0]
        dev = self.device
        buf = torch.cat([state.buffer[:, self.hop:], block], 1)
        snaps = music_ops.snapshot_frames(buf, self.nb_frame, self.nb_hop)
        xr = snaps.real.to(F32)                             # (M, F, K)
        xi = snaps.imag.to(F32)
        f_cnt = xr.shape[1]
        # Per-bin snapshot covariances (1/F) X X^H as real/imag planes.
        out_r = (torch.einsum("mfk,nfk->kmn", xr, xr)
                 + torch.einsum("mfk,nfk->kmn", xi, xi)) / f_cnt
        out_i = (torch.einsum("mfk,nfk->kmn", xi, xr)
                 - torch.einsum("mfk,nfk->kmn", xr, xi)) / f_cnt
        # Per-bin inter-frame phase-advance sums over mics and frame pairs.
        pr = xr[:, 1:, :] * xr[:, :-1, :] + xi[:, 1:, :] * xi[:, :-1, :]
        pi_ = xi[:, 1:, :] * xr[:, :-1, :] - xr[:, 1:, :] * xi[:, :-1, :]
        adv_r = torch.sum(pr, (0, 1))
        adv_i = torch.sum(pi_, (0, 1))
        a = self.ema
        cvr = a * state.cov_r + (1.0 - a) * out_r
        cvi = a * state.cov_i + (1.0 - a) * out_i
        shr = a * state.shift_r + (1.0 - a) * adv_r
        shi = a * state.shift_i + (1.0 - a) * adv_i
        new_state = CovStreamState(buf, cvr, cvi, shr, shi, state.count + 1)

        # Bin selection from the EMA power: the union of the tempered
        # top-``num_bins`` and the +-1 skirts of the top num_bins // 3 local
        # maxima, gated at 6x a low in-band quantile of the power.
        power = torch.diagonal(cvr, dim1=-2, dim2=-1).sum(-1)  # (K,)
        if self._mask_nb is not None:
            power = power * self._mask_nb
        nb_bins = power.shape[0]
        power = power.clone()
        power[0] = 0.0
        power[-1] = 0.0
        npeaks = max(1, self.num_bins // 3)
        is_peak = ((power >= torch.roll(power, 1))
                   & (power > torch.roll(power, -1)))
        # DC/Nyquist excluded: the roll test wraps them against each other.
        is_peak[0] = False
        is_peak[-1] = False
        pvals, pidx = torch.topk(torch.where(is_peak, power,
                                             torch.zeros_like(power)), npeaks)
        kvals, kidx = torch.topk(power, self.num_bins)
        skirt = torch.clamp((pidx[:, None] + torch.tensor(
            [-1, 0, 1], device=dev)).reshape(-1), 1, nb_bins - 2)
        idx = torch.cat([kidx, skirt])
        vals = power[idx]
        if self._mask_nb is not None:
            n_inband = self._n_inband
            floor_src = torch.where(self._mask_nb > 0, power,
                                    torch.full_like(power, float("inf")))
        else:
            n_inband = nb_bins
            floor_src = power
        noise_floor = 6.0 * torch.sort(floor_src)[0][max(1, n_inband // 8)]
        valid = torch.cat([kvals > noise_floor,
                           torch.repeat_interleave(pvals > noise_floor, 3)])
        tempered = torch.where(valid, torch.clamp(vals, min=0.0) ** 0.3,
                               torch.zeros_like(vals))
        # Keep one copy of a bin the union holds twice: the best-gated, the
        # first of equals.
        count = idx.shape[0]
        pos = torch.arange(count, device=dev)
        seg_max = torch.zeros(nb_bins, dtype=tempered.dtype,
                              device=dev).scatter_reduce(
            0, idx, tempered, reduce="amax")
        at_max = tempered >= seg_max[idx]
        first = torch.full((nb_bins,), count, dtype=pos.dtype,
                           device=dev).scatter_reduce(
            0, idx, torch.where(at_max, pos, torch.full_like(pos, count)),
            reduce="amin")
        tempered = torch.where(at_max & (pos == first[idx]), tempered,
                               torch.zeros_like(tempered))
        bin_w = tempered / torch.clamp(torch.sum(tempered), min=1e-30)

        # Phase-vocoder refinement at hop nb_hop = nb_frame / 2, clamped
        # to +-0.55 bin.
        base = 2.0 * np.pi * idx.to(F32) / self.nb_frame
        adv = torch.atan2(shi[idx], shr[idx])
        two_pi = 2.0 * np.pi
        delta = torch.remainder(adv - base * self.nb_hop + np.pi,
                                two_pi) - np.pi
        half_bin = 0.55 * two_pi / self.nb_frame
        delta = torch.clamp(delta / self.nb_hop, -half_bin, half_bin)
        omega = (base + delta) * self.fs

        emb = music_ops.embed_planes(cvr[idx], cvi[idx])    # (B, 2M, 2M)
        if self.method == "capon":
            inv = capon_ops.loaded_inverse(emb, self.loading)

            def bins_fn(p_):
                return capon_ops.capon_map_bins(inv, omega, p_, self.mics,
                                                self.c)
        else:
            _, vecs = torch.linalg.eigh(emb)
            subs = vecs[..., :2 * m - 2 * self.num_sources]

            def bins_fn(p_):
                return music_ops.music_map_bins(subs, omega, p_, self.mics,
                                                self.c)

        def map_fn(p_):
            return torch.sum(bin_w * bins_fn(p_), -1)

        if self.num_sources > 1:
            positions, powers = self._claimed_multi_search(bins_fn, bin_w)
            return StreamOutput(positions, powers, new_state)
        pos_, pw, _, _ = two_stage_search(map_fn, map_fn, self.lower,
                                          self.upper, self.coarse_n,
                                          self.fine_n)
        return StreamOutput(
            torch.minimum(torch.maximum(pos_, self.lower), self.upper), pw,
            new_state)

    def _claimed_multi_search(self, bins_fn, bin_w):
        """K sources by iterative argmax, spatial suppression and bin
        claiming: after each extracted source, the bins whose own per-bin
        lattice argmax lies within the suppression radius of it are zeroed
        for the later rounds (the JAX package's ``_claimed_multi_search``,
        online.py:424 there); then each source's fine stage on the bin
        weights of its round."""
        pts = srp_ops._grid_points(self.lower, self.upper, self.coarse_n)
        per = bins_fn(pts)                                  # (G, B)
        bin_arg = pts[torch.argmax(per, 0)]                 # (B, 3)
        cell = (self.upper - self.lower) / self.coarse_n
        radius = (3.0 * torch.amax(cell) if self.min_separation is None
                  else torch.as_tensor(self.min_separation, dtype=F32,
                                       device=self.device))
        w = bin_w
        sup = torch.zeros(pts.shape[0], dtype=F32, device=self.device)
        centers, round_w = [], []
        for _ in range(self.num_sources):
            vals = torch.sum(w * per, -1) + sup
            center = pts[torch.argmax(vals)]
            claimed = torch.linalg.norm(bin_arg - center, dim=-1) <= radius
            w_next = torch.where(claimed, torch.zeros_like(w), w)
            w_next = torch.where(torch.sum(w_next) > 1e-30, w_next, w)
            sup = torch.where(torch.linalg.norm(pts - center, dim=-1)
                              <= radius, torch.full_like(sup, -np.inf), sup)
            centers.append(center)
            round_w.append(w)
            w = w_next
        centers = torch.stack(centers)                      # (K, 3)
        round_w = torch.stack(round_w)                      # (K, B)
        fine_pts = srp_ops._grid_points(centers - 1.5 * cell,
                                        centers + 1.5 * cell, self.fine_n)
        fine_val = torch.sum(round_w[:, None, :] * bins_fn(fine_pts), -1)
        k = torch.argmax(fine_val, -1)
        positions = srp_ops._take_point(fine_pts, k) + \
            srp_ops.quadratic_peak_offset(fine_val, k, self.fine_n,
                                          3.0 * cell / self.fine_n)
        powers = srp_ops._take_value(fine_val, k)
        return (torch.minimum(torch.maximum(positions, self.lower),
                              self.upper), powers)

    # -- broadband --------------------------------------------------------

    def _step(self, state, block: torch.Tensor) -> StreamOutput:
        if self.method != "srp":
            return self._step_cov(state, block)
        buf = torch.cat([state.buffer[:, self.hop:], block], 1)
        spec = torch.fft.rfft(buf * self._window, n=self.frame)
        cross = spec[self._pi] * torch.conj(spec[self._pj])
        a = self.ema
        cr = a * state.cross_r + (1.0 - a) * cross.real
        ci = a * state.cross_i + (1.0 - a) * cross.imag
        if self.weighting in ("phat", "cc"):
            auto = state.auto          # never read by these weightings
        else:
            auto = a * state.auto + (1.0 - a) * gccphat._auto(spec)
        # torch.complex builds a new tensor: the whitening never touches
        # the EMA planes the next hop reads.
        white = gccphat._weight_cross(
            torch.complex(cr, ci), auto[self._pi], auto[self._pj],
            self.weighting, gccphat.PHAT_EPS)
        if self._mask is not None:
            white = white * self._mask
        new_state = StreamState(buf, cr, ci, auto, state.count + 1)
        if self.motion == "compensated":
            wn = self._mc_whalf + self._mc_smax
            win = tracking_ops._subframe_windows(
                buf[None], self.pi, self.pj, self.fs, self.band,
                self.weighting, self._mc_nsub, wn, self._mc_nfft)
            spec_w = torch.fft.rfft(win, n=self._mc_npad)
            dets, powers = tracking_ops._detect_rate_envelope(
                spec_w, self.mics, self.pi, self.pj, self.fs, self.c,
                self.lower, self.upper, self.num_sources, self._mc_dtf,
                self._mc_npad, self._mc_wlen, self._mc_whalf,
                self._mc_smax, self._mc_nfft, self.coarse_n, self.fine_n,
                self.pool)
            if self.num_sources > 1:
                return StreamOutput(dets[0], powers[0], new_state)
            return StreamOutput(dets[0, 0], powers[0, 0], new_state)
        corr = torch.fft.irfft(white, n=self.frame)
        if self.num_sources > 1:
            multi = srp_ops.srp_phat_locate_multi(
                corr, self.mics, self.pi, self.pj, self.fs, self.c,
                self.lower, self.upper, num_sources=self.num_sources,
                coarse_n=self.coarse_n, fine_n=self.fine_n,
                min_separation=self.min_separation, pool_samples=self.pool,
                max_lag_samples=self._max_lag, suppression=self.suppression)
            return StreamOutput(multi.positions, multi.powers, new_state)
        out = srp_ops.srp_phat_locate(
            corr, self.mics, self.pi, self.pj, self.fs, self.c, self.lower,
            self.upper, coarse_n=self.coarse_n, fine_n=self.fine_n,
            pool_samples=self.pool, max_lag_samples=self._max_lag)
        return StreamOutput(out.position, out.power, new_state)

    def step(self, state, block) -> StreamOutput:
        """Absorb one (M, hop) block and localize; O(1) state."""
        block = (block.to(device=self.device, dtype=F32)
                 if torch.is_tensor(block) else torch.as_tensor(
                     np.array(block, np.float32), device=self.device))
        if tuple(block.shape) != (self.mics.shape[0], self.hop):
            raise ValueError(
                f"block must be (num_mics, hop) = "
                f"({self.mics.shape[0]}, {self.hop}), got "
                f"{tuple(block.shape)}")
        return self._step(state, block)

    def run(self, signals) -> Tuple[np.ndarray, np.ndarray]:
        """Stream a whole (M, T) capture through the step: one upload, a
        loop over the hops with the estimates kept on the device, one read
        at the end.  Returns (positions (S, 3), powers (S,)) for the S
        hops from the first full frame on ((S, K, 3), (S, K) with
        ``num_sources=K``)."""
        signals = np.array(signals, np.float32)
        m, t = signals.shape
        num_blocks = t // self.hop
        warmup = self.frame // self.hop
        if num_blocks < warmup:
            shape = ((0, 3) if self.num_sources == 1
                     else (0, self.num_sources, 3))
            pshape = (0,) if self.num_sources == 1 else (0, self.num_sources)
            return np.zeros(shape, np.float32), np.zeros(pshape, np.float32)
        blocks = torch.as_tensor(
            signals[:, :num_blocks * self.hop]
            .reshape(m, num_blocks, self.hop).transpose(1, 0, 2),
            device=self.device)                         # (S_all, M, hop)
        state = self.init_state()
        positions, powers = [], []
        for s in range(num_blocks):
            out = self._step(state, blocks[s])
            state = out.state
            positions.append(out.position)
            powers.append(out.power)
        return (torch.stack(positions[warmup - 1:]).cpu().numpy(),
                torch.stack(powers[warmup - 1:]).cpu().numpy())


class TrackedOutput(NamedTuple):
    positions: torch.Tensor   # (K, 3) identity-stable track positions
    powers: torch.Tensor      # (K,) detection powers, track order
    associated: torch.Tensor  # (K,) bool: the detection passed the gate
    velocities: torch.Tensor  # (K, 3) alpha-beta velocity estimates (m/s)
    state: tuple


class OnlineTracker:
    """Causal identities over a multi-talker ``StreamingLocalizer``, the
    JAX package's ``OnlineTracker`` (models/online.py:592 there): each hop,
    the momentum-gated K! assignment of ``tracking.association_step``;
    during the localizer's warm-up (frame // hop hops) the tracks restart
    from the raw detections; a gated-out detection emits the coasting
    prediction.  ``gate`` defaults to max_speed * hop / fs + 0.3 m."""

    def __init__(self, localizer: StreamingLocalizer,
                 gate: Optional[float] = None, max_speed: float = 5.0):
        if localizer.num_sources < 2:
            raise ValueError("OnlineTracker needs a multi-talker localizer "
                             "(num_sources >= 2)")
        if localizer.num_sources > 5:
            raise ValueError("association enumerates K! assignments; "
                             "num_sources > 5 is unsupported")
        self.loc = localizer
        self.dt = localizer.hop / localizer.fs
        self.gate = (max_speed * self.dt + 0.3) if gate is None \
            else float(gate)
        self.warmup = localizer.frame // localizer.hop

    def init_state(self):
        k = self.loc.num_sources
        zeros = torch.zeros((k, 3), dtype=F32, device=self.loc.device)
        return (self.loc.init_state(), zeros, zeros.clone(), 0)

    def step(self, state, block) -> TrackedOutput:
        """Absorb one (M, hop) block; localize and associate."""
        loc_state, pos, vel, n = state
        out = self.loc.step(loc_state, block)
        det, pw = out.position, out.power
        warm = n >= self.warmup
        pos_eff = pos if warm else det
        vel_eff = vel if warm else torch.zeros_like(vel)
        (pos_new, vel_new), (z, zp, ok) = tracking_ops.association_step(
            pos_eff, vel_eff, det, pw, self.dt, self.gate)
        # A gated-out detection is a wild fix: emit the prediction.
        ok_eff = ok & warm
        pred = pos_eff + vel_eff * self.dt
        emit = torch.where(ok_eff[:, None], z, pred)
        return TrackedOutput(emit, zp, ok_eff, vel_new,
                             (out.state, pos_new, vel_new, n + 1))

    def run(self, signals) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stream a whole (M, T) capture; returns (positions (S, K, 3),
        powers (S, K), associated (S, K)) for the S hops from the first
        full frame on, read from the device once at the end."""
        signals = np.array(signals, np.float32)
        m, t = signals.shape
        hop = self.loc.hop
        num_blocks = t // hop
        k = self.loc.num_sources
        if num_blocks < self.warmup:
            return (np.zeros((0, k, 3), np.float32),
                    np.zeros((0, k), np.float32), np.zeros((0, k), bool))
        blocks = torch.as_tensor(signals[:, :num_blocks * hop].reshape(
            m, num_blocks, hop).transpose(1, 0, 2), device=self.loc.device)
        state = self.init_state()
        ps, ws, oks = [], [], []
        for s in range(num_blocks):
            outt = self.step(state, blocks[s])
            state = outt.state
            if s >= self.warmup - 1:
                ps.append(outt.positions)
                ws.append(outt.powers)
                oks.append(outt.associated)
        return (torch.stack(ps).cpu().numpy(), torch.stack(ws).cpu().numpy(),
                torch.stack(oks).cpu().numpy())
