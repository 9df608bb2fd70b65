"""TDOA extraction, correlation metrics and the bootstrap significance
null (counterpart of the JAX package's models/tdoa.py; reference:
utils.py:121-271).

Ported: the ladder with the 'gaussian', 'adaptive' and 'median'
thresholds, with a max_expected_delay window or over the whole row, on
the physical lag axis (lag 0 centred, strict local maxima) or the
reference's (SURVEY.md Q1: the positional scipy 'full' axis, no centring,
scipy's plateau peaks); its collapsed form on a lag window
(``tdoa_single_from_window``, fed by kernels K2 / K5); the single-pair
``get_time_delays_phat``; the correlation metrics; and the bootstrap
null: permutation, block and circular resamples through kernels K4a/K4b
(ops/cuda_fft.fft_real + bootstrap_peaks), and the uniform-noise null
through K4a/K6 (``noise_bootstrap_peaks``).  The kernels take power-of-two
lengths; at any other length (parity mode's exact 2n - 1) the null runs
as the JAX package's XLA branch does: ``torch.fft`` transforms of the
resampled rows in chunks, PHAT whitening by K7 (``gccphat``), the inverse
and the row maxima.  The route follows from the length alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_fft
from ..ops import gccphat
from ..ops import noise as noise_ops
from ..ops import peaks as peaks_ops
from ..ops.fftutils import irfft_n, rfft_n
from ..ops.quantile import median_nonneg


class TdoaResult(NamedTuple):
    delays: torch.Tensor     # (..., num_peaks) seconds
    valid: torch.Tensor      # (..., num_peaks) bool
    corr: torch.Tensor       # (..., n) correlation, lag 0 centred
    time_lags: torch.Tensor  # (n,) lag axis in seconds


def time_delays_from_corr(corr: torch.Tensor, n1: int, n2: int, fs: float,
                          num_peaks: int = 1,
                          threshold_method: str = "gaussian",
                          threshold_multiplier: float = 1.0,
                          max_expected_delay: Optional[float] = None,
                          lag_mode: str = "physical",
                          num_candidates: int = 128,
                          threshold_subsample: int = 7) -> TdoaResult:
    """Delays (s) of the tallest peaks of each row of ``corr`` (circular
    order, last axis length n): the reference's ladder — primary threshold
    ('gaussian', 'adaptive' or 'median'; any other name falls back to
    'median' as in utils.py:149), then mean|corr|, then the global argmax,
    each re-run inside the max_expected_delay window when one is given
    (utils.py:148-172).  ``lag_mode='physical'`` centres lag 0 and takes
    strict local maxima; 'reference' (or 'compat') keeps the circular
    order on the reference's positional lag axis (``gccphat.lag_axis``)
    with scipy's plateau peaks and an exact median, bit for bit the
    reference's find_peaks ladder."""
    n = corr.shape[-1]
    num_candidates = min(num_candidates, n)
    physical = lag_mode == "physical"
    if physical:
        # Centre lag 0 so peaks near zero delay are interior samples.
        # Alias-free transforms hold linear lags in [-(n2-1), n1-1];
        # circular ones split symmetrically.
        shift = n2 - 1 if n >= n1 + n2 - 1 else n // 2
        corr = torch.roll(corr, shift, dims=-1)
        lags = np.arange(n) - shift
    else:
        lags = gccphat.lag_axis(lag_mode, n1, n2, n)
    time_lags = torch.as_tensor(lags, dtype=corr.dtype,
                                device=corr.device) / fs

    abs_corr = torch.abs(corr)
    if threshold_method == "adaptive":
        thr_primary = threshold_multiplier * (
            torch.mean(abs_corr, -1, keepdim=True)
            + torch.std(abs_corr, -1, correction=0, keepdim=True))
    elif threshold_method == "gaussian":
        # Gaussian-calibrated median estimate: 0.84535 * mean|x| estimates
        # the median |x| of zero-mean Gaussian bins in one pass.
        thr_primary = (threshold_multiplier * 0.84535
                       * torch.mean(abs_corr, -1, keepdim=True))
    else:
        # Exact median of |corr|, in physical mode on a prime-stride
        # subsample of long rows (a prime stride keeps tonal |corr| from
        # phase-locking onto one point of its period); parity mode exact.
        stride = (threshold_subsample if physical and threshold_subsample > 1
                  and n >= 64 * threshold_subsample else 1)
        thr_primary = threshold_multiplier * median_nonneg(
            abs_corr[..., ::stride])[..., None]
    thr_alt = torch.mean(abs_corr, -1, keepdim=True)  # utils.py:155
    distance = int(fs * 0.001)  # min 1 ms peak spacing (utils.py:151)

    if physical and max_expected_delay is not None:
        # After centring, the lag window is one static slice around
        # `shift`, dilated by 8 peak distances so suppressors of in-window
        # candidates are present; the threshold-existence tests scan the
        # whole row.
        half = int(np.ceil(max_expected_delay * fs)) + 8 * max(distance, 1)
        c0 = max(0, shift - half)
        c1 = min(n, shift + half + 1)
        lm = peaks_ops.local_maxima(corr)
        use_a = torch.any(lm & (corr >= thr_primary), -1, keepdim=True)
        use_b = torch.any(lm & (corr >= thr_alt), -1, keepdim=True)
        pos_s, h_s, keep_a, keep_b = peaks_ops.select_peaks_two(
            corr[..., c0:c1], thr_primary, thr_alt, distance,
            min(num_candidates, c1 - c0))
        pos = pos_s + c0
        set_a = (pos, h_s, keep_a)
        set_b = (pos, h_s, keep_b)
    else:
        window_mask = None
        if max_expected_delay is not None:
            # Dilated by a few peak distances so suppressors of in-window
            # candidates are in the candidate set (select_peaks).
            dilated = max_expected_delay + 4.0 * distance / fs
            window_mask = torch.abs(time_lags) <= dilated
        set_a = peaks_ops.select_peaks(corr, thr_primary, distance,
                                       num_candidates, window_mask,
                                       plateaus=not physical)
        set_b = peaks_ops.select_peaks(corr, thr_alt, distance,
                                       num_candidates, window_mask,
                                       plateaus=not physical)
        use_a = torch.any(set_a[2], -1, keepdim=True)
        use_b = torch.any(set_b[2], -1, keepdim=True)

    stage1 = tuple(torch.where(use_a, xa, xb) for xa, xb in zip(set_a, set_b))
    argmax_fallback = ~use_a & ~use_b     # utils.py:157-160

    if max_expected_delay is not None:
        w1 = stage1[2] & (torch.abs(time_lags[stage1[0]])
                          <= max_expected_delay)
        w2 = set_b[2] & (torch.abs(time_lags[set_b[0]])
                         <= max_expected_delay)
        have1 = torch.any(w1, -1, keepdim=True)
        have2 = torch.any(w2, -1, keepdim=True)
        final = tuple(torch.where(have1, s1, torch.where(have2, s2, s1))
                      for s1, s2 in zip((stage1[0], stage1[1], w1),
                                        (set_b[0], set_b[1], w2)))
        # No in-window peak anywhere -> argmax fallback (utils.py:169-172).
        argmax_fallback = argmax_fallback | (~have1 & ~have2)
    else:
        final = stage1

    pos_f, _, keep_f = peaks_ops.compact_valid(*final)
    delays = time_lags[pos_f[..., :num_peaks]]
    valid = keep_f[..., :num_peaks]

    am_delay = time_lags[torch.argmax(corr, dim=-1)]
    slot = torch.arange(num_peaks, device=corr.device) == 0
    fb = argmax_fallback & slot
    delays = torch.where(fb, am_delay[..., None], delays)
    valid = torch.where(argmax_fallback, slot, valid)
    return TdoaResult(delays, valid, corr, time_lags)


def window_half(fs: float, max_expected_delay: float) -> int:
    """Lags the windowed ladder consults on each side of lag 0: the
    max_expected_delay gate plus its 8 x 1 ms dilation margin."""
    return int(np.ceil(max_expected_delay * fs)) + 8 * max(int(fs * 0.001),
                                                           1)


def window_wq(fs: float, max_expected_delay: float, nfft: int) -> int:
    """Half-width of K2's lag window in units of 128 lags: covers
    ``window_half`` where nfft allows, capped at nfft/256 (the JAX
    package's ``_fast_window_wq`` and ``_tdoa_window_wq``)."""
    half = window_half(fs, max_expected_delay)
    return min(max(-(-half // 128) + 1, 1), nfft // 256)


def tdoa_single_from_window(win: torch.Tensor, stats: torch.Tensor,
                            wq: int, nfft: int, fs: float,
                            max_expected_delay: float,
                            threshold_multiplier: float = 1.0
                            ) -> torch.Tensor:
    """Single-peak physical-lag TDOA from a lag-centred correlation window
    plus global statistics (the outputs of ops/cuda_fft.gcc_windowed and
    scene_windowed): peak-lag delays in seconds, shape win.shape[:-1] (the
    sign convention of ``TdoaResult.delays``: td = -delay).

    Matches ``time_delays_from_corr(num_peaks=1, threshold_method=
    'gaussian', max_expected_delay=...)`` whenever the winning peak lies in
    the window, which its sizing guarantees: the candidate is the tallest
    in-window strict local maximum above 0.84535 * mean|corr| that no
    taller local maximum within the 1 ms peak spacing dominates; with no
    candidate, the global argmax (natural index nfft/2 and above decode as
    negative lags).  Suppression chains are approximated as in the JAX
    package (models/tdoa.py:188-253 there)."""
    if threshold_multiplier > 1.0 / 0.84535:
        raise ValueError(
            "tdoa_single_from_window requires threshold_multiplier <= "
            "1/0.84535: larger multipliers put the primary threshold above "
            "the alt mean-|corr| rung, which this collapsed ladder omits — "
            "use time_delays_from_corr for those")
    length = win.shape[-1]
    lags = torch.arange(length, dtype=win.dtype,
                        device=win.device) - wq * 128
    thr = 0.84535 * threshold_multiplier * stats[..., 0:1]
    lm = peaks_ops.local_maxima(win)
    inwin = torch.abs(lags) <= max_expected_delay * fs
    # A candidate loses to any strictly taller local maximum within
    # +-distance samples: one max-dilation over the local-max heights
    # (max_pool1d pads with -inf, like reduce_window's "SAME").
    distance = max(int(fs * 0.001), 1)
    neg = torch.full_like(win, -float("inf"))
    heights = torch.where(lm, win, neg)
    dil = F.max_pool1d(heights.reshape(-1, 1, length), 2 * distance + 1,
                       stride=1, padding=distance).reshape(win.shape)
    cand = lm & inwin & (win >= thr) & (win >= dil)
    best = torch.argmax(torch.where(cand, win, neg), dim=-1)
    has = torch.any(cand, dim=-1)
    peak_lag = lags[best]
    gidx = stats[..., 2]
    glag = torch.where(gidx >= nfft // 2, gidx - nfft, gidx)
    return torch.where(has, peak_lag, glag) / fs


def get_time_delays_phat(sig1: torch.Tensor, sig2: torch.Tensor, fs: float,
                         num_peaks: int = 1,
                         threshold_method: str = "median",
                         threshold_multiplier: float = 1.0,
                         max_expected_delay: Optional[float] = None,
                         lag_mode: str = "reference",
                         nfft: Optional[int] = None) -> TdoaResult:
    """Single-pair convenience with the reference's call shape
    (utils.py:121-181): ``gccphat.phat_correlation`` (kernels K4a + K9 at
    a power-of-two ``nfft``, torch.fft + K7 at the exact length) and the
    ladder, on the reference's lag axis by default."""
    corr = gccphat.phat_correlation(sig1, sig2, nfft=nfft)
    return time_delays_from_corr(
        corr, sig1.shape[-1], sig2.shape[-1], fs, num_peaks,
        threshold_method, threshold_multiplier, max_expected_delay, lag_mode)


def peak_to_peak_ratio(corr: torch.Tensor) -> torch.Tensor:
    """max / |min|; inf when the trough is exactly zero (utils.py:228-236)."""
    peak = torch.amax(corr, -1)
    trough = torch.amin(corr, -1)
    safe = torch.where(trough == 0, torch.ones_like(trough), trough)
    return torch.where(trough == 0, torch.full_like(peak, float("inf")),
                       peak / torch.abs(safe))


def correlation_snr(corr: torch.Tensor) -> torch.Tensor:
    """Peak over the std of the correlation outside a ±1%-length window
    around the peak (utils.py:238-250)."""
    n = corr.shape[-1]
    peak, peak_idx = torch.max(corr, -1)
    window = max(1, int(0.01 * n))
    start = torch.clamp(peak_idx - window, min=0)
    end = torch.clamp(peak_idx + window, max=n)
    idx = torch.arange(n, device=corr.device)
    outside = (idx < start[..., None]) | (idx >= end[..., None])
    safe = torch.clamp(torch.sum(outside, -1), min=1)
    zero = torch.zeros_like(corr)
    mean = torch.sum(torch.where(outside, corr, zero), -1) / safe
    var = torch.sum(torch.where(outside, (corr - mean[..., None]) ** 2, zero),
                    -1) / safe
    noise = torch.sqrt(var)
    return torch.where(noise == 0, torch.full_like(peak, float("inf")),
                       peak / torch.where(noise == 0, torch.ones_like(noise),
                                          noise))


def permuted_rows(sig2: torch.Tensor, num: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """``num`` independent uniform permutations of ``sig2``, drawn in one
    batched op (argsort of uniform float64 keys, so ties are negligible)."""
    keys = torch.rand((num, sig2.shape[-1]), generator=generator,
                      dtype=torch.float64, device=sig2.device)
    return sig2[torch.argsort(keys, dim=-1)]


def block_rows(sig2: torch.Tensor, num: int,
               generator: Optional[torch.Generator],
               block_size: int = 50) -> torch.Tensor:
    """``num`` block permutations of ``sig2``: it is cut into blocks of
    ``block_size`` (the last zero-padded), the blocks permuted, the result
    trimmed back to sig2's length."""
    n2 = sig2.shape[-1]
    num_blocks = -(-n2 // block_size)
    padded = torch.nn.functional.pad(sig2, (0, num_blocks * block_size - n2))
    blocks = padded.reshape(num_blocks, block_size)
    keys = torch.rand((num, num_blocks), generator=generator,
                      dtype=torch.float64, device=sig2.device)
    return blocks[torch.argsort(keys, dim=-1)].reshape(num, -1)[:, :n2]


def circular_rows(sig2: torch.Tensor, num: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """``num`` circular shifts of ``sig2`` by uniform integers in
    [0, n2): row[t] = sig2[(t - shift) mod n2], ``torch.roll``'s sense."""
    n2 = sig2.shape[-1]
    shift = torch.randint(0, n2, (num, 1), generator=generator,
                          device=sig2.device)
    idx = (torch.arange(n2, device=sig2.device) - shift) % n2
    return sig2[idx]


# Resampled rows a chunk of the exact-length null transforms at once: at
# parity mode's 88,199 points, 256 rows of spectra are 90 MB in complex64.
BOOT_CHUNK = 256


def _spectrum(sig1: torch.Tensor, n: int) -> torch.Tensor:
    """sig1's (n//2 + 1,) spectrum through kernel K4a, truncated to n
    samples first as numpy's rfft would."""
    return cuda_fft.fft_real(sig1[None, :n].contiguous(), n)[0].contiguous()


def exact_null_peaks(sig1: torch.Tensor, rows: torch.Tensor,
                     n: int) -> torch.Tensor:
    """PHAT peak between ``sig1`` and each row (B, n2) at any transform
    length n (the JAX package's XLA branch of the null, models/tdoa.py:
    369-374 there): ``BOOT_CHUNK`` rows at a time, torch.fft spectra, the
    cross-spectra whitened by ``gccphat``'s PHAT (kernel K7 on the card),
    the inverse and the row maxima."""
    s1 = rfft_n(sig1, n)[None, :]
    peaks = []
    for r0 in range(0, rows.shape[0], BOOT_CHUNK):
        white = gccphat._weighted_cross(s1, rfft_n(rows[r0:r0 + BOOT_CHUNK],
                                                   n), "phat",
                                        gccphat.PHAT_EPS)
        peaks.append(torch.amax(irfft_n(white, n), -1))
    return torch.cat(peaks)


def bootstrap_threshold(sig1: torch.Tensor, rows: torch.Tensor,
                        nfft: int, alpha: float = 0.05) -> torch.Tensor:
    """(1-alpha) quantile of the PHAT peak between ``sig1`` and each
    resampled row (B, n2) at transform length ``nfft``: kernels K4a and
    K4b at a power of two (the lengths they take: the JAX package's
    ``bfly_bootstrap_eligible`` by length), ``exact_null_peaks`` at any
    other length."""
    if gccphat._is_pow2(nfft):
        peaks = cuda_fft.bootstrap_peaks(_spectrum(sig1, nfft),
                                         rows[:, :nfft].contiguous(), nfft,
                                         gccphat.PHAT_EPS)
    else:
        peaks = exact_null_peaks(sig1, rows, nfft)
    return torch.quantile(peaks, 1.0 - alpha)


def noise_null_peaks(sig1: torch.Tensor, sig2: torch.Tensor,
                     generator: Optional[torch.Generator],
                     num_bootstrap: int, nfft: int) -> torch.Tensor:
    """PHAT peak maxima between sig1 and ``num_bootstrap`` fresh uniform
    noise rows of sig2's length (``bootstrap_mode='noise'``, the JAX
    package's ``_noise_null_peaks``): sig2 enters only through its length,
    the null's degrees of freedom.  K4a transforms sig1; K6 draws, whitens
    and reduces the rows, from one (B, 2) int32 seed pair per draw taken
    from ``generator``; at a length that is not a power of two, the same
    draws (``ops/noise.uniform``) go through ``exact_null_peaks``."""
    seeds = torch.randint(-2 ** 31, 2 ** 31, (num_bootstrap, 2),
                          generator=generator, dtype=torch.int32,
                          device=sig1.device)
    n_samp = min(sig2.shape[-1], nfft)
    if not gccphat._is_pow2(nfft):
        rows = noise_ops.uniform(seeds, n_samp).to(sig1.dtype)
        return exact_null_peaks(sig1, rows, nfft)
    return cuda_fft.noise_bootstrap_peaks(
        _spectrum(sig1, nfft), seeds, n_samp, nfft, gccphat.PHAT_EPS)


def bootstrap_significance(sig1: torch.Tensor, sig2: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           num_bootstrap: int = 1000, alpha: float = 0.05,
                           bootstrap_mode: str = "permutation",
                           block_size: int = 50,
                           nfft: Optional[int] = None) -> torch.Tensor:
    """Null-distribution threshold for the PHAT peak (utils.py:183-216):
    ``num_bootstrap`` resamples of sig2 (``bootstrap_mode`` 'permutation',
    'block' or 'circular'), each correlated with sig1 at ``nfft`` (the
    real correlation's transform length), reduced to the (1-alpha)
    quantile of their peaks.  'noise' is the physical-mode surrogate: fresh
    uniform noise rows of sig2's length in place of the resamples (the
    permutation null within Monte-Carlo error, tests/test_bootstrap_noise.py
    of the JAX package), drawn inside kernel K6, so no permutation is
    sorted.  Signals longer than nfft are truncated, as numpy's rfft
    does."""
    n1, n2 = sig1.shape[-1], sig2.shape[-1]
    n = nfft if nfft is not None else n1 + n2 - 1
    if bootstrap_mode == "noise":
        peaks = noise_null_peaks(sig1, sig2, generator, num_bootstrap, n)
        return torch.quantile(peaks, 1.0 - alpha)
    if bootstrap_mode == "permutation":
        rows = permuted_rows(sig2, num_bootstrap, generator)
    elif bootstrap_mode == "block":
        rows = block_rows(sig2, num_bootstrap, generator, block_size)
    elif bootstrap_mode == "circular":
        rows = circular_rows(sig2, num_bootstrap, generator)
    else:
        raise ValueError("Unknown bootstrap_mode. Use 'permutation', "
                         "'block', 'circular' or 'noise'.")
    return bootstrap_threshold(sig1, rows, n, alpha)


def significance_test(corr: torch.Tensor, sig1: torch.Tensor,
                      sig2: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      alpha: float = 0.05, snr_threshold: float = 2.0,
                      num_bootstrap: int = 1000,
                      nfft: Optional[int] = None):
    """Combined bootstrap + SNR significance (utils.py:252-259): (snr,
    significant), the peak above the permutation null's threshold and the
    SNR above ``snr_threshold``."""
    snr = correlation_snr(corr)
    threshold = bootstrap_significance(sig1, sig2, generator,
                                       num_bootstrap=num_bootstrap,
                                       alpha=alpha, nfft=nfft)
    return snr, (torch.amax(corr, -1) > threshold) & (snr > snr_threshold)


def cross_correlation_metrics(corr: torch.Tensor, sig1: torch.Tensor,
                              sig2: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              alpha: float = 0.05, num_bootstrap: int = 1000,
                              nfft: Optional[int] = None) -> dict:
    """The metric dict of compute_cross_correlation_metrics
    (utils.py:261-271): peak-to-peak ratio, SNR, significance."""
    snr, significant = significance_test(corr, sig1, sig2, generator,
                                         alpha=alpha,
                                         num_bootstrap=num_bootstrap,
                                         nfft=nfft)
    return {"peak_to_peak_ratio": peak_to_peak_ratio(corr), "snr": snr,
            "significant": significant}

def compute_weights(snr: torch.Tensor) -> torch.Tensor:
    """Per-pair solver weights: SNR normalized by its mean
    (utils.py:484-497)."""
    mean = torch.mean(snr)
    safe = torch.where(mean == 0, torch.ones_like(mean), mean)
    return torch.where(mean != 0, snr / safe, snr)
