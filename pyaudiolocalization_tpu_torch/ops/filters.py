"""Noise-reduction front ends and IIR filtering (counterpart of the JAX
package's ops/filters.py; reference: signal_processing.py:109-138).

Design happens on the host in float64 (numpy).  The Butterworth filter
runs as two convolutions with the truncated impulse response of the
biquad cascade (``filtfilt_sos_conv``), the JAX package's default
realization; the FIR bandpass as scipy's filtfilt protocol over a causal
convolution (``filtfilt``); the Wiener filter as local statistics over a
3-sample window.  Direct-form IIR filtering (``lfilter``, ``filtfilt``,
``sosfilt``, ``filtfilt_sos``) evaluates the DF2T state recurrence
z[t] = M z[t-1] + k x[t] either as a log-depth doubling scan over the
affine maps ('prefix', ceil(log2 T) batched matrix products) or in sample
order ('scan', one small step a sample: on a card, several launches a
sample, so only for short rows), in float64 whatever the signal's dtype,
the output cast back to it.  The JAX package runs them in the signal's
dtype: in float32 its doubling scan of the reference's Butterworth cascade
(``noise_reduction(lfilter_method='prefix')``) comes out up to 7.8e-4 off
the float64 answer on a 1 s row at 44.1 kHz, its sequential scan 3.6e-5
on 0.1 s (tests/test_torch_iir.py pins both); the port's float32 answers
are the float64 ones rounded.  No TPU kernel ran here: the JAX package
computes all of this on XLA, so the port computes it in plain tensor
arithmetic (an FFT for convolutions of 256 taps and more).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _butter_bandpass_zpk(order: int, low: float, high: float):
    """Digital Butterworth bandpass as z-domain zeros/poles/gain."""
    if not 0.0 < low < high < 1.0:
        raise ValueError(
            "Digital filter critical frequencies must be 0 < low < high < 1 "
            f"(got low={low}, high={high}; frequencies are in units of the "
            "Nyquist rate)")
    n = order
    k_idx = np.arange(1, n + 1)
    poles = np.exp(1j * np.pi * (2 * k_idx + n - 1) / (2 * n))
    fs = 2.0
    w1 = 2 * fs * np.tan(np.pi * low / fs)
    w2 = 2 * fs * np.tan(np.pi * high / fs)
    bw = w2 - w1
    wo = np.sqrt(w1 * w2)
    # Lowpass -> bandpass: each pole p maps to p*bw/2 +/- sqrt((p*bw/2)^2 -
    # wo^2); n zeros appear at s=0.
    scaled = poles * bw / 2.0
    root = np.sqrt(scaled ** 2 - wo ** 2)
    bp_poles = np.concatenate([scaled + root, scaled - root])
    bp_zeros = np.zeros(n, complex)
    bp_gain = bw ** n
    # Bilinear transform to the z-domain.
    fs2 = 2.0 * fs
    z_d = (fs2 + bp_zeros) / (fs2 - bp_zeros)
    p_d = (fs2 + bp_poles) / (fs2 - bp_poles)
    k_d = bp_gain * np.real(np.prod(fs2 - bp_zeros) / np.prod(fs2 - bp_poles))
    z_d = np.concatenate([z_d, -np.ones(len(p_d) - len(z_d))])
    return z_d, p_d, float(k_d)


@functools.lru_cache(maxsize=64)
def butter_bandpass_sos(order: int, low: float, high: float) -> tuple:
    """Butterworth bandpass as ``order`` second-order sections
    ((b0, b1, b2, a0, a1, a2), ...): one conjugate pole pair with one zero
    at z=+1 and one at z=-1 each, the gain spread evenly, sections with
    poles closest to the unit circle last."""
    z_d, p_d, k_d = _butter_bandpass_zpk(order, low, high)
    tol = 1e-12
    upper = sorted([p for p in p_d if p.imag > tol], key=lambda p: abs(p))
    reals = sorted([p.real for p in p_d if abs(p.imag) <= tol])
    pole_pairs = [(p, np.conj(p)) for p in upper]
    pole_pairs += [(reals[i], reals[i + 1])
                   for i in range(0, len(reals) - 1, 2)]
    if 2 * len(pole_pairs) != len(p_d):
        raise ValueError("unpaired pole while forming sections")
    pole_pairs.sort(key=lambda pq: abs(abs(pq[0]) - 1.0), reverse=True)
    k_sec = float(np.sign(k_d)) * abs(k_d) ** (1.0 / len(pole_pairs))
    sos = []
    for p, q in pole_pairs:
        b = k_sec * np.poly([1.0, -1.0])          # (z-1)(z+1) = z^2 - 1
        a = np.real(np.poly([p, q]))
        sos.append((float(b[0]), float(b[1]), float(b[2]),
                    float(a[0]), float(a[1]), float(a[2])))
    return tuple(sos)


@functools.lru_cache(maxsize=64)
def butter_bandpass(order: int, low: float, high: float) -> tuple:
    """Digital Butterworth bandpass (b, a), cutoffs normalized to Nyquist
    (scipy.butter(order, [low, high], btype='band') semantics).  The single
    direct form of an order-2n narrowband filter is numerically fragile
    (poles cluster near the unit circle); ``butter_bandpass_sos`` is the
    realization to filter with."""
    z_d, p_d, k_d = _butter_bandpass_zpk(order, low, high)
    b = np.real(k_d * np.poly(z_d))
    a = np.real(np.poly(p_d))
    return tuple(b.tolist()), tuple(a.tolist())

@functools.lru_cache(maxsize=64)
def sos_impulse_response(sos: tuple, tol: float = 1e-9) -> tuple:
    """Impulse response of a biquad cascade, truncated where the tail is
    below ``tol`` relative to the peak (host-side float64 simulation); the
    length follows the slowest pole."""
    max_pole = 0.0
    for sec in sos:
        roots = np.roots(np.asarray(sec[3:], np.float64))
        max_pole = max(max_pole, float(np.max(np.abs(roots))))
    max_pole = min(max(max_pole, 1e-6), 0.999999)
    length = int(np.ceil(np.log(tol) / np.log(max_pole))) + len(sos) * 2 + 1
    length = min(length, 65536)
    h = np.zeros(length, np.float64)
    h[0] = 1.0
    for sec in sos:
        b = np.asarray(sec[:3], np.float64)
        a = np.asarray(sec[3:], np.float64)
        out = np.zeros(length, np.float64)
        z1 = z2 = 0.0
        for t in range(length):  # DF2T biquad
            xt = h[t]
            yt = b[0] * xt + z1
            z1 = b[1] * xt - a[1] * yt + z2
            z2 = b[2] * xt - a[2] * yt
            out[t] = yt
        h = out
    return tuple(h.tolist())


def _conv_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'valid' correlation of x with kernel along the last axis, batched.
    Kernels of 256 taps and more go through one padded real FFT."""
    n = x.shape[-1]
    k = kernel.shape[0]
    if k >= 256:
        nfft = 1 << (n - 1).bit_length()
        spec = (torch.fft.rfft(x, n=nfft)
                * torch.fft.rfft(torch.flip(kernel, [0]), n=nfft))
        full = torch.fft.irfft(spec, n=nfft)
        # Linear-conv positions k-1..n-1 are alias-free because nfft >= n.
        return full[..., k - 1:n]
    # Short kernels: an explicit multiply-add in the working precision.
    return x.unfold(-1, k, 1) @ kernel


def _odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension at both ends (scipy.signal.odd_ext semantics)."""
    left = 2 * x[..., :1] - torch.flip(x[..., 1:n + 1], [-1])
    right = 2 * x[..., -1:] - torch.flip(x[..., -(n + 1):-1], [-1])
    return torch.cat([left, x, right], dim=-1)


def filtfilt_sos_conv(sos: tuple, x: torch.Tensor,
                      tol: float = 1e-9) -> torch.Tensor:
    """Zero-phase IIR filtering as two convolutions, matching scipy's
    filtfilt protocol up to the impulse-tail truncation O(tol): the forward
    pass sees the constant ``ext[0]`` prehistory (scipy's steady-state
    ``zi * ext[0]``), the backward pass the constant last forward output."""
    h = torch.as_tensor(np.asarray(sos_impulse_response(sos, tol)),
                        dtype=x.dtype, device=x.device)
    length = h.shape[0]
    padlen = 3 * (2 * len(sos) + 1)
    if x.shape[-1] <= padlen:
        raise ValueError("The length of the input vector must be greater "
                         f"than padlen ({padlen}).")
    ext = _odd_ext(x, padlen)
    shape_pad = ext.shape[:-1] + (length - 1,)
    pre = ext[..., :1].expand(shape_pad)
    y_fwd = _conv_valid(torch.cat([pre, ext], -1), torch.flip(h, [0]))
    post = y_fwd[..., -1:].expand(shape_pad)
    y = _conv_valid(torch.cat([y_fwd, post], -1), h)
    return y[..., padlen:-padlen]


@functools.lru_cache(maxsize=64)
def firwin_bandpass(numtaps: int, low: float, high: float) -> tuple:
    """Hamming-windowed-sinc bandpass FIR taps (scipy.firwin(numtaps,
    [low, high], pass_zero=False) semantics), unit gain at the band
    centre."""
    m = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = high * np.sinc(high * m) - low * np.sinc(low * m)
    h = h * np.hamming(numtaps)
    c = np.cos(np.pi * m * (0.5 * (low + high)))
    h = h / np.sum(h * c)
    return tuple(h.tolist())


def _pad_ba(b, a):
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    n = max(len(b), len(a))
    b = np.concatenate([b, np.zeros(n - len(b))])
    a = np.concatenate([a, np.zeros(n - len(a))])
    return b / a[0], a / a[0]


@functools.lru_cache(maxsize=64)
def lfilter_zi(b: tuple, a: tuple) -> tuple:
    """Steady-state initial conditions for a unit-step input (scipy
    lfilter_zi semantics): solve (I - M) zi = k with M the DF2T state
    transition and k = b[1:] - a[1:] b[0]."""
    if max(len(a), len(b)) == 1:
        return ()
    _, trans, kvec = _df2t(b, a)
    return tuple(np.linalg.solve(np.eye(len(kvec)) - trans, kvec).tolist())


def _df2t(b: tuple, a: tuple):
    """(b0, M, k) of the DF2T recurrence z[t] = M z[t-1] + k x[t],
    y[t] = b0 x[t] + z[t-1][0]."""
    bb, aa = _pad_ba(b, a)
    n = len(aa)
    trans = np.zeros((n - 1, n - 1))
    trans[:-1, 1:] += np.eye(n - 2)
    trans[:, 0] -= aa[1:]
    # A plain float: a numpy float64 scalar would promote float32 signals.
    return float(bb[0]), trans, bb[1:] - aa[1:] * bb[0]


def _fir_lfilter(b: tuple, a0: float, x: torch.Tensor,
                 zi) -> torch.Tensor:
    """lfilter with a = [a0]: causal convolution plus, given ``zi``, the
    exact DF2T head correction y[t] += zi[t] for t < len(b) - 1."""
    taps = torch.as_tensor(np.asarray(b, np.float64) / a0, dtype=x.dtype,
                           device=x.device)
    k = taps.shape[0]
    length = x.shape[-1]
    y = _conv_valid(torch.nn.functional.pad(x, (k - 1, 0)),
                    torch.flip(taps, [0]))
    if zi is not None and k > 1:
        head = torch.zeros_like(y)
        head[..., :k - 1] = zi[..., :k - 1]
        y = y + head
    return y[..., :length]


def _prefix_scan(trans: torch.Tensor, c: torch.Tensor):
    """Inclusive scan of the affine maps z -> M z + c[t] over t, by
    doubling: after the step of offset s each entry composes the maps of
    its last 2s samples, (A_t, c_t) o (A_{t-s}, c_{t-s}) =
    (A_t A_{t-s}, A_t c_{t-s} + c_t); ceil(log2 T) steps of batched
    products.  c (..., T, N) -> (A (T, N, N) = M^(t+1), c (..., T, N): the
    states from z[-1] = 0)."""
    length = c.shape[-2]
    mats = trans.expand(length, *trans.shape)
    s = 1
    while s < length:
        head = mats[s:]
        c = torch.cat([c[..., :s, :], c[..., s:, :] + (
            head @ c[..., :-s, :, None])[..., 0]], -2)
        mats = torch.cat([mats[:s], head @ mats[:-s]], 0)
        s *= 2
    return mats, c


def lfilter(b, a, x: torch.Tensor, zi=None,
            method: str = "prefix") -> torch.Tensor:
    """Direct-form-II-transposed linear filter along the last axis
    (scipy.signal.lfilter semantics).  ``zi`` (optional) has shape
    ``x.shape[:-1] + (max(len(a), len(b)) - 1,)``.  FIR filters
    (``len(a) == 1``) are a causal convolution whatever ``method`` says;
    IIR filters run the state recurrence: 'scan' in sample order (one
    small step a sample), any other method the doubling scan
    (``_prefix_scan``), as the JAX package's ``lfilter`` treats any
    method but 'scan' as its parallel prefix."""
    b = tuple(np.atleast_1d(b).tolist())
    a = tuple(np.atleast_1d(a).tolist())
    if len(a) == 1:
        return _fir_lfilter(b, a[0], x, zi)
    b0, trans_np, kvec_np = _df2t(b, a)
    # The recurrence runs in float64 whatever x's dtype (module docstring).
    f64, dev = torch.float64, x.device
    xd = x.to(f64)
    trans = torch.as_tensor(trans_np, dtype=f64, device=dev)
    kvec = torch.as_tensor(kvec_np, dtype=f64, device=dev)
    zi = (torch.zeros(x.shape[:-1] + kvec.shape, dtype=f64, device=dev)
          if zi is None else zi.to(f64))
    if method == "scan":
        z = zi
        ys = []
        for t in range(x.shape[-1]):
            xt = xd[..., t]
            ys.append(b0 * xt + z[..., 0])
            z = z @ trans.T + xt[..., None] * kvec
        return torch.stack(ys, -1).to(x.dtype)
    # z[t] = M^(t+1) zi + the states the forcing k x[t] drives from 0.
    mats, forced = _prefix_scan(trans, xd[..., :, None] * kvec)
    z = (mats @ zi[..., None, :, None])[..., 0] + forced     # (..., T, N)
    prev0 = torch.cat([zi[..., None, 0], z[..., :-1, 0]], -1)
    return (b0 * xd + prev0).to(x.dtype)


def filtfilt(b, a, x: torch.Tensor, method: str = "prefix") -> torch.Tensor:
    """Zero-phase filtering with scipy's defaults: odd extension of
    3*max(len(a), len(b)) samples, steady-state zi scaled by the first
    sample, forward pass, reversed pass, extension stripped; each pass is
    ``lfilter`` with ``method``."""
    b = tuple(np.atleast_1d(b).tolist())
    a = tuple(np.atleast_1d(a).tolist())
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError("The length of the input vector must be greater "
                         f"than padlen ({padlen}).")
    zi = torch.as_tensor(np.asarray(lfilter_zi(b, a)), dtype=x.dtype,
                         device=x.device)
    ext = _odd_ext(x, padlen)
    y = lfilter(b, a, ext, zi * ext[..., :1], method=method)
    y = torch.flip(y, [-1])
    y = lfilter(b, a, y, zi * y[..., :1], method=method)
    return torch.flip(y, [-1])[..., padlen:-padlen]


def sosfilt(sos: tuple, x: torch.Tensor, x0=None,
            method: str = "prefix") -> torch.Tensor:
    """Cascade of biquads along the last axis.  Given ``x0`` ((..., 1)),
    each section starts from its steady state for a step of amplitude x0
    scaled by the DC gain of the sections before it (scipy sosfilt_zi
    semantics), the cascade's form of lfilter's ``zi * x[0]``."""
    y = x
    gain_cum = 1.0
    for sec in sos:
        b, a = sec[:3], sec[3:]
        zi = None
        if x0 is not None:
            zi = torch.as_tensor(np.asarray(lfilter_zi(b, a)), dtype=x.dtype,
                                 device=x.device) * (gain_cum * x0)
            gain_cum *= sum(b) / sum(a)
        y = lfilter(b, a, y, zi, method=method)
    return y


def filtfilt_sos(sos: tuple, x: torch.Tensor,
                 method: str = "conv") -> torch.Tensor:
    """Zero-phase filtering through a biquad cascade with ``filtfilt``'s
    edge protocol: odd extension of 3*(2*sections+1) samples and steady
    states scaled by the first sample of each pass.  'conv' (the default)
    is ``filtfilt_sos_conv``, two truncated-impulse-response convolutions;
    'prefix' and 'scan' run each section's recurrence (``sosfilt``)."""
    if method == "conv":
        return filtfilt_sos_conv(sos, x)
    padlen = 3 * (2 * len(sos) + 1)
    if x.shape[-1] <= padlen:
        raise ValueError("The length of the input vector must be greater "
                         f"than padlen ({padlen}).")
    ext = _odd_ext(x, padlen)
    y = sosfilt(sos, ext, ext[..., :1], method=method)
    y = torch.flip(y, [-1])
    y = sosfilt(sos, y, y[..., :1], method=method)
    return torch.flip(y, [-1])[..., padlen:-padlen]


def wiener(x: torch.Tensor, mysize: int = 3) -> torch.Tensor:
    """Local-statistics Wiener filter (scipy.signal.wiener 1-D semantics,
    noise power estimated as the mean local variance)."""
    ones = torch.ones(mysize, dtype=x.dtype, device=x.device)
    pad = (mysize // 2, mysize - 1 - mysize // 2)
    l_mean = _conv_valid(torch.nn.functional.pad(x, pad), ones) / mysize
    l_var = (_conv_valid(torch.nn.functional.pad(x * x, pad), ones) / mysize
             - l_mean * l_mean)
    noise = torch.mean(l_var, -1, keepdim=True)
    safe = torch.where(l_var == 0, torch.ones_like(l_var), l_var)
    res = l_mean + (x - l_mean) * (1.0 - noise / safe)
    return torch.where(l_var < noise, l_mean, res)


def noise_reduction(signal: torch.Tensor, fs: float,
                    method: str = "butterworth", lowcut: float = 300.0,
                    highcut: float = 3400.0, filter_order: int = 101,
                    lfilter_method: str = "conv") -> torch.Tensor:
    """Bandpass / Wiener noise reduction with the reference's defaults
    (order-5 Butterworth or a 101-tap FIR, 300-3400 Hz; 3-sample
    Wiener).  ``lfilter_method`` realizes the Butterworth cascade
    (``filtfilt_sos``: 'conv', 'prefix' or 'scan'); the FIR is a
    convolution whatever it says."""
    nyquist = 0.5 * fs
    if method == "butterworth":
        sos = butter_bandpass_sos(5, lowcut / nyquist, highcut / nyquist)
        return filtfilt_sos(sos, signal, method=lfilter_method)
    if method == "fir":
        taps = firwin_bandpass(filter_order, lowcut / nyquist,
                               highcut / nyquist)
        return filtfilt(taps, (1.0,), signal, method=lfilter_method)
    if method == "wiener":
        return wiener(signal)
    raise ValueError("Unknown filter method. Available methods: "
                     "'butterworth', 'fir', 'wiener'")
