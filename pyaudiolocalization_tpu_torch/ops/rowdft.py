"""K10: the four-step row DFT on the tensor cores against butterfly stages.

The TPU package's A/B tool of FFT schedules (``tools/mxu_rowdft_bench.py``,
``_call`` :328) splits a length-N row, N = n2 * 128, into a plane
``x2d[q, p] = x[q*128 + p]`` of shape (n2, 128) and transforms it in four
steps: the length-n2 DFT along the rows of every lane, the long twiddle
``W_N^{p t}``, and the 128-point DFT along the lanes, so that plane
position [t, s] holds ``X[s*n2 + t]``.  It times the row DFT two ways
(butterfly stages, or a DFT-8 over the leading digit followed by one fused
(G, G) x (G, 128) matrix product per digit, G = n2 / 8) and three
granularities (the row DFT alone, one full forward, a GCC-like chain).

Three hand-written kernels (``csrc/rowdft.cu``) replace its bodies, each
one launch per transform on the shared FFT's on-chip stages
(``csrc/fft.cuh``'s ``block_fft``):

================= ===================================== ====================
wrapper           replaces (tools/mxu_rowdft_bench.py)  bound on an H100
================= ===================================== ====================
``row_dft``       ``_rowdft_kernel`` / ``_rowinv_kernel`` plane read + write
                  (:181, :192)                          (strips; radix-16
                                                        stages as W16
                                                        products, 3xTF32)
``row_stages``    ``_stages_kernel`` (:170)             plane read + write
                                                        (strips; float32
                                                        stages)
``lane_dft``      ``_lane_kernel`` (:317) and the       plane read + write
                  forward / chain glue (:198-314)       (32 rows a block;
                                                        float32 stages)
================= ===================================== ====================

The port keeps natural order everywhere: the TPU's permuted row orders
(``_t_perm``, bit reversal) are layout artifacts.  ``fft_four_step`` (the
full forward of ``_fwd_full_kernel`` / ``_fwd_mxu_kernel``) returns the
(B, N) spectrum in natural bin order, and ``chain`` (``_chain_*_kernel``)
runs wholly on the kernels: the cross spectrum and whitening are the lane
kernel's prologue, the real-part sum the row kernels' epilogue.  The
tool's chain feeds four scaled copies of one plane, so its output is ~3 N
at lag 0 and rounding noise elsewhere; ``chain`` also takes four planes of
their own, (4, B, n2, 128), which is what the checks feed it.  Rep chains
(``rep`` > 1, x1e-3 between transforms) chain in natural order.

Every wrapper checks float32, contiguity and n2 in {64, ..., 1024} (the
tool's range) and raises outside them (``lane_dft`` on CUDA also planes
that start on a 16-byte boundary, for its 16-byte loads), then takes the
plain twin (``*_plain``, ``torch.fft``) for CPU tensors and launches its
kernels for CUDA tensors, counting launches in ``cuda_fft.LAUNCHES``
under ``row_dft``, ``row_stages`` and ``lane_dft``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_fft as cf

N1 = 128
MIN_N2 = 64
MAX_N2 = 1024
CHAIN_EPS = 1e-6
# Kernel against twin on the card, relative to max|twin|.  Transforms: the
# kernels read 1.9e-7 to 6.5e-7 at rep 1 and up to 3.0e-6 after rep 8 on an
# H100; K10a's radix-16 products in TF32 without the data's low part give
# 2.3e-4 to 2.9e-4 and plain TF32 2.4e-4 to 3.6e-4 (the CPU emulation in
# tests/test_torch_rowdft.py; 3.0e-4 and 3.5e-4 on the card), both well
# over this limit.  The chain: the TPU tool's 2e-3.
TRANSFORM_TOL = 5e-5
CHAIN_TOL = 2e-3
CHAIN_PAIRS = ((0, 1), (2, 3), (0, 3))
SCHEDULES = {"mxu": "row_dft", "stages": "row_stages"}

Planes = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Host constants: float64, rounded once to float32.  The kernels' stage
# twiddles are ``cuda_fft._twiddles(n2)`` and ``cuda_fft._twiddles(128)``;
# K10a's W16 is made on the card (``kCos16``, csrc/rowdft.cu).
# ---------------------------------------------------------------------------

def _long_twiddle64(n2: int) -> np.ndarray:
    return np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(N1))
                  / (n2 * N1))


@functools.lru_cache(maxsize=16)
def long_twiddle(n2: int):
    """(n2, 128) long twiddle W_N^{p t} at [t, p], natural t, N = n2*128."""
    tw = _long_twiddle64(n2)
    return tw.real.astype(np.float32), tw.imag.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _long_twiddle_on(n2: int, device: str):
    """``long_twiddle(n2)`` on ``device`` as (re, im)."""
    return tuple(torch.from_numpy(a).to(device) for a in long_twiddle(n2))


# ---------------------------------------------------------------------------
# Plain twins (torch.fft), natural order, any float dtype.
# ---------------------------------------------------------------------------

def _complex(xr: torch.Tensor, xi: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.complex(xr, torch.zeros_like(xr) if xi is None else xi)


def _split(z: torch.Tensor) -> Planes:
    return z.real.contiguous(), z.imag.contiguous()


def _twiddle_c(n2: int, dtype, device) -> torch.Tensor:
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return torch.from_numpy(_long_twiddle64(n2)).to(device=device, dtype=cdt)


def row_dft_plain(xr: torch.Tensor, xi: Optional[torch.Tensor] = None,
                  inverse: bool = False, rep: int = 1,
                  zero_top: bool = False) -> Planes:
    """(B, rows, 128) planes -> the length-n2 DFT along axis 1 (n2 = rows,
    or 2 * rows with ``zero_top``: the upper rows are zero), unscaled when
    ``inverse``; ``rep`` transforms chained with x1e-3 between them."""
    n2 = xr.shape[1] * (2 if zero_top else 1)
    y = _complex(xr, xi)
    for it in range(rep):
        if it:
            y = y * 1e-3
        y = (torch.fft.ifft(y, n=n2, dim=1, norm="forward") if inverse
             else torch.fft.fft(y, n=n2, dim=1))
    return _split(y)


def _whitened_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * conj(b) over |a * conj(b)| + 1e-6 (PHAT, the tool's chain)."""
    r = a * torch.conj(b)
    mag = torch.sqrt(r.real * r.real + r.imag * r.imag) + CHAIN_EPS
    return torch.complex(r.real / mag, r.imag / mag)


def lane_dft_plain(xr: torch.Tensor, xi: Optional[torch.Tensor],
                   conj: bool = False, twiddle: bool = False,
                   cross: Optional[Planes] = None) -> Planes:
    """(B, n2, 128) planes -> the 128-point DFT along axis 2 (``conj``: with
    the conjugate matrix, unscaled).  ``cross``: planes b; the input is
    first replaced by the whitened cross spectrum x * conj(b) / (|.| +
    1e-6).  ``twiddle``: the long twiddle W_N^{p t} multiplies the input of
    a forward DFT, its conjugate the output of a conjugate one."""
    c = _complex(xr, xi)
    if cross is not None:
        c = _whitened_cross(c, _complex(*cross))
    tw = _twiddle_c(c.shape[1], xr.dtype, xr.device) if twiddle else None
    if not conj:
        return _split(torch.fft.fft(c if tw is None else c * tw, dim=2))
    z = torch.fft.ifft(c, dim=2, norm="forward")
    return _split(z if tw is None else z * tw.conj())


def fft_four_step_plain(x: torch.Tensor, zero_top: bool = False):
    """(B, rows, 128) real plane -> (B, N) complex spectrum of the row
    x[q*128 + p] = x2d[q, p], N = rows * 128 (2 * rows * 128 with
    ``zero_top``, the upper half zero), natural bin order."""
    n = x.shape[1] * N1 * (2 if zero_top else 1)
    return torch.fft.fft(x.reshape(x.shape[0], -1), n=n)


def chain_plain(x: torch.Tensor) -> torch.Tensor:
    """The GCC-like chain (``_chain_stages_kernel``): spectra of four
    inputs, x * (1 + 0.25 m), m < 4, for a (B, n2, 128) plane x (the
    tool's), or the four planes of a (4, B, n2, 128) x; for the pairs
    (0, 1), (2, 3), (0, 3) the cross spectrum a * conj(b) whitened by
    |.| + 1e-6 and inverted unscaled; the sum of the three real parts,
    (B, n2, 128) in natural time order."""
    shape = x.shape[-3:]
    if x.dim() == 4:
        flats = [x[m].reshape(shape[0], -1) for m in range(4)]
    else:
        flat = x.reshape(shape[0], -1)
        flats = [flat * (1.0 + 0.25 * m) for m in range(4)]
    specs = [torch.fft.fft(f) for f in flats]
    acc = torch.zeros_like(flats[0])
    for a, b in CHAIN_PAIRS:
        white = _whitened_cross(specs[a], specs[b])
        acc = acc + torch.fft.ifft(white, norm="forward").real
    return acc.reshape(shape)


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------

def _check(name: str, n2: int, *tensors: Optional[torch.Tensor]) -> None:
    if n2 < MIN_N2 or n2 > MAX_N2 or n2 & (n2 - 1):
        raise ValueError(f"{name}: n2 must be a power of two in "
                         f"[{MIN_N2}, {MAX_N2}], got {n2}")
    live = [t for t in tensors if t is not None]
    cf._check_f32(name, *live)
    cf._check_contiguous(name, *live)
    shape = live[0].shape
    for t in live:
        if t.dim() != 3 or t.shape[2] != N1 or t.shape != shape:
            raise ValueError(f"{name}: planes must be (B, rows, {N1}) and "
                             f"alike, got {tuple(t.shape)}")
    if shape[0] == 0 or shape[0] > cf._MAX_GRID_Y:
        raise ValueError(f"{name}: 1 to {cf._MAX_GRID_Y} planes, got "
                         f"{shape[0]}")


def _n2(x: torch.Tensor, zero_top: bool) -> int:
    return x.shape[1] * (2 if zero_top else 1)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _row_launch(kind: str, xr, xi, n2: int, inverse: bool, rep: int,
                scale: float, out_r=None, mode: int = 0,
                terms: int = 3) -> Planes:
    """One entry of K10a (``row_dft``) or K10b (``row_stages``).  mode 0
    returns new complex planes; 1 writes the real part into ``out_r``; 2
    adds it there.  ``terms``: K10a's TF32 products per real product, 3
    (3xTF32), or 2 (the data in TF32) and 1 (plain TF32) for the precision
    controls."""
    if rep < 1:
        raise ValueError(f"{kind}: rep must be >= 1, got {rep}")
    lib = cf._library()
    dev = xr.device
    planes = xr.shape[0]
    shape = (planes, n2, N1)
    if out_r is None:
        out_r = torch.empty(shape, dtype=torch.float32, device=dev)
    out_i = (torch.empty(shape, dtype=torch.float32, device=dev)
             if mode == 0 else None)
    # The planes between chained transforms, which run in place.
    scratch = ([torch.empty(shape, dtype=torch.float32, device=dev)
                for _ in range(2)] if rep > 1 else [None, None])
    args = (xr.data_ptr(), _ptr(xi), planes, n2, xr.shape[1], int(inverse),
            rep, scale, cf._twiddles(n2, str(dev)).data_ptr(),
            *[_ptr(s) for s in scratch], out_r.data_ptr(), _ptr(out_i), mode)
    if kind == "row_stages":
        cf._launch(kind, dev, lib.palt_row_stages, *args)
    else:
        cf._launch(kind, dev, lib.palt_row_dft, *args, terms)
    return out_r, out_i


def _lane_launch(ar, ai, br=None, bi=None, conj: bool = False,
                 twiddle: bool = False, natural: bool = False):
    """One entry of K10c; returns planes, or the (B, N) complex row in
    natural bin order when ``natural``."""
    lib = cf._library()
    dev = ar.device
    planes, n2, _ = ar.shape
    tw = _long_twiddle_on(n2, str(dev)) if twiddle else (None, None)
    out_r = out_i = out_nat = None
    if natural:
        out_nat = torch.empty((planes, n2 * N1), dtype=torch.complex64,
                              device=dev)
    else:
        out_r = torch.empty_like(ar)
        out_i = torch.empty_like(ar)
    cf._launch("lane_dft", dev, lib.palt_lane_dft, ar.data_ptr(), _ptr(ai),
               _ptr(br), _ptr(bi), planes, n2, CHAIN_EPS, int(conj),
               _ptr(tw[0]), _ptr(tw[1]),
               cf._twiddles(N1, str(dev)).data_ptr(), _ptr(out_r),
               _ptr(out_i), _ptr(out_nat))
    return out_nat if natural else (out_r, out_i)


def _schedule(name: str, schedule: str) -> str:
    if schedule not in SCHEDULES:
        raise ValueError(f"{name}: schedule must be one of "
                         f"{sorted(SCHEDULES)}, got {schedule!r}")
    return SCHEDULES[schedule]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def row_dft(xr: torch.Tensor, xi: Optional[torch.Tensor] = None,
            inverse: bool = False, rep: int = 1,
            zero_top: bool = False) -> Planes:
    """``row_dft_plain`` with its radix-16 stages on the tensor cores (K10a
    ``palt_row_dft``: K10b's strips and stages, each radix-16 stage a W16
    product in 3xTF32; one launch per transform).  ``xi=None`` marks a real
    input."""
    n2 = _n2(xr, zero_top)
    _check("row_dft", n2, xr, xi)
    if cf._use_plain(*[t for t in (xr, xi) if t is not None]):
        return row_dft_plain(xr, xi, inverse, rep, zero_top)
    return _row_launch("row_dft", xr, xi, n2, inverse, rep, 1.0)


def row_stages(xr: torch.Tensor, xi: Optional[torch.Tensor] = None,
               inverse: bool = False, rep: int = 1,
               zero_top: bool = False) -> Planes:
    """``row_dft_plain`` by butterfly stages on chip (K10b
    ``palt_row_stages``): one launch per transform, each block holding a
    strip of n2 rows x 16 lanes in shared memory for all of its radix-16
    Stockham stages."""
    n2 = _n2(xr, zero_top)
    _check("row_stages", n2, xr, xi)
    if cf._use_plain(*[t for t in (xr, xi) if t is not None]):
        return row_dft_plain(xr, xi, inverse, rep, zero_top)
    return _row_launch("row_stages", xr, xi, n2, inverse, rep, 1.0)


def lane_dft(xr: torch.Tensor, xi: torch.Tensor, conj: bool = False,
             twiddle: bool = False, cross: Optional[Planes] = None) -> Planes:
    """``lane_dft_plain`` on chip (K10c ``palt_lane_dft``: 32 rows a
    block, one radix-8 and one radix-16 float32 stage in shared memory;
    the whitened cross spectrum with ``cross`` and the long twiddle are its
    prologue, the conjugate twiddle its epilogue)."""
    live = (xr, xi) + (tuple(cross) if cross is not None else ())
    _check("lane_dft", xr.shape[1], *live)
    if cf._use_plain(*live):
        return lane_dft_plain(xr, xi, conj, twiddle, cross)
    if any(t.data_ptr() % 16 for t in live):
        raise ValueError("lane_dft: the kernel reads 16 bytes at a time; "
                         "planes must start on a 16-byte boundary")
    return _lane_launch(xr, xi, *(cross or (None, None)), conj=conj,
                        twiddle=twiddle)


def fft_four_step(x: torch.Tensor, schedule: str = "mxu",
                  zero_top: bool = False) -> torch.Tensor:
    """``fft_four_step_plain`` on the kernels: the row DFT of the real
    plane by ``schedule`` ("mxu": K10a, "stages": K10b), then K10c with the
    long-twiddle prologue and the natural-order epilogue."""
    kind = _schedule("fft_four_step", schedule)
    n2 = _n2(x, zero_top)
    _check("fft_four_step", n2, x)
    if cf._use_plain(x):
        return fft_four_step_plain(x, zero_top)
    yr, yi = _row_launch(kind, x, None, n2, False, 1, 1.0)
    return _lane_launch(yr, yi, twiddle=True, natural=True)


def chain(x: torch.Tensor, schedule: str = "mxu") -> torch.Tensor:
    """``chain_plain`` on the kernels: four forwards (row DFT by
    ``schedule`` with the input scale, K10c with the twiddle), then per
    pair K10c with the whitening prologue, the conjugate DFT and twiddle,
    and the inverse row DFT whose epilogue writes (first pair) or adds the
    real part."""
    kind = _schedule("chain", schedule)
    four = x.dim() == 4
    if four and x.shape[0] != 4:
        raise ValueError(f"chain: a 4-D input holds 4 planes, got "
                         f"{tuple(x.shape)}")
    inputs = list(x.unbind(0)) if four else [x] * 4
    n2 = x.shape[-2] if x.dim() >= 2 else 0
    _check("chain", n2, *inputs)
    if cf._use_plain(x):
        return chain_plain(x)
    specs = []
    for m, plane in enumerate(inputs):
        yr, yi = _row_launch(kind, plane, None, n2, False, 1,
                             1.0 if four else 1.0 + 0.25 * m)
        specs.append(_lane_launch(yr, yi, twiddle=True))
    out = torch.empty_like(inputs[0])
    for k, (a, b) in enumerate(CHAIN_PAIRS):
        er, ei = _lane_launch(*specs[a], *specs[b], conj=True, twiddle=True)
        _row_launch(kind, er, ei, n2, True, 1, 1.0, out_r=out,
                    mode=1 if k == 0 else 2)
    return out
