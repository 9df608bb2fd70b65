"""The port's hand-written CUDA kernels: wrappers, plain twins, build.

Nine kernels replace the Pallas kernels of the TPU package
(``pyaudiolocalization_tpu/ops/pallas_fft.py``, and ``pallas_kernels.py``
for K7):

===================== ====================================== ==================
wrapper               replaces                               bound on an H100
===================== ====================================== ==================
fft_real              bfly_fft_real (:685)                   memory: 2 or 3*
whitened_corr         bfly_whitened_corr (:707)              memory: 2 launches*
gcc_all_pairs         bfly_gcc_all_pairs (:922)              memory: 1 to 6*
gcc_windowed          bfly_gcc_windowed (:1095)              memory: 1 to 6*
bootstrap_peaks       bfly_bootstrap_peaks (:1227)           memory: 3 or 5*
noise_bootstrap_peaks bfly_noise_bootstrap_peaks (:1326)     memory: 3 or 5*
scene_windowed        bfly_scene_windowed (:1600)            memory: 2 to 16*
delay_sum             bfly_delay_sum (:1851)                 memory: 1 to 10*
whiten                pallas_kernels.phat_whiten_planes (:34) memory: 16 B/bin
===================== ====================================== ==================

(*) Above 2^24 points, to ``FFT_LONG_MAX`` (2^30), every transforming
kernel runs a three-pass split (``long_plan``: K4a 3 launches, K4b and
K6 5, K9 3, K1's and K2's GCC 6 through the mic rows' spectra, K3's
render 6 through the base rows' spectra); past it every wrapper raises.
K1, K2 and K5's GCC take one route a shape (``gcc_route``): 1 launch in
one block a scene, 3 with ``gcc_rows``, 4 through the mic rows' spectra
on the split, 2 through them in one block, 6 on the three-pass split.
K3's render and K5's render stage take one route a length
(``render_route``): 1 launch in one block, 3 with ``render_rows``, 4
through the base rows' spectra on the split, 6 on the three-pass split,
then the finish: 1 launch, a block a mic row, or up to 4 spread over the
card (``finish_groups``).

The three kernels of K10, the TPU package's A/B tool of FFT schedules
(``tools/mxu_rowdft_bench.py:328``), are wrapped by ``ops/rowdft.py``
(``row_dft``, ``row_stages``, ``lane_dft``) and built into the same
library from ``csrc/rowdft.cu``; their launches count here too.

All but ``whiten`` are built on one FFT (``csrc/fft.cuh``): every
transforming kernel (and K10's ``row_stages``) runs on-chip
sub-transforms: a block holds a strip of sequences in shared memory for
all of its radix-16 stages, and a long row is a four-step split of two such
launches (``fft_real_split``; the bootstrap, the render's ``render_rows``
and the GCCs' ``gcc_rows`` routes run it forward and back in three, the
middle launch holding rows for both directions; K9, whose input is
spectra, in two; the GCCs' spectra route K4a's two, then K9's two with a
pair-indexed loader, and the render's K4a's two into the base rows'
spectra, then a mix row pass and the column pass; up to 2^24 for all of
them, whose strips narrow to 8 at 2,048 and to 4 at 4,096,
``split_strips``; ``split_plan`` gives each launch of K4a's, K4b's and
K6's, ``spectra_plan`` each of the spectra routes', with the row strips'
bank-spread stride; above 2^24 every one of them takes rows of 2,048
points and splits the n1-point columns again into two passes of
16-column strips, ``long_plan``, the
row passes of K4b, K6, K9 and the spectra routes leaving their twiddle
to the inverse column passes), so a transform reads and writes each
point once per launch (16 bytes a complex point) and is bound by device
memory at that.  Up to 4,096 points the bootstraps, K9,
the render (a packed base row a block) and the all-pairs and windowed
GCCs (a scene a block up to 10 mics at 4,096, else a packed cross row a
block through the mic rows' spectra) hold a whole row in one block, so
K3 is one launch there, K2 one or two and K5 two or three.
The design keeps the rest of the work out of device memory where the TPU
kernels did: real rows are packed two to a complex transform, the whitening /
ramp synthesis runs in one pass over the spectra, two real results share
each inverse, and the bootstrap's maxima and the windowed GCC's lag
window and statistics are taken inside the last inverse pass instead of
writing the correlation.  The TPU kernels' bit-reversed (N2, 128) plane
layout is not carried over: spectra are in natural order.  The
all-pairs GCC, render, windowed-GCC and scene kernels take a leading
scene axis; a launch covers every scene, and a batch beyond the grids'
65,535 rows, or whose scratch would pass ``SPLIT_SCRATCH_BYTES``,
launches over scene chunks (``scene_chunk``, one rule for the four
kernels).  K4a, K4b, K6 and K9 take a batch of rows beyond their
grids in chunks of ``ROW_CHUNK`` rows, K4a, K4b and K6 also in chunks
whose scratch stays within ``SPLIT_SCRATCH_BYTES`` (``_launch_rows``).
Measurement noise and the noise-null bootstrap's rows come from a
counter-based Philox generator (``csrc/philox.cuh``, twin
``ops/noise.py``) in place of the TPU core's random bits.

Every wrapper takes the plain PyTorch twin (``*_plain``, same module, same
semantics, ``torch.fft``) for a tensor on the CPU, launches its kernel for
a CUDA tensor (or raises), and counts its launches in ``LAUNCHES``.  The
kernels take float32 only.  The library is compiled with ``nvcc`` from the
package's ``csrc/`` at first use into ``build/kernels/`` at the repository
root, keyed by a hash of the sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import noise as noise_ops
from . import signal as sig_ops

PHAT_EPS = 1e-10
# K4a: one block holds the packed row up to FFT_REAL_ONE_BLOCK; the
# four-step split of two on-chip transforms reaches 4096 x 4096
# (FFT_SPLIT_MAX, 2^24) for every transforming kernel (K4a, K4b, K6 and
# the spectra routes of K9, K1, K2, K3 and K5), with strips of 8 at 2,048
# and of 4 at 4,096 (``split_strips``); the split's long side is its
# columns (n1 >= n2) up to SPLIT_COLS_LONG_MAX and its contiguous rows
# above (``fft_real_split``); the row passes that hold more than one strip
# reach 1024 x 1024 (STAGE_SPLIT_MAX): the GCCs' ``gcc_rows`` route and
# the render's ``render_rows``, whose two strips fit to 2^19; elsewhere the
# GCCs go through their mic rows' spectra (``gcc_route``) and the render
# through its base rows' (``render_route``).  Above FFT_SPLIT_MAX, where
# a column strip of 4 and its tables would not fit a block (and 2 columns
# would read half a 32-byte sector of each row), every transforming kernel
# takes rows of LONG_N2 points and
# splits its columns again (``long_plan``) up to FFT_LONG_MAX (2^30): the
# largest nfft whose row and scratch fit the
# card (8 GiB a packed row at 2^30) and whose int n every entry point
# takes; every wrapper raises above it (``_check_pow2``).
FFT_REAL_ONE_BLOCK = 4096
SPLIT_COLS_LONG_MAX = 1 << 22
FFT_SPLIT_MAX = 1 << 24
FFT_LONG_MAX = 1 << 30
STAGE_SPLIT_MAX = 1 << 20
# Rows a split row pass holds (kStrip, csrc/fft.cuh), the strips the
# split may take, widest first (4 only above 2^22, 2 only above 2^24), the
# points one block's strip transform holds (kElems * 1024, ``block_fft``)
# and the shared memory one block may opt in to on an H100 (227 KB).
ROW_STRIP = 16
SPLIT_STRIPS = (16, 8, 4, 2)
BLOCK_POINTS = 16 * 1024
SMEM_OPTIN = 232448
# The three-pass split's row side (``fft_real_split`` above FFT_SPLIT_MAX):
# K4a's row pass holds 4 rows k1 and their partners there (strips of 8),
# so that its spectra go out in runs of 4 bins, whole 32-byte sectors; the
# row passes of K4b, K6, K9 and the spectra routes hold row k1 and its
# partner (LONG_ROW_STRIP), several blocks an SM (``long_plan``).  From
# HALF_MIN K4a transforms an odd last row (every one-row call) as one
# half-length complex row (``half_plan``; below it, where a launch's
# latency outweighs its bytes, the row packs with a zero row as before),
# on the three-pass split from HALF_LONG_MIN inner points, below
# FFT_SPLIT_MAX too: its row pass then holds 2,048-point rows.
LONG_N2 = 2048
LONG_ROW_STRIP = 2
HALF_MIN = 1 << 17
HALF_LONG_MIN = 1 << 23
# The spread finish (``finish_groups``): an H100's SMs, the blocks of
# 1,024 threads it aims for (two an SM) and the most blocks a packed mic
# row takes.
FINISH_SMS = 132
FINISH_BLOCKS = 2 * FINISH_SMS
FINISH_MAX_GROUPS = 128

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"fft_real": 0, "gcc_all_pairs": 0,
                            "gcc_windowed": 0, "bootstrap_peaks": 0,
                            "delay_sum": 0, "scene_windowed": 0,
                            "noise_bootstrap_peaks": 0, "whiten": 0,
                            "whitened_corr": 0, "row_dft": 0,
                            "row_stages": 0, "lane_dft": 0}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_MAX_GRID_Y = 65535
# Rows a launch of K4a, K4b, K6 or K9 takes: their grids' y extent is the
# packed row count (two rows a complex transform), at most 65,535.  Even,
# so that a longer batch packs its rows as one launch would.
ROW_CHUNK = 2 * _MAX_GRID_Y
# The scratch one launch of K4a, K4b or K6 may take (``_launch_rows``):
# 1,000 rows at 2^22 on the split (16.8 GB) keep one launch; 512 rows a
# launch at 2^23, 256 at 2^24, 128 at 2^25, 64 at 2^26, 32 at 2^27, 16 at
# 2^28 and 4 at 2^30.  The same cap
# holds a launch of K1, K2, K3 or K5 (``scene_chunk``): 8 scenes of 4
# mics at 2^25, 4 at 2^26.
SPLIT_SCRATCH_BYTES = 16 << 30
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled from "
                       f"{_CSRC} at first use and need the CUDA toolkit")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(_CSRC.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpalt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the kernel library unless the current sources' build exists.
    Returns the seconds spent compiling (0.0 when it was already built).
    The compiler's per-kernel register report goes to ``ptxas.log`` beside
    the library."""
    lib_path = _library_path()
    if lib_path.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_CSRC / "kernels.cu")]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    (BUILD_DIR / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return seconds


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_library_path()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        signatures = {
            "palt_fft_real": [p, i, i, i, i, i, i, i, i, p, p, p, p, p],
            "palt_noise_bootstrap_peaks": [p, p, i, i, i, i, i, i, i, f, p,
                                           p, p, p],
            "palt_whiten": [p, ctypes.c_longlong, f, p, p],
            "palt_whitened_corr": [p, p, i, i, i, i, i, i, p, f, p, p, p,
                                   p],
            "palt_gcc_all_pairs": [p, i, i, i, i, i, i, i, i, i, i, p, p, i,
                                   p, f, p, p, p, p, p, p],
            "palt_bootstrap_peaks": [p, p, i, i, i, i, i, i, i, f, p, p,
                                     p, p],
            "palt_gcc_windowed": [p, i, i, i, i, i, i, i, i, i, i, p, p, i,
                                  p, f, i, p, p, p, p, p, p, p, p, p, p],
            "palt_delay_sum": [p, i, i, p, p, i, i, i, i, i, p, i, p, p, p,
                               p, p, p, i, i, i, i, i, p, i, p, p, p],
            "palt_scene_windowed": [p, i, i, p, p, i, i, i, i, i, i, i, i, i,
                                    i, i, p, p, p, p, p, i, p, f, i, p, p, p,
                                    p, p, p, p, p, p, i, i, i, i, i, p, p, p,
                                    p],
            "palt_row_dft": [p, p, i, i, i, i, i, f, p, p, p, p, p, i, i,
                             p],
            "palt_row_stages": [p, p, i, i, i, i, i, f, p, p, p, p, p, i,
                                p],
            "palt_lane_dft": [p, p, p, p, i, i, f, i, p, p, p, p, p, p, p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _twiddle_lengths(nfft: int, three: bool = False):
    """The lengths L whose half tables ``_twiddles`` holds at nfft, in
    order: nfft, then on the split above 2^20 (``STAGE_SPLIT_MAX`` < nfft
    <= ``FFT_LONG_MAX``) its n1 and n2 (``fft_real_split``), and above
    ``FFT_SPLIT_MAX`` (or with ``three``, ``_long_twiddles``) the
    three-pass split's n1, n2, n1a and n1b (``three_pass_shape``)."""
    if three or nfft > FFT_SPLIT_MAX:
        n1a, n1b, n2 = three_pass_shape(nfft)
        return [nfft, n1a * n1b, n2, n1a, n1b]
    if nfft <= STAGE_SPLIT_MAX:
        return [nfft]
    return [nfft] + list(fft_real_split(nfft))


def tw3_sizes(nfft: int):
    """(entries, stride) of the three full-circle tables whose product is
    W_nfft^e on the three-pass split (``Tw3`` in ``csrc/kernels.cu``): with
    L = log2(nfft) and b = ceil(L / 3), T0[r] = W^r and T1[r] = W^(r 2^b)
    for r < 2^b, T2[r] = W^(r 2^2b) for r < 2^max(L - 2b, 0): at most
    1,024 entries each (2^30), 1,536 in all at 2^27, staged in shared
    memory by pass B."""
    bits = nfft.bit_length() - 1
    b = (bits + 2) // 3
    return [(1 << b, 1), (1 << b, 1 << b),
            (1 << max(bits - 2 * b, 0), 1 << (2 * b))]


# Entries of a half table ``_twiddles`` makes at a time in float64, on up
# to ``_TABLE_THREADS`` host threads (numpy's cos and sin release the GIL;
# a 2^30-point table's n-point part holds 2^29 entries).
_TABLE_CHUNK = 1 << 22
_TABLE_THREADS = 8


def _half_table_part(n: int, m0: int, m1: int, step: int = 1) -> np.ndarray:
    """Entries m0 .. m1 - 1 of the n-point half table exp(-2 pi i m / n)
    (with ``step``, of exp(-2 pi i step m / n)), made in float64 and
    rounded once to float32, the exact zeros of cos and sin kept exact:
    (m1 - m0, 2)."""
    ang = -2.0 * np.pi * (np.arange(m0, m1) * step % n) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], -1)
    tw[np.abs(tw) < 1e-12] = 0.0
    return tw.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table(nfft: int, three: bool, device: str) -> torch.Tensor:
    """The table of ``_twiddles`` (three = nfft > ``FFT_SPLIT_MAX``) or of
    ``_long_twiddles`` (three = True) at nfft."""
    from concurrent.futures import ThreadPoolExecutor
    spans = [(n, n // 2, 1) for n in _twiddle_lengths(nfft, three)]
    if three:
        spans += [(nfft, count, step) for count, step in tw3_sizes(nfft)]
    parts = [(n, m0, min(m0 + _TABLE_CHUNK, count), step)
             for n, count, step in spans
             for m0 in range(0, count, _TABLE_CHUNK)]
    starts = np.cumsum([0] + [m1 - m0 for _, m0, m1, _ in parts])
    table = np.empty((starts[-1], 2), np.float32)

    def make(i):
        table[starts[i]:starts[i + 1]] = _half_table_part(*parts[i])

    with ThreadPoolExecutor(min(_TABLE_THREADS, len(parts))) as pool:
        list(pool.map(make, range(len(parts))))
    return torch.from_numpy(table).to(device)


def _twiddles(nfft: int, device: str) -> torch.Tensor:
    """exp(-2*pi*i*m/nfft), m < nfft/2, made in float64 and rounded once to
    float32, as a (nfft/2, 2) tensor; the exact zero of cos at m = nfft/4
    is kept exact.  On the split above 2^20 the half tables of n1 and n2
    follow (``_twiddle_lengths``), made the same way: entry q of the
    L-point table is entry q * nfft / L of the first, bit for bit (the
    angles differ by powers of two), read contiguously by the split
    kernels (``stage_split_twiddles`` and ``stage_split_tables_of`` in
    ``csrc/kernels.cu``).  On the three-pass split (above
    ``FFT_SPLIT_MAX``) ``_long_twiddles``' table.  Each entry is made as it
    would be made alone, in parts of ``_TABLE_CHUNK`` entries on host
    threads (``_table``, cached)."""
    return _table(nfft, nfft > FFT_SPLIT_MAX, device)


def _long_twiddles(nfft: int, device: str) -> torch.Tensor:
    """The table of the three-pass split at nfft (``three_pass_shape``), as
    ``long_tables`` in ``csrc/kernels.cu`` reads it: the nfft-, n1-, n2-,
    n1a- and n1b-point half tables, then the three tables of
    ``tw3_sizes`` (pass B's W_nfft^e).  ``_twiddles`` above
    ``FFT_SPLIT_MAX``; K4a's half-length transform from ``HALF_LONG_MIN``
    too."""
    return _table(nfft, True, device)


def _check_pow2(nfft: int) -> None:
    if nfft < 4 or nfft & (nfft - 1) or nfft > FFT_LONG_MAX:
        raise ValueError(f"nfft must be a power of two from 4 to 2^30 "
                         f"(FFT_LONG_MAX), got {nfft}")


def _check_contiguous(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_f32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got {t.dtype}")


def _use_plain(*tensors: torch.Tensor) -> bool:
    # Plain loops over the tensors' flags: this runs on every call.
    if tensors[0].is_cuda:
        for t in tensors:
            if not t.is_cuda:
                break
        else:
            return False
    elif tensors[0].is_cpu:
        for t in tensors:
            if not t.is_cpu:
                break
        else:
            return True
    devices = sorted({t.device.type for t in tensors})
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got "
                     f"{devices}")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def _launch(name: str, device: torch.device, entry, *args) -> None:
    """Counts one launch of ``name`` in ``LAUNCHES`` and calls the library
    entry ``entry(*args, stream)`` on ``device``'s current stream; raises
    on the CUDA error it returns.  The stream is the raw pointer (no
    ``torch.cuda.Stream`` object is built), and the device guard is
    entered only where ``device`` is not the current device: a one-row
    call's host time is most of its time on the card."""
    index = device.index
    LAUNCHES[name] += 1
    # A CUDA tensor exists, so torch has initialised CUDA: the current
    # device is read without torch.cuda.current_device()'s lazy-init check.
    if index == torch._C._cuda_getDevice():
        err = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    _raise_on(name, err)


def _scratch(rows: int, nfft: int, device) -> torch.Tensor:
    return torch.empty((rows, nfft, 2), dtype=torch.float32, device=device)


def _row_chunks(rows: int, chunk: int = ROW_CHUNK):
    """(first, last) row of each launch over ``rows`` rows (``chunk`` at a
    time)."""
    return [(r0, min(r0 + chunk, rows)) for r0 in range(0, rows, chunk)]


def _launch_rows(n1: int, nfft: int) -> int:
    """Rows a launch of K4a, K4b or K6 takes on schedule n1 at nfft:
    ``ROW_CHUNK``, and on the split, whose scratch is one buffer of packed
    rows (``_pass_scratch``), at most as many as keep it within
    ``SPLIT_SCRATCH_BYTES``, an even count.  Each packed row pair is
    transformed on its own and each K6 draw keyed by its own seed words,
    so the chunks give one launch's bits."""
    if n1 == 1:
        return ROW_CHUNK
    packed = SPLIT_SCRATCH_BYTES // (nfft * 8)
    return max(2, min(ROW_CHUNK, 2 * packed))


def _split_n1(nfft: int) -> int:
    """n1 of K4a's, K4b's and K6's schedule at nfft: 1, one block, up to
    ``FFT_REAL_ONE_BLOCK``; the four-step split of ``fft_real_split``
    above, its n1-point columns split again into two passes above
    ``FFT_SPLIT_MAX`` (2^24, ``long_plan``)."""
    return fft_real_split(nfft)[0]


def _long_n1a(nfft: int) -> int:
    """n1a of the three-pass split (``long_plan``) above ``FFT_SPLIT_MAX``,
    as the entry points of every transforming kernel take it; 0 below."""
    return long_plan(nfft).n1a if nfft > FFT_SPLIT_MAX else 0


def corr_schedule(nfft: int) -> int:
    """n1 of K9's schedule at nfft, K4a's (``_split_n1``): 1, one block a
    packed row (``corr_block``), up to ``FFT_REAL_ONE_BLOCK``; the split
    to ``FFT_SPLIT_MAX`` (the spectra routes' last two launches,
    ``spectra_plan``); the three-pass split above (``corr_rows_long``, B'
    and A' with the correlations, ``long_plan``)."""
    return _split_n1(nfft)


def _corr_strips(nfft: int):
    """(column strip, row strip) of K9's schedule at nfft: (0, 0) in one
    block, ``spectra_plan``'s column and row passes' to 2^24, ``long_plan``'s
    ``corr_cols`` and ``corr_rows`` above."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return 0, 0
    if nfft > FFT_SPLIT_MAX:
        plan = long_plan(nfft)
        return plan.corr_cols.strip, plan.corr_rows.strip
    plan = spectra_plan(nfft)
    return plan.spec_cols.strip, plan.spec_rows.strip


def _split_strips(n1: int, nfft: int):
    """The strips (columns, rows) K4b's and K6's schedule n1 passes to
    its entry point: ``split_strips``' columns and ``boot_strip``'s rows
    on the split up to ``FFT_SPLIT_MAX``, above it the column passes' and
    ``boot_rows_long``'s (``long_plan``), (0, 0) (unused) in one block."""
    if n1 == 1:
        return 0, 0
    if nfft > FFT_SPLIT_MAX:
        plan = long_plan(nfft)
        return plan.cols_a.strip, plan.boot_rows.strip
    n2 = nfft // n1
    return split_strips(n1, n2)[0], boot_strip(n1, n2)


def _pass_scratch(n1: int, packed: int, nfft: int, device):
    """The scratch of K4a's, K4b's, K6's and K9's schedule n1 for
    ``packed`` packed rows: none in one block, one buffer on the split."""
    return None if n1 == 1 else _scratch(packed, nfft, device)


def band_mask(nfft: int, band, fs: Optional[float], dtype=torch.float32,
              device=None) -> torch.Tensor:
    """(nfft//2 + 1,) band-limited PHAT mask over rfft bins (ones for
    ``band=None``), the same bins as ops/gccphat of the TPU package."""
    if band is None:
        mask = np.ones(nfft // 2 + 1)
    else:
        if fs is None:
            raise ValueError("band-limited PHAT requires fs")
        freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
        mask = (freqs >= band[0]) & (freqs <= band[1])
    return torch.as_tensor(mask, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# K4a: forward spectrum of real rows
# ---------------------------------------------------------------------------

def fft_real_plain(x: torch.Tensor, nfft: int) -> torch.Tensor:
    return torch.fft.rfft(x, n=nfft)


def fft_real_split(nfft: int):
    """(n1, n2) of the four-step split nfft = n1 * n2 of every transforming
    kernel (K4a's passes, K4b's, K6's and the spectra routes'): (1, nfft)
    up to ``FFT_REAL_ONE_BLOCK`` (one block holds the packed row); up to
    ``SPLIT_COLS_LONG_MAX`` (2^22) the long side in the columns, n2 =
    2^floor(log2(nfft) / 2) and n1 = nfft / n2 >= n2: both at most 1024 up
    to ``STAGE_SPLIT_MAX`` (2^20), 2048 x 1024 at 2^21 and 2048 x 2048 at
    2^22, where the strips narrow to 8 (``split_strips``); above, the long
    side goes to the contiguous rows, n1 = 2^floor(log2(nfft) / 2) <= n2:
    2048 x 4096 at 2^23 (column strips of 8 still read 64 bytes a row, row
    strips of 4) and 4096 x 4096 at ``FFT_SPLIT_MAX`` (2^24: strips of 4,
    one 32-byte sector a row).  ``SPLIT_COLS_LONG_MAX`` picks only that
    orientation:
    every transforming kernel runs the split up to ``FFT_SPLIT_MAX``.
    Above, to ``FFT_LONG_MAX`` (2^30), the three-pass split of every
    transforming kernel takes rows of ``LONG_N2`` = 2,048 points (K4a's row
    pass holds 4 rows k1 and their partners, ``BLOCK_POINTS``, and writes
    its spectra in runs of 4 bins) and n1 = nfft / 2,048, 65,536 at 2^27
    to 2^19 at 2^30, whose columns ``long_plan`` splits again."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return 1, nfft
    if nfft > FFT_SPLIT_MAX:
        if nfft > FFT_LONG_MAX:
            raise ValueError(f"fft_real_split: nfft {nfft} passes "
                             f"FFT_LONG_MAX (2^30)")
        return nfft // LONG_N2, LONG_N2
    short = 1 << ((nfft.bit_length() - 1) // 2)
    if nfft > SPLIT_COLS_LONG_MAX:
        return short, nfft // short
    return nfft // short, short


def fft_real_rows_strip(n2: int, packed: int) -> int:
    """Rows a block of K4a's second pass holds, half of them the partners
    n1 - k1 of the other half; its output runs of consecutive bins are half
    as long.  64 (n2 <= 256) or 32 (n2 <= 512), the most one block's shared
    memory holds, where there are enough packed rows (>= 64) that fewer
    blocks still fill the card; where 16 rows would pass ``BLOCK_POINTS``
    the most it holds, 8 at n2 = 2,048 (2^22), 4 at 4,096 (2^23, 2^24) and
    8 at 2,048 on the three-pass split; else 16 (a single
    row's call is bound by latency, not bytes)."""
    if n2 * ROW_STRIP > BLOCK_POINTS:
        return BLOCK_POINTS // n2
    if packed < 64 or n2 > 512:
        return 16
    return 64 if n2 <= 256 else 32


def _row_pass_smem(n1: int, n2: int, strips: int,
                   strip: int = ROW_STRIP) -> int:
    """Bytes of shared memory of a split row pass (``render_rows``,
    ``gcc_rows``, ``boot_rows``) that holds ``strips`` strips of ``strip``
    rows of n2 points (sequence stride n2 + 1) and the twiddle tables (n2/2
    + n1 + n2 complex)."""
    return 8 * (n2 // 2 + n1 + n2 + strips * strip * (n2 + 1))


def split_strips(n1: int, n2: int):
    """(columns a strip of a column pass holds, rows a strip of the spectra
    routes' row pass holds) on the split n1 x n2 (K4a's, K4b's, K6's and
    the spectra routes'): for each, the widest of ``SPLIT_STRIPS`` (16, 8,
    4, 2) whose strip holds at most ``BLOCK_POINTS`` points
    (``block_fft``'s kElems x 1024) and whose pass fits one block's shared
    memory (``SMEM_OPTIN``): the column pass's n1/2 sub-twiddles, n1 + n2
    split tables and n1 x S strip (``fft_real_cols``; ``boot_cols`` holds
    less), and ``_row_pass_smem`` of one strip with those tables
    (``corr_rows``, ``render_spec_rows``; K4a's own row pass takes
    ``fft_real_rows_strip``, K4b's and K6's ``boot_strip``).  (16, 16) up
    to 1024 x 1024, so every shape up to 2^20 keeps its strips; (8, 16) at
    2048 x 1024 (2^21) and (8, 8) at 2048 x 2048 (2^22): 164-172 KB a
    block; (8, 4) at 2048 x 4096 (2^23: 188,416 and 196,640 bytes) and
    (4, 4) at 4096 x 4096 (2^24: 212,992 and 213,024), whose column
    strips read one 32-byte sector a row.  Past 2^24 a column pass's
    tables and a strip of 4 columns would not fit a block (the three-pass
    split takes over, ``long_plan``)."""
    where = f"the split {n1} x {n2}"
    return (_widest(n1, lambda s: 8 * (n1 // 2 + n1 + n2 + n1 * s), where),
            _widest(n2, lambda s: _row_pass_smem(n1, n2, 1, s), where))


def boot_strip(n1: int, n2: int) -> int:
    """Rows a strip of K4b's and K6's row pass (``boot_rows``) holds on
    the split n1 x n2: 16 at n2 <= 256 (two blocks of 256 threads an SM),
    else the widest of ``SPLIT_STRIPS`` of at most ``BLOCK_POINTS`` / 2
    points, so that its fft_threads are at most 512 with up to 128
    registers each and no spill (16 rows at n2 = 512, 8 at 1,024, 4 at
    2,048, 2 at 4,096), whose pass fits a block's shared memory."""
    if n2 <= 256:
        return ROW_STRIP
    for strip in SPLIT_STRIPS:
        if (n2 * strip <= BLOCK_POINTS // 2
                and _row_pass_smem(n1, n2, 1, strip) <= SMEM_OPTIN):
            return strip
    raise ValueError(f"no strip of {SPLIT_STRIPS} fits boot_rows at "
                     f"{n1} x {n2}")


def _widest(length: int, smem, where: str) -> int:
    """The widest of ``SPLIT_STRIPS`` whose strip of sequences of
    ``length`` points holds at most ``BLOCK_POINTS`` points and whose pass
    takes at most ``SMEM_OPTIN`` bytes (``smem(strip)``)."""
    for strip in SPLIT_STRIPS:
        if length * strip <= BLOCK_POINTS and smem(strip) <= SMEM_OPTIN:
            return strip
    raise ValueError(f"no strip of {SPLIT_STRIPS} fits {where}")


class SplitPass(NamedTuple):
    """One launch of the split (``split_plan``): the strip a block holds
    (columns of a column pass, rows of a row pass) and its bytes of
    dynamic shared memory."""
    strip: int
    smem: int


class SplitPlan(NamedTuple):
    """The launches of K4a's, K4b's and K6's split at one shape
    (``split_plan``): K4a's pass 1 (``fft_real_cols``, also the first
    pass of K4b, K6 and the spectra routes), K4a's pass 2
    (``fft_real_rows``), and K4b's and K6's row pass (``boot_rows``) and
    last column pass (``boot_cols``)."""
    cols: SplitPass
    rows: SplitPass
    boot_rows: SplitPass
    boot_cols: SplitPass


def row_ld(strip: int, n2: int) -> int:
    """The sequence stride (complex points) of a strip of ``strip`` rows of
    n2 points in K4a's pass 2 and K4b's and K6's row pass (``row_ld`` in
    ``csrc/kernels.cu``): n2 + 16 / strip up to 16 rows, so that a
    half-warp's 16 threads fall in distinct shared-memory bank pairs,
    n2 + 1 above."""
    return n2 + (16 // strip if strip < 16 else 1)


def split_plan(nfft: int, packed: int = 1) -> SplitPlan:
    """Each launch of the split at nfft (8,192 to ``FFT_SPLIT_MAX``) for
    ``packed`` packed rows a launch: its strip (``split_strips``,
    ``fft_real_rows_strip``) and shared memory a block (the kernels' byte
    counts; K4a's pass 2 and K4b's and K6's row pass hold their rows at
    the stride ``row_ld``).  Every block holds at most ``BLOCK_POINTS``
    points in at most ``SMEM_OPTIN`` bytes, and no launch takes a
    thread-block cluster: clusters that read whole sectors of each row
    measured 30-40 % slower on an H100 (PERF.md).  K4b's and K6's row pass
    holds ``boot_strip``'s rows in at most 512 threads above n2 = 256
    (``boot_rows_launch``)."""
    n1, n2 = fft_real_split(nfft)
    if n1 == 1 or nfft > FFT_SPLIT_MAX:
        raise ValueError(f"split_plan: nfft {nfft} is not on the split")
    cs = split_strips(n1, n2)[0]
    rs = boot_strip(n1, n2)
    s2 = fft_real_rows_strip(n2, packed)
    return SplitPlan(
        SplitPass(cs, 8 * (n1 // 2 + n1 + n2 + n1 * cs)),
        SplitPass(s2, 8 * (n2 // 2 + s2 * row_ld(s2, n2))),
        SplitPass(rs, 8 * (n2 // 2 + n1 + n2 + rs * row_ld(rs, n2))),
        SplitPass(cs, 8 * (n1 // 2 + n1 * cs) + 128))


class SpectraPlan(NamedTuple):
    """The launches of the spectra routes at one shape (``spectra_plan``):
    K4a's two passes into the spectra (``cols``, ``rows``; not K9's, whose
    input is spectra), the row pass that forms each packed row from the
    spectra (``spec_rows``: ``corr_rows`` for K9 and the GCCs of K1, K2
    and K5, ``render_spec_rows`` for the renders of K3 and K5) and the
    inverse column pass (``spec_cols``: ``corr_cols``, ``window_cols``,
    ``render_cols``)."""
    cols: SplitPass
    rows: SplitPass
    spec_rows: SplitPass
    spec_cols: SplitPass


def spectra_plan(nfft: int, packed: int = 1) -> SpectraPlan:
    """Each launch of the spectra routes at nfft (8,192 to
    ``FFT_SPLIT_MAX``, 2^24) for ``packed`` packed rows in K4a's passes:
    K4a's two (``split_plan``'s ``cols`` and ``rows``); the row pass, one
    strip of ``split_strips``' rows at the bank-spread stride ``row_ld``
    with the n1- and n2-point tables (n2/2 + n1 + n2 complex: 213,120
    bytes at 2^24, strips of 4 rows); the column pass, ``split_strips``'
    columns and the n1/2 sub-twiddles (``window_cols`` adds 257 static
    bytes; 4 columns at n1 = 4,096, 147,456 bytes).  Above 2^20 these
    kernels read their tables from the contiguous copies of
    ``_twiddles``; the row pass keeps ``fft_threads`` = 1,024 threads a
    block there (512 of twice the points measured 3-12 % slower on an
    H100; PERF.md).  Above 2^24 ``split_plan`` raises: every transforming
    kernel runs ``long_plan``'s split there."""
    plan = split_plan(nfft, packed)
    n1, n2 = fft_real_split(nfft)
    cs, rs = split_strips(n1, n2)
    return SpectraPlan(plan.cols, plan.rows,
                       SplitPass(rs, 8 * (n2 // 2 + n1 + n2
                                          + rs * row_ld(rs, n2))),
                       SplitPass(cs, 8 * (n1 // 2 + n1 * cs)))


class LongPlan(NamedTuple):
    """The launches of the three-pass split above ``FFT_SPLIT_MAX``
    (``long_plan``): the factors n1 = n1a * n1b of its columns; pass A
    (``long_cols_a``, and mirrored with the maxima ``long_cols_max``,
    which holds 128 bytes more); pass B (``long_cols_b``, forward and
    back); K4a's row pass (``fft_real_rows``) and K4b's and K6's
    (``boot_rows_long``); the row pass of K9's and the GCCs' back half
    (``corr_rows_long``), and of the render (``render_spec_rows_long``),
    and pass A mirrored with the correlations, the window or the
    render's inverse (``long_cols_corr``, ``long_cols_window``,
    ``long_cols_render``)."""
    n1a: int
    n1b: int
    cols_a: SplitPass
    cols_b: SplitPass
    rows: SplitPass
    boot_rows: SplitPass
    corr_rows: SplitPass
    corr_cols: SplitPass


def three_pass_shape(nfft: int):
    """(n1a, n1b, n2) of the three-pass split at nfft: rows of n2 =
    ``LONG_N2`` points and n1 = nfft / n2 = n1a * n1b, n1a =
    2^ceil(log2(n1) / 2): 256 x 256 x 2,048 at 2^27, 512 x 256 at 2^28,
    512 x 512 at 2^29, 1,024 x 512 at 2^30, 256 x 128 at 2^26."""
    n1 = nfft // LONG_N2
    n1a = 1 << (n1.bit_length() // 2)
    return n1a, n1 // n1a, LONG_N2


def _three_pass_plan(nfft: int, packed: int) -> LongPlan:
    """``long_plan``'s launches at any nfft of ``three_pass_shape``."""
    n1a, n1b, n2 = three_pass_shape(nfft)

    def cols_smem(length, strip):
        return 8 * (length // 2 + length * strip)

    where = f"the three-pass split {n1a} x {n1b} x {n2}"
    tw3 = sum(count for count, _ in tw3_sizes(nfft))
    cs = min(_widest(n1a, lambda s: cols_smem(n1a, s) + 128, where),
             _widest(n1b, lambda s: cols_smem(n1b, s) + 8 * tw3, where))
    s2 = fft_real_rows_strip(n2, packed)

    def rows_smem(strip):
        return 8 * (n2 // 2 + strip * row_ld(strip, n2))

    rs = LONG_ROW_STRIP
    cols_a = SplitPass(cs, cols_smem(n1a, cs))
    return LongPlan(n1a, n1b, cols_a,
                    SplitPass(cs, cols_smem(n1b, cs) + 8 * tw3),
                    SplitPass(s2, rows_smem(s2)), SplitPass(rs, rows_smem(rs)),
                    SplitPass(rs, rows_smem(rs)), cols_a)


def long_plan(nfft: int, packed: int = 1) -> LongPlan:
    """Each launch of the three-pass split of every transforming kernel at
    nfft (``FFT_SPLIT_MAX`` < nfft <= ``FFT_LONG_MAX``: 2^26 to 2^30) for
    ``packed`` packed rows a launch.  The split's n1 x n2
    (``fft_real_split``: n2 = ``LONG_N2`` = 2,048) with n1 = n1a * n1b
    (``three_pass_shape``).  The column passes' strip is the widest of
    ``SPLIT_STRIPS`` that both passes hold within ``BLOCK_POINTS`` points
    and ``SMEM_OPTIN`` bytes (their n1a/2 or n1b/2 sub-twiddles and the
    strip; ``long_cols_max`` 128 bytes more, pass B the three tables of
    ``tw3_sizes``): 16 columns, 128 bytes of each row read or written, at
    every length.  K4a's row
    pass ``fft_real_rows`` holds ``fft_real_rows_strip``'s 8 rows (4 rows
    k1 and their partners) at the stride ``row_ld``, 139,392 bytes, and
    writes runs of 4 bins; ``boot_rows_long``, ``corr_rows_long`` and
    ``render_spec_rows_long`` hold ``LONG_ROW_STRIP`` = 2 rows (row k1 and
    its partner) in 256 threads, 41,088 bytes (no n1- or n2-point table:
    pass B' takes the inverse twiddle), several blocks an SM;
    ``long_cols_corr``, ``long_cols_window`` and ``long_cols_render`` pass
    A's strip and bytes."""
    if not FFT_SPLIT_MAX < nfft <= FFT_LONG_MAX:
        raise ValueError(f"long_plan: nfft {nfft} is not on the three-pass "
                         f"split")
    return _three_pass_plan(nfft, packed)


class HalfPlan(NamedTuple):
    """K4a's half-length transform of one real row at nfft (``half_plan``):
    the inner length m = nfft / 2 and, as ``palt_fft_real`` takes them,
    n1 (1 in one block), the column strip, the row pass's strip and n1a
    (0 off the three-pass split)."""
    m: int
    n1: int
    cols: int
    rows: int
    n1a: int


def half_plan(nfft: int) -> HalfPlan:
    """The schedule of K4a's odd last row at nfft (from ``HALF_MIN`` in
    ``fft_real``; past 2 ``FFT_REAL_ONE_BLOCK`` to ``FFT_LONG_MAX``
    here): z[t] = x[2t] + i x[2t + 1], t < m = nfft / 2, transformed as
    one m-point complex row, the real spectrum X[k] = E[k] + W_nfft^k
    O[k] (E, O the spectra of the even and odd samples, split from Z[k]
    and Z[m - k]) in the row pass's epilogue: on m's split
    (``split_plan(m, 1)``) below ``HALF_LONG_MIN``; from it on m's
    three-pass split (``_three_pass_plan(m, 1)``, 2,048-point rows whose
    row pass writes runs of 4 bins).  Half the points of the packed row
    that one real row would take, in the launches of the packed row's
    schedule at m."""
    m = nfft // 2
    if m <= FFT_REAL_ONE_BLOCK:
        raise ValueError(f"half_plan: nfft {nfft} is not past one block")
    if m < HALF_LONG_MIN:
        plan = split_plan(m, 1)
        return HalfPlan(m, fft_real_split(m)[0], plan.cols.strip,
                        plan.rows.strip, 0)
    plan = _three_pass_plan(m, 1)
    return HalfPlan(m, m // LONG_N2, plan.cols_a.strip, plan.rows.strip,
                    plan.n1a)


@functools.lru_cache(maxsize=8)
def _half_post(nfft: int, device: str) -> torch.Tensor:
    """The table of the half-length transform's epilogue on the split and
    the three-pass split at nfft (``half_plan``; n1 x n2 = m's): W_nfft^k1
    for k1 < n1, then W_(2 n2)^k2 for k2 < n2, so that W_nfft^k = W^k1 *
    W_(2 n2)^k2 at k = k1 + n1 k2 < m; each entry made in float64 and
    rounded once (``_half_table_part``)."""
    plan = half_plan(nfft)
    n2 = plan.m // plan.n1
    table = np.concatenate([_half_table_part(nfft, 0, plan.n1),
                            _half_table_part(2 * n2, 0, n2)])
    return torch.from_numpy(table).to(device)


def _gcc_block_smem(nfft: int, mics: int) -> int:
    """Bytes of shared memory of a scene's GCC in one block (``gcc_block``,
    ``window_block``): the nfft/2 twiddles, the (mics + 1) // 2 packed mic
    rows a scene's mics can span and one spare row."""
    return 8 * (nfft // 2 + ((mics + 1) // 2 + 1) * nfft)


class GccRoute(NamedTuple):
    """The route of K1's, K2's and K5's GCC, or of K3's and K5's render, at
    one shape (``gcc_route``, ``render_route``): ``kind`` (``ROUTE_*``, the
    kernels' ``GccRoute``), ``n1`` (1 in one block, else the split's n1)
    and, on the spectra and three-pass routes, the strips of the column
    passes and the row pass (0 elsewhere)."""
    kind: int
    n1: int
    cols: int
    rows: int


(ROUTE_BLOCK, ROUTE_ROWS, ROUTE_SPECTRA, ROUTE_SPECTRA_BLOCK,
 ROUTE_LONG) = range(1, 6)
ROUTE_NAMES = {ROUTE_BLOCK: "block", ROUTE_ROWS: "rows",
               ROUTE_SPECTRA: "spectra", ROUTE_SPECTRA_BLOCK: "spectra block",
               ROUTE_LONG: "long"}


def gcc_route(nfft: int, mics: int) -> GccRoute:
    """The GCC route of K1, K2 and K5's GCC stage for ``mics`` mics a
    scene at nfft, one rule for the three (so that K5 and K3 then K2
    compute the same bits):

    - up to ``FFT_REAL_ONE_BLOCK`` (4,096), one block a scene
      (``gcc_block``, ``window_block``) where a scene's packed mic rows
      and a spare row fit (``_gcc_block_smem``: up to 10 mics at 4,096, 24
      at 2,048), else one block a packed cross row through the mic rows'
      spectra (K4a's ``fft_real_block``, then ``corr_block``);
    - up to ``STAGE_SPLIT_MAX`` (2^20), the four-step split nfft = n1 *
      n2 of ``fft_real_split`` with ``gcc_rows`` where its strips, one for
      each packed mic row a scene's mics can span ((mics + 1) // 2) and
      one for the output, fit one block's shared memory (``SMEM_OPTIN``);
      never at 2^20, where two strips of 16 x 1,025 points pass it;
    - elsewhere up to ``FFT_SPLIT_MAX`` (2^24), the split through the mic
      rows' spectra at any mic count (K4a's two passes, ``corr_rows`` with
      the pair-indexed loader, ``corr_cols`` or ``window_cols``), with the
      strips of ``spectra_plan``: 16 and 16 up to 2^20, 8 columns from n1
      = 2,048 and 8 rows at n2 = 2,048, 4 rows at n2 = 4,096 (2^23), 4
      columns at n1 = 4,096 (2^24);
    - above, to ``FFT_LONG_MAX`` (2^30), the three-pass split through the
      mic rows' spectra at any mic count (``ROUTE_LONG``: K4a's passes A,
      B and ``fft_real_rows`` into the spectra, ``corr_rows_long`` with
      the pair-indexed loader, B' and ``long_cols_corr`` or
      ``long_cols_window``), with ``long_plan``'s column strip (16) and
      ``corr_rows`` strip (2); past it ``fft_real_split`` raises."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        if _gcc_block_smem(nfft, mics) <= SMEM_OPTIN:
            return GccRoute(ROUTE_BLOCK, 1, 0, 0)
        return GccRoute(ROUTE_SPECTRA_BLOCK, 1, 0, 0)
    n1, n2 = fft_real_split(nfft)
    if nfft > FFT_SPLIT_MAX:
        return _long_route(nfft)
    if (nfft <= STAGE_SPLIT_MAX
            and _row_pass_smem(n1, n2, (mics + 1) // 2 + 1) <= SMEM_OPTIN):
        return GccRoute(ROUTE_ROWS, n1, 0, 0)
    return _spectra_route(nfft)


def _spectra_route(nfft: int) -> GccRoute:
    """``ROUTE_SPECTRA`` at nfft with the split's n1 and the strips of
    ``spectra_plan``'s column and row passes."""
    plan = spectra_plan(nfft)
    return GccRoute(ROUTE_SPECTRA, fft_real_split(nfft)[0],
                    plan.spec_cols.strip, plan.spec_rows.strip)


def _long_route(nfft: int) -> GccRoute:
    """``ROUTE_LONG`` at nfft with the split's n1, ``long_plan``'s column
    strip and its row passes' (``corr_rows``, the same as the render's mix
    row pass)."""
    plan = long_plan(nfft)
    return GccRoute(ROUTE_LONG, fft_real_split(nfft)[0], plan.cols_a.strip,
                    plan.corr_rows.strip)


def render_route(nfft: int) -> GccRoute:
    """The route of K3's render stage at nfft, K5's too (so that K5 and K3
    then K2 compute the same bits), in ``gcc_route``'s kinds:

    - up to ``FFT_REAL_ONE_BLOCK`` (4,096), one block a packed base row
      (``render_block``: the twiddles, the base row and one work row, 80
      KB at 4,096), n1 = 1;
    - where the row pass's two strips (the base rows' and one output
      row's) fit one block's shared memory (``SMEM_OPTIN``: to 2^19),
      the four-step split nfft = n1 * n2 of ``fft_real_split`` with
      ``render_rows`` (``ROUTE_ROWS``);
    - elsewhere up to ``FFT_SPLIT_MAX`` (2^24), the split through the
      base rows' spectra (``ROUTE_SPECTRA``): K4a's two passes, the
      one-strip mix row pass ``render_spec_rows`` and ``render_cols``,
      with the strips of ``spectra_plan`` (16 and 16 at 2^20, 8 columns
      from n1 = 2,048 and 8 rows at n2 = 2,048, 4 rows at n2 = 4,096, 4
      columns at n1 = 4,096);
    - above, to ``FFT_LONG_MAX`` (2^30), the three-pass split through the
      base rows' spectra (``ROUTE_LONG``: K4a's three passes, the mix row
      pass ``render_spec_rows_long``, B' and ``long_cols_render``), with
      ``gcc_route``'s strips there; past it ``fft_real_split`` raises.

    The mic count does not enter: the render's row passes hold one or two
    strips at any mic count."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return GccRoute(ROUTE_BLOCK, 1, 0, 0)
    n1, n2 = fft_real_split(nfft)
    if nfft > FFT_SPLIT_MAX:
        return _long_route(nfft)
    if _row_pass_smem(n1, n2, 2) <= SMEM_OPTIN:
        return GccRoute(ROUTE_ROWS, n1, 0, 0)
    return _spectra_route(nfft)


def finish_groups(nfft: int, rows: int) -> int:
    """Blocks a packed mic row of K3's finish (K5's too) for a launch of
    ``rows`` mic rows at nfft: 1 (``render_finalize``, a block of 1,024
    threads a mic row) up to 2^19 and wherever the rows fill the card
    (``FINISH_SMS`` or more); else, on the render's spectra routes (the
    split from 2^20 and the three-pass split above 2^24), enough for
    ``FINISH_BLOCKS`` blocks (``finish_spread``), at most
    ``FINISH_MAX_GROUPS``.  The rule reads the shape only, not the card,
    so that a call's bits do not depend on the card it runs on."""
    if (render_route(nfft).kind not in (ROUTE_SPECTRA, ROUTE_LONG)
            or rows >= FINISH_SMS):
        return 1
    return min(FINISH_MAX_GROUPS, -(-FINISH_BLOCKS // ((rows + 1) // 2)))


def _window_scratch(rows: int, nfft: int, route: GccRoute, device):
    """The windowed GCC's partials for ``rows`` packed cross rows on the
    split routes (``gcc_rows``, the spectra, the three-pass split): the
    (max, index) keys (rows * 2, int64), the block counters (rows, int32)
    and the per-block sums of |corr| (rows * 2 * blocks float32: a block
    a column strip of ``window_cols``, n2 / strip, the strip 16 on
    ``gcc_rows`` and the route's on the spectra; of ``long_cols_window``
    n1b * n2 / 16, 32,768 at 2^27); Nones in one block."""
    if route.kind not in (ROUTE_ROWS, ROUTE_SPECTRA, ROUTE_LONG):
        return None, None, None
    if route.kind == ROUTE_LONG:
        blocks = nfft // _long_n1a(nfft) // route.cols
    else:
        blocks = nfft // route.n1 // (route.cols or ROW_STRIP)
    return (torch.empty(2 * rows, dtype=torch.int64, device=device),
            torch.empty(rows, dtype=torch.int32, device=device),
            torch.empty(2 * rows * blocks, dtype=torch.float32,
                        device=device))


def _gcc_buffers(route: GccRoute, scenes: int, mics: int, couples: int,
                 nfft: int, device):
    """K1's and K2's buffers on ``route`` for ``scenes`` scenes a launch:
    the strips argument (column strip, K4a's pass-2 strip, row strip; all
    0 off the spectra routes), pointers (spec0, spec1, cross0) and the
    tensors.  One block a scene: none.  ``gcc_rows``: the packed mic rows
    and the cross rows.  The spectra, on the split and on the three-pass
    split: K4a's packed rows, which the cross rows reuse once the spectra
    are written, and the spectra (scenes * mics, nfft/2 + 1) in spec1; the
    spectra block route the spectra alone."""
    packed = (scenes * mics + 1) // 2
    cross = scenes * couples
    if route.kind == ROUTE_BLOCK:
        return (0, 0, 0), (None, None, None), []
    if route.kind == ROUTE_ROWS:
        zm, zc = _scratch(packed, nfft, device), _scratch(cross, nfft, device)
        return (0, 0, 0), (zm.data_ptr(), None, zc.data_ptr()), [zm, zc]
    spec = torch.empty((scenes * mics, nfft // 2 + 1),
                       dtype=torch.complex64, device=device)
    if route.kind == ROUTE_SPECTRA_BLOCK:
        return (0, 0, 0), (None, spec.data_ptr(), None), [spec]
    buf = _scratch(max(packed, cross), nfft, device)
    return (_route_strips(route, nfft, packed),
            (buf.data_ptr(), spec.data_ptr(), buf.data_ptr()), [buf, spec])


def _route_strips(route: GccRoute, nfft: int, packed: int):
    """(column strip, K4a's pass-2 strip, row strip) of the spectra routes
    at nfft for ``packed`` packed rows in K4a's passes: ``spectra_plan``'s
    on the split, ``long_plan``'s on the three-pass split."""
    if route.kind == ROUTE_LONG:
        return route.cols, long_plan(nfft, packed).rows.strip, route.rows
    return _spectra_strips(nfft, packed)


def _spectra_strips(nfft: int, packed: int):
    """(column strip, K4a's pass-2 strip, row strip) of the spectra routes
    at nfft for ``packed`` packed rows in K4a's passes
    (``spectra_plan``), as K1's, K2's, K3's and K5's entries take them."""
    plan = spectra_plan(nfft, packed)
    return plan.spec_cols.strip, plan.rows.strip, plan.spec_rows.strip


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fft_real(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """(B, len <= nfft) real rows -> (B, nfft//2 + 1) complex spectra in
    natural order (zero-padded to nfft).

    Replaces ``bfly_fft_real`` (pyaudiolocalization_tpu/ops/pallas_fft.py:
    685), whose output is an opaque bit-reversed (N2, 128) plane layout.
    Two rows share each complex transform.  By length (``_split_n1``): up
    to nfft = 4096 one launch, a block per packed row; up to 2^24 a
    four-step split (``fft_real_split``) of two on-chip launches, the
    columns' DFTs with the twiddle (strips of 16 columns, 8 at n1 = 2,048,
    4 at 4,096: ``split_strips``), then the rows' DFTs with
    the two real spectra split in the epilogue (``fft_real_rows_strip``;
    the launches as ``split_plan`` gives them); above, to 2^30, three:
    the columns' DFTs in two passes of 16-column strips (n1 = n1a * n1b,
    ``long_plan``), then the rows' in strips of 4 rows k1 and their
    partners (runs of 4 bins).  From ``HALF_MIN`` an odd last row (every
    one-row call) is one half-length complex transform (``half_plan``):
    its even and odd samples as one nfft/2-point row on that length's
    schedule, the real spectrum formed in the row pass's epilogue, one
    launch more where the call also has pairs of rows.  Bound by device memory: the rows' read,
    one write and one read of the packed intermediate (a pass) and the
    spectra's write.  A batch beyond ``_launch_rows`` rows (``ROW_CHUNK``,
    or the scratch's byte cap) launches in chunks."""
    if _use_plain(x):
        return fft_real_plain(x, nfft)
    _check_contiguous("fft_real", x)
    _check_f32("fft_real", x)
    _check_pow2(nfft)
    rows, length = x.shape
    if length > nfft:
        raise ValueError(f"fft_real: unsupported shape {tuple(x.shape)} at "
                         f"nfft={nfft}")
    lib = _library()
    dev = x.device
    out = torch.empty((rows, nfft // 2 + 1), dtype=torch.complex64,
                      device=dev)
    pairs = rows - rows % 2 if nfft >= HALF_MIN else rows
    n1 = _split_n1(nfft)
    n1a = _long_n1a(nfft)
    chunks = _row_chunks(pairs, _launch_rows(n1, nfft))
    packed = (chunks[0][1] + 1) // 2 if chunks else 0
    buf = _pass_scratch(n1, packed, nfft, dev) if chunks else None
    tw = _twiddles(nfft, str(dev)) if chunks else None
    for r0, r1 in chunks:
        cols, s2 = _fft_real_strips(nfft, (r1 - r0 + 1) // 2)
        _launch("fft_real", dev, lib.palt_fft_real, x[r0].data_ptr(),
                r1 - r0, length, nfft, n1, cols, s2, n1a, 0, tw.data_ptr(),
                None, _ptr(buf), out[r0].data_ptr())
    if pairs < rows:
        _fft_real_half(lib, x[rows - 1], nfft, out[rows - 1])
    return out


def _fft_real_half(lib, row: torch.Tensor, nfft: int,
                   out: torch.Tensor) -> None:
    """One launch of K4a's half-length transform (``half_plan``) of the
    real row ``row`` (len <= nfft) into its spectrum ``out`` (nfft/2 + 1):
    m's table (``_long_twiddles`` on its three-pass split), the
    epilogue's (``_half_post``) and one packed row of scratch."""
    dev = row.device
    plan = half_plan(nfft)
    tw = (_long_twiddles if plan.n1a else _twiddles)(plan.m, str(dev))
    post, buf = _half_post(nfft, str(dev)), _scratch(1, plan.m, dev)
    _launch("fft_real", dev, lib.palt_fft_real, row.data_ptr(), 1,
            row.shape[0], nfft, plan.n1, plan.cols, plan.rows, plan.n1a, 1,
            tw.data_ptr(), post.data_ptr(), buf.data_ptr(), out.data_ptr())


def _fft_real_strips(nfft: int, packed: int):
    """(column strip, pass-2 strip) of K4a's launch over ``packed`` packed
    rows: ``split_plan``'s up to 2^24, ``long_plan``'s above (its column
    passes' strip), (0, 0) in one block."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return 0, 0
    if nfft > FFT_SPLIT_MAX:
        plan = long_plan(nfft, packed)
        return plan.cols_a.strip, plan.rows.strip
    plan = split_plan(nfft, packed)
    return plan.cols.strip, plan.rows.strip


# ---------------------------------------------------------------------------
# K9: whitened correlation of two spectra
# ---------------------------------------------------------------------------

def whitened_corr_plain(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                        nfft: int, eps: float = PHAT_EPS) -> torch.Tensor:
    r = a * torch.conj(b)
    mag = torch.sqrt(r.real * r.real + r.imag * r.imag) + eps
    m = mask.to(mag.dtype)
    white = torch.complex(r.real / mag * m, r.imag / mag * m)
    # irfft reads only the real parts of DC and Nyquist (cuFFT's float32
    # inverse does not drop them itself).
    white.imag[..., 0] = 0.0
    white.imag[..., nfft // 2] = 0.0
    return torch.fft.irfft(white, n=nfft)


def whitened_corr(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                  nfft: int, eps: float = PHAT_EPS) -> torch.Tensor:
    """(B, nfft//2 + 1) natural-order spectra ``a`` and ``b`` (from
    ``fft_real``) and a band mask (``band_mask``) -> (B, nfft) circular
    correlations irfft(whiten(a * conj(b)) * mask), whitening
    r / (|r| + eps).

    Replaces ``bfly_whitened_corr`` (pyaudiolocalization_tpu/ops/
    pallas_fft.py:707): K1's back half with arbitrary row pairs — the
    whitened, band-masked cross-spectra of two rows per packed Hermitian
    row (bins 0..n/2, mirrored, real DC and Nyquist), the packed inverse,
    1/n and the split into the two rows.  By length (``corr_schedule``):
    up to ``FFT_REAL_ONE_BLOCK`` (4,096) one launch, a block per packed row
    holding it in shared memory, no scratch; up to ``FFT_SPLIT_MAX``
    (2^24) two launches over one scratch buffer on K4b's four-step split
    — a row pass that gathers each strip's bins of ``a`` and ``b``,
    whitens and runs the inverse row DFTs, and K1's column pass, whose
    inverse column DFTs write the rows in natural order (the spectra
    routes' last two launches, ``spectra_plan``: strips of 16 rows and
    columns, 8 at 2,048, 4 at 4,096); above, to ``FFT_LONG_MAX``
    (2^30), three launches over that buffer on the three-pass split
    (``long_plan``, n1 = n1a * n1b): the row pass in strips of 2 rows
    without the conjugate twiddle (``corr_rows_long``), the inverse
    n1b-point column DFTs with the twiddle (pass B'), and the inverse
    n1a-point ones, which write the correlations (``long_cols_corr``), in
    strips of 16 columns.  Bound by device memory (the spectra's read, the
    rows' write, one write and one read of the packed buffer a pass on
    the split); a single pair's call by its launches' latency.  A batch
    beyond ``ROW_CHUNK`` row pairs launches in chunks."""
    if _use_plain(a, b, mask):
        return whitened_corr_plain(a, b, mask, nfft, eps)
    _check_contiguous("whitened_corr", a, b, mask)
    _check_f32("whitened_corr", mask)
    _check_pow2(nfft)
    if a.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise ValueError("whitened_corr: spectra must be complex64")
    if (a.dim() != 2 or a.shape != b.shape or a.shape[0] == 0
            or a.shape[1] != nfft // 2 + 1
            or mask.shape != (nfft // 2 + 1,)):
        raise ValueError("whitened_corr: unsupported shapes")
    lib = _library()
    dev = a.device
    rows = a.shape[0]
    out = torch.empty((rows, nfft), dtype=torch.float32, device=dev)
    n1 = corr_schedule(nfft)
    cols, strip = _corr_strips(nfft)
    chunks = _row_chunks(rows)
    z = _pass_scratch(n1, (chunks[0][1] + 1) // 2, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        _launch("whitened_corr", dev, lib.palt_whitened_corr,
                a[r0].data_ptr(), b[r0].data_ptr(), r1 - r0, nfft, n1, cols,
                strip, _long_n1a(nfft), mask.data_ptr(), eps, tw.data_ptr(),
                _ptr(z), out[r0].data_ptr())
    return out


# ---------------------------------------------------------------------------
# K1: all-pairs PHAT correlations
# ---------------------------------------------------------------------------

def gcc_all_pairs_plain(signals: torch.Tensor, pairs_i: Sequence[int],
                        pairs_j: Sequence[int], nfft: int,
                        mask: torch.Tensor,
                        eps: float = PHAT_EPS) -> torch.Tensor:
    """(..., M, len) -> (..., P, nfft); any leading axes."""
    pi = torch.as_tensor(np.asarray(pairs_i), device=signals.device)
    pj = torch.as_tensor(np.asarray(pairs_j), device=signals.device)
    spec = torch.fft.rfft(signals, n=nfft)
    cross = spec[..., pi, :] * torch.conj(spec[..., pj, :])
    inv = 1.0 / (torch.sqrt(cross.real ** 2 + cross.imag ** 2) + eps)
    white = cross * inv * mask.to(signals.dtype)
    return torch.fft.irfft(white, n=nfft)


def _scene_bytes(nfft: int, mics: int, couples: int) -> int:
    """Bytes of scratch one scene of ``mics`` mics and ``couples`` pair
    couples holds in a launch of K1, K2, K3 or K5 at nfft, the most of the
    four (``_gcc_buffers``, ``_render_buffers``, ``scene_windowed``'s), in
    half packed rows of nfft complex points: none up to
    ``FFT_REAL_ONE_BLOCK``; on the split (to ``FFT_SPLIT_MAX``) the mic
    rows' (mics) or the cross rows' (2 couples), whichever is more, and
    the spectra of every mic row (mics); above, on the three-pass split,
    K5's: its render's pass A' writes the finished signals' packed rows
    (mics) beside the rows it reads, which then take the GCC's forward
    passes and its cross rows (the more of mics and 2 couples), and the
    spectra of every mic row (mics) (K1 and K2 hold the split's count, K3
    2 mics + 1).  A 4-mic scene: 0.67 GB at 2^24, 1.88 GB at 2^25, 3.76 GB
    at 2^26, 7.52 GB at 2^27, 15.0 GB at 2^28, 30.1 GB at 2^29 and 60.1 GB
    at 2^30."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return 0
    halves = max(mics, 2 * couples) + mics
    if nfft > FFT_SPLIT_MAX:
        halves += mics
    return halves * nfft * 4


def scene_chunk(scenes: int, mics: int, num_pairs: int, nfft: int) -> int:
    """Scenes per launch of K1, K2, K3 and K5, one rule for all four:
    every grid's y extent stays within 65,535 — the packed base rows
    ((chunk + 1) / 2), the packed mic rows ((chunk * mics + 1) / 2), the
    scenes of a GCC row pass (chunk) and the pair couples (chunk *
    couples) — and the scenes' scratch at nfft within
    ``SPLIT_SCRATCH_BYTES`` (``_scene_bytes``; at least 2 scenes), as
    ``_launch_rows`` caps K4a's, K4b's and K6's rows: 24 scenes of 4 mics
    at 2^24, 8 at 2^25, 4 at 2^26 (from 2^15 the cap binds before the
    grids' limit: 13,106 scenes of 4 mics at 2^15, 408 at 2^20).  The
    couples are those of the larger of ``num_pairs`` and the all-pairs
    count M (M - 1) / 2, so that K3, which
    has no pairs, chunks as K2 and K5 do over all pairs of the same
    scenes, and the sweep's fused and split paths stay equal to the bit.
    A chunk short of ``scenes`` is even, so that rows pack two to a
    transform (the bases, and the mic rows of an odd mic count, across
    scenes) as one launch over every scene packs them; each scene's noise
    comes from its own seed words, so a chunk draws what one launch
    would."""
    couples = max(1, (max(num_pairs, mics * (mics - 1) // 2) + 1) // 2)
    limit = min(_MAX_GRID_Y // couples, 2 * _MAX_GRID_Y // max(mics, 1))
    per_scene = _scene_bytes(nfft, mics, couples)
    if per_scene:
        limit = min(limit, max(2, SPLIT_SCRATCH_BYTES // per_scene))
    return scenes if scenes <= limit else limit - limit % 2


def gcc_all_pairs(signals: torch.Tensor, pairs_i: Sequence[int],
                  pairs_j: Sequence[int], nfft: int, mask: torch.Tensor,
                  eps: float = PHAT_EPS) -> torch.Tensor:
    """(..., M, len <= nfft) signals -> (..., P, nfft) circular PHAT
    correlations, band-masked by ``mask`` (``band_mask``) after whitening;
    any leading (scene) axes.

    Replaces ``bfly_gcc_all_pairs`` (pyaudiolocalization_tpu/ops/
    pallas_fft.py:922): the forward transforms of every mic row of every
    scene (rows scene * M + mic, two per complex FFT, so an odd M packs
    across scenes), the whitened, band-masked cross-spectra of two pairs
    of one scene per packed Hermitian row, the packed inverse, 1/n and the
    split into the two pairs.  By route (``gcc_route``, K2's and K5's
    rule):

    - one block a scene (nfft <= ``FFT_REAL_ONE_BLOCK``, 4,096, up to 10
      mics): one launch, the scene's packed mic rows and a spare row in
      shared memory, no scratch (blocks share a scene's couples where
      scenes are too few to fill the card);
    - ``gcc_rows`` (up to 2^19 where its strips fit: 4 mics at 2^19, 10
      mics at 65,536): three launches on K4b's four-step split over one
      buffer of packed mic rows and one of packed cross rows — K4a's
      column pass, K2's row pass (a scene's strips of every packed mic
      row; per couple the cross-spectra and the inverse row DFTs), and a
      column pass whose inverse column DFTs write the correlations in
      natural order;
    - the spectra (8,192 to ``FFT_SPLIT_MAX``, 2^24, where ``gcc_rows``
      does not fit, at any mic count; every mic count from 2^20 on): four
      launches — K4a's two passes write the mic rows' natural-order
      spectra (scenes * M, nfft/2 + 1), K9's row pass reads rows scene * M
      + pairs_i[p] and scene * M + pairs_j[p] of them (the pair-indexed
      loader) into the packed cross rows, and the column pass as above;
      the strips are ``spectra_plan``'s (16 columns and rows up to 2^20; 8
      columns, 16 rows at 2^21 and 8 at 2^22; 8 and 4 at 2^23; 4 and 4 at
      2^24), and the cross rows reuse
      K4a's packed buffer;
    - the spectra block (nfft <= 4,096 beyond 10 mics; 24 at 2,048): two
      launches, K4a's one-block transform of every mic row into the
      spectra, then K9's one-block kernel a packed cross row with the
      pair-indexed loader;
    - above 2^24, to ``FFT_LONG_MAX`` (2^30), the three-pass split through
      the spectra (``long_plan``): six launches, K4a's three (passes A and
      B, ``fft_real_rows``) into the spectra, then K9's three with the
      pair-indexed loader (``corr_rows_long``, B', ``long_cols_corr``),
      through the same two buffers.

    A batch whose grids would exceed 65,535 rows, or whose scratch would
    pass ``SPLIT_SCRATCH_BYTES``, launches over scene chunks
    (``scene_chunk``; the one-block routes have no such limit).
    Bound by device memory: the signals' read, the correlations' write
    and, on the split, one write and one read of each packed buffer a
    pass (on the spectra routes also the spectra's write and two spectra
    read a pair)."""
    if _use_plain(signals, mask):
        return gcc_all_pairs_plain(signals, pairs_i, pairs_j, nfft, mask, eps)
    _check_contiguous("gcc_all_pairs", signals, mask)
    _check_f32("gcc_all_pairs", signals, mask)
    _check_pow2(nfft)
    if signals.dim() < 2:
        raise ValueError("gcc_all_pairs: signals must be (..., M, len)")
    lead = signals.shape[:-2]
    mics, length = signals.shape[-2:]
    pi, pj = _check_pairs("gcc_all_pairs", pairs_i, pairs_j, mics)
    scenes = int(np.prod(lead)) if lead else 1
    num_pairs = int(pi.shape[0])
    couples = (num_pairs + 1) // 2
    route = gcc_route(nfft, mics)
    chunk = (scenes if route.n1 == 1
             else scene_chunk(scenes, mics, num_pairs, nfft))
    if length > nfft or mask.shape != (nfft // 2 + 1,):
        raise ValueError("gcc_all_pairs: unsupported shapes")
    dev = signals.device
    out = torch.empty(lead + (num_pairs, nfft), dtype=torch.float32,
                      device=dev)
    if scenes == 0:
        return out
    if chunk < 1:
        raise ValueError("gcc_all_pairs: one scene exceeds the kernel's "
                         "grid limit")
    lib = _library()
    pi_t = torch.as_tensor(pi, dtype=torch.int32, device=dev)
    pj_t = torch.as_tensor(pj, dtype=torch.int32, device=dev)
    x = signals.view(scenes, mics, length)
    o = out.view(scenes, num_pairs, nfft)
    strips, ptrs, _bufs = _gcc_buffers(route, chunk, mics, couples, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for s0 in range(0, scenes, chunk):
        _launch("gcc_all_pairs", dev, lib.palt_gcc_all_pairs,
                x[s0].data_ptr(), min(chunk, scenes - s0), mics, length,
                nfft, route.n1, route.kind, *strips, _long_n1a(nfft),
                pi_t.data_ptr(),
                pj_t.data_ptr(), num_pairs, mask.data_ptr(), eps,
                tw.data_ptr(), *ptrs, o[s0].data_ptr())
    return out


# ---------------------------------------------------------------------------
# K2: windowed all-pairs PHAT correlations + statistics
# ---------------------------------------------------------------------------

def gcc_windowed_plain(signals: torch.Tensor, pairs_i: Sequence[int],
                       pairs_j: Sequence[int], nfft: int, wq: int,
                       mask: torch.Tensor, eps: float = PHAT_EPS):
    corr = gcc_all_pairs_plain(signals, pairs_i, pairs_j, nfft, mask, eps)
    w = wq * 128
    win = torch.cat([corr[..., nfft - w:], corr[..., :w]], -1)
    stats = torch.stack([torch.mean(torch.abs(corr), -1),
                         torch.amax(corr, -1),
                         torch.argmax(corr, -1).to(corr.dtype)], -1)
    return win, stats


def _check_pairs(name: str, pairs_i, pairs_j, mics: int):
    pi = np.asarray(pairs_i, np.int64)
    pj = np.asarray(pairs_j, np.int64)
    if (pi.ndim != 1 or pi.shape[0] == 0 or pj.shape != pi.shape
            or min(pi.min(), pj.min()) < 0
            or max(pi.max(), pj.max()) >= mics):
        raise ValueError(f"{name}: unsupported pair indices")
    return pi, pj


def _check_window(name: str, nfft: int, wq: int) -> None:
    if not 0 < wq <= nfft // 256:
        raise ValueError(f"{name}: wq must be in (0, nfft/256], got wq={wq} "
                         f"at nfft={nfft}")


def gcc_windowed(signals: torch.Tensor, pairs_i: Sequence[int],
                 pairs_j: Sequence[int], nfft: int, wq: int,
                 mask: torch.Tensor, eps: float = PHAT_EPS):
    """(..., M, len <= nfft) signals -> (win (..., P, 2*wq*128), stats
    (..., P, 3)): the band-masked PHAT correlation of every pair, reduced
    to its lag window (sample s holds lag s - wq*128) and three statistics
    over the whole correlation (mean |corr|, maximum, the smallest natural
    index attaining it).  wq <= nfft/256.

    Replaces ``bfly_gcc_windowed`` (pyaudiolocalization_tpu/ops/
    pallas_fft.py:1095; ``_couple_window_stats`` :1032): the packed
    forward transforms of every mic row of every scene (two rows a complex
    transform), the whitened, band-masked cross-spectra of two pairs a
    packed row, the packed inverse, and the scale, the window write and
    the statistics in the inverse's last step, so the (..., P, nfft)
    correlation is never written.  By route (``gcc_route``, K1's rule):
    up to 4,096 points where a scene's packed mic rows fit (10 mics at
    4,096, 24 at 2,048), one launch, a block a scene (``window_block``:
    the rows' transforms in shared memory, then couple by couple the
    cross-spectra, the inverse and the window with the statistics by
    block reductions in a fixed order, ties going to the smallest index),
    no scratch; beyond that mic count two launches through the mic rows'
    spectra (K4a's one-block transform, then a block a packed cross row
    with the same window and statistics); where ``gcc_rows`` fits (8,192
    <= nfft <= 2^19; up to 10 mics a scene at 65,536), three launches on
    K4b's four-step schedule: K4a's column pass; a row pass that holds a
    scene's strips of every packed mic row and, couple by couple, forms
    the cross-spectra and runs the inverse row DFTs; a column pass whose
    inverse column DFTs end in the window and the statistics (per-block
    partials summed in block order by the row's last block, the argmax by
    a 64-bit atomic maximum that keeps the smallest index on ties);
    elsewhere up to 2^24, four launches through the mic rows' spectra, as
    K1's: K4a's two passes, the pair-indexed row pass (which also clears
    the argmax keys and block counters) and that column pass, with
    ``spectra_plan``'s strips (8 columns from 2^21, 4 at 2^24);
    above, to 2^30, six launches on the three-pass split through
    the mic rows' spectra, as K1's: K4a's three passes, the pair-indexed
    row pass, B' and pass A' ending in the window and the statistics
    (``long_cols_window``, the partials of its 32,768 blocks a row at 2^27
    summed in a fixed order by the row's last block).  Bound by device
    memory.  A batch whose
    grids would exceed 65,535 rows, or whose scratch would pass
    ``SPLIT_SCRATCH_BYTES``, launches over scene chunks (``scene_chunk``),
    in one block too, so that K2 chunks as K5 does."""
    _check_window("gcc_windowed", nfft, wq)
    if _use_plain(signals, mask):
        return gcc_windowed_plain(signals, pairs_i, pairs_j, nfft, wq, mask,
                                  eps)
    _check_contiguous("gcc_windowed", signals, mask)
    _check_f32("gcc_windowed", signals, mask)
    _check_pow2(nfft)
    lead = signals.shape[:-2]
    mics, length = signals.shape[-2:]
    pi, pj = _check_pairs("gcc_windowed", pairs_i, pairs_j, mics)
    scenes = int(np.prod(lead)) if lead else 1
    num_pairs = int(pi.shape[0])
    couples = (num_pairs + 1) // 2
    if length > nfft or mask.shape != (nfft // 2 + 1,) or scenes == 0:
        raise ValueError("gcc_windowed: unsupported shapes")
    lib = _library()
    dev = signals.device
    pi_t = torch.as_tensor(pi, dtype=torch.int32, device=dev)
    pj_t = torch.as_tensor(pj, dtype=torch.int32, device=dev)
    width = 2 * wq * 128
    win = torch.empty(lead + (num_pairs, width), dtype=torch.float32,
                      device=dev)
    stats = torch.empty(lead + (num_pairs, 3), dtype=torch.float32,
                        device=dev)
    chunk = scene_chunk(scenes, mics, num_pairs, nfft)
    route = gcc_route(nfft, mics)
    strips, ptrs, _bufs = _gcc_buffers(route, chunk, mics, couples, nfft, dev)
    keys, count, part = _window_scratch(chunk * couples, nfft, route, dev)
    tw = _twiddles(nfft, str(dev))
    x = signals.view(scenes, mics, length)
    win_s = win.view(scenes, num_pairs, width)
    stats_s = stats.view(scenes, num_pairs, 3)
    for s0 in range(0, scenes, chunk):
        _launch("gcc_windowed", dev, lib.palt_gcc_windowed,
                x[s0].data_ptr(), min(chunk, scenes - s0), mics, length,
                nfft, route.n1, route.kind, *strips, _long_n1a(nfft),
                pi_t.data_ptr(),
                pj_t.data_ptr(), num_pairs, mask.data_ptr(), eps, wq,
                tw.data_ptr(), *ptrs, _ptr(keys), _ptr(count), _ptr(part),
                win_s[s0].data_ptr(), stats_s[s0].data_ptr())
    return win, stats


# ---------------------------------------------------------------------------
# K4b: bootstrap null peaks
# ---------------------------------------------------------------------------

def bootstrap_peaks_plain(s1: torch.Tensor, rows: torch.Tensor, nfft: int,
                          eps: float = PHAT_EPS) -> torch.Tensor:
    s2 = torch.fft.rfft(rows, n=nfft)
    r = s1[None, :] * torch.conj(s2)
    r = r / (torch.abs(r) + eps)
    return torch.max(torch.fft.irfft(r, n=nfft), dim=-1).values


def bootstrap_peaks(s1: torch.Tensor, rows: torch.Tensor, nfft: int,
                    eps: float = PHAT_EPS) -> torch.Tensor:
    """Max of the PHAT correlation between the signal whose spectrum is
    ``s1`` ((nfft//2 + 1,) complex, from ``fft_real``) and each row of
    ``rows`` ((B, len <= nfft) real) -> (B,).

    Replaces ``bfly_bootstrap_peaks`` (pyaudiolocalization_tpu/ops/
    pallas_fft.py:1227): per pair of rows one packed forward transform,
    the whitening against S1, the packed inverse and the row maxima, so
    the (B, nfft) correlation is never written.  By length:

    - nfft <= ``FFT_REAL_ONE_BLOCK`` (4096): one launch, a block per
      packed row holding every step in shared memory, no scratch;
    - up to ``FFT_SPLIT_MAX`` (2^24): three launches over one scratch
      buffer, K4a's split nfft = n1 * n2 (``fft_real_split``) forward and
      back: K4a's column pass; a row pass (16 rows a block, 8 at n2 =
      1,024, 4 at 2,048, 2 at 4,096: ``boot_strip``, at most 512 threads)
      that runs the forward row DFTs, the whitening, the inverse row DFTs
      and the inverse twiddle in shared memory and writes back in place;
      and a column pass whose inverse column DFTs end in the maxima (the
      column passes' strips 16 columns, 8 at n1 = 2,048, 4 at 4,096:
      ``split_strips``);
    - above, to 2^30: five launches over the scratch buffer, the
      three-pass split (``long_plan``): the column DFTs in two passes of
      16-column strips (n1 = n1a * n1b), a row pass of 2,048-point rows
      that leaves the inverse twiddle to the next pass, and the two column
      passes mirrored, the last ending in the maxima.

    Bound by device memory: the rows' read and, on the split, two reads
    and two writes of the packed buffer (32 bytes a point of the packed
    rows; 48 above 2^24).  A batch beyond ``_launch_rows`` rows
    (``ROW_CHUNK``, or as many as keep the scratch within
    ``SPLIT_SCRATCH_BYTES``: 512 rows at 2^23, 256 at 2^24, 128 at 2^25,
    64 at 2^26, 32 at 2^27, 16 at 2^28, 4 at 2^30) launches in chunks,
    with one launch's peaks."""
    if _use_plain(s1, rows):
        return bootstrap_peaks_plain(s1, rows, nfft, eps)
    _check_contiguous("bootstrap_peaks", s1, rows)
    _check_f32("bootstrap_peaks", rows)
    if s1.dtype != torch.complex64:
        raise ValueError(f"bootstrap_peaks: s1 must be complex64, got "
                         f"{s1.dtype}")
    _check_pow2(nfft)
    num, length = rows.shape
    if length > nfft or s1.shape != (nfft // 2 + 1,) or num == 0:
        raise ValueError("bootstrap_peaks: unsupported shapes")
    lib = _library()
    dev = rows.device
    out = torch.empty(num, dtype=torch.float32, device=dev)
    n1 = _split_n1(nfft)
    cols, strip = _split_strips(n1, nfft)
    n1a = _long_n1a(nfft)
    chunks = _row_chunks(num, _launch_rows(n1, nfft))
    buf = _pass_scratch(n1, (chunks[0][1] + 1) // 2, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        _launch("bootstrap_peaks", dev, lib.palt_bootstrap_peaks,
                s1.data_ptr(), rows[r0].data_ptr(), r1 - r0, length, nfft,
                n1, cols, strip, n1a, eps, tw.data_ptr(), _ptr(buf),
                out[r0:].data_ptr())
    return out


# ---------------------------------------------------------------------------
# K6: noise-null bootstrap peaks
# ---------------------------------------------------------------------------

def noise_bootstrap_peaks_plain(s1: torch.Tensor, seeds: torch.Tensor,
                                n_samp: int, nfft: int,
                                eps: float = PHAT_EPS) -> torch.Tensor:
    rows = noise_ops.uniform(seeds, n_samp).to(s1.real.dtype)
    return bootstrap_peaks_plain(s1, rows, nfft, eps)


def noise_bootstrap_peaks(s1: torch.Tensor, seeds: torch.Tensor,
                          n_samp: int, nfft: int,
                          eps: float = PHAT_EPS) -> torch.Tensor:
    """``bootstrap_peaks`` against B noise draws made inside the kernel:
    draw d is ``n_samp`` uniform samples in [-0.5, 0.5) of the Philox
    stream keyed by ``seeds[d]`` ((B, 2) int32, read as uint32; counter =
    sample index; the first output word as int32 times 2^-32,
    ``ops/noise.uniform``), zero-padded to nfft -> (B,) maxima.

    Replaces ``bfly_noise_bootstrap_peaks`` (pyaudiolocalization_tpu/ops/
    pallas_fft.py:1326): K4b's schedules (``bootstrap_peaks``: one launch
    up to 4096, three on the four-step split up to 2^24 with K4b's strips,
    five on the three-pass split above) with its row load replaced by the
    draw, made where the first forward step reads the point (two draws per
    complex transform), so the rows never exist in device memory and no
    permutation is sorted.  The draws and everything after them are K4b's,
    so the peaks equal ``bootstrap_peaks`` of ``noise_ops.uniform(seeds,
    n_samp)`` bit for bit on every schedule.  Bound by device memory
    (one write and two reads of the packed buffer on the split) and the
    Philox rounds.  A batch beyond ``_launch_rows`` draws launches in
    chunks (K4b's), each draw keyed by its own seed words."""
    if _use_plain(s1, seeds):
        return noise_bootstrap_peaks_plain(s1, seeds, n_samp, nfft, eps)
    _check_contiguous("noise_bootstrap_peaks", s1, seeds)
    if s1.dtype != torch.complex64 or seeds.dtype != torch.int32:
        raise ValueError("noise_bootstrap_peaks: s1 must be complex64 and "
                         "seeds int32")
    _check_pow2(nfft)
    num = seeds.shape[0]
    if (seeds.shape != (num, 2) or num == 0 or not 0 < n_samp <= nfft
            or s1.shape != (nfft // 2 + 1,)):
        raise ValueError("noise_bootstrap_peaks: unsupported shapes")
    lib = _library()
    dev = s1.device
    out = torch.empty(num, dtype=torch.float32, device=dev)
    n1 = _split_n1(nfft)
    cols, strip = _split_strips(n1, nfft)
    n1a = _long_n1a(nfft)
    chunks = _row_chunks(num, _launch_rows(n1, nfft))
    buf = _pass_scratch(n1, (chunks[0][1] + 1) // 2, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        _launch("noise_bootstrap_peaks", dev,
                lib.palt_noise_bootstrap_peaks, s1.data_ptr(),
                seeds[r0].data_ptr(), r1 - r0, n_samp, nfft, n1, cols, strip,
                n1a, eps, tw.data_ptr(), _ptr(buf), out[r0:].data_ptr())
    return out


# ---------------------------------------------------------------------------
# K3: multipath render
# ---------------------------------------------------------------------------

def delay_sum_plain(base: torch.Tensor, tau: torch.Tensor,
                    gains: torch.Tensor, nfft: int, out_samples: int,
                    fade: torch.Tensor, finalize: bool, snr_db=None,
                    seeds=None) -> torch.Tensor:
    spec = torch.fft.rfft(base, n=nfft)                       # (..., F)
    k = torch.arange(nfft // 2 + 1, dtype=torch.float64, device=base.device)
    # Phase k*tau/nfft in turns, reduced by whole turns in float64 (exact
    # for the integer bin index), as the kernel does.
    turns = k * tau.to(torch.float64)[..., None] / nfft
    turns = turns - torch.floor(turns)
    theta = 2.0 * np.pi * turns
    ramps = torch.complex(torch.cos(theta), -torch.sin(theta)).to(spec.dtype)
    mixed = torch.sum(gains.to(spec.dtype)[..., None] * ramps,
                      -2) * spec[..., None, :]
    # A real render's Nyquist response is real (cos(pi*tau)), as in the
    # kernel; cuFFT's float32 inverse does not ignore an imaginary part
    # there.
    mixed[..., -1] = mixed[..., -1].real.to(mixed.dtype)
    out = torch.fft.irfft(mixed, n=nfft)[..., :out_samples] * fade
    if finalize:
        out = sig_ops.dynamic_range_compression(sig_ops.normalize_signal(out))
    if snr_db is not None:
        out = noise_ops.add_noise(out, snr_db, seeds)
    return out


def _check_noise_pair(name, snr_db, seeds):
    if (snr_db is None) != (seeds is None):
        raise ValueError(f"{name}: snr_db and seeds go together")


def _check_noise(name, snr_db, seeds, lead, dev):
    if snr_db is None:
        return None, None
    if tuple(snr_db.shape) != tuple(lead) or tuple(seeds.shape) != (
            tuple(lead) + (2,)):
        raise ValueError(f"{name}: snr_db must be {tuple(lead)} and seeds "
                         f"{tuple(lead) + (2,)}")
    if seeds.dtype != torch.int32 or snr_db.device != dev \
            or seeds.device != dev:
        raise ValueError(f"{name}: seeds must be int32 and both on {dev}")
    _check_f32(name, snr_db)
    return snr_db.contiguous(), seeds.contiguous()


def _at(t: Optional[torch.Tensor], s0: int):
    """Pointer to scene s0 of a per-scene tensor, or None."""
    return None if t is None else t[s0].data_ptr()


def _scene_views(lead, *tensors):
    """Each tensor (or None), contiguous with leading scene axes ``lead``,
    viewed with those axes flattened into one."""
    scenes = int(np.prod(lead)) if lead else 1
    return [None if t is None else t.view((scenes,) + t.shape[len(lead):])
            for t in tensors]


def _render_shapes(name, base, tau, gains, nfft, out_samples, fade):
    lead = base.shape[:-1]
    length = base.shape[-1]
    if tau.dim() != base.dim() + 1 or tau.shape[:-2] != lead:
        raise ValueError(f"{name}: tau must be {tuple(lead)} + (M, paths)")
    mics, paths = tau.shape[-2:]
    scenes = int(np.prod(lead)) if lead else 1
    if (length > nfft or gains.shape != tau.shape or paths == 0
            or scenes == 0 or out_samples > nfft
            or fade.shape != (out_samples,)):
        raise ValueError(f"{name}: unsupported shapes")
    return lead, scenes, length, mics, paths


def _render_buffers(route: GccRoute, scenes: int, mics: int, nfft: int,
                    device):
    """K3's buffers on its render ``route`` for ``scenes`` scenes a
    launch: the strips argument (column strip, K4a's pass-2 strip, row
    strip; all 0 off the spectra routes), pointers (zb, z0, z1), the
    spectra (or None) and the tensors.  One block: none.  ``render_rows``:
    the packed base rows and the packed mic rows.  The base rows' spectra
    on the split: the packed mic rows, whose buffer takes K4a's packed
    base rows first (they are dead once their spectra are written), and
    the spectra (scenes, nfft/2 + 1); on the three-pass split also a
    second buffer of packed mic rows, which pass A' writes (it cannot
    write the rows it reads)."""
    packed_b, packed = (scenes + 1) // 2, (scenes * mics + 1) // 2
    if route.kind == ROUTE_BLOCK:
        return (0, 0, 0), (None, None, None), None, []
    z = _scratch(packed, nfft, device)
    if route.kind == ROUTE_ROWS:
        zb = _scratch(packed_b, nfft, device)
        return (0, 0, 0), (zb.data_ptr(), z.data_ptr(), None), None, [zb, z]
    spec = torch.empty((scenes, nfft // 2 + 1), dtype=torch.complex64,
                       device=device)
    z1 = _scratch(packed, nfft, device) if route.kind == ROUTE_LONG else None
    return (_render_strips(route, scenes, nfft),
            (z.data_ptr(), z.data_ptr(), _ptr(z1)), spec, [z, z1])


def _render_strips(route: GccRoute, scenes: int, nfft: int):
    """(column strip, K4a's pass-2 strip, row strip) of the render's
    spectra routes for ``scenes`` scenes a launch (two a packed base row);
    (0, 0, 0) on the other routes."""
    if route.kind not in (ROUTE_SPECTRA, ROUTE_LONG):
        return 0, 0, 0
    return _route_strips(route, nfft, (scenes + 1) // 2)


def _finish_scratch(nfft: int, scenes: int, chunk: int, mics: int, device):
    """The finish's blocks a packed mic row for each scene chunk's launch
    (``finish_groups`` of its rows) and the spread finish's partials
    (rows * 3 * groups float32 for the largest need; None where every
    launch takes one block a mic row)."""
    groups = [finish_groups(nfft, min(chunk, scenes - s0) * mics)
              for s0 in range(0, scenes, chunk)]
    need = max((min(chunk, scenes - s0) * mics * 3 * g
                for g, s0 in zip(groups, range(0, scenes, chunk)) if g > 1),
               default=0)
    part = (torch.empty(need, dtype=torch.float32, device=device) if need
            else None)
    return groups, part


def delay_sum(base: torch.Tensor, tau: torch.Tensor, gains: torch.Tensor,
              nfft: int, out_samples: int, fade: torch.Tensor,
              finalize: bool, snr_db: Optional[torch.Tensor] = None,
              seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multipath render: for each scene and mic m, the sum over paths p of
    ``gains[..., m, p]`` times the scene's ``base`` delayed by
    ``tau[..., m, p]`` samples (circular at ``nfft``), scaled by ``fade``
    ((out_samples,)) and trimmed to ``out_samples``; ``finalize`` adds the
    per-mic peak-normalize, log compression and re-normalize; ``snr_db``
    ((...,) dB) with ``seeds`` ((..., 2) int32) then adds white noise at
    sigma = rms * 10^(-snr/20) per mic (``ops/noise.py``).  base
    (..., len <= nfft), tau / gains (..., M, paths) -> (..., M, out_samples).

    Replaces ``bfly_delay_sum`` (pyaudiolocalization_tpu/ops/pallas_fft.py:
    1851; ``_render_postprocess`` :1788): one forward transform per base
    (two scenes per packed row), per-mic transfer functions synthesized on
    the fly from (tau, gain) with the phase reduced by whole turns and a
    real Nyquist bin (cos(pi*tau)), two mic rows per packed inverse, and
    the scale, fade, trim, finalize and noise of each mic row.  One call
    covers every scene.  Up to 4,096 points one launch (``render_block``):
    a block a packed base row (two scenes) transforms it once in shared
    memory, then mixes, inverts and finishes its packed mic rows one at a
    time in one work row, no scratch.  Elsewhere by ``render_route``:
    from 8,192 to 2^19, K4b's four-step schedule in three launches, K4a's
    column pass over the bases, a row pass that holds a base strip, mixes
    each of its mic rows in turn and runs their inverse row DFTs, and the
    inverse column DFTs in place; from 2^20 to 2^24, where that row pass's
    two strips do not fit, four: K4a's two passes write the bases' half
    spectra, a row pass mixes each packed mic row's strip from them (one
    strip at any mic count) and runs its inverse row DFTs, and the inverse
    column DFTs (``spectra_plan``'s strips: 8 wide at 2,048, 4 at 4,096);
    above 2^24, to 2^30, six on the three-pass split: K4a's
    three passes into the bases' half spectra, the mix row pass
    (``render_spec_rows_long``, the twiddle left to B'), B' and A'
    (``long_cols_render``) into a second buffer of packed mic rows.
    Then the finish: a block a mic row (``render_finalize``), or, where a
    call's rows from 2^20 are too few to fill the card, spread over
    ``finish_groups`` blocks a packed mic row in up to four launches
    (``finish_spread``: its maxima and sums of squares combined across
    the blocks in block order).  Bound by device memory.  A batch whose
    grids would exceed 65,535 rows, or whose scratch would pass
    ``SPLIT_SCRATCH_BYTES``, launches over the scene chunks K2 and K5
    take for all pairs of the same mics (``scene_chunk``), in one block
    too."""
    _check_noise_pair("delay_sum", snr_db, seeds)
    if _use_plain(base, tau, gains, fade):
        return delay_sum_plain(base, tau, gains, nfft, out_samples, fade,
                               finalize, snr_db, seeds)
    _check_contiguous("delay_sum", base, tau, gains, fade)
    _check_f32("delay_sum", base, tau, gains, fade)
    _check_pow2(nfft)
    lead, scenes, length, mics, paths = _render_shapes(
        "delay_sum", base, tau, gains, nfft, out_samples, fade)
    snr_db, seeds = _check_noise("delay_sum", snr_db, seeds, lead,
                                 base.device)
    lib = _library()
    dev = base.device
    out = torch.empty(lead + (mics, out_samples), dtype=torch.float32,
                      device=dev)
    chunk = scene_chunk(scenes, mics, 0, nfft)
    route = render_route(nfft)
    strips, (zb, zm0, zm1), spec, _bufs = _render_buffers(
        route, chunk, mics, nfft, dev)
    groups, part = _finish_scratch(nfft, scenes, chunk, mics, dev)
    tw = _twiddles(nfft, str(dev))
    base_s, tau_s, gains_s, snr_s, seeds_s, out_s = _scene_views(
        lead, base, tau, gains, snr_db, seeds, out)
    for g, s0 in zip(groups, range(0, scenes, chunk)):
        _launch("delay_sum", dev, lib.palt_delay_sum, base_s[s0].data_ptr(),
                min(chunk, scenes - s0), length, tau_s[s0].data_ptr(),
                gains_s[s0].data_ptr(), mics, paths, nfft, route.n1,
                out_samples, fade.data_ptr(), int(finalize), _at(snr_s, s0),
                _at(seeds_s, s0), tw.data_ptr(), zb, zm0, zm1, route.kind,
                *strips, _long_n1a(nfft), _ptr(spec), g, _ptr(part),
                out_s[s0].data_ptr())
    return out


# ---------------------------------------------------------------------------
# K5: whole scene (render -> windowed GCC)
# ---------------------------------------------------------------------------

def scene_windowed_plain(base, tau, gains, pairs_i, pairs_j, nfft: int,
                         out_samples: int, wq: int, fade, mask, snr_db=None,
                         seeds=None, eps: float = PHAT_EPS):
    sigs = delay_sum_plain(base, tau, gains, nfft, out_samples, fade, True,
                           snr_db, seeds)
    return gcc_windowed_plain(sigs, pairs_i, pairs_j, nfft, wq, mask, eps)


def scene_windowed(base: torch.Tensor, tau: torch.Tensor,
                   gains: torch.Tensor, pairs_i: Sequence[int],
                   pairs_j: Sequence[int], nfft: int, out_samples: int,
                   wq: int, fade: torch.Tensor, mask: torch.Tensor,
                   snr_db: Optional[torch.Tensor] = None,
                   seeds: Optional[torch.Tensor] = None,
                   eps: float = PHAT_EPS):
    """Whole-scene pipeline: ``gcc_windowed(delay_sum(base, tau, gains,
    nfft, out_samples, fade, finalize=True, snr_db, seeds), pairs, nfft,
    wq, mask)`` for every scene, with the rendered signals never handed
    back.  base (..., len), tau / gains (..., M, paths) -> (win (..., P,
    2*wq*128), stats (..., P, 3)).

    Replaces ``bfly_scene_windowed`` (pyaudiolocalization_tpu/ops/
    pallas_fft.py:1600; ``_bfly_scene_kernel`` :1503).  The TPU kernel kept
    one scene in VMEM; one scene's 4 x 65,536 complex spectra (2 MB)
    exceed a block's 227 KB of shared memory, so here one host entry runs
    K3's render stage and K2's GCC stage for all scenes back to back on
    one stream, the render on K3's route (``render_route``) with K3's
    finish and the GCC on K2's route (``gcc_route``): up to 4,096 points
    ``render_block`` then ``window_block``, two launches (beyond the
    one-block mic limit ``render_block``, K4a's one-block transform into
    the mic rows' spectra and a block a packed cross row, three); at
    65,536 three launches each on the four-step split, with the finalize
    between, seven in all; where ``gcc_rows`` does not fit (2^20 and up
    at any mic count) the GCC's four launches through the mic rows'
    spectra; from 2^20 to 2^24 the render's four through the base rows'
    spectra and the finish's one to four (``finish_groups``); above, to
    2^30, the render's six and the GCC's six on the three-pass split with
    the finish between; the intermediates in device memory and L2.  The
    render writes each finished signal as the packed forward input of the
    GCC stage (zero-padded to nfft), which the GCC's block or column pass
    reads (on the split in place, on the three-pass split into the other
    buffer of packed mic rows).  The same stage code as ``delay_sum``
    then ``gcc_windowed``, so the two paths agree to the bit on the same
    inputs; a batch whose grids would exceed 65,535 rows launches over the
    scene chunks those two take (``scene_chunk``).  Bound by device
    memory."""
    _check_noise_pair("scene_windowed", snr_db, seeds)
    _check_window("scene_windowed", nfft, wq)
    if _use_plain(base, tau, gains, fade, mask):
        return scene_windowed_plain(base, tau, gains, pairs_i, pairs_j, nfft,
                                    out_samples, wq, fade, mask, snr_db,
                                    seeds, eps)
    _check_contiguous("scene_windowed", base, tau, gains, fade, mask)
    _check_f32("scene_windowed", base, tau, gains, fade, mask)
    _check_pow2(nfft)
    lead, scenes, length, mics, paths = _render_shapes(
        "scene_windowed", base, tau, gains, nfft, out_samples, fade)
    snr_db, seeds = _check_noise("scene_windowed", snr_db, seeds, lead,
                                 base.device)
    pi, pj = _check_pairs("scene_windowed", pairs_i, pairs_j, mics)
    num_pairs = int(pi.shape[0])
    couples = (num_pairs + 1) // 2
    if mask.shape != (nfft // 2 + 1,):
        raise ValueError("scene_windowed: unsupported shapes")
    lib = _library()
    dev = base.device
    pi_t = torch.as_tensor(pi, dtype=torch.int32, device=dev)
    pj_t = torch.as_tensor(pj, dtype=torch.int32, device=dev)
    width = 2 * wq * 128
    win = torch.empty(lead + (num_pairs, width), dtype=torch.float32,
                      device=dev)
    stats = torch.empty(lead + (num_pairs, 3), dtype=torch.float32,
                        device=dev)
    chunk = scene_chunk(scenes, mics, num_pairs, nfft)
    rroute = render_route(nfft)
    route = gcc_route(nfft, mics)
    packed, cross = (chunk * mics + 1) // 2, chunk * couples
    # The packed base rows as K3 takes them (none in one block; in the
    # packed mic rows' buffer through the base rows' spectra); the packed
    # mic rows, which hold the finished signals between the stages, large
    # enough for the cross rows where the GCC goes through the spectra
    # (they go there once the spectra are written); on the three-pass
    # split a second buffer of packed mic rows, where the render's pass A'
    # leaves the finished signals; the cross rows as K2 takes them on the
    # rows route; one spectra buffer for the GCC's spectra routes and the
    # render's, the GCC's rows being the more.
    long = route.kind == ROUTE_LONG    # the render's route is long too
    spectra = route.kind in (ROUTE_SPECTRA, ROUTE_LONG)
    rspectra = rroute.kind in (ROUTE_SPECTRA, ROUTE_LONG)
    _zm = _scratch(max(packed, cross) if spectra else packed, nfft, dev)
    _zm1 = _scratch(packed, nfft, dev) if long else None
    zm0, zm1 = _zm.data_ptr(), _ptr(_zm1)
    _zb = (_scratch((chunk + 1) // 2, nfft, dev)
           if rroute.kind == ROUTE_ROWS else None)
    zb = zm0 if rspectra else _ptr(_zb)
    _cpl = _scratch(cross, nfft, dev) if route.kind == ROUTE_ROWS else None
    cpl0 = zm0 if spectra else _ptr(_cpl)
    strips = _route_strips(route, nfft, packed) if spectra else (0, 0, 0)
    gcc_spectra = spectra or route.kind == ROUTE_SPECTRA_BLOCK
    spec = None
    if gcc_spectra or rspectra:
        spec = torch.empty((chunk * mics if gcc_spectra else chunk,
                            nfft // 2 + 1), dtype=torch.complex64,
                           device=dev)
    rstrips = _render_strips(rroute, chunk, nfft)
    keys, count, part = _window_scratch(cross, nfft, route, dev)
    groups, fpart = _finish_scratch(nfft, scenes, chunk, mics, dev)
    tw = _twiddles(nfft, str(dev))
    base_s, tau_s, gains_s, snr_s, seeds_s, win_s, stats_s = _scene_views(
        lead, base, tau, gains, snr_db, seeds, win, stats)
    for g, s0 in zip(groups, range(0, scenes, chunk)):
        _launch("scene_windowed", dev, lib.palt_scene_windowed,
                base_s[s0].data_ptr(), min(chunk, scenes - s0), length,
                tau_s[s0].data_ptr(), gains_s[s0].data_ptr(), mics, paths,
                nfft, rroute.n1, route.n1, route.kind, *strips,
                _long_n1a(nfft), out_samples, fade.data_ptr(),
                _at(snr_s, s0), _at(seeds_s, s0), pi_t.data_ptr(),
                pj_t.data_ptr(), num_pairs, mask.data_ptr(), eps, wq,
                tw.data_ptr(), zb, zm0, zm1, cpl0, _ptr(spec), _ptr(keys),
                _ptr(count), _ptr(part), rroute.kind,
                *rstrips, g, _ptr(fpart), win_s[s0].data_ptr(),
                stats_s[s0].data_ptr())
    return win, stats


# ---------------------------------------------------------------------------
# K7: PHAT whitening of complex spectra
# ---------------------------------------------------------------------------

def whiten_plain(spec: torch.Tensor, eps: float = PHAT_EPS) -> torch.Tensor:
    re, im = spec.real, spec.imag
    inv = 1.0 / (torch.sqrt(re * re + im * im) + eps)
    return torch.complex(re * inv, im * inv)


def whiten(spec: torch.Tensor, eps: float = PHAT_EPS,
           inplace: bool = False) -> torch.Tensor:
    """spec / (|spec| + eps) elementwise over a complex tensor of any
    shape, computed as re * inv, im * inv with inv = 1 / (sqrt(re² + im²)
    + eps).  ``inplace=True`` lets the kernel overwrite ``spec`` (for a
    caller that owns it); use the return value either way.

    Replaces ``phat_whiten_planes`` (pyaudiolocalization_tpu/ops/
    pallas_kernels.py:34), which takes separate (rows, bins) real and
    imaginary planes; the port's spectra are complex64, so the kernel reads
    them interleaved, one pass, 8 bytes in and 8 out per bin, two bins a
    thread with 16-byte loads and stores (a view that starts between two
    16-byte words, such as ``spec[..., 1:]``, takes its first bin alone).
    Bound by device-memory bandwidth; at one scene's 44,100 bins, by the
    launch."""
    if _use_plain(spec):
        return whiten_plain(spec, eps)
    _check_contiguous("whiten", spec)
    if spec.dtype != torch.complex64:
        raise ValueError(f"whiten: the kernel takes complex64, got "
                         f"{spec.dtype}")
    lib = _library()
    out = spec if inplace else torch.empty_like(spec)
    _launch("whiten", spec.device, lib.palt_whiten, spec.data_ptr(),
            spec.numel(), eps, out.data_ptr())
    return out
