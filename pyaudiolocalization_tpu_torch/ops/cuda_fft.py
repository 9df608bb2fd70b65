"""The port's hand-written CUDA kernels: wrappers, plain twins, build.

Nine kernels replace the Pallas kernels of the TPU package
(``pyaudiolocalization_tpu/ops/pallas_fft.py``, and ``pallas_kernels.py``
for K7):

===================== ====================================== ==================
wrapper               replaces                               bound on an H100
===================== ====================================== ==================
fft_real              bfly_fft_real (:685)                   memory: 2 launches*
whitened_corr         bfly_whitened_corr (:707)              memory: 2 launches*
gcc_all_pairs         bfly_gcc_all_pairs (:922)              memory: 1 to 4*
gcc_windowed          bfly_gcc_windowed (:1095)              memory: 1 to 4*
bootstrap_peaks       bfly_bootstrap_peaks (:1227)           memory: 3 launches
noise_bootstrap_peaks bfly_noise_bootstrap_peaks (:1326)     memory: 3 launches
scene_windowed        bfly_scene_windowed (:1600)            memory: 2 to 12*
delay_sum             bfly_delay_sum (:1851)                 memory: 1 to 8*
whiten                pallas_kernels.phat_whiten_planes (:34) memory: 16 B/bin
===================== ====================================== ==================

(*) Above 2^22 points K9, K1, K2, K3 and K5 run the radix-2 passes, and
K4a, K4b and K6 above 2^24 (K4a: the packing, log2(nfft) passes and the
split into the two spectra, 2 + log2(nfft) launches).  K1, K2 and K5's
GCC take one route a shape
(``gcc_route``): 1 launch in one block a scene, 3 with ``gcc_rows``, 4
through the mic rows' spectra on the split, 2 through them in one block.
K3's render and K5's render stage take one route a length
(``render_route``): 1 launch in one block, 3 with ``render_rows``, 4
through the base rows' spectra, then the finish: 1 launch, a block a mic
row, or up to 4 spread over the card (``finish_groups``).

The three kernels of K10, the TPU package's A/B tool of FFT schedules
(``tools/mxu_rowdft_bench.py:328``), are wrapped by ``ops/rowdft.py``
(``row_dft``, ``row_stages``, ``lane_dft``) and built into the same
library from ``csrc/rowdft.cu``; their launches count here too.

All but ``whiten`` are built on one FFT (``csrc/fft.cuh``) in two
schedules.  ``fft_real``, ``bootstrap_peaks``, ``noise_bootstrap_peaks``,
``gcc_all_pairs`` and ``whitened_corr`` (and K10's ``row_stages``) and,
where ``render_route`` and ``gcc_route`` give the split, ``delay_sum``,
``gcc_windowed`` and ``scene_windowed`` run on-chip sub-transforms: a
block holds a strip of sequences in shared memory for all of its
radix-16 stages, and a long row is a four-step split of two such
launches (``fft_real_split``; the bootstrap, the render's ``render_rows``
and the GCCs' ``gcc_rows`` routes run it forward and back in three, the
middle launch holding rows for both directions; K9, whose input is
spectra, in two; the GCCs' spectra route K4a's two, then K9's two with a
pair-indexed loader, and the render's K4a's two into the base rows'
spectra, then a mix row pass and the column pass; up to 2^22 for K9 and
the GCCs and renders of K1, K2, K3 and K5, whose strips narrow to 8 at
2,048, and up to 2^24 for K4a, K4b and K6, whose strips narrow to 4 at
4,096, ``split_strips``; ``split_plan`` gives each launch of theirs, with
the row strips' bank-spread stride), so a transform reads
and writes each point once per launch (16 bytes a complex point) and is
bound by device memory at that.  Up to 4,096 points the bootstraps, K9,
the render (a packed base row a block) and the all-pairs and windowed
GCCs (a scene a block up to 10 mics at 4,096, else a packed cross row a
block through the mic rows' spectra) hold a whole row in one block, so
K3 is one launch there, K2 one or two and K5 two or three.  The others
run radix-2 Stockham passes over rows in device memory, one launch and
16 bytes a point per pass, about 16·log2(nfft) bytes per point and
transform, and fuse their first or last pass into a prologue or
epilogue: everything above 2^22 (for K4a, K4b and K6 above 2^24).
The design keeps the rest of the work out of device memory where the TPU
kernels did: real rows are packed two to a complex transform, the whitening /
ramp synthesis runs in one pass over the spectra, two real results share
each inverse, and the bootstrap's maxima and the windowed GCC's lag
window and statistics are taken inside the last inverse pass instead of
writing the correlation.  The TPU kernels' bit-reversed (N2, 128) plane
layout is not carried over: spectra are in natural order.  The
all-pairs GCC, render, windowed-GCC and scene kernels take a leading
scene axis; a launch covers every scene, and a batch beyond the grids'
65,535 rows launches over scene chunks (``scene_chunk``, one rule for the
four kernels).  K4a, K4b, K6 and K9 take a batch of rows beyond their
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
# K4a: one block holds the packed row up to this length; the four-step
# split of two on-chip transforms reaches 2048 x 2048 for K9 and the GCCs
# and renders of K1, K2, K3 and K5 (FFT_REAL_MAX), with strips of 8 at
# 2,048 (``split_strips``), 4096 x 4096 for K4a, K4b and K6
# (FFT_SPLIT_MAX), with strips of 4 at 4,096, and 1024 x 1024 for the row
# passes that hold more than one strip (STAGE_SPLIT_MAX): the GCCs'
# ``gcc_rows`` route and the render's ``render_rows``, whose two strips fit
# to 2^19; elsewhere the GCCs go through their mic rows' spectra
# (``gcc_route``) and the render through its base rows' (``render_route``).
FFT_REAL_ONE_BLOCK = 4096
FFT_REAL_MAX = 1 << 22
FFT_SPLIT_MAX = 1 << 24
STAGE_SPLIT_MAX = 1 << 20
# Rows a split row pass holds (kStrip, csrc/fft.cuh), the strips K4a's,
# K4b's and K6's split may take, widest first (4 only above 2^22), the
# points one block's strip transform holds (kElems * 1024, ``block_fft``)
# and the shared memory one block may opt in to on an H100 (227 KB).
ROW_STRIP = 16
SPLIT_STRIPS = (16, 8, 4)
BLOCK_POINTS = 16 * 1024
SMEM_OPTIN = 232448
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
# launch at 2^23 and 256 at 2^24.
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
            "palt_fft_real": [p, i, i, i, i, i, i, p, p, p, p],
            "palt_noise_bootstrap_peaks": [p, p, i, i, i, i, i, i, f, p, p,
                                           p, p],
            "palt_whiten": [p, ctypes.c_longlong, f, p, p],
            "palt_whitened_corr": [p, p, i, i, i, i, i, p, f, p, p, p, p,
                                   p],
            "palt_gcc_all_pairs": [p, i, i, i, i, i, i, i, i, i, p, p, i, p,
                                   f, p, p, p, p, p, p, p],
            "palt_bootstrap_peaks": [p, p, i, i, i, i, i, i, f, p, p, p,
                                     p],
            "palt_gcc_windowed": [p, i, i, i, i, i, i, i, i, i, p, p, i, p,
                                  f, i, p, p, p, p, p, p, p, p, p, p, p],
            "palt_delay_sum": [p, i, i, p, p, i, i, i, i, i, p, i, p, p, p,
                               p, p, p, p, i, i, i, i, p, i, p, p, p],
            "palt_scene_windowed": [p, i, i, p, p, i, i, i, i, i, i, i, i, i,
                                    i, p, p, p, p, p, i, p, f, i, p, p, p, p,
                                    p, p, p, p, p, p, p, i, i, i, i, i, p, p,
                                    p, p],
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


@functools.lru_cache(maxsize=8)
def _twiddles(nfft: int, device: str) -> torch.Tensor:
    """exp(-2*pi*i*m/nfft), m < nfft/2, made in float64 and rounded once to
    float32, as a (nfft/2, 2) tensor; the exact zero of cos at m = nfft/4
    is kept exact.  On K4a's split above 2^20 (``STAGE_SPLIT_MAX`` < nfft
    <= ``FFT_SPLIT_MAX``) the half tables of n1 and n2
    (``fft_real_split``) follow, made the same way: entry q of the L-point
    table is entry q * nfft / L of the first, bit for bit (the angles
    differ by powers of two), read contiguously by K4a's, K4b's and K6's
    split kernels (``stage_split_twiddles`` and ``stage_split_tables_of``
    in ``csrc/kernels.cu``)."""
    lengths = [nfft]
    if STAGE_SPLIT_MAX < nfft <= FFT_SPLIT_MAX:
        lengths += list(fft_real_split(nfft))
    parts = []
    for n in lengths:
        ang = -2.0 * np.pi * np.arange(n // 2) / n
        tw = np.stack([np.cos(ang), np.sin(ang)], -1)
        tw[np.abs(tw) < 1e-12] = 0.0
        parts.append(tw)
    return torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(
        device)


def _check_pow2(nfft: int) -> None:
    if nfft < 4 or nfft & (nfft - 1):
        raise ValueError(f"nfft must be a power of two >= 4, got {nfft}")


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
    ``ROW_CHUNK``, and where the schedule has scratch (one buffer of packed
    rows on the split, two on the passes: ``_pass_scratch``) at most as
    many as keep it within ``SPLIT_SCRATCH_BYTES``, an even count.  Each
    packed row pair is transformed on its own and each K6 draw keyed by
    its own seed words, so the chunks give one launch's bits."""
    copies = _copies(n1)
    if not copies:
        return ROW_CHUNK
    packed = SPLIT_SCRATCH_BYTES // (copies * nfft * 8)
    return max(2, min(ROW_CHUNK, 2 * packed))


def _split_n1(nfft: int) -> int:
    """n1 of K4a's, K4b's and K6's schedule at nfft: 1, one block, up to
    ``FFT_REAL_ONE_BLOCK``; the four-step split of ``fft_real_split`` up to
    ``FFT_SPLIT_MAX`` (2^24); 0, the radix-2 passes, above."""
    return fft_real_split(nfft)[0] if nfft <= FFT_SPLIT_MAX else 0


def _split_strips(n1: int, nfft: int):
    """The strips K4a's, K4b's and K6's schedule n1 passes to its entry
    point: ``split_strips`` on the split, (0, 0) (unused) elsewhere."""
    return split_strips(n1, nfft // n1) if n1 > 1 else (0, 0)


def _pass_scratch(n1: int, packed: int, nfft: int, device):
    """The scratch of K4a's, K4b's and K6's schedule n1 for ``packed``
    packed rows: none in one block, one buffer on the split, two halves
    of one buffer (ping-pong) on the passes."""
    if n1 == 1:
        return None
    return _scratch(packed * (2 if n1 == 0 else 1), nfft, device)


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
    """(n1, n2) of K4a's four-step split nfft = n1 * n2: (1, nfft) up to
    ``FFT_REAL_ONE_BLOCK`` (one block holds the packed row); up to
    ``FFT_REAL_MAX`` n2 = 2^floor(log2(nfft) / 2) and n1 = nfft / n2 >=
    n2: both at most 1024 up to ``STAGE_SPLIT_MAX`` (2^20), 2048 x 1024 at
    2^21 and 2048 x 2048 at 2^22, where K4a's, K4b's and K6's strips narrow
    to 8 (``split_strips``); above, the long side goes to the contiguous
    rows, n1 = 2^floor(log2(nfft) / 2) <= n2: 2048 x 4096 at 2^23 (column
    strips of 8 still read 64 bytes a row, row strips of 4) and 4096 x
    4096 at ``FFT_SPLIT_MAX`` (2^24, strips of 4)."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return 1, nfft
    short = 1 << ((nfft.bit_length() - 1) // 2)
    if nfft > FFT_REAL_MAX:
        return short, nfft // short
    return nfft // short, short


def fft_real_rows_strip(n2: int, packed: int) -> int:
    """Rows a block of K4a's second pass holds, half of them the partners
    n1 - k1 of the other half; its output runs of consecutive bins are half
    as long.  64 (n2 <= 256) or 32 (n2 <= 512), the most one block's shared
    memory holds, where there are enough packed rows (>= 64) that fewer
    blocks still fill the card; where 16 rows would pass ``BLOCK_POINTS``
    the most it holds, 8 at n2 = 2,048 (2^22) and 4 at 4,096 (2^23, 2^24);
    else 16 (a single row's call is bound by latency, not bytes)."""
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
    """(columns a strip of a column pass holds, rows a strip of the row
    pass holds) on K4a's, K4b's and K6's split n1 x n2: for each, the
    widest of ``SPLIT_STRIPS`` (16, 8, 4) whose strip holds at most
    ``BLOCK_POINTS`` points (``block_fft``'s kElems x 1024) and whose pass
    fits one block's shared memory (``SMEM_OPTIN``): the column pass's
    n1/2 sub-twiddles, n1 + n2 split tables and n1 x S strip
    (``fft_real_cols``; ``boot_cols`` holds less), and ``_row_pass_smem``
    of one strip (``boot_rows``; K4a's own row pass takes
    ``fft_real_rows_strip``).  (16, 16) up to 1024 x 1024, so every
    shape up to 2^20 keeps its strips; (8, 16) at 2048 x 1024 (2^21) and
    (8, 8) at 2048 x 2048 (2^22): 164-172 KB a block; (8, 4) at 2048 x
    4096 (2^23: 188,416 and 196,640 bytes) and (4, 4) at 4096 x 4096
    (2^24: 212,992 and 213,024), whose column strips read one 32-byte
    sector a row."""
    def widest(length, smem):
        for strip in SPLIT_STRIPS:
            if length * strip <= BLOCK_POINTS and smem(strip) <= SMEM_OPTIN:
                return strip
        raise ValueError(f"no strip of {SPLIT_STRIPS} fits the split "
                         f"{n1} x {n2}")
    return (widest(n1, lambda s: 8 * (n1 // 2 + n1 + n2 + n1 * s)),
            widest(n2, lambda s: _row_pass_smem(n1, n2, 1, s)))


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
    runs 512 threads a block above 2^20 (``boot_rows_launch``)."""
    n1, n2 = fft_real_split(nfft)
    if n1 == 1 or nfft > FFT_SPLIT_MAX:
        raise ValueError(f"split_plan: nfft {nfft} is not on the split")
    cs, rs = split_strips(n1, n2)
    s2 = fft_real_rows_strip(n2, packed)
    return SplitPlan(
        SplitPass(cs, 8 * (n1 // 2 + n1 + n2 + n1 * cs)),
        SplitPass(s2, 8 * (n2 // 2 + s2 * row_ld(s2, n2))),
        SplitPass(rs, 8 * (n2 // 2 + n1 + n2 + rs * row_ld(rs, n2))),
        SplitPass(cs, 8 * (n1 // 2 + n1 * cs) + 128))


def _gcc_block_smem(nfft: int, mics: int) -> int:
    """Bytes of shared memory of a scene's GCC in one block (``gcc_block``,
    ``window_block``): the nfft/2 twiddles, the (mics + 1) // 2 packed mic
    rows a scene's mics can span and one spare row."""
    return 8 * (nfft // 2 + ((mics + 1) // 2 + 1) * nfft)


class GccRoute(NamedTuple):
    """The route of K1's, K2's and K5's GCC at one shape (``gcc_route``):
    ``kind`` (``ROUTE_*``, the kernels' ``GccRoute``), ``n1`` (0 on the
    passes, 1 in one block, else the split's n1) and, on the spectra
    route, the strips of the column passes and the row pass (0 elsewhere)."""
    kind: int
    n1: int
    cols: int
    rows: int


ROUTE_PASSES, ROUTE_BLOCK, ROUTE_ROWS, ROUTE_SPECTRA, ROUTE_SPECTRA_BLOCK = (
    range(5))
ROUTE_NAMES = ("passes", "block", "rows", "spectra", "spectra block")


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
    - elsewhere up to ``FFT_REAL_MAX`` (2^22), the split through the mic
      rows' spectra at any mic count (K4a's two passes, ``corr_rows`` with
      the pair-indexed loader, ``corr_cols`` or ``window_cols``), with
      K4a's strips (``split_strips``: 16 and 16 up to 2^20, 8 columns from
      n1 = 2,048 and 8 rows at n2 = 2,048);
    - the radix-2 passes above."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        if _gcc_block_smem(nfft, mics) <= SMEM_OPTIN:
            return GccRoute(ROUTE_BLOCK, 1, 0, 0)
        return GccRoute(ROUTE_SPECTRA_BLOCK, 1, 0, 0)
    if nfft > FFT_REAL_MAX:
        return GccRoute(ROUTE_PASSES, 0, 0, 0)
    n1, n2 = fft_real_split(nfft)
    if (nfft <= STAGE_SPLIT_MAX
            and _row_pass_smem(n1, n2, (mics + 1) // 2 + 1) <= SMEM_OPTIN):
        return GccRoute(ROUTE_ROWS, n1, 0, 0)
    return GccRoute(ROUTE_SPECTRA, n1, *split_strips(n1, n2))


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
    - elsewhere up to ``FFT_REAL_MAX`` (2^22), the split through the base
      rows' spectra (``ROUTE_SPECTRA``): K4a's two passes, the one-strip
      mix row pass ``render_spec_rows`` and ``render_cols``, with K4a's
      strips (``split_strips``: 16 and 16 at 2^20, 8 columns from n1 =
      2,048 and 8 rows at n2 = 2,048);
    - the radix-2 passes above (n1 = 0).

    The mic count does not enter: the render's row passes hold one or two
    strips at any mic count."""
    if nfft <= FFT_REAL_ONE_BLOCK:
        return GccRoute(ROUTE_BLOCK, 1, 0, 0)
    if nfft > FFT_REAL_MAX:
        return GccRoute(ROUTE_PASSES, 0, 0, 0)
    n1, n2 = fft_real_split(nfft)
    if _row_pass_smem(n1, n2, 2) <= SMEM_OPTIN:
        return GccRoute(ROUTE_ROWS, n1, 0, 0)
    return GccRoute(ROUTE_SPECTRA, n1, *split_strips(n1, n2))


def scene_stages(nfft: int, mics: int):
    """(n1 of the render stage, n1 of the GCC stage) for ``mics`` mics a
    scene at nfft: the n1 of ``render_route`` and of ``gcc_route``, the
    routes of K3's render and of K2's windowed GCC (K5 runs each stage as
    K3 and K2 run it).  Both 1 up to 4,096, the split's n1 from 8,192 to
    2^22, 0 (the radix-2 passes) above."""
    return render_route(nfft).n1, gcc_route(nfft, mics).n1


def finish_groups(nfft: int, rows: int) -> int:
    """Blocks a packed mic row of K3's finish (K5's too) for a launch of
    ``rows`` mic rows at nfft: 1 (``render_finalize``, a block of 1,024
    threads a mic row) up to 2^19 and wherever the rows fill the card
    (``FINISH_SMS`` or more); else, on the render's spectra route, enough
    for ``FINISH_BLOCKS`` blocks (``finish_spread``), at most
    ``FINISH_MAX_GROUPS``.  The rule reads the shape only, not the card,
    so that a call's bits do not depend on the card it runs on."""
    if render_route(nfft).kind != ROUTE_SPECTRA or rows >= FINISH_SMS:
        return 1
    return min(FINISH_MAX_GROUPS, -(-FINISH_BLOCKS // ((rows + 1) // 2)))


def corr_schedule(nfft: int) -> int:
    """n1 of K9's schedule at nfft, K4a's up to 2^22: 1, one block a
    packed row (``corr_block``), up to ``FFT_REAL_ONE_BLOCK``; the
    four-step split of ``fft_real_split`` up to ``FFT_REAL_MAX`` (2^22; its
    row pass holds one strip, of 16 rows or 8 at n2 = 2,048, and its column
    pass strips of 16 columns or 8 at n1 = 2,048: ``split_strips``); 0, the
    radix-2 passes, above (where K4a's split goes on to 2^24)."""
    return fft_real_split(nfft)[0] if nfft <= FFT_REAL_MAX else 0


def _copies(n1: int) -> int:
    """Copies of a scratch buffer that a schedule n1 of K1, K2, K3 or K9
    uses: none in one block, one on the split, two (ping-pong) on the
    passes."""
    return 0 if n1 == 1 else (1 if n1 else 2)


def _window_scratch(rows: int, nfft: int, route: GccRoute, device):
    """``window_cols``' partials for ``rows`` packed cross rows on the
    split routes (``gcc_rows``, the spectra): the (max, index) keys (rows
    * 2, int64), the block counters (rows, int32) and the per-block sums
    of |corr| (rows * 2 * n2 / strip, float32; the column strip, 16 on
    ``gcc_rows``, the route's on the spectra); Nones in one block and on
    the passes."""
    if route.kind not in (ROUTE_ROWS, ROUTE_SPECTRA):
        return None, None, None
    blocks = nfft // route.n1 // (route.cols or ROW_STRIP)
    return (torch.empty(2 * rows, dtype=torch.int64, device=device),
            torch.empty(rows, dtype=torch.int32, device=device),
            torch.empty(2 * rows * blocks, dtype=torch.float32,
                        device=device))


def _gcc_buffers(route: GccRoute, scenes: int, mics: int, couples: int,
                 nfft: int, device):
    """K1's and K2's buffers on ``route`` for ``scenes`` scenes a launch:
    the strips argument (column strip, K4a's pass-2 strip, row strip; all
    0 off the spectra route), pointers (spec0, spec1, cross0, cross1) and
    the tensors.  One block a scene: none.  ``gcc_rows``: the packed mic
    rows and the cross rows.  The passes: two copies of each (ping-pong).
    The spectra: K4a's packed rows, which the cross rows reuse once the
    spectra are written, and the spectra (scenes * mics, nfft/2 + 1) in
    spec1; the spectra block route the spectra alone."""
    packed = (scenes * mics + 1) // 2
    cross = scenes * couples
    if route.kind in (ROUTE_SPECTRA, ROUTE_SPECTRA_BLOCK):
        spec = torch.empty((scenes * mics, nfft // 2 + 1),
                           dtype=torch.complex64, device=device)
        if route.kind == ROUTE_SPECTRA_BLOCK:
            return (0, 0, 0), (None, spec.data_ptr(), None, None), [spec]
        buf = _scratch(max(packed, cross), nfft, device)
        s2 = fft_real_rows_strip(nfft // route.n1, packed)
        return ((route.cols, s2, route.rows),
                (buf.data_ptr(), spec.data_ptr(), buf.data_ptr(), None),
                [buf, spec])
    copies = _copies(route.n1)
    spec0, spec1, bufs = _buffers(copies, packed, nfft, device)
    cpl0, cpl1, cross_bufs = _buffers(copies, cross, nfft, device)
    return (0, 0, 0), (spec0, spec1, cpl0, cpl1), bufs + cross_bufs


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _buffers(copies: int, rows: int, nfft: int, device):
    """Pointers to the first and second of ``copies`` scratch buffers of
    (rows, nfft) complex (None where there are fewer), and the tensors."""
    bufs = [_scratch(rows, nfft, device) for _ in range(copies)]
    ptrs = [b.data_ptr() for b in bufs] + [None, None]
    return ptrs[0], ptrs[1], bufs


def fft_real(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """(B, len <= nfft) real rows -> (B, nfft//2 + 1) complex spectra in
    natural order (zero-padded to nfft).

    Replaces ``bfly_fft_real`` (pyaudiolocalization_tpu/ops/pallas_fft.py:
    685), whose output is an opaque bit-reversed (N2, 128) plane layout.
    Two rows share each complex transform.  By length (``_split_n1``): up
    to nfft = 4096 one launch, a block per packed row; up to 2^24 a
    four-step split (``fft_real_split``) of two on-chip launches, the
    columns' DFTs with the twiddle (strips of 16 columns, 8 at n1 = 2,048,
    4 at 4,096: ``split_strips``), then the rows' DFTs with the two real
    spectra split in the epilogue (``fft_real_rows_strip``; the launches
    as ``split_plan`` gives them); above, the
    packed rows, the log2(nfft) radix-2 passes through device memory (one
    launch a pass) and the split into the two spectra.  Bound by device
    memory: the rows' read, one write and one read of the packed
    intermediate (a pass) and the spectra's write.  A batch beyond
    ``_launch_rows`` rows (``ROW_CHUNK``, or the scratch's byte cap)
    launches in chunks."""
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
    n1 = _split_n1(nfft)
    chunks = _row_chunks(rows, _launch_rows(n1, nfft))
    packed = (chunks[0][1] + 1) // 2 if chunks else 0
    buf = _pass_scratch(n1, packed, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        plan = split_plan(nfft, (r1 - r0 + 1) // 2) if n1 > 1 else None
        cols, s2 = (plan.cols.strip, plan.rows.strip) if plan else (0, 0)
        _launch("fft_real", dev, lib.palt_fft_real, x[r0].data_ptr(),
                r1 - r0, length, nfft, n1, cols, s2, tw.data_ptr(),
                _ptr(buf), out[r0].data_ptr())
    return out


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
    holding it in shared memory, no scratch; up to ``FFT_REAL_MAX`` (2^22)
    two launches over one scratch buffer on K4b's four-step split — a row
    pass that gathers each strip's bins of ``a`` and ``b``, whitens and
    runs the inverse row DFTs, and K1's column pass, whose inverse column
    DFTs write the rows in natural order (strips of 16 rows and columns, 8
    at 2,048: ``split_strips``); above, the radix-2 passes.
    Bound by device memory (the spectra's read, the rows' write, one
    write and one read of the packed buffer on the split); a single pair's
    call by its launches' latency.  A batch beyond ``ROW_CHUNK`` row
    pairs launches in chunks."""
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
    cols, strip = _split_strips(n1, nfft)
    chunks = _row_chunks(rows)
    z0, z1, _z = _buffers(_copies(n1), (chunks[0][1] + 1) // 2, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        _launch("whitened_corr", dev, lib.palt_whitened_corr,
                a[r0].data_ptr(), b[r0].data_ptr(), r1 - r0, nfft, n1, cols,
                strip, mask.data_ptr(), eps, tw.data_ptr(), z0, z1,
                out[r0].data_ptr())
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


def scene_chunk(scenes: int, mics: int, num_pairs: int = 0) -> int:
    """Scenes per launch of K1, K2, K3 and K5, one rule for all four:
    every grid's y extent stays within 65,535 — the packed base rows
    ((chunk + 1) / 2), the packed mic rows ((chunk * mics + 1) / 2), the
    scenes of a GCC row pass (chunk) and the pair couples (chunk *
    couples).  The couples are those of the larger of ``num_pairs`` and
    the all-pairs count M (M - 1) / 2, so that K3, which has no pairs,
    chunks as K2 and K5 do over all pairs of the same scenes, and the
    sweep's fused and split paths stay equal to the bit.  A chunk short of
    ``scenes`` is even, so that rows pack two to a transform (the bases,
    and the mic rows of an odd mic count, across scenes) as one launch
    over every scene packs them; each scene's noise comes from its own
    seed words, so a chunk draws what one launch would."""
    couples = max(1, (max(num_pairs, mics * (mics - 1) // 2) + 1) // 2)
    limit = min(_MAX_GRID_Y // couples, 2 * _MAX_GRID_Y // max(mics, 1))
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
    split into the two pairs.  By route (``gcc_route``, K2's):

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
    - the spectra (8,192 to ``FFT_REAL_MAX``, 2^22, where ``gcc_rows``
      does not fit, at any mic count; every mic count from 2^20 on): four
      launches — K4a's two passes write the mic rows' natural-order
      spectra (scenes * M, nfft/2 + 1), K9's row pass reads rows scene * M
      + pairs_i[p] and scene * M + pairs_j[p] of them (the pair-indexed
      loader) into the packed cross rows, and the column pass as above;
      the strips are K4a's (``split_strips``, ``fft_real_rows_strip``: 16
      columns and rows up to 2^20; 8 columns, 16 rows at 2^21 and 8 at
      2^22), and the cross rows reuse K4a's packed buffer;
    - the spectra block (nfft <= 4,096 beyond 10 mics; 24 at 2,048): two
      launches, K4a's one-block transform of every mic row into the
      spectra, then K9's one-block kernel a packed cross row with the
      pair-indexed loader;
    - above 2^22 the radix-2 passes through device memory.

    A batch whose grids would exceed 65,535 rows launches over scene
    chunks (``scene_chunk``; the one-block routes have no such limit).
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
             else scene_chunk(scenes, mics, num_pairs))
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
                nfft, route.n1, route.kind, *strips, pi_t.data_ptr(),
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
    elsewhere up to 2^22, four launches through the mic rows' spectra, as
    K1's: K4a's two passes, the pair-indexed row pass (which also clears
    the argmax keys and block counters) and that column pass, with K4a's
    strips (8 columns from 2^21).  Above 2^22 the radix-2 passes, the last
    one fused with the window and the statistics.  Bound by device
    memory.  A batch whose grids would exceed 65,535 rows launches over
    scene chunks (``scene_chunk``), in one block too, so that K2 chunks as
    K5 does."""
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
    chunk = scene_chunk(scenes, mics, num_pairs)
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
                nfft, route.n1, route.kind, *strips, pi_t.data_ptr(),
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
      2,048, 4 at 4,096) that runs the forward row DFTs, the whitening, the
      inverse row DFTs and the inverse twiddle in shared memory and writes
      back in place; and a column pass whose inverse column DFTs end in
      the maxima (the column passes' strips 16 columns, 8 at n1 = 2,048,
      4 at 4,096: ``split_strips``; the row pass in 512 threads from
      2^21);
    - above: the radix-2 passes through device memory (one launch a
      pass), ping-ponging in a scratch buffer of twice the packed rows.

    Bound by device memory: the rows' read and, on the split, two reads
    and two writes of the packed buffer (32 bytes a point of the packed
    rows).  A batch beyond ``_launch_rows`` rows (``ROW_CHUNK``, or as
    many as keep the scratch within ``SPLIT_SCRATCH_BYTES``: 512 rows at
    2^23, 256 at 2^24) launches in chunks, with one launch's peaks."""
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
    chunks = _row_chunks(num, _launch_rows(n1, nfft))
    buf = _pass_scratch(n1, (chunks[0][1] + 1) // 2, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        _launch("bootstrap_peaks", dev, lib.palt_bootstrap_peaks,
                s1.data_ptr(), rows[r0].data_ptr(), r1 - r0, length, nfft,
                n1, cols, strip, eps, tw.data_ptr(), _ptr(buf),
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
    the radix-2 passes above) with its row load replaced by the draw, made
    where the first forward step reads the point (two draws per complex
    transform), so the rows never exist in device memory and no
    permutation is sorted.  The draws and everything after them are K4b's, so the peaks
    equal ``bootstrap_peaks`` of ``noise_ops.uniform(seeds, n_samp)``
    bit for bit on the split and in one block.  Bound by device memory
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
    chunks = _row_chunks(num, _launch_rows(n1, nfft))
    buf = _pass_scratch(n1, (chunks[0][1] + 1) // 2, nfft, dev)
    tw = _twiddles(nfft, str(dev))
    for r0, r1 in chunks:
        _launch("noise_bootstrap_peaks", dev,
                lib.palt_noise_bootstrap_peaks, s1.data_ptr(),
                seeds[r0].data_ptr(), r1 - r0, n_samp, nfft, n1, cols, strip,
                eps, tw.data_ptr(), _ptr(buf), out[r0:].data_ptr())
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
    launch: the strips argument (column strip, K4a's pass-2
    strip, row strip; all 0 off the spectra route), pointers (zb0, zb1,
    z0, z1), the spectra (or None) and the tensors.  One block: none.
    ``render_rows``: the packed base rows and the packed mic rows.  The
    passes: two copies of each (ping-pong).  The base rows' spectra: the
    packed mic rows, whose buffer takes K4a's packed base rows first (they
    are dead once their spectra are written), and the spectra (scenes,
    nfft/2 + 1)."""
    packed_b, packed = (scenes + 1) // 2, (scenes * mics + 1) // 2
    if route.kind != ROUTE_SPECTRA:
        copies = _copies(route.n1)
        zb0, zb1, bufs = _buffers(copies, packed_b, nfft, device)
        z0, z1, mic_bufs = _buffers(copies, packed, nfft, device)
        return (0, 0, 0), (zb0, zb1, z0, z1), None, bufs + mic_bufs
    z = _scratch(packed, nfft, device)
    spec = torch.empty((scenes, nfft // 2 + 1), dtype=torch.complex64,
                       device=device)
    return (_render_strips(route, scenes, nfft),
            (z.data_ptr(), None, z.data_ptr(), None), spec, [z])


def _render_strips(route: GccRoute, scenes: int, nfft: int):
    """(column strip, K4a's pass-2 strip, row strip) of the render's
    spectra route for ``scenes`` scenes a launch (two a packed base row);
    (0, 0, 0) on the other routes."""
    if route.kind != ROUTE_SPECTRA:
        return 0, 0, 0
    return (route.cols,
            fft_real_rows_strip(nfft // route.n1, (scenes + 1) // 2),
            route.rows)


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
    inverse column DFTs in place; from 2^20 to 2^22, where that row pass's
    two strips do not fit, four: K4a's two passes write the bases' half
    spectra, a row pass mixes each packed mic row's strip from them (one
    strip at any mic count) and runs its inverse row DFTs, and the inverse
    column DFTs (8-wide strips at 2,048); above 2^22 the radix-2 passes.
    Then the finish: a block a mic row (``render_finalize``), or, where a
    call's rows from 2^20 are too few to fill the card, spread over
    ``finish_groups`` blocks a packed mic row in up to four launches
    (``finish_spread``: its maxima and sums of squares combined across
    the blocks in block order).  Bound by device memory.  A batch whose
    grids would exceed 65,535 rows launches over the scene chunks K2 and
    K5 take for all pairs of the same mics (``scene_chunk``), in one block
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
    chunk = scene_chunk(scenes, mics)
    route = render_route(nfft)
    strips, (zb0, zb1, zm0, zm1), spec, _bufs = _render_buffers(
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
                _at(seeds_s, s0), tw.data_ptr(), zb0, zb1, zm0, zm1,
                route.kind, *strips, _ptr(spec), g, _ptr(part),
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
    spectra; from 2^20 to 2^22 the render's four through the base rows'
    spectra and the finish's one to four (``finish_groups``); the
    intermediates in device memory and L2.  The render
    writes each finished signal as the packed forward input of the GCC
    stage (zero-padded to nfft), which the GCC's block or column pass
    reads (on the split in place).  The same stage code as ``delay_sum``
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
    chunk = scene_chunk(scenes, mics, num_pairs)
    rroute = render_route(nfft)
    route = gcc_route(nfft, mics)
    packed, cross = (chunk * mics + 1) // 2, chunk * couples
    # The packed base rows as K3 takes them (none in one block; in the
    # packed mic rows' buffer through the base rows' spectra); the packed
    # mic rows, which hold the finished signals between the stages, once
    # where the render does not run the passes (the GCC runs them only
    # above 2^22, where the render does too), the first copy large enough
    # for the cross rows on the GCC's spectra route (they go there once
    # the spectra are written); the cross rows as K2 takes them on the
    # other routes; one spectra buffer for the GCC's spectra routes and
    # the render's, the GCC's rows being the more.
    rspectra = rroute.kind == ROUTE_SPECTRA
    zb0, zb1, _zb = _buffers(0 if rspectra else _copies(rroute.n1),
                             (chunk + 1) // 2, nfft, dev)
    two = rroute.kind == ROUTE_PASSES
    spectra = route.kind == ROUTE_SPECTRA
    _zm = [_scratch(max(packed, cross) if spectra else packed, nfft, dev)]
    if two:
        _zm.append(_scratch(packed, nfft, dev))
    zm0, zm1 = _zm[0].data_ptr(), (_zm[1].data_ptr() if two else None)
    if rspectra:
        zb0 = zm0
    strips, spec = (0, 0, 0), None
    if spectra:
        cpl0, cpl1 = zm0, None
        strips = (route.cols, fft_real_rows_strip(nfft // route.n1, packed),
                  route.rows)
    else:
        cpl0, cpl1, _cpl = _buffers(
            0 if route.kind == ROUTE_SPECTRA_BLOCK else _copies(route.n1),
            cross, nfft, dev)
    gcc_spectra = route.kind in (ROUTE_SPECTRA, ROUTE_SPECTRA_BLOCK)
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
                nfft, rroute.n1, route.n1, route.kind, *strips, out_samples,
                fade.data_ptr(), _at(snr_s, s0), _at(seeds_s, s0),
                pi_t.data_ptr(), pj_t.data_ptr(), num_pairs, mask.data_ptr(),
                eps, wq, tw.data_ptr(), zb0, zb1, zm0, zm1, cpl0, cpl1,
                _ptr(spec), _ptr(keys), _ptr(count), _ptr(part), rroute.kind,
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
