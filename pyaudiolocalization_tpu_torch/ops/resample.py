"""Sample-rate conversion by Kaiser-windowed sinc interpolation
(counterpart of the JAX package's ops/resample.py; reference:
signal_processing.py:105-107, resampy's 'kaiser_best').

The same construction as the JAX package: a Kaiser-windowed sinc low-pass
evaluated at fractional positions, with resampy's published kaiser_best
parameters (64 zero crossings, beta ~14.77, roll-off ~0.9476), dilated by
the rate ratio when downsampling.  The JAX package gathers one dense
(n_out, K) window matrix; at 48 -> 44.1 kHz (K = 141) a 24 s channel
makes that several GiB of values, weights and indices.  Here the same sum
runs over chunks of output samples of at most ``CHUNK_BYTES`` of working
memory each.  Every output sample's K-term sum is one row of one chunk, in
the JAX package's order of terms, so the chunking changes no value.

The output positions, the kernel's arguments and its weights are computed
in float64 and the weights cast to the signal's dtype, whatever that is.
The JAX package computes them in the signal's dtype: in float32 a position
near sample n carries an error of up to n * 2^-24 samples, so a 1 s row at
48 kHz comes out up to 1.6e-3 off its float64 resampling, a 4 s row 6.6e-3,
and the error grows with the length (tests/test_torch_audio_io.py pins
both).  In float64 the two packages agree to 1e-12.  Plain tensor
arithmetic on the signal's device; no TPU kernel ran here.
"""

from __future__ import annotations

import math

import torch

# resampy 'kaiser_best' design parameters (public: resampy.filters docs).
KAISER_BEST_ZEROS = 64
KAISER_BEST_BETA = 14.769656459379492
KAISER_BEST_ROLLOFF = 0.9475937167399596

# Working memory of one chunk of output samples: per tap, its index,
# float64 position and weight temporaries (~64 bytes), and the gathered
# values and their products for each leading row.
CHUNK_BYTES = 256 << 20
_WEIGHT_BYTES = 64


def _kaiser_sinc(t: torch.Tensor, num_zeros: int, beta: float,
                 rolloff: float) -> torch.Tensor:
    """Windowed-sinc interpolation kernel h(t), t in input-sample units."""
    inside = torch.abs(t) < num_zeros
    ts = torch.where(inside, t, torch.zeros_like(t))
    sinc = rolloff * torch.sinc(rolloff * ts)
    arg = torch.sqrt(torch.clamp(1.0 - (ts / num_zeros) ** 2, min=0.0))
    window = torch.special.i0(beta * arg) / torch.special.i0(
        torch.tensor(beta, dtype=t.dtype, device=t.device))
    return torch.where(inside, sinc * window, torch.zeros_like(t))


def resample(x: torch.Tensor, sr_orig: float, sr_new: float,
             num_zeros: int = KAISER_BEST_ZEROS,
             beta: float = KAISER_BEST_BETA,
             rolloff: float = KAISER_BEST_ROLLOFF) -> torch.Tensor:
    """Resample the last axis of ``x`` from sr_orig to sr_new.

    Output length = ceil(n * sr_new / sr_orig) (resampy's convention), in
    ``x``'s dtype and on its device.  When downsampling the kernel is
    dilated by the rate ratio to keep the cutoff below the new Nyquist."""
    if sr_orig == sr_new:
        return x
    n_in = x.shape[-1]
    ratio = sr_new / sr_orig
    n_out = int(math.ceil(n_in * ratio))
    scale = min(1.0, ratio)
    half_width = int(math.ceil(num_zeros / scale))
    k = 2 * half_width + 1
    dt, dev = x.dtype, x.device
    rows = math.prod(x.shape[:-1])
    chunk = max(1, CHUNK_BYTES // (k * (_WEIGHT_BYTES
                                        + 2 * x.element_size() * rows)))
    offsets = torch.arange(-half_width, half_width + 1, device=dev)
    out = torch.empty(x.shape[:-1] + (n_out,), dtype=dt, device=dev)
    for o0 in range(0, n_out, chunk):
        o1 = min(o0 + chunk, n_out)
        # Positions in input units, in float64 (module docstring).
        out_pos = torch.arange(o0, o1, dtype=torch.float64,
                               device=dev) / ratio
        base = torch.floor(out_pos).to(torch.int64)
        idx = base[:, None] + offsets[None, :]                  # (c, K)
        valid = (idx >= 0) & (idx < n_in)
        gathered = x[..., torch.clamp(idx, 0, n_in - 1)]         # (..., c, K)
        t = (out_pos[:, None] - idx.to(torch.float64)) * scale
        weights = _kaiser_sinc(t, num_zeros, beta, rolloff) * scale
        weights = torch.where(valid, weights, torch.zeros_like(weights))
        out[..., o0:o1] = torch.sum(gathered * weights.to(dt), -1)
    return out
