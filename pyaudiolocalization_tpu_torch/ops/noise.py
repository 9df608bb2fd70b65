"""Counter-based Gaussian measurement noise and the noise-null bootstrap's
uniform draws: the plain PyTorch twin of the generator the render and
bootstrap kernels run in-kernel (``csrc/philox.cuh``).

The TPU kernels draw their noise from the TPU core's own random bits
(``pltpu.prng_seed`` / ``prng_random_bits``,
pyaudiolocalization_tpu/ops/pallas_fft.py:1807-1833), which no other
machine reproduces.  The port replaces them with Philox4x32-10 (Salmon et
al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011):

* key = (scene word 0, scene word 1 + mic * 0x9E3779B9 mod 2^32): the
  scene's two int32 seed words with the TPU kernels' per-mic Weyl mix
  (pallas_fft.py:1548, :1777);
* counter = (sample index, 0, 0, 0);
* the first two output words, shifted right by 8, are the 24-bit integers
  b1, b2 of the TPU kernel's Box-Muller (pallas_fft.py:1826-1829):
  u1 = b1 * 2^-24 + 2^-25, u2 = b2 * 2^-24,
  z = sqrt(-2 ln u1) * cos(2 pi u2).

Kernel and twin compute the same integers; the float32 transcendental
functions may differ in the last unit.  uint32 products do not fit torch's
signed int64, so ``_mulhilo`` splits the counter word into 16-bit halves.
"""

from __future__ import annotations

import math

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF
LN10_OVER_20 = math.log(10.0) / 20.0


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x, x holding uint32
    values in int64; every partial product stays below 2^49."""
    p1 = m * (x >> 16)
    p0 = m * (x & 0xFFFF)
    mid = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (mid >> 32), mid & _MASK


def philox_bits(key0: torch.Tensor, key1: torch.Tensor,
                counter: torch.Tensor):
    """Philox4x32-10 with counter (counter, 0, 0, 0): returns the first two
    output words as int64 tensors of uint32 values, broadcast over the
    shapes of key0, key1 (uint32 values in int64) and counter."""
    c0 = counter & _MASK
    c1 = torch.zeros_like(c0)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = key0 & _MASK
    k1 = key1 & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK
            k1 = (k1 + PHILOX_W1) & _MASK
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's Box-Muller on two 24-bit integers, in float32."""
    u1 = b1.to(torch.float32) * (2.0 ** -24) + 2.0 ** -25
    u2 = b2.to(torch.float32) * (2.0 ** -24)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def mic_keys(seeds: torch.Tensor, num_mics: int):
    """(key0, key1) of shape (..., M, 1) from int32 scene seeds (..., 2)."""
    s = seeds.to(torch.int64) & _MASK
    mics = torch.arange(num_mics, dtype=torch.int64, device=seeds.device)
    key0 = s[..., None, 0:1].expand(*s.shape[:-1], num_mics, 1)
    key1 = (s[..., None, 1:2] + (mics * PHILOX_W0)[:, None]) & _MASK
    return key0, key1


def normal(seeds: torch.Tensor, num_mics: int,
           num_samples: int) -> torch.Tensor:
    """(..., M, num_samples) float32 standard normals for scene seeds
    (..., 2) int32: mic m's stream is keyed by the Weyl-mixed seed, sample
    t draws counter t."""
    key0, key1 = mic_keys(seeds, num_mics)
    t = torch.arange(num_samples, dtype=torch.int64, device=seeds.device)
    w0, w1 = philox_bits(key0, key1, t)
    return bits_to_normal(w0 >> 8, w1 >> 8)


def uniform(seeds: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, num_samples) float32 uniforms in [-0.5, 0.5) for draw seeds
    (B, 2) int32: draw d's stream is keyed by its two seed words read as
    uint32, sample t draws counter t, and the value is the first output
    word reinterpreted as int32 times 2^-32 (the noise-null bootstrap's
    draw, ``csrc/philox.cuh`` ``philox_uniform``; the TPU kernel bitcasts
    its raw bits the same way, pallas_fft.py:1305-1307).  The int32 ->
    float32 conversion rounds as the kernel's does; the scale is exact."""
    s = seeds.to(torch.int64) & _MASK
    t = torch.arange(num_samples, dtype=torch.int64, device=seeds.device)
    w0, _ = philox_bits(s[:, 0:1], s[:, 1:2], t)
    signed = w0 - ((w0 >> 31) << 32)
    return signed.to(torch.float32) * (2.0 ** -32)


def add_noise(signals: torch.Tensor, snr_db: torch.Tensor,
              seeds: torch.Tensor) -> torch.Tensor:
    """signals (..., M, N) + sigma * z with sigma = rms * 10^(-snr/20) per
    mic (rms over the N samples), snr_db (...,), seeds (..., 2) int32, in
    the signals' dtype (float32 on the kernels' path)."""
    x = signals
    rms = torch.sqrt(torch.sum(x * x, -1) / x.shape[-1])
    sigma = rms * torch.exp(-snr_db.to(x.dtype)[..., None] * LN10_OVER_20)
    z = normal(seeds, x.shape[-2], x.shape[-1]).to(x.dtype)
    return x + sigma[..., None] * z
