// Counter-based noise for the render kernels and the noise-null bootstrap
// (sm_90a).
//
// Replaces the TPU core's hardware random bits of the render and scene
// kernels (pyaudiolocalization_tpu/ops/pallas_fft.py:1807-1833) and of the
// noise-null bootstrap (:1305-1307), which no other machine reproduces,
// with Philox4x32-10 (Salmon et al., SC 2011):
// for the render, key = (scene word 0, scene word 1 + mic * 0x9E3779B9),
// the TPU kernels' per-mic Weyl mix; for the bootstrap, key = the draw's
// two seed words; counter = (sample index, 0, 0, 0).  The first two
// output words shifted right by 8 are the 24-bit integers of the TPU
// kernel's Box-Muller (pallas_fft.py:1826-1829); the first word as int32
// is the bootstrap's uniform.  The plain twin is ops/noise.py; both
// compute the same integers.
//
// Ten rounds of two 32-bit multiplies per sample: a few dozen integer
// operations, far below what the FFT passes around it cost.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace palt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// First two output words of Philox4x32-10 at counter (t, 0, 0, 0).
__device__ __forceinline__ uint2 philox_bits(uint32_t t, uint32_t k0,
                                             uint32_t k1) {
  uint32_t c0 = t, c1 = 0u, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint2(c0, c1);
}

// Standard normal for sample t of the stream keyed (k0, k1).
__device__ __forceinline__ float philox_normal(uint32_t t, uint32_t k0,
                                              uint32_t k1) {
  const uint2 w = philox_bits(t, k0, k1);
  const float u1 = (float)(w.x >> 8) * 5.9604644775390625e-08f  // 2^-24
                   + 2.98023223876953125e-08f;                  // 2^-25
  const float u2 = (float)(w.y >> 8) * 5.9604644775390625e-08f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// Uniform in [-0.5, 0.5) for sample t of the stream keyed (k0, k1): the
// first output word reinterpreted as int32, times 2^-32 (the noise-null
// kernel's draw, ops/pallas_fft.py:1305-1307 of the TPU package, which
// bitcasts its raw bits the same way).  The int32 -> float rounding is the
// only rounding; the scale is exact.
__device__ __forceinline__ float philox_uniform(uint32_t t, uint32_t k0,
                                               uint32_t k1) {
  const int32_t bits = (int32_t)philox_bits(t, k0, k1).x;
  return (float)bits * 2.3283064365386963e-10f;  // 2^-32
}

}  // namespace palt
