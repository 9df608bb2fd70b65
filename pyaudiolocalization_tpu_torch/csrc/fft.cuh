// Batched power-of-two complex FFT for the port's kernels (sm_90a).
//
// One radix-2 Stockham pass per launch over rows in device memory,
// ping-ponging between two buffers; after log2(n) passes the row is in
// natural order.  Twiddles come from a table tw[m] = exp(-2*pi*i*m/n),
// m < n/2, made in double precision on the host and rounded once to f32;
// inverse passes use the conjugate (no 1/n scale).
//
// Bounds: a 65,536-point row is 512 KB, more than the 227 KB of shared
// memory a block can hold, so every pass streams the rows through device
// memory (and the 50 MB L2): each pass reads and writes 16 bytes per
// point, which makes the transform memory-bound at about 16 * log2(n)
// bytes per point.  Shared-memory sub-transforms (a four-step split) are
// the speed work that comes after correctness.
#pragma once

#include <cuda_runtime.h>

namespace palt {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One Stockham pass: p is the length of the sub-transforms already done
// (1, 2, 4, ..., n/2).  blockIdx.y selects the row.
__global__ void stockham_pass(const float2* __restrict__ in,
                              float2* __restrict__ out,
                              const float2* __restrict__ tw, int n, int p,
                              int inverse) {
  const int half = n >> 1;
  const int stride = half / p;
  const size_t row = (size_t)blockIdx.y * (size_t)n;
  const float2* x = in + row;
  float2* y = out + row;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < half;
       i += gridDim.x * blockDim.x) {
    const int k = i & (p - 1);
    float2 w = tw[k * stride];  // exp(-i*pi*k/p)
    if (inverse) w.y = -w.y;
    const float2 a = x[i];
    const float2 b = cmul(x[i + half], w);
    const int j = (i << 1) - k;
    y[j] = make_float2(a.x + b.x, a.y + b.y);
    y[j + p] = make_float2(a.x - b.x, a.y - b.y);
  }
}

inline int pass_blocks(int n) {
  int blocks = ((n >> 1) + kThreads - 1) / kThreads;
  return blocks < 1024 ? blocks : 1024;
}

// Transforms `rows` rows of length n held in buf0; returns the buffer
// (buf0 or buf1) that holds the result.  `passes` < log2(n) stops early
// (the caller fuses the last pass into its epilogue); `p0` > 1 starts
// after passes the caller fused into its prologue.
inline float2* fft_rows(float2* buf0, float2* buf1, const float2* tw, int n,
                        int rows, int inverse, int passes,
                        cudaStream_t stream, int p0 = 1) {
  float2* src = buf0;
  float2* dst = buf1;
  int done = 0;
  for (int p = p0; p < n && done < passes; p <<= 1, ++done) {
    dim3 grid(pass_blocks(n), rows);
    stockham_pass<<<grid, kThreads, 0, stream>>>(src, dst, tw, n, p, inverse);
    float2* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

inline int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace palt
