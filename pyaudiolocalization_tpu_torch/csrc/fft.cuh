// Batched power-of-two complex FFTs for the port's kernels (sm_90a).
// Twiddles come from one table tw[m] = exp(-2*pi*i*m/n), m < n/2, made in
// double precision on the host and rounded once to f32 (w = -tw[e - n/2]
// for e >= n/2); inverses use the conjugates (no 1/n scale).
//
// On-chip sub-transforms (`block_fft`): one block transforms S sequences
// of length L (L * S <= kElems * 1024) held in shared memory, all log2(L)
// stages in one launch: Stockham stages of radix 16 (one of radix 2, 4 or
// 8 first where log2(L) is not a multiple of 4), kElems points a thread
// per stage in registers, a shared-memory exchange between stages (two
// __syncthreads each).  Sub-twiddles exp(-2*pi*i*q/L), q < L/2, are staged
// in shared memory from the table (`stage_twiddles`).  The caller loads
// the strip with coalesced reads and hands the result to its own
// epilogue, so a launch moves 16 bytes per complex point (8 in, 8 out).
// A longer row is a four-step product n = n1 * n2 of two such launches
// (K4a; K4b, K6, K1, and K3's render and K2's GCC stages, both of them in
// K5, run it forward and back in three, the middle one holding the rows
// for both directions; K9 runs the back half in two, and K1's, K2's and
// K5's GCC, where their row pass's strips of every mic row do not fit,
// K4a's two and K9's two, through the mic rows' spectra; K3's render,
// where its two strips do not fit, K4a's two into the base rows' spectra,
// a one-strip mix row pass and the column pass; up to 1024 x 1024 with
// strips of kStrip sequences, up to 2048 x 2048 with strips of 8 where 16
// would pass kElems * 1024 points, up to 4096 x 4096, the long side in the
// rows (2048 x 4096 at 2^23), with strips of 4 at 4,096); above 2^24, to
// 2^30, every
// transforming kernel takes rows of 2,048 points and splits n1 again, n1 =
// n1a * n1b, two column passes of 16 columns each way (the three-pass
// split, `long_forward` in kernels.cu).  The
// length-n2 rows of a (n2, 128) plane are one (K10b, and K10a with its
// radix-16 stages on the tensor cores), and so are the 128-point lane
// DFTs of 32 of its rows (K10c).  Up to 4096 points one block holds a
// whole row (K4a, K4b, K6, K1, K9, K3's render and K2's GCC: a scene where
// its rows fit, else a packed cross row through the mic rows' spectra).
// Bound: device memory, one read and one write per launch.
#pragma once

#include <cuda_runtime.h>

namespace palt {

constexpr int kThreads = 256;
constexpr int kStrip = 16;  // sequences a strip transform holds (tuned;
                            // the split above 2^20 takes 8 at 2,048, 4 at
                            // 4,096 and 2 at 8,192)
constexpr int kElems = 16;  // points a thread holds per stage

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// ---- on-chip sub-transforms ----------------------------------------------

// The dynamic shared memory of a kernel built on block_fft.
__device__ __forceinline__ float2* fft_shared() {
  extern __shared__ __align__(16) float2 palt_fft_smem[];
  return palt_fft_smem;
}

// Lets Kernel take the device's whole opt-in shared memory beside its
// static shared memory (the launch asks for what it uses), once per
// device: the attribute call costs host time that a one-row transform
// would pay on every call.  A failure is returned and also cleared from
// the runtime's last error, so that it does not surface again in a later
// launch's check.
template <auto Kernel>
inline cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  int bytes = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, Kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Threads of a block that transforms S sequences of length L.
inline int fft_threads(int L, int S) {
  return (L * S + kElems - 1) / kElems;
}

// stw[q] = tw[q * stride] = exp(-2*pi*i*q/L), q < L/2, where tw is the
// table of a length n = L * stride.
__device__ __forceinline__ void stage_twiddles(float2* stw,
                                               const float2* __restrict__ tw,
                                               int L, int stride) {
  for (int q = threadIdx.x; q < (L >> 1); q += blockDim.x)
    stw[q] = tw[(size_t)q * stride];
}

// exp(-2*pi*i*e/L) from the half table (sgn < 0: its conjugate), e < L.
__device__ __forceinline__ float2 sub_twiddle(const float2* stw, int e,
                                              int half, float sgn) {
  float2 w = e < half ? stw[e] : stw[e - half];
  if (e >= half) w = make_float2(-w.x, -w.y);
  w.y *= sgn;
  return w;
}

// exp(-2*pi*i*e/16), e < 16 (sgn < 0: the conjugate); e is a constant
// once the callers' loops are unrolled.
__device__ __forceinline__ float2 w16(int e, float sgn) {
  constexpr float c[16] = {
      1.0f, 0.92387953251128674f, 0.70710678118654752f,
      0.38268343236508977f, 0.0f, -0.38268343236508977f,
      -0.70710678118654752f, -0.92387953251128674f, -1.0f,
      -0.92387953251128674f, -0.70710678118654752f, -0.38268343236508977f,
      0.0f, 0.38268343236508977f, 0.70710678118654752f,
      0.92387953251128674f};
  return make_float2(c[e], -sgn * c[(e + 12) & 15]);  // sin = cos(. - pi/2)
}

// In-register DFT of R = 2, 4, 8 or 16 points; sgn < 0 is the unscaled
// inverse.  8 and 16 split as R = 4 * R2: point m = R2*a + b (a < 4,
// b < R2), bin c + 4*d: a DFT-4 over a for each b, times W_R^{bc}, a
// DFT-R2 over b for each c.
template <int R>
__device__ __forceinline__ void dft_small(float2 (&v)[R], float sgn) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = make_float2(a.x + v[1].x, a.y + v[1].y);
    v[1] = make_float2(a.x - v[1].x, a.y - v[1].y);
  } else if constexpr (R == 4) {
    const float2 t0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
    const float2 t1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
    const float2 t2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
    const float2 d = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
    const float2 t3 = make_float2(sgn * d.y, -sgn * d.x);  // -i*sgn*d
    v[0] = make_float2(t0.x + t2.x, t0.y + t2.y);
    v[2] = make_float2(t0.x - t2.x, t0.y - t2.y);
    v[1] = make_float2(t1.x + t3.x, t1.y + t3.y);
    v[3] = make_float2(t1.x - t3.x, t1.y - t3.y);
  } else {
    constexpr int R1 = 4;
    constexpr int R2 = R / 4;
    float2 u[R2][R1];
#pragma unroll
    for (int b = 0; b < R2; ++b) {
#pragma unroll
      for (int a = 0; a < R1; ++a) u[b][a] = v[R2 * a + b];
      dft_small<R1>(u[b], sgn);
#pragma unroll
      for (int c = 1; c < R1; ++c)
        if (b > 0) u[b][c] = cmul(u[b][c], w16(b * c * (16 / R), sgn));
    }
#pragma unroll
    for (int c = 0; c < R1; ++c) {
      float2 t[R2];
#pragma unroll
      for (int b = 0; b < R2; ++b) t[b] = u[b][c];
      dft_small<R2>(t, sgn);
#pragma unroll
      for (int d = 0; d < R2; ++d) v[c + R1 * d] = t[d];
    }
  }
}

// One radix-R Stockham stage in place over the strip, p = the length of
// the sub-transforms done.  Butterfly i of sequence s reads points
// i + m*L/R, multiplies point m by W_{pR}^{m k} (k = i mod p), and writes
// the R-point DFT to (i - k)*R + k + m*p.  Thread t takes butterflies
// t + u*blockDim.x, u < E/R (E points a thread: kElems, or twice as many
// where a block runs half the threads), sequence fastest (s = task mod
// S), so a half-warp touches 16 neighbouring sequences.  The first stage
// (p = 1) needs no twiddle.
template <int S, int R, int E = kElems>
__device__ __forceinline__ void stockham_stage(float2* x, int js, int ss,
                                               int L, int p,
                                               const float2* stw, float sgn) {
  constexpr int kTasks = E / R;
  const int q = L / R;
  const int tasks = q * S;
  const int half = L >> 1;
  const int tstep = L / (p * R);  // W_{pR}^{mk} = W_L^{mk * tstep}
  float2 v[kTasks][R];
#pragma unroll
  for (int u = 0; u < kTasks; ++u) {
    const int task = threadIdx.x + u * blockDim.x;
    if (task < tasks) {
      const int s = task % S;
      const int i = task / S;
      const int k = i & (p - 1);
      const float2* xs = x + s * ss;
#pragma unroll
      for (int m = 0; m < R; ++m) v[u][m] = xs[(i + m * q) * js];
      if (p > 1) {
#pragma unroll
        for (int m = 1; m < R; ++m)
          v[u][m] = cmul(v[u][m], sub_twiddle(stw, m * k * tstep, half, sgn));
      }
      dft_small<R>(v[u], sgn);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kTasks; ++u) {
    const int task = threadIdx.x + u * blockDim.x;
    if (task < tasks) {
      const int s = task % S;
      const int i = task / S;
      const int k = i & (p - 1);
      float2* xs = x + s * ss;
      const int base = (i - k) * R + k;
#pragma unroll
      for (int m = 0; m < R; ++m) xs[(base + m * p) * js] = v[u][m];
    }
  }
  __syncthreads();
}

// block_fft's radix-16 stage: stockham_stage<S, 16>, the DFT-16 in float32
// registers.  A caller may pass another stage of the same signature and
// index maps (K10a's W16 product on the tensor cores, rowdft.cu).
template <int S, int E = kElems>
struct Radix16 {
  __device__ __forceinline__ void operator()(float2* x, int js, int ss,
                                             int L, int p, const float2* stw,
                                             float sgn) const {
    stockham_stage<S, 16, E>(x, js, ss, L, p, stw, sgn);
  }
};

// In-place L-point FFT (L a power of two >= 4) of S sequences in shared
// memory, point j of sequence s at x[j*js + s*ss], natural order in and
// out: one stage of radix 2^(log2(L) mod 4) first where that is not 1,
// then radix-16 stages (`stage16`).  stw: the L/2 sub-twiddles in shared
// memory.  sgn = 1 forward, -1 the unscaled inverse.  Needs blockDim.x >=
// L * S / E (``fft_threads`` for E = kElems); every thread of the block
// calls it.  E = 2 * kElems runs two butterflies a thread a stage, each
// the same arithmetic, in a block of half the threads.  Synchronizes on
// entry and exit.
//
// `block_fft_inline` is the same transform inlined where it is called: a
// kernel that runs two transforms (K4b's and K6's row pass) calls it, so
// that neither becomes a function call whose saved registers spill.
template <int S, class Stage16 = Radix16<S>, int E = kElems>
__device__ __forceinline__ void block_fft_inline(
    float2* x, int js, int ss, int L, const float2* stw, float sgn,
    const Stage16& stage16 = Stage16()) {
  __syncthreads();
  int bits = 0;
  while ((1 << bits) < L) ++bits;
  int p = 1 << (bits & 3);
  if (p == 2) stockham_stage<S, 2, E>(x, js, ss, L, 1, stw, sgn);
  if (p == 4) stockham_stage<S, 4, E>(x, js, ss, L, 1, stw, sgn);
  if (p == 8) stockham_stage<S, 8, E>(x, js, ss, L, 1, stw, sgn);
  for (; p < L; p <<= 4) stage16(x, js, ss, L, p, stw, sgn);
}

template <int S, class Stage16 = Radix16<S>, int E = kElems>
__device__ void block_fft(float2* x, int js, int ss, int L,
                          const float2* stw, float sgn,
                          const Stage16& stage16 = Stage16()) {
  block_fft_inline<S, Stage16, E>(x, js, ss, L, stw, sgn, stage16);
}

}  // namespace palt
