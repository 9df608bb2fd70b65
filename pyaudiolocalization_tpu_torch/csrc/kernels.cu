// Hand-written Hopper kernels of the port, with a plain C interface for
// ctypes (ops/cuda_fft.py builds and binds them).
//
// Each entry point launches on the caller's stream, allocates nothing
// (the Python wrapper passes outputs and scratch), and returns the value
// of cudaGetLastError() after its launches (0 = success).
//
// Shared conventions:
//   * real rows are packed two to a complex row (z = a + i*b) before a
//     forward transform; `unpack_bin` recovers either row's spectrum.
//     Rows are numbered across the whole batch (row = scene * M + mic), so
//     a packed row may hold the last mic of one scene and the first of the
//     next;
//   * a consumer writes only bins 0..n/2 of a Hermitian spectrum and
//     mirrors them (`store_packed`), with the imaginary part dropped at DC
//     and Nyquist exactly as irfft drops it, so two real results share
//     one complex inverse transform without leaking into each other
//     (the Hermitian trap noted at ops/pallas_fft.py:1385-1396 of the
//     TPU package).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fft.cuh"
#include "philox.cuh"

using palt::cmul;
using palt::fft_rows;
using palt::kThreads;
using palt::log2_int;

namespace {

constexpr int kRowThreads = 1024;

// Spectrum bin k of the real row packed as the real part (odd = 0) or the
// imaginary part (odd = 1) of a complex row Z, from zk = Z[k] and zm =
// Z[(n - k) mod n]; exactly real at DC and Nyquist (zk = zm).
__device__ __forceinline__ float2 split_bin(float2 zk, float2 zm, int odd) {
  if (!odd) return make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  return make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
}

// Spectrum bin k (0 <= k <= n/2) of real row r, from rows packed in pairs.
__device__ __forceinline__ float2 unpack_bin(const float2* z, int r, int k,
                                             int n) {
  const float2* row = z + (size_t)(r >> 1) * (size_t)n;
  return split_bin(row[k], row[(n - k) & (n - 1)], r & 1);
}

// Writes bins k and n-k of the packed spectrum ya + i*yb of two Hermitian
// spectra given by their bins 0..n/2.
__device__ __forceinline__ void store_packed(float2* row, int k, int n,
                                             float2 ya, float2 yb) {
  const int half = n >> 1;
  if (k == 0 || k == half) {
    ya.y = 0.0f;
    yb.y = 0.0f;
  }
  row[k] = make_float2(ya.x - yb.y, ya.y + yb.x);
  if (k != 0 && k != half) row[n - k] = make_float2(ya.x + yb.y, yb.x - ya.y);
}

// PHAT whitening of a * conj(b), in the TPU kernel's operation order
// (ops/pallas_fft.py:855-863).
__device__ __forceinline__ float2 whiten(float2 a, float2 b, float eps) {
  const float rr = a.x * b.x + a.y * b.y;
  const float ri = a.y * b.x - a.x * b.y;
  const float mag = sqrtf(rr * rr + ri * ri) + eps;
  return make_float2(rr / mag, ri / mag);
}

__device__ __forceinline__ float block_max(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? shared[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) shared[0] = v;
  }
  __syncthreads();
  return shared[0];
}

// Tree sum over the block: warp shuffles, then one warp over the partials.
__device__ __forceinline__ float block_sum(float v, float* shared) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? shared[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) shared[0] = v;
  }
  __syncthreads();
  return shared[0];
}

// (value, index) maximum with ties going to the smallest index.
__device__ __forceinline__ void arg_update(float& best, int& idx, float v,
                                           int j) {
  if (v > best || (v == best && j < idx)) {
    best = v;
    idx = j;
  }
}

__device__ __forceinline__ void block_argmax(float& v, int& idx, float* sv,
                                             int* si) {
  for (int off = 16; off > 0; off >>= 1)
    arg_update(v, idx, __shfl_xor_sync(0xffffffffu, v, off),
               __shfl_xor_sync(0xffffffffu, idx, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x >> 5);
    v = live ? sv[lane] : -INFINITY;
    idx = live ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      arg_update(v, idx, __shfl_xor_sync(0xffffffffu, v, off),
                 __shfl_xor_sync(0xffffffffu, idx, off));
    if (lane == 0) {
      sv[0] = v;
      si[0] = idx;
    }
  }
  __syncthreads();
  v = sv[0];
  idx = si[0];
}

// Real rows x (rows, len), row stride ld, zero-padded to n -> complex rows
// (ceil(rows/2), n) packing rows 2c and 2c+1.
__global__ void pack_rows(const float* __restrict__ x, int rows, int len,
                          int ld, int n, float2* __restrict__ z) {
  const int c = blockIdx.y;
  const int ra = 2 * c;
  const int rb = 2 * c + 1;
  float2* out = z + (size_t)c * (size_t)n;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const float a = t < len ? x[(size_t)ra * ld + t] : 0.0f;
    const float b = (t < len && rb < rows) ? x[(size_t)rb * ld + t] : 0.0f;
    out[t] = make_float2(a, b);
  }
}

inline int bin_blocks(int n) {
  int blocks = ((n >> 1) + 1 + kThreads - 1) / kThreads;
  return blocks < 1024 ? blocks : 1024;
}

// The device's SM count, read once per device (the query costs host time
// that a launch-bound kernel would pay on every call).
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && count[dev] > 0) return count[dev];
  int sms = 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    sms = 1;
  if (dev < 64) count[dev] = sms;
  return sms;
}

// Calls launch(std::integral_constant<int, S>()) for K4a's pass-2 strip
// width s2 = S of 16, 32 or 64 rows (a template argument of the kernel).
template <typename Launch>
cudaError_t with_strip(int s2, Launch launch) {
  if (s2 == 64) return launch(std::integral_constant<int, 64>());
  if (s2 == 32) return launch(std::integral_constant<int, 32>());
  if (s2 == 16) return launch(std::integral_constant<int, 16>());
  return cudaErrorInvalidValue;
}

// ---- K4a: forward spectrum of real rows, natural order -------------------
//
// Real rows 2c and 2c+1 are packed as z = a + i*b while loading.  With
// n = n1 * n2, j = n2*j1 + j2 and k = k1 + n1*k2:
//   Z[k1 + n1 k2] = sum_j2 W_n2^{j2 k2} W_n^{j2 k1}
//                   * sum_j1 W_n1^{j1 k1} z[n2 j1 + j2].
// Pass 1 (`fft_real_cols`) runs the n1-point DFTs down strips of kStrip
// columns j2 and writes Y[k1, j2] times W_n^{j2 k1}, row-major; pass 2
// (`fft_real_rows`) runs the n2-point DFTs along rows k1 and splits the
// two real spectra in its epilogue: Z[n - k] lies in row (n1 - k1) mod n1
// at k2' = n2 - 1 - k2 (k1 != 0) or (n2 - k2) mod n2 (k1 = 0), so each
// block holds S/2 consecutive rows k1 < n1/2 with their partners
// n1 - k1 (block 0 holds row n1/2, its own partner, in the slot of row
// 0's) and writes bins 0..n/2 of both real rows straight to the output.
// For n <= 4096 one block holds the packed row (`fft_real_block`).

// Row of Y in slot r (< 2 * pairs) of pass-2 block b.
__device__ __forceinline__ int pair_row(int b, int r, int n1, int pairs) {
  const int own = b * pairs + (r % pairs);
  if (r < pairs) return own;
  return own == 0 ? n1 / 2 : n1 - own;
}

__global__ void __launch_bounds__(1024)
fft_real_block(const float* __restrict__ x, int rows, int len, int n,
               const float2* __restrict__ tw, float2* __restrict__ out) {
  using palt::kElems;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n >> 1);
  const int c = blockIdx.x;
  const bool two = 2 * c + 1 < rows;
  const float* xa = x + (size_t)(2 * c) * len;
  const float* xb = xa + len;
  palt::stage_twiddles(stw, tw, n, 1);
  // Every load of the thread in flight before the first store.
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    const bool live = t < len && t < n;
    v[u] = make_float2(live ? xa[t] : 0.0f, live && two ? xb[t] : 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    if (t < n) buf[t] = v[u];
  }
  palt::block_fft<1>(buf, 1, 0, n, stw, 1.0f);
  const int bins = (n >> 1) + 1;
  float2* oa = out + (size_t)(2 * c) * bins;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    const float2 zk = buf[k];
    const float2 zm = buf[(n - k) & (n - 1)];
    oa[k] = split_bin(zk, zm, 0);
    if (two) oa[bins + k] = split_bin(zk, zm, 1);
  }
}

// The split's twiddle W_n^e, e = j2*k1 < n, is W_n2^{e / n1} * W_n^{e mod
// n1}: lo[r] = W_n^r (r < n1) and hi[a] = W_n2^a (a < n2), staged in
// shared memory from the table.
__device__ __forceinline__ void stage_split_tables(
    float2* lo, float2* hi, const float2* __restrict__ tw, int n1, int n2) {
  for (int r = threadIdx.x; r < n1; r += blockDim.x) lo[r] = tw[r];
  for (int a = threadIdx.x; a < n2; a += blockDim.x) {
    const float2 w = tw[(size_t)(a & ((n2 >> 1) - 1)) * n1];
    hi[a] = a < (n2 >> 1) ? w : make_float2(-w.x, -w.y);
  }
}

__device__ __forceinline__ float2 split_twiddle(const float2* lo,
                                                const float2* hi, int e,
                                                int n1) {
  return cmul(hi[e >> (__ffs(n1) - 1)], lo[e & (n1 - 1)]);
}

// Pass 1.  Grid (n2 / kStrip column strips, packed rows).  The twiddle
// W_n^{j2 k1} from the two tables of `stage_split_tables`.
__global__ void __launch_bounds__(1024)
fft_real_cols(const float* __restrict__ x, int rows, int len, int n1, int n2,
              const float2* __restrict__ tw, float2* __restrict__ y) {
  using palt::kElems;
  using palt::kStrip;
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n1 >> 1);
  float2* hi = lo + n1;
  float2* buf = hi + n2;
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int c0 = blockIdx.x * kStrip;
  const bool two = 2 * c + 1 < rows;
  const float* xa = x + (size_t)(2 * c) * len;
  const float* xb = xa + len;
  palt::stage_twiddles(stw, tw, n1, n2);
  stage_split_tables(lo, hi, tw, n1, n2);
  const int total = n1 * kStrip;
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const int t = (idx / kStrip) * n2 + c0 + idx % kStrip;
    const bool live = idx < total && t < len;
    v[u] = make_float2(live ? xa[t] : 0.0f, live && two ? xb[t] : 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[idx] = v[u];
  }
  palt::block_fft<kStrip>(buf, kStrip, 1, n1, stw, 1.0f);
  float2* yc = y + (size_t)c * n;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1 = idx / kStrip;
    const int j2 = c0 + idx % kStrip;
    yc[(size_t)k1 * n2 + j2] =
        cmul(buf[idx], split_twiddle(lo, hi, j2 * k1, n1));
  }
}

// Pass 2.  Grid (n1 / S blocks of S / 2 rows and their partners, packed
// rows) -> out (rows, n/2 + 1).  The output's runs of consecutive bins are
// S / 2 long: S = 64 or 32 where the strip fits in shared memory and the
// batch fills the card, else 16 (``cuda_fft.fft_real_rows_strip``).
template <int S>
__global__ void __launch_bounds__(1024)
fft_real_rows(const float2* __restrict__ y, int rows, int n1, int n2,
              const float2* __restrict__ tw, float2* __restrict__ out) {
  using palt::kElems;
  constexpr int kPairs = S / 2;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n2 >> 1);
  const int ld = n2 + 1;  // odd sequence stride: conflict-free columns
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  palt::stage_twiddles(stw, tw, n2, n1);
  const float2* yc = y + (size_t)c * n;
  const int total = S * n2;
  const int shift = __ffs(n2) - 1;
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const size_t row = pair_row(b, idx >> shift, n1, kPairs);
    v[u] = idx < total ? yc[row * n2 + (idx & (n2 - 1))]
                       : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[(idx >> shift) * ld + (idx & (n2 - 1))] = v[u];
  }
  palt::block_fft<S>(buf, 1, ld, n2, stw, 1.0f);
  const int bins = (n >> 1) + 1;
  const int h2 = n2 >> 1;
  const bool two = 2 * c + 1 < rows;
  float2* oa = out + (size_t)(2 * c) * bins;
  for (int idx = threadIdx.x; idx < S * (h2 + 1); idx += blockDim.x) {
    const int r = idx % S;
    const int k2 = idx / S;
    const int row = pair_row(b, r, n1, kPairs);
    if (k2 == h2 && row != 0) continue;  // bin n/2 is row 0's alone
    int pr = r;  // rows 0 and n1/2 are their own partners
    int pk = n2 - 1 - k2;
    if (row == 0)
      pk = (n2 - k2) & (n2 - 1);
    else if (row != n1 / 2)
      pr = r < kPairs ? r + kPairs : r - kPairs;
    const float2 zk = buf[r * ld + k2];
    const float2 zm = buf[pr * ld + pk];
    const int k = row + n1 * k2;
    oa[k] = split_bin(zk, zm, 0);
    if (two) oa[bins + k] = split_bin(zk, zm, 1);
  }
}

// Pass 2 with S = s2 (16, 32 or 64).
int fft_real_rows_launch(const float2* y, int rows, int n1, int n2, int s2,
                         const float2* tw, float2* out, cudaStream_t s) {
  const int packed = (rows + 1) / 2;
  const int smem = (n2 / 2 + s2 * (n2 + 1)) * (int)sizeof(float2);
  const dim3 grid(n1 / s2, packed);
  const int threads = palt::fft_threads(n2, s2);
  const cudaError_t err = with_strip(s2, [&](auto strip) {
    constexpr int S = decltype(strip)::value;
    const cudaError_t e = palt::allow_smem<fft_real_rows<S>>();
    if (e == cudaSuccess)
      fft_real_rows<S><<<grid, threads, smem, s>>>(y, rows, n1, n2, tw, out);
    return e;
  });
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---- K1 / K2: PHAT cross-spectra, two pairs per packed row ---------------

// Packed row blockIdx.y = scene * couples + c holds pairs 2c and 2c+1 of
// that scene; the mics of scene s are spectrum rows s * mics + i.
__global__ void gcc_cross(const float2* __restrict__ spec,
                          const int* __restrict__ pairs_i,
                          const int* __restrict__ pairs_j, int num_pairs,
                          int mics, int couples,
                          const float* __restrict__ band, float eps, int n,
                          float2* __restrict__ z) {
  const int row_c = blockIdx.y;
  const int scene = row_c / couples;
  const int c = row_c - scene * couples;
  const int m0 = scene * mics;
  const int p0 = 2 * c;
  const int p1 = 2 * c + 1;
  const int half = n >> 1;
  float2* row = z + (size_t)row_c * (size_t)n;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k <= half;
       k += gridDim.x * blockDim.x) {
    const float b = band[k];
    float2 r0 = whiten(unpack_bin(spec, m0 + pairs_i[p0], k, n),
                       unpack_bin(spec, m0 + pairs_j[p0], k, n), eps);
    r0 = make_float2(r0.x * b, r0.y * b);
    float2 r1 = make_float2(0.0f, 0.0f);
    if (p1 < num_pairs) {
      r1 = whiten(unpack_bin(spec, m0 + pairs_i[p1], k, n),
                  unpack_bin(spec, m0 + pairs_j[p1], k, n), eps);
      r1 = make_float2(r1.x * b, r1.y * b);
    }
    store_packed(row, k, n, r0, r1);
  }
}

// Packed inverse rows -> (scenes, num_pairs, n) correlations scaled by 1/n.
// Packed row blockIdx.y = scene * couples + c holds pairs 2c and 2c+1 of
// that scene; with an odd num_pairs the second slot of each scene's last
// couple is empty and nothing is written for it.
__global__ void split_pairs(const float2* __restrict__ z, int num_pairs,
                            int couples, int n, float scale,
                            float* __restrict__ out) {
  const int row_c = blockIdx.y;
  const int scene = row_c / couples;
  const int c = row_c - scene * couples;
  const int p0 = 2 * c;
  const int p1 = 2 * c + 1;
  const float2* row = z + (size_t)row_c * (size_t)n;
  float* o0 = out + ((size_t)scene * num_pairs + p0) * (size_t)n;
  float* o1 = o0 + n;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const float2 v = row[t];
    o0[t] = v.x * scale;
    if (p1 < num_pairs) o1[t] = v.y * scale;
  }
}

// K2's epilogue: the last inverse pass fused with the 1/n scale, the write
// of lags [-w, w) (window sample s holds lag s - w: natural indices n-w..n-1
// then 0..w-1) and three statistics over the whole correlation: mean |corr|,
// the maximum and the smallest natural index attaining it.  One block per
// packed row (pairs 2c, 2c+1 of one scene); the correlation is never
// written.  The mean is a per-thread serial sum of n/1024 terms followed by
// a shuffle tree.
__global__ void last_pass_window(const float2* __restrict__ in,
                                 const float2* __restrict__ tw, int n,
                                 int num_pairs, int couples, int w,
                                 float scale, float* __restrict__ win,
                                 float* __restrict__ stats) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int row_c = blockIdx.x;
  const int scene = row_c / couples;
  const int c = row_c - scene * couples;
  const int p0 = 2 * c;
  const int p1 = 2 * c + 1;
  const bool two = p1 < num_pairs;
  const int half = n >> 1;  // final pass: k = i, twiddle tw[i], j = i
  const float2* x = in + (size_t)row_c * (size_t)n;
  const size_t q0 = (size_t)scene * num_pairs + p0;
  float* w0 = win + q0 * (size_t)(2 * w);
  float* w1 = w0 + 2 * w;
  float sum0 = 0.0f, sum1 = 0.0f;
  float max0 = -INFINITY, max1 = -INFINITY;
  int idx0 = INT_MAX, idx1 = INT_MAX;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float2 t = tw[i];
    t.y = -t.y;
    const float2 a = x[i];
    const float2 b = cmul(x[i + half], t);
    const float lo0 = (a.x + b.x) * scale, lo1 = (a.y + b.y) * scale;
    const float hi0 = (a.x - b.x) * scale, hi1 = (a.y - b.y) * scale;
    sum0 += fabsf(lo0) + fabsf(hi0);
    sum1 += fabsf(lo1) + fabsf(hi1);
    arg_update(max0, idx0, lo0, i);
    arg_update(max0, idx0, hi0, i + half);
    arg_update(max1, idx1, lo1, i);
    arg_update(max1, idx1, hi1, i + half);
    if (i < w) {
      w0[w + i] = lo0;
      if (two) w1[w + i] = lo1;
    }
    if (i >= half - w) {
      w0[i - half + w] = hi0;
      if (two) w1[i - half + w] = hi1;
    }
  }
  sum0 = block_sum(sum0, sv);
  sum1 = block_sum(sum1, sv);
  block_argmax(max0, idx0, sv, si);
  block_argmax(max1, idx1, sv, si);
  if (threadIdx.x == 0) {
    float* s0 = stats + q0 * 3;
    s0[0] = sum0 / (float)n;
    s0[1] = max0;
    s0[2] = (float)idx0;
    if (two) {
      s0[3] = sum1 / (float)n;
      s0[4] = max1;
      s0[5] = (float)idx1;
    }
  }
}

// ---- K4b: bootstrap null peaks -------------------------------------------
//
// Per packed row z = a + i*b (rows 2c, 2c+1): the forward transform, each
// real row's spectrum whitened against s1 and re-packed as one Hermitian
// pair, the inverse transform, and the maxima of its real part (row 2c)
// and imaginary part (row 2c+1), times 1/n; the correlation is never
// written.  With n = n1 * n2, j = n2*j1 + j2 and k = k1 + n1*k2 the
// inverse is the forward split run backwards:
//   x[n2 j1 + j2] = sum_k1 W_n1^{-j1 k1} W_n^{-j2 k1}
//                   * sum_k2 W_n2^{-j2 k2} Y[k1 + n1 k2],
// so three launches over one buffer: K4a's pass 1 (`fft_real_cols`);
// `boot_rows`, which holds K4a's pass-2 rows k1 (with their partners n1 -
// k1) for the forward row DFTs, the whitening, the inverse row DFTs and
// the conjugate twiddle, written back in place; and `boot_cols`, pass 1
// mirrored, whose inverse column DFTs end in the maxima.  A maximum does
// not depend on where a sample lies, so the output of the inverse is never
// put in natural order.  For n <= 4096 one block holds the packed row
// (`boot_block`); above 2^20 (beyond `block_fft`'s 1024 x 1024) the
// radix-2 passes of `boot_stage` run instead.  Bound: device memory, one
// read of the rows and two reads and two writes of the packed buffer.

// In place, bins q <= n/2 (at zq) and n - q (at zm; the same place for q
// = 0 and n/2) of the packed forward spectrum -> the packed whitened
// cross-spectrum: both real rows' bins q whitened against s1[q], their
// imaginary parts dropped at DC and Nyquist as irfft drops them, written
// with their mirrors as `store_packed` writes them.  One thread owns the
// pair, so the in-place update needs no barrier.
__device__ __forceinline__ void boot_pair(const float2* __restrict__ s1,
                                          float2* zq, float2* zm, int q,
                                          int n, float eps) {
  const float2 a = *zq;
  const float2 b = *zm;
  const float2 s = s1[q];
  float2 wa = whiten(s, split_bin(a, b, 0), eps);
  float2 wb = whiten(s, split_bin(a, b, 1), eps);
  const bool edge = q == 0 || q == (n >> 1);
  if (edge) {
    wa.y = 0.0f;
    wb.y = 0.0f;
  }
  *zq = make_float2(wa.x - wb.y, wa.y + wb.x);
  if (!edge) *zm = make_float2(wa.x + wb.y, wb.x - wa.y);
}

// out = fmaxf(out, v) for a v that is not NaN, atomically, on the float's
// bits: integer order for v >= +0, reversed unsigned order for a v with
// the sign bit set (out starts at -inf).
__device__ __forceinline__ void atomic_max_float(float* out, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(out), __float_as_uint(v));
}

// n <= 4096: one block per packed row (at most 256 threads, two blocks an
// SM with up to 128 registers a thread), every step in shared memory.
__global__ void __launch_bounds__(256, 2)
boot_block(const float2* __restrict__ s1, const float* __restrict__ x,
           int rows, int len, int n, float eps, const float2* __restrict__ tw,
           float* __restrict__ out) {
  using palt::kElems;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n >> 1);
  float* red = reinterpret_cast<float*>(buf + n);
  const int c = blockIdx.x;
  const bool two = 2 * c + 1 < rows;
  const float* xa = x + (size_t)(2 * c) * len;
  const float* xb = xa + len;
  palt::stage_twiddles(stw, tw, n, 1);
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    const bool live = t < len && t < n;
    v[u] = make_float2(live ? xa[t] : 0.0f, live && two ? xb[t] : 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    if (t < n) buf[t] = v[u];
  }
  palt::block_fft<1>(buf, 1, 0, n, stw, 1.0f);
  for (int q = threadIdx.x; q <= (n >> 1); q += blockDim.x)
    boot_pair(s1, buf + q, buf + ((n - q) & (n - 1)), q, n, eps);
  palt::block_fft<1>(buf, 1, 0, n, stw, -1.0f);
  float mre = -INFINITY;
  float mim = -INFINITY;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    mre = fmaxf(mre, buf[t].x);
    mim = fmaxf(mim, buf[t].y);
  }
  mre = block_max(mre, red);
  mim = block_max(mim, red);
  if (threadIdx.x == 0) {
    const float scale = 1.0f / (float)n;
    out[2 * c] = mre * scale;
    if (two) out[2 * c + 1] = mim * scale;
  }
}

// Pass 2.  Grid (n1 / S blocks, packed rows), S = kStrip rows k1 of K4a's
// pass 2 a block (half of them the partners n1 - k1 of the other half):
// forward row DFTs; the whitening, one task a mirror pair of bins (the
// maps of `fft_real_rows`): bin (r, k2) of a first-half slot (row k1 <
// n1/2) with bin (r + S/2, n2 - 1 - k2) of row n1 - k1, threads
// row-fastest so that s1's reads run over consecutive bins; slot 0 of
// block 0 takes row 0's pairs (k2, -k2 mod n2) for k2 <= n2/2 and then,
// with one task more, row n1/2's (q, n2 - 1 - q) in slot S/2; inverse row
// DFTs; times W_n^{-j2 k1}; written back in place (the block owns its
// rows).  Block 0 of each packed row sets its two maxima to -inf for
// pass 3.  The rows go back whole, so the strip's width does not set the
// length of the output's runs as in K4a's pass 2: 16 rows keep a block
// at n2 threads, and at n2 <= 256 (kMaxThreads 256) two blocks an SM
// with up to 128 registers a thread, against spills at 64.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
boot_rows(const float2* __restrict__ s1, int rows, int n1, int n2, float eps,
          const float2* __restrict__ tw, float2* y, float* __restrict__ out) {
  using palt::kElems;
  constexpr int S = palt::kStrip;
  constexpr int kPairs = S / 2;
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n2 >> 1);
  float2* hi = lo + n1;
  float2* buf = hi + n2;
  const int ld = n2 + 1;  // odd sequence stride: conflict-free columns
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  if (b == 0 && threadIdx.x == 0) {
    out[2 * c] = -INFINITY;
    if (2 * c + 1 < rows) out[2 * c + 1] = -INFINITY;
  }
  palt::stage_twiddles(stw, tw, n2, n1);
  stage_split_tables(lo, hi, tw, n1, n2);
  float2* yc = y + (size_t)c * n;
  const int total = S * n2;
  const int shift = __ffs(n2) - 1;
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const size_t row = pair_row(b, idx >> shift, n1, kPairs);
    v[u] = idx < total ? yc[row * n2 + (idx & (n2 - 1))]
                       : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[(idx >> shift) * ld + (idx & (n2 - 1))] = v[u];
  }
  palt::block_fft<S>(buf, 1, ld, n2, stw, 1.0f);
  const int tasks = kPairs * n2 + (b == 0);
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    int r = t % kPairs;
    int k2 = t / kPairs;
    int row = b * kPairs + r;
    int pr = r + kPairs;
    int pk = n2 - 1 - k2;
    if (row == 0) {
      if (k2 <= (n2 >> 1)) {  // row 0 is its own partner
        pr = 0;
        pk = (n2 - k2) & (n2 - 1);
      } else {  // row n1/2, in slot S/2, is its own partner
        r = pr = kPairs;
        row = n1 / 2;
        k2 -= (n2 >> 1) + 1;
        pk = n2 - 1 - k2;
      }
    }
    const int p = row + n1 * k2;
    float2* zr = buf + r * ld + k2;
    float2* zp = buf + pr * ld + pk;
    if (p <= (n >> 1))
      boot_pair(s1, zr, zp, p, n, eps);
    else
      boot_pair(s1, zp, zr, n - p, n, eps);
  }
  palt::block_fft<S>(buf, 1, ld, n2, stw, -1.0f);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx >> shift;
    const int j2 = idx & (n2 - 1);
    const int row = pair_row(b, r, n1, kPairs);
    float2 w = split_twiddle(lo, hi, j2 * row, n1);
    w.y = -w.y;
    yc[(size_t)row * n2 + j2] = cmul(buf[r * ld + j2], w);
  }
}

// Pass 3, pass 1 mirrored.  Grid (n2 / kStrip column strips, packed
// rows): the inverse n1-point DFTs down the strip's columns give samples
// n2*j1 + j2 of the packed inverse; the block's maxima of their real and
// imaginary parts, times 1/n, go into out[2c] and out[2c + 1]
// (`atomic_max_float`).
__global__ void __launch_bounds__(1024)
boot_cols(const float2* __restrict__ y, int rows, int n1, int n2,
          const float2* __restrict__ tw, float* out) {
  using palt::kElems;
  using palt::kStrip;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n1 >> 1);
  float* red = reinterpret_cast<float*>(buf + n1 * kStrip);
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int c0 = blockIdx.x * kStrip;
  palt::stage_twiddles(stw, tw, n1, n2);
  const float2* yc = y + (size_t)c * n;
  const int total = n1 * kStrip;
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    v[u] = idx < total ? yc[(size_t)(idx / kStrip) * n2 + c0 + idx % kStrip]
                       : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[idx] = v[u];
  }
  palt::block_fft<kStrip>(buf, kStrip, 1, n1, stw, -1.0f);
  float mre = -INFINITY;
  float mim = -INFINITY;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    mre = fmaxf(mre, buf[idx].x);
    mim = fmaxf(mim, buf[idx].y);
  }
  mre = block_max(mre, red);
  mim = block_max(mim, red);
  if (threadIdx.x == 0) {
    const float scale = 1.0f / (float)n;
    atomic_max_float(out + 2 * c, mre * scale);
    if (2 * c + 1 < rows) atomic_max_float(out + 2 * c + 1, mim * scale);
  }
}

// In place: packed row spectra -> packed whitened cross-spectra against s1
// (the radix-2 pipeline of `boot_stage`).
__global__ void boot_whiten(const float2* __restrict__ s1, float eps, int n,
                            float2* __restrict__ z) {
  const int c = blockIdx.y;
  const int half = n >> 1;
  float2* row = z + (size_t)c * (size_t)n;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k <= half;
       k += gridDim.x * blockDim.x) {
    const float2 a = s1[k];
    const float2 xa = unpack_bin(row, 0, k, n);
    const float2 xb = unpack_bin(row, 1, k, n);
    store_packed(row, k, n, whiten(a, xa, eps), whiten(a, xb, eps));
  }
}

// The last inverse pass fused with the per-row maximum: one block per
// packed row; the correlation itself is never written.
__global__ void last_pass_max(const float2* __restrict__ in,
                              const float2* __restrict__ tw, int n,
                              int rows, float scale,
                              float* __restrict__ out) {
  __shared__ float shared[32];
  const int c = blockIdx.x;
  const int half = n >> 1;  // final pass: k = i, twiddle tw[i], j = i
  const float2* x = in + (size_t)c * (size_t)n;
  float mre = -INFINITY;
  float mim = -INFINITY;
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float2 w = tw[i];
    w.y = -w.y;
    const float2 a = x[i];
    const float2 b = cmul(x[i + half], w);
    mre = fmaxf(mre, fmaxf(a.x + b.x, a.x - b.x));
    mim = fmaxf(mim, fmaxf(a.y + b.y, a.y - b.y));
  }
  mre = block_max(mre, shared);
  mim = block_max(mim, shared);
  if (threadIdx.x == 0) {
    out[2 * c] = mre * scale;
    if (2 * c + 1 < rows) out[2 * c + 1] = mim * scale;
  }
}

// ---- K6: noise-null bootstrap peaks --------------------------------------

// Point t of packed row (draw a) + i*(draw b): for t < n_samp the uniform
// [-0.5, 0.5) sample t of each draw's Philox stream (key = the draw's two
// seed words as uint32, counter = t); zero from n_samp on.
__device__ __forceinline__ float2 noise_point(int t, int n_samp, bool two,
                                              uint32_t a0, uint32_t a1,
                                              uint32_t b0, uint32_t b1) {
  if (t >= n_samp) return make_float2(0.0f, 0.0f);
  return make_float2(palt::philox_uniform((uint32_t)t, a0, a1),
                     two ? palt::philox_uniform((uint32_t)t, b0, b1) : 0.0f);
}

// The first forward Stockham pass (p = 1, twiddle 1: y[2i] = x[i] +
// x[i + n/2], y[2i + 1] = their difference) over packed row c = draws 2c
// and 2c+1, with both points drawn instead of read.  This replaces K4b's
// row load: the rows never exist in device memory; the only input is the
// seeds.  Past n_samp the second point is zero and the butterfly copies.
__global__ void noise_first_pass(const int* __restrict__ seeds, int rows,
                                 int n_samp, int n, float2* __restrict__ z) {
  const int c = blockIdx.y;
  const int ra = 2 * c;
  const int rb = 2 * c + 1;
  const bool two = rb < rows;
  const uint32_t a0 = (uint32_t)seeds[2 * ra];
  const uint32_t a1 = (uint32_t)seeds[2 * ra + 1];
  const uint32_t b0 = two ? (uint32_t)seeds[2 * rb] : 0u;
  const uint32_t b1 = two ? (uint32_t)seeds[2 * rb + 1] : 0u;
  const int half = n >> 1;
  float2* y = z + (size_t)c * (size_t)n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < half;
       i += gridDim.x * blockDim.x) {
    const float2 u = noise_point(i, n_samp, two, a0, a1, b0, b1);
    const float2 v = noise_point(i + half, n_samp, two, a0, a1, b0, b1);
    y[2 * i] = make_float2(u.x + v.x, u.y + v.y);
    y[2 * i + 1] = make_float2(u.x - v.x, u.y - v.y);
  }
}

// ---- K7: PHAT whitening of complex spectra -------------------------------

// z / (|z| + eps) of one bin, in the TPU kernel's order
// (ops/pallas_kernels.py:26-31): inv = 1 / (sqrt(re^2 + im^2) + eps), then
// both parts times inv.  The squares and their sum are rounded separately
// (no fused multiply-add), as the plain float32 expression rounds them.
__device__ __forceinline__ float2 phat_bin(float2 z, float eps) {
  const float mag2 = __fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y));
  const float inv = 1.0f / (sqrtf(mag2) + eps);
  return make_float2(z.x * inv, z.y * inv);
}

// `phat_bin` over interleaved complex64, two bins a thread with one
// 16-byte load: bin 0 alone where `in` is only 8-byte aligned (head = 1),
// then the pairs from in + head (one 16-byte store where out + head is
// 16-byte aligned too, vec_out, else two 8-byte stores), then an odd last
// bin alone.  in == out is allowed.
__global__ void whiten_bins(const float2* in, long long count, int head,
                            int vec_out, float eps, float2* out) {
  const long long pairs = (count - head) >> 1;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const float4* in4 = reinterpret_cast<const float4*>(in + head);
  for (long long t = t0; t < pairs; t += (long long)gridDim.x * blockDim.x) {
    const float4 q = in4[t];
    const float2 a = phat_bin(make_float2(q.x, q.y), eps);
    const float2 b = phat_bin(make_float2(q.z, q.w), eps);
    float2* o = out + head + 2 * t;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
    } else {
      o[0] = a;
      o[1] = b;
    }
  }
  if (t0 == 0) {
    if (head) out[0] = phat_bin(in[0], eps);
    if (head + 2 * pairs < count) out[count - 1] = phat_bin(in[count - 1], eps);
  }
}

// ---- K9: whitened correlation of two spectra -----------------------------

// Packed row c holds rows 2c and 2c+1 of whiten(a * conj(b)) * band over
// bins 0..n/2 of natural-order half spectra (n/2 + 1 bins a row), mirrored
// into the packed Hermitian row by store_packed.
__global__ void corr_cross(const float2* __restrict__ a,
                           const float2* __restrict__ b, int rows,
                           const float* __restrict__ band, float eps, int n,
                           float2* __restrict__ z) {
  const int c = blockIdx.y;
  const int r0 = 2 * c;
  const int r1 = 2 * c + 1;
  const int half = n >> 1;
  const size_t bins = (size_t)half + 1;
  float2* row = z + (size_t)c * (size_t)n;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k <= half;
       k += gridDim.x * blockDim.x) {
    const float bk = band[k];
    const size_t i0 = (size_t)r0 * bins + k;
    float2 w0 = whiten(a[i0], b[i0], eps);
    w0 = make_float2(w0.x * bk, w0.y * bk);
    float2 w1 = make_float2(0.0f, 0.0f);
    if (r1 < rows) {
      const size_t i1 = i0 + bins;
      w1 = whiten(a[i1], b[i1], eps);
      w1 = make_float2(w1.x * bk, w1.y * bk);
    }
    store_packed(row, k, n, w0, w1);
  }
}

// ---- K3: multipath render ------------------------------------------------

// H_m(k) = sum_p g_mp exp(-2*pi*i*k*tau_mp/n), tau in samples.  The phase
// k*tau is reduced by whole turns in double precision before the f32
// sincos, so long delays keep full phase accuracy (the TPU kernel's lane
// range reduction, ops/pallas_fft.py:1400-1429, serves the same end).
__device__ __forceinline__ float2 mic_response(const float* tau,
                                               const float* gain, int paths,
                                               int k, int n) {
  float hr = 0.0f;
  float hi = 0.0f;
  const double inv_n = 1.0 / (double)n;
  for (int p = 0; p < paths; ++p) {
    double turns = (double)k * (double)tau[p] * inv_n;
    turns -= floor(turns);
    float s, c;
    sincosf((float)(6.283185307179586 * turns), &s, &c);
    hr += gain[p] * c;
    hi -= gain[p] * s;
  }
  return make_float2(hr, hi);
}

// Packed row c mixes mic rows 2c and 2c+1 (row = scene * mics + mic) from
// their scene's base spectrum (packed base row scene / 2).
__global__ void render_mix(const float2* __restrict__ zb,
                           const float* __restrict__ tau,
                           const float* __restrict__ gain, int rows,
                           int mics, int paths, int n,
                           float2* __restrict__ z) {
  const int c = blockIdx.y;
  const int ra = 2 * c;
  const int rb = 2 * c + 1;
  const int half = n >> 1;
  float2* row = z + (size_t)c * (size_t)n;
  const float* ta = tau + (size_t)ra * paths;
  const float* ga = gain + (size_t)ra * paths;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k <= half;
       k += gridDim.x * blockDim.x) {
    const float2 ya = cmul(unpack_bin(zb, ra / mics, k, n),
                           mic_response(ta, ga, paths, k, n));
    float2 yb = make_float2(0.0f, 0.0f);
    if (rb < rows)
      yb = cmul(unpack_bin(zb, rb / mics, k, n),
                mic_response(ta + paths, ga + paths, paths, k, n));
    store_packed(row, k, n, ya, yb);
  }
}

// One block per mic row r = scene * mics + mic: scale, fade and trim the
// packed inverse, then the optional finalize (peak-normalize,
// sign*log1p(|x|/0.8+1e-8), re-normalize; silent rows pass through), then
// the optional measurement noise: sigma = rms * 10^(-snr/20) over the kept
// samples, times Philox normals keyed by (seed0, seed1 + mic * 0x9E3779B9)
// (the TPU kernel's _render_postprocess, ops/pallas_fft.py:1788-1834).
// With packed_out the row is written in place into the packed buffer (the
// forward input of K5's GCC stage), zero-padded to n; otherwise to
// out (rows, out_len).  Each thread revisits only the samples it wrote, so
// the passes need no cross-thread ordering beyond the reductions.
__global__ void render_finalize(float2* z, int n, int mics, int out_len,
                                const float* __restrict__ fade, float scale,
                                int finalize, const float* __restrict__ snr_db,
                                const int* __restrict__ seeds, float* out,
                                int packed_out) {
  __shared__ float shared[32];
  const int r = blockIdx.x;
  const int scene = r / mics;
  const size_t packed_off = (size_t)(r >> 1) * 2 * (size_t)n + (r & 1);
  const float* in = reinterpret_cast<const float*>(z) + packed_off;
  float* o;
  int stride;
  if (packed_out) {
    o = reinterpret_cast<float*>(z) + packed_off;
    stride = 2;
  } else {
    o = out + (size_t)r * (size_t)out_len;
    stride = 1;
  }
  float peak = 0.0f;
  for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
    const float y = in[2 * (size_t)t] * scale * fade[t];
    o[(size_t)t * stride] = y;
    peak = fmaxf(peak, fabsf(y));
  }
  if (packed_out) {
    for (int t = out_len + threadIdx.x; t < n; t += blockDim.x)
      o[(size_t)t * stride] = 0.0f;
  }
  if (finalize) {
    peak = block_max(peak, shared);
    float cpeak = 0.0f;
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
      float y = o[(size_t)t * stride];
      if (peak != 0.0f) y = y / peak;
      const float sgn = (y > 0.0f) - (y < 0.0f);
      const float comp = sgn * log1pf(fabsf(y) / 0.8f + 1e-8f);
      o[(size_t)t * stride] = comp;
      cpeak = fmaxf(cpeak, fabsf(comp));
    }
    cpeak = block_max(cpeak, shared);
    if (cpeak > 0.0f) {
      for (int t = threadIdx.x; t < out_len; t += blockDim.x)
        o[(size_t)t * stride] = o[(size_t)t * stride] / cpeak;
    }
  }
  if (snr_db != nullptr) {
    float ss = 0.0f;
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
      const float y = o[(size_t)t * stride];
      ss += y * y;
    }
    ss = block_sum(ss, shared);
    const float rms = sqrtf(ss / (float)out_len);
    const float sigma = rms * expf(-snr_db[scene] * 0.11512925464970229f);
    const uint32_t k0 = (uint32_t)seeds[2 * scene];
    const uint32_t k1 = (uint32_t)seeds[2 * scene + 1] +
                        (uint32_t)(r - scene * mics) * palt::kPhiloxW0;
    for (int t = threadIdx.x; t < out_len; t += blockDim.x)
      o[(size_t)t * stride] += sigma * palt::philox_normal((uint32_t)t, k0,
                                                           k1);
  }
}

// ---- stages shared by the entry points -----------------------------------

// Base rows (scenes, len) -> packed inverse of the per-mic mixes (rows
// scene * mics + mic, unscaled), in z0 or z1 (the returned pointer).
float2* render_stage(const float* base, int scenes, int len,
                     const float* tau, const float* gain, int mics,
                     int paths, int n, const float2* tw, float2* zb0,
                     float2* zb1, float2* z0, float2* z1, cudaStream_t s) {
  const int packed_b = (scenes + 1) / 2;
  const int rows = scenes * mics;
  const int couples = (rows + 1) / 2;
  pack_rows<<<dim3(palt::pass_blocks(n), packed_b), kThreads, 0, s>>>(
      base, scenes, len, len, n, zb0);
  float2* spec = fft_rows(zb0, zb1, tw, n, packed_b, 0, log2_int(n), s);
  render_mix<<<dim3(bin_blocks(n), couples), kThreads, 0, s>>>(
      spec, tau, gain, rows, mics, paths, n, z0);
  return fft_rows(z0, z1, tw, n, couples, 1, log2_int(n), s);
}

// Forward spectra of rows scene * mics + mic (packed) -> win / stats of
// every pair of every scene (K2's back half).
void window_stage(const float2* spec, int scenes, int mics,
                  const int* pairs_i, const int* pairs_j, int num_pairs,
                  const float* band, float eps, int wq, int n,
                  const float2* tw, float2* c0, float2* c1, float* win,
                  float* stats, cudaStream_t s) {
  const int couples = (num_pairs + 1) / 2;
  const int rows = scenes * couples;
  gcc_cross<<<dim3(bin_blocks(n), rows), kThreads, 0, s>>>(
      spec, pairs_i, pairs_j, num_pairs, mics, couples, band, eps, n, c0);
  float2* part = fft_rows(c0, c1, tw, n, rows, 1, log2_int(n) - 1, s);
  last_pass_window<<<rows, kRowThreads, 0, s>>>(part, tw, n, num_pairs,
                                                couples, wq * 128,
                                                1.0f / (float)n, win, stats);
}

// K6's pipeline (and K4b's above 2^20) on the radix-2 passes, after buf0
// holds the rows (packed two to a complex row) with their first `done`
// forward passes applied: the other
// forward passes, whitening against s1 in place, the packed inverse with
// its last pass fused with the row maxima.
void boot_stage(const float2* s1, int rows, int n, float eps, int done,
                const float2* tw, float2* buf0, float2* buf1, float* out,
                cudaStream_t s) {
  const int packed = (rows + 1) / 2;
  const int passes = log2_int(n);
  float2* spec = fft_rows(buf0, buf1, tw, n, packed, 0, passes - done, s,
                          1 << done);
  boot_whiten<<<dim3(bin_blocks(n), packed), kThreads, 0, s>>>(s1, eps, n,
                                                                spec);
  float2* other = spec == buf0 ? buf1 : buf0;
  float2* part = fft_rows(spec, other, tw, n, packed, 1, passes - 1, s);
  last_pass_max<<<packed, kRowThreads, 0, s>>>(part, tw, n, rows,
                                               1.0f / (float)n, out);
}

}  // namespace

#define PALT_CHECK()                          \
  do {                                        \
    cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

extern "C" {

// K4a: x (rows, len) -> out (rows, n/2+1) complex, natural order.  n1 = 1:
// one block per packed row (n <= 4096); else the two passes of the
// four-step split n = n1 * n2 through buf (ceil(rows/2), n) complex, pass
// 2 with strips of s2 (16, 32 or 64) rows.
int palt_fft_real(const float* x, int rows, int len, int n, int n1, int s2,
                  const float2* tw, float2* buf, float2* out, void* stream) {
  using palt::fft_threads;
  using palt::kStrip;
  cudaStream_t s = (cudaStream_t)stream;
  const int packed = (rows + 1) / 2;
  if (n1 == 1) {
    const int smem = (n / 2 + n) * (int)sizeof(float2);
    const cudaError_t err = palt::allow_smem<fft_real_block>();
    if (err != cudaSuccess) return (int)err;
    fft_real_block<<<packed, fft_threads(n, 1), smem, s>>>(x, rows, len, n,
                                                           tw, out);
    PALT_CHECK();
    return 0;
  }
  const int n2 = n / n1;
  const int smem1 =
      (n1 / 2 + n1 + n2 + n1 * kStrip) * (int)sizeof(float2);
  const cudaError_t err = palt::allow_smem<fft_real_cols>();
  if (err != cudaSuccess) return (int)err;
  fft_real_cols<<<dim3(n2 / kStrip, packed), fft_threads(n1, kStrip), smem1,
                  s>>>(x, rows, len, n1, n2, tw, buf);
  PALT_CHECK();
  return fft_real_rows_launch(buf, rows, n1, n2, s2, tw, out, s);
}

// K1: x (scenes, mics, len) -> out (scenes, num_pairs, n) PHAT
// correlations, circular.  Rows scene * mics + mic are packed two to a
// transform across scenes (an odd mic count still packs), as in K2.
int palt_gcc_all_pairs(const float* x, int scenes, int mics, int len, int n,
                       const int* pairs_i, const int* pairs_j, int num_pairs,
                       const float* band, float eps, const float2* tw,
                       float2* spec0, float2* spec1, float2* z0, float2* z1,
                       float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = scenes * mics;
  const int packed = (rows + 1) / 2;
  const int couples = (num_pairs + 1) / 2;
  const int cross = scenes * couples;
  pack_rows<<<dim3(palt::pass_blocks(n), packed), kThreads, 0, s>>>(
      x, rows, len, len, n, spec0);
  PALT_CHECK();
  float2* spec = fft_rows(spec0, spec1, tw, n, packed, 0, log2_int(n), s);
  PALT_CHECK();
  gcc_cross<<<dim3(bin_blocks(n), cross), kThreads, 0, s>>>(
      spec, pairs_i, pairs_j, num_pairs, mics, couples, band, eps, n, z0);
  PALT_CHECK();
  float2* corr = fft_rows(z0, z1, tw, n, cross, 1, log2_int(n), s);
  PALT_CHECK();
  split_pairs<<<dim3(palt::pass_blocks(n), cross), kThreads, 0, s>>>(
      corr, num_pairs, couples, n, 1.0f / (float)n, out);
  PALT_CHECK();
  return 0;
}

// K2: x (scenes, mics, len) -> win (scenes, num_pairs, 2*wq*128) lag-centred
// correlation windows and stats (scenes, num_pairs, 3).
int palt_gcc_windowed(const float* x, int scenes, int mics, int len, int n,
                      const int* pairs_i, const int* pairs_j, int num_pairs,
                      const float* band, float eps, int wq, const float2* tw,
                      float2* spec0, float2* spec1, float2* c0, float2* c1,
                      float* win, float* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = scenes * mics;
  const int packed = (rows + 1) / 2;
  pack_rows<<<dim3(palt::pass_blocks(n), packed), kThreads, 0, s>>>(
      x, rows, len, len, n, spec0);
  PALT_CHECK();
  float2* spec = fft_rows(spec0, spec1, tw, n, packed, 0, log2_int(n), s);
  PALT_CHECK();
  window_stage(spec, scenes, mics, pairs_i, pairs_j, num_pairs, band, eps,
               wq, n, tw, c0, c1, win, stats, s);
  PALT_CHECK();
  return 0;
}

// K4b: s1 (n/2+1) complex, rows x (rows, len) -> out (rows,) maxima of the
// PHAT correlations between s1's signal and each row.  n1 = 1: one block
// per packed row (n <= 4096), no buffer; n1 = 0: the radix-2 passes (n >
// 2^20) through buf's two halves of ceil(rows/2) rows each; else the three
// launches of the split n = n1 * n2 through buf (ceil(rows/2), n) in
// place.
int palt_bootstrap_peaks(const float2* s1, const float* x, int rows, int len,
                         int n, int n1, float eps, const float2* tw,
                         float2* buf, float* out, void* stream) {
  using palt::fft_threads;
  using palt::kStrip;
  cudaStream_t s = (cudaStream_t)stream;
  const int packed = (rows + 1) / 2;
  const int red = 16 * (int)sizeof(float2);  // block_max's 32 floats
  if (n1 == 0) {
    pack_rows<<<dim3(palt::pass_blocks(n), packed), kThreads, 0, s>>>(
        x, rows, len, len, n, buf);
    PALT_CHECK();
    boot_stage(s1, rows, n, eps, 0, tw, buf, buf + (size_t)packed * n, out,
               s);
    PALT_CHECK();
    return 0;
  }
  cudaError_t err;
  if (n1 == 1) {
    int threads = fft_threads(n, 1);
    threads = threads < 32 ? 32 : threads;  // whole warps for block_max
    err = palt::allow_smem<boot_block>();
    if (err != cudaSuccess) return (int)err;
    boot_block<<<packed, threads, (n / 2 + n) * (int)sizeof(float2) + red,
                 s>>>(s1, x, rows, len, n, eps, tw, out);
    PALT_CHECK();
    return 0;
  }
  const int n2 = n / n1;
  err = palt::allow_smem<fft_real_cols>();
  if (err != cudaSuccess) return (int)err;
  fft_real_cols<<<dim3(n2 / kStrip, packed), fft_threads(n1, kStrip),
                  (n1 / 2 + n1 + n2 + n1 * kStrip) * (int)sizeof(float2),
                  s>>>(x, rows, len, n1, n2, tw, buf);
  PALT_CHECK();
  const dim3 grid2(n1 / kStrip, packed);
  const int threads2 = fft_threads(n2, kStrip);
  const int smem2 =
      (n2 / 2 + n1 + n2 + kStrip * (n2 + 1)) * (int)sizeof(float2);
  if (n2 <= 256) {
    err = palt::allow_smem<boot_rows<256, 2>>();
    if (err != cudaSuccess) return (int)err;
    boot_rows<256, 2><<<grid2, threads2, smem2, s>>>(s1, rows, n1, n2, eps,
                                                     tw, buf, out);
  } else {
    err = palt::allow_smem<boot_rows<1024, 1>>();
    if (err != cudaSuccess) return (int)err;
    boot_rows<1024, 1><<<grid2, threads2, smem2, s>>>(s1, rows, n1, n2, eps,
                                                      tw, buf, out);
  }
  PALT_CHECK();
  err = palt::allow_smem<boot_cols>();
  if (err != cudaSuccess) return (int)err;
  boot_cols<<<dim3(n2 / kStrip, packed), fft_threads(n1, kStrip),
              (n1 / 2 + n1 * kStrip) * (int)sizeof(float2) + red, s>>>(
      buf, rows, n1, n2, tw, out);
  PALT_CHECK();
  return 0;
}

// K6: s1 (n/2+1) complex, seeds (rows, 2) int32 -> out (rows,) maxima of
// the PHAT correlations between s1's signal and `rows` in-kernel uniform
// noise draws of n_samp samples each, zero-padded to n.
int palt_noise_bootstrap_peaks(const float2* s1, const int* seeds, int rows,
                               int n_samp, int n, float eps,
                               const float2* tw, float2* buf0, float2* buf1,
                               float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int packed = (rows + 1) / 2;
  noise_first_pass<<<dim3(palt::pass_blocks(n), packed), kThreads, 0, s>>>(
      seeds, rows, n_samp, n, buf0);
  PALT_CHECK();
  boot_stage(s1, rows, n, eps, 1, tw, buf0, buf1, out, s);
  PALT_CHECK();
  return 0;
}

// K7: z (count) complex -> out (count) = z / (|z| + eps); out may be z.
int palt_whiten(const float2* z, long long count, float eps, float2* out,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int head = count > 0 && ((uintptr_t)z & 15) != 0;
  const int vec_out = ((uintptr_t)(out + head) & 15) == 0;
  // One thread a pair of bins, at most one wave of resident blocks.
  const long long wave = (long long)sm_count() * (2048 / kThreads);
  long long blocks = ((count - head) / 2 + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  whiten_bins<<<(int)blocks, kThreads, 0, s>>>(z, count, head, vec_out, eps,
                                               out);
  PALT_CHECK();
  return 0;
}

// K9: a, b (rows, n/2+1) complex natural-order spectra, band (n/2+1) ->
// out (rows, n) circular correlations of whiten(a * conj(b)) * band,
// scaled by 1/n (K1's back half with arbitrary row pairs).
int palt_whitened_corr(const float2* a, const float2* b, int rows, int n,
                       const float* band, float eps, const float2* tw,
                       float2* z0, float2* z1, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int couples = (rows + 1) / 2;
  corr_cross<<<dim3(bin_blocks(n), couples), kThreads, 0, s>>>(
      a, b, rows, band, eps, n, z0);
  PALT_CHECK();
  float2* corr = fft_rows(z0, z1, tw, n, couples, 1, log2_int(n), s);
  PALT_CHECK();
  split_pairs<<<dim3(palt::pass_blocks(n), couples), kThreads, 0, s>>>(
      corr, rows, couples, n, 1.0f / (float)n, out);
  PALT_CHECK();
  return 0;
}

// K3: base (scenes, len) real, tau/gain (scenes, mics, paths) in samples /
// linear gain -> out (scenes, mics, out_len): circular multipath render at
// length n, scaled by 1/n and fade, optionally finalized per mic, and with
// measurement noise at snr_db (scenes,) from seeds (scenes, 2) unless
// snr_db is NULL.
int palt_delay_sum(const float* base, int scenes, int len, const float* tau,
                   const float* gain, int mics, int paths, int n, int out_len,
                   const float* fade, int finalize, const float* snr_db,
                   const int* seeds, const float2* tw, float2* zb0,
                   float2* zb1, float2* z0, float2* z1, float* out,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float2* sig = render_stage(base, scenes, len, tau, gain, mics, paths, n,
                             tw, zb0, zb1, z0, z1, s);
  PALT_CHECK();
  render_finalize<<<scenes * mics, kRowThreads, 0, s>>>(
      sig, n, mics, out_len, fade, 1.0f / (float)n, finalize, snr_db, seeds,
      out, 0);
  PALT_CHECK();
  return 0;
}

// K5: the whole scene.  K3's render with finalize (and noise) for every
// scene, each finished signal written in place as the packed forward input
// of K2's GCC, then K2's transforms and windowed epilogue.  Outputs as K2.
int palt_scene_windowed(const float* base, int scenes, int len,
                        const float* tau, const float* gain, int mics,
                        int paths, int n, int out_len, const float* fade,
                        const float* snr_db, const int* seeds,
                        const int* pairs_i, const int* pairs_j, int num_pairs,
                        const float* band, float eps, int wq,
                        const float2* tw, float2* zb0, float2* zb1,
                        float2* z0, float2* z1, float2* c0, float2* c1,
                        float* win, float* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float2* sig = render_stage(base, scenes, len, tau, gain, mics, paths, n,
                             tw, zb0, zb1, z0, z1, s);
  PALT_CHECK();
  render_finalize<<<scenes * mics, kRowThreads, 0, s>>>(
      sig, n, mics, out_len, fade, 1.0f / (float)n, 1, snr_db, seeds,
      nullptr, 1);
  PALT_CHECK();
  float2* other = sig == z0 ? z1 : z0;
  const int packed = (scenes * mics + 1) / 2;
  float2* spec = fft_rows(sig, other, tw, n, packed, 0, log2_int(n), s);
  PALT_CHECK();
  window_stage(spec, scenes, mics, pairs_i, pairs_j, num_pairs, band, eps,
               wq, n, tw, c0, c1, win, stats, s);
  PALT_CHECK();
  return 0;
}

}  // extern "C"

// K10: the four-step row DFT, its radix-2 passes and the lane DFT.
#include "rowdft.cu"
