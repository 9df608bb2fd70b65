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
// The GCC routes of K1, K2 and K5 (``cuda_fft.gcc_route`` picks one for
// (nfft, mics), the same for the three): the radix-2 passes (above 2^22),
// one block a scene, the split with `gcc_rows`, the split through the mic
// rows' spectra, and one block a packed cross row through the spectra.
// K3's render stage, K5's too, takes the first four (``cuda_fft.
// render_route``): the passes, `render_block`, the split with
// `render_rows`, the split through the base rows' spectra.
enum GccRoute {
  kRoutePasses = 0,
  kRouteBlock = 1,
  kRouteRows = 2,
  kRouteSpectra = 3,
  kRouteSpectraBlock = 4
};

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

// The block's maxima (kMax) or tree sums of H values a thread at once:
// warp shuffles, then one warp over the warps' partials; shared holds 32 *
// H floats.  Every thread gets the results.
template <bool kMax, int H>
__device__ __forceinline__ void block_reduce(float (&v)[H], float* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float o = __shfl_xor_sync(0xffffffffu, v[h], off);
      v[h] = kMax ? fmaxf(v[h], o) : v[h] + o;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) shared[32 * h + warp] = v[h];
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x >> 5);
#pragma unroll
    for (int h = 0; h < H; ++h)
      v[h] = live ? shared[32 * h + lane] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float o = __shfl_xor_sync(0xffffffffu, v[h], off);
        v[h] = kMax ? fmaxf(v[h], o) : v[h] + o;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) shared[32 * h] = v[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < H; ++h) v[h] = shared[32 * h];
}

__device__ __forceinline__ float block_max(float v, float* shared) {
  float a[1] = {v};
  block_reduce<true>(a, shared);
  return a[0];
}

__device__ __forceinline__ float block_sum(float v, float* shared) {
  float a[1] = {v};
  block_reduce<false>(a, shared);
  return a[0];
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
// width s2 = S of 4, 8, 16, 32 or 64 rows (a template argument of the
// kernel).
template <typename Launch>
cudaError_t with_strip(int s2, Launch launch) {
  if (s2 == 64) return launch(std::integral_constant<int, 64>());
  if (s2 == 32) return launch(std::integral_constant<int, 32>());
  if (s2 == 16) return launch(std::integral_constant<int, 16>());
  if (s2 == 8) return launch(std::integral_constant<int, 8>());
  if (s2 == 4) return launch(std::integral_constant<int, 4>());
  return cudaErrorInvalidValue;
}

// The same for the strips of the split's column passes (K4a's, K4b's,
// K6's, K9's and the GCCs' spectra route's) and of K4b's, K6's and
// `corr_rows`' row passes (K9's, and K1's, K2's and K5's on the spectra
// route): 16 (kStrip) up to n1 (n2) = 1,024, 8 at 2,048, and (kFour, the
// split of K4a, K4b and K6 above 2^22) 4 at 4,096
// (``cuda_fft.split_strips``).  Only kFour's callers instantiate their
// kernels at 4: the other routes stop at 2^22.
template <bool kFour = false, typename Launch>
cudaError_t with_split_strip(int strip, Launch launch) {
  if (strip == palt::kStrip)
    return launch(std::integral_constant<int, palt::kStrip>());
  if (strip == 8) return launch(std::integral_constant<int, 8>());
  if constexpr (kFour) {
    if (strip == 4) return launch(std::integral_constant<int, 4>());
  }
  return cudaErrorInvalidValue;
}

// ---- K4a: forward spectrum of real rows, natural order -------------------
//
// Real rows 2c and 2c+1 are packed as z = a + i*b while loading.  With
// n = n1 * n2, j = n2*j1 + j2 and k = k1 + n1*k2:
//   Z[k1 + n1 k2] = sum_j2 W_n2^{j2 k2} W_n^{j2 k1}
//                   * sum_j1 W_n1^{j1 k1} z[n2 j1 + j2].
// Pass 1 (`fft_real_cols`) runs the n1-point DFTs down strips of S
// columns j2 and writes Y[k1, j2] times W_n^{j2 k1}, row-major; pass 2
// (`fft_real_rows`) runs the n2-point DFTs along rows k1 and splits the
// two real spectra in its epilogue: Z[n - k] lies in row (n1 - k1) mod n1
// at k2' = n2 - 1 - k2 (k1 != 0) or (n2 - k2) mod n2 (k1 = 0), so each
// block holds S/2 consecutive rows k1 < n1/2 with their partners
// n1 - k1 (block 0 holds row n1/2, its own partner, in the slot of row
// 0's) and writes bins 0..n/2 of both real rows straight to the output.
// For n <= 4096 one block holds the packed row (`fft_real_block`, which
// takes a loader: K4a's rows, and the mic rows of the GCCs' spectra
// route in one block, K5's finished signals among them).
//
// Up to 2^20 (n1, n2 <= 1,024) the column strips hold 16 columns; at
// 2^21 and 2^22 (n1 = 2,048) a strip of 16 would be 32,768 points (295
// KB), past `block_fft`'s kElems * 1024 points and a block's 227 KB, so
// the host takes 8 (n1 * 8 = 16,384 points, 164-172 KB: 64 bytes, two
// 32-byte sectors, of each row a strip reads), and pass 2 strips of 8 rows
// at n2 = 2,048.  Above 2^22 (K4a, K4b and K6 only) the long side goes to
// the rows, n1 <= n2: 2048 x 4096 at 2^23 keeps the 8-column strips (184
// KB) and takes pass-2 strips of 4 rows (2 rows k1 and their partners),
// 4096 x 4096 at 2^24 strips of 4 columns (208 KB; one 32-byte sector a
// row) and of 4 rows.  Nothing here needs n1 >= n2: the twiddle e = j2*k1
// < n splits as W_n2^{e / n1} W_n^{e mod n1} at any n1, the sub-twiddles
// of either side are every (n/L)-th entry of the table, and the partner
// rows n1 - k1 (row n1/2 in the slot of row 0's) are rows of n1.  Bound:
// device memory, 32 bytes a point of the packed rows over the split (pass
// 1 writes Y, pass 2 reads it: 16 each way) besides the rows' read and the
// spectra's write.

// The sequence stride (in float2) of a strip of S rows of n2 points in
// K4a's pass 2 and K4b's and K6's row pass: n2 + 16 / S up to 16 rows,
// n2 + 1 above.  `block_fft` runs the sequences fastest, so the 16
// threads of a half-warp's 8-byte access take S rows of 16 / S
// consecutive points: at that stride they fall in 16 distinct bank pairs
// (n2 + 1 gave 4-way conflicts at S = 4, 2-way at 8).  The same points and
// the same arithmetic, only their places change.
template <int S>
__host__ __device__ constexpr int row_ld(int n2) {
  return n2 + (S < 16 ? 16 / S : 1);
}

// Row of Y in slot r (< 2 * pairs) of pass-2 block b; block 0's slot
// `pairs` holds row n1/2, row 0's own partner being itself.
__device__ __forceinline__ int pair_row(int b, int r, int n1, int pairs) {
  const int own = b * pairs + (r % pairs);
  if (r < pairs) return own;
  return own == 0 ? n1 / 2 : n1 - own;
}

template <class Load>
__global__ void __launch_bounds__(1024)
fft_real_block(Load load, int rows, int n, const float2* __restrict__ tw,
               float2* __restrict__ out) {
  using palt::kElems;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n >> 1);
  const int c = blockIdx.x;
  const bool two = 2 * c + 1 < rows;
  const auto src = load.row(c);
  palt::stage_twiddles(stw, tw, n, 1);
  // Every load of the thread in flight before the first store.
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    v[u] = t < n ? src(t) : make_float2(0.0f, 0.0f);
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

// The tables of K4a's, K4b's and K6's split kernels (n = n1 * n2).  Above
// 2^20 the n1- and n2-point half tables are read from the contiguous
// copies after the n-point table (``cuda_fft._twiddles``: the same floats
// as its every n2-th and n1-th entry); up to 2^20 as before, from the
// n-point table at a stride (there the many blocks of a launch would all
// read one small contiguous copy).  kWhere: 1 above 2^20, 0 up to it, -1
// by n at run time; a kernel whose strip settles it passes 0 or 1, so
// that its shapes up to 2^20 compile to the reads they had (`split_where`).
// stw <- the n1-point (second = false) or n2-point sub-twiddles.
template <int kWhere>
__device__ __forceinline__ void stage_split_twiddles(
    float2* stw, const float2* __restrict__ tw, int n1, int n2,
    bool second) {
  const int n = n1 * n2;
  const int len = second ? n2 : n1;
  if (kWhere == 0 || (kWhere < 0 && n <= (1 << 20))) {
    palt::stage_twiddles(stw, tw, len, second ? n1 : n2);
    return;
  }
  palt::stage_twiddles(stw, tw + (n >> 1) + (second ? n1 >> 1 : 0), len, 1);
}

// `stage_split_tables`, above 2^20 with hi from the n2-point half table.
template <int kWhere>
__device__ __forceinline__ void stage_split_tables_of(
    float2* lo, float2* hi, const float2* __restrict__ tw, int n1, int n2) {
  const int n = n1 * n2;
  if (kWhere == 0 || (kWhere < 0 && n <= (1 << 20))) {
    stage_split_tables(lo, hi, tw, n1, n2);
    return;
  }
  const float2* t2 = tw + (n >> 1) + (n1 >> 1);
  for (int r = threadIdx.x; r < n1; r += blockDim.x) lo[r] = tw[r];
  for (int a = threadIdx.x; a < n2; a += blockDim.x) {
    const float2 w = t2[a & ((n2 >> 1) - 1)];
    hi[a] = a < (n2 >> 1) ? w : make_float2(-w.x, -w.y);
  }
}

// kWhere of a strip of S sequences: strips below kStrip sequences occur
// only above 2^20 (1), wider ones only up to it (0), kStrip itself on
// both sides (-1).
template <int S>
__host__ __device__ constexpr int split_where() {
  return S < palt::kStrip ? 1 : (S > palt::kStrip ? 0 : -1);
}

__device__ __forceinline__ float2 split_twiddle(const float2* lo,
                                                const float2* hi, int e,
                                                int n1) {
  return cmul(hi[e >> (__ffs(n1) - 1)], lo[e & (n1 - 1)]);
}

// Loaders of the forward passes: `load.row(c)` gives point t (< n) of
// packed row c, rows 2c and 2c+1 as its real and imaginary parts, zero
// from the rows' length on and in the imaginary part of an odd count's
// last packed row.  A loader makes every point of a row the same whichever
// schedule reads it, so kernels that differ only in their loader compute
// the same bits from the same values.

// Real rows x (rows, len), row-major (K4a, K4b, K2, the render's bases).
struct RowLoad {
  const float* x;
  int rows;
  int len;
  struct Row {
    const float* xa;
    int len;
    bool two;
    __device__ __forceinline__ float2 operator()(int t) const {
      const bool live = t < len;
      return make_float2(live ? xa[t] : 0.0f,
                         live && two ? xa[len + t] : 0.0f);
    }
  };
  __device__ __forceinline__ Row row(int c) const {
    return {x + (size_t)(2 * c) * len, len, 2 * c + 1 < rows};
  }
};

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

// K6's draws, made where they are read: `rows` draws of n_samp samples
// keyed by seeds (rows, 2); the rows never exist in device memory.
struct NoiseLoad {
  const int* seeds;
  int rows;
  int n_samp;
  struct Row {
    uint32_t a0, a1, b0, b1;
    int n_samp;
    bool two;
    __device__ __forceinline__ float2 operator()(int t) const {
      return noise_point(t, n_samp, two, a0, a1, b0, b1);
    }
  };
  __device__ __forceinline__ Row row(int c) const {
    const bool two = 2 * c + 1 < rows;
    return {(uint32_t)seeds[4 * c], (uint32_t)seeds[4 * c + 1],
            two ? (uint32_t)seeds[4 * c + 2] : 0u,
            two ? (uint32_t)seeds[4 * c + 3] : 0u, n_samp, two};
  }
};

// Rows already packed two to a complex row z (ceil(rows/2), n), zero-padded
// to n (K5's finalized signals, written in place by `render_finalize`).
// May alias the pass's output: a column pass reads and writes one strip.
struct PackedLoad {
  const float2* z;
  int rows;
  int n;
  struct Row {
    const float2* zc;
    bool two;
    __device__ __forceinline__ float2 operator()(int t) const {
      const float2 v = zc[t];
      return make_float2(v.x, two ? v.y : 0.0f);
    }
  };
  __device__ __forceinline__ Row row(int c) const {
    return {z + (size_t)c * n, 2 * c + 1 < rows};
  }
};

// Pass 1.  Grid (n2 / S column strips, packed rows), S = kStrip (16), 8
// or 4 columns a strip (n1 * S <= kElems * 1024).  The twiddle W_n^{j2 k1}
// from the two tables of `stage_split_tables_of` (above 2^20 the
// n1-point sub-twiddles and the n2-point table read contiguously from the
// half tables after the n-point one).  The block writes the strip it
// read, so y may be the loader's own buffer.
template <class Load, int S>
__global__ void __launch_bounds__(1024)
fft_real_cols(Load load, int n1, int n2, const float2* __restrict__ tw,
              float2* y) {
  using palt::kElems;
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n1 >> 1);
  float2* hi = lo + n1;
  float2* buf = hi + n2;
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int c0 = blockIdx.x * S;
  const auto src = load.row(c);
  // Column strips below 16 occur only above 2^20, of 16 only up to it.
  constexpr int kWhere = S < palt::kStrip ? 1 : 0;
  stage_split_twiddles<kWhere>(stw, tw, n1, n2, false);
  stage_split_tables_of<kWhere>(lo, hi, tw, n1, n2);
  const int total = n1 * S;
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const int t = (idx / S) * n2 + c0 + idx % S;
    v[u] = idx < total ? src(t) : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[idx] = v[u];
  }
  palt::block_fft<S>(buf, S, 1, n1, stw, 1.0f);
  float2* yc = y + (size_t)c * n;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int k1 = idx / S;
    const int j2 = c0 + idx % S;
    yc[(size_t)k1 * n2 + j2] =
        cmul(buf[idx], split_twiddle(lo, hi, j2 * k1, n1));
  }
}

// Pass 1 over `packed` rows of load into y, strips of S columns.
template <int S = palt::kStrip, class Load>
cudaError_t cols_launch(Load load, int packed, int n1, int n2,
                        const float2* tw, float2* y, cudaStream_t s) {
  const int smem = (n1 / 2 + n1 + n2 + n1 * S) * (int)sizeof(float2);
  const cudaError_t err = palt::allow_smem<fft_real_cols<Load, S>>();
  if (err != cudaSuccess) return err;
  fft_real_cols<Load, S><<<dim3(n2 / S, packed), palt::fft_threads(n1, S),
                           smem, s>>>(load, n1, n2, tw, y);
  return cudaGetLastError();
}

// Pass 2.  Grid (n1 / S blocks of S / 2 rows and their partners, packed
// rows) -> out (rows, n/2 + 1).  The output's runs of consecutive bins are
// S / 2 long: S = 64 or 32 where the strip fits in shared memory and the
// batch fills the card, 8 at n2 = 2,048 (runs of 4 bins, one 32-byte
// sector), 4 at 4,096 (runs of 2), else 16
// (``cuda_fft.fft_real_rows_strip``).
template <int S>
__global__ void __launch_bounds__(1024)
fft_real_rows(const float2* __restrict__ y, int rows, int n1, int n2,
              const float2* __restrict__ tw, float2* __restrict__ out) {
  using palt::kElems;
  constexpr int kPairs = S / 2;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n2 >> 1);
  const int ld = row_ld<S>(n2);  // conflict-free half-warps
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  stage_split_twiddles<split_where<S>()>(stw, tw, n1, n2, true);
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

// K4a above 2^24 (n1 = 0), after the radix-2 passes: packed natural-order
// rows z (ceil(rows/2), n) -> the two real spectra, bins 0..n/2 of rows
// 2c and 2c+1 of out (rows, n/2 + 1).  The split's bound holds: one read
// of the packed row and one write of each spectrum.
__global__ void split_spectra(const float2* __restrict__ z, int rows, int n,
                              float2* __restrict__ out) {
  const int c = blockIdx.y;
  const int bins = (n >> 1) + 1;
  const bool two = 2 * c + 1 < rows;
  const float2* row = z + (size_t)c * (size_t)n;
  float2* oa = out + (size_t)(2 * c) * (size_t)bins;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < bins;
       k += gridDim.x * blockDim.x) {
    const float2 zk = row[k];
    const float2 zm = row[(n - k) & (n - 1)];
    oa[k] = split_bin(zk, zm, 0);
    if (two) oa[bins + k] = split_bin(zk, zm, 1);
  }
}

// Pass 2 with S = s2 (4, 8, 16, 32 or 64).
int fft_real_rows_launch(const float2* y, int rows, int n1, int n2, int s2,
                         const float2* tw, float2* out, cudaStream_t s) {
  const int packed = (rows + 1) / 2;
  const dim3 grid(n1 / s2, packed);
  const int threads = palt::fft_threads(n2, s2);
  const cudaError_t err = with_strip(s2, [&](auto strip) {
    constexpr int S = decltype(strip)::value;
    const int smem = (n2 / 2 + S * row_ld<S>(n2)) * (int)sizeof(float2);
    const cudaError_t e = palt::allow_smem<fft_real_rows<S>>();
    if (e == cudaSuccess)
      fft_real_rows<S><<<grid, threads, smem, s>>>(y, rows, n1, n2, tw, out);
    return e;
  });
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// K4a in one block (n <= 4096) over `rows` rows given by load -> out
// (rows, n/2 + 1), a block a packed row.
template <class Load>
cudaError_t fft_real_block_launch(Load load, int rows, int n,
                                  const float2* tw, float2* out,
                                  cudaStream_t s) {
  const int smem = (n / 2 + n) * (int)sizeof(float2);
  const cudaError_t err = palt::allow_smem<fft_real_block<Load>>();
  if (err != cudaSuccess) return err;
  fft_real_block<Load><<<(rows + 1) / 2, palt::fft_threads(n, 1), smem, s>>>(
      load, rows, n, tw, out);
  return cudaGetLastError();
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

// ---- K4b / K6: bootstrap null peaks --------------------------------------
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
// (`boot_block`); above 2^24 the radix-2 passes of `boot_stage` run
// instead.  K6 is the same pipeline with its rows drawn by the loader
// (`NoiseLoad`) where K4b reads them (`RowLoad`).  Bound: device memory,
// one read of the rows and two reads and two writes of the packed buffer
// (32 bytes a point of the packed rows over the split).
//
// The strips: up to 2^20 (n1, n2 <= 1,024) 16 columns in both column
// passes and 16 rows in the row pass.  At 2^21 (2,048 x 1,024) and 2^22
// (2,048 x 2,048) the host takes the widest strip of {16, 8, 4} that
// holds at most kElems * 1024 points and fits a block's shared memory
// (``cuda_fft.split_strips``): the column passes 8 columns (16,384 points,
// 164-172 KB), the row pass 16 rows at n2 = 1,024 and 8 at 2,048 (172
// KB).  A strip of 8 columns reads 64 bytes, two 32-byte sectors, of each
// row; of 4 it reads one.  So above 2^22 the long side goes to the rows:
// 2,048 x 4,096 at 2^23 (columns 8, `boot_rows` 4 rows: 196,640 bytes)
// and 4,096 x 4,096 at 2^24 (4 and 4: 212,992 and 213,024 bytes), whose
// column passes read one sector a row; above 2^24 the passes.

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
template <class Load>
__global__ void __launch_bounds__(256, 2)
boot_block(const float2* __restrict__ s1, Load load, int rows, int n,
           float eps, const float2* __restrict__ tw,
           float* __restrict__ out) {
  using palt::kElems;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n >> 1);
  float* red = reinterpret_cast<float*>(buf + n);
  const int c = blockIdx.x;
  const bool two = 2 * c + 1 < rows;
  const auto src = load.row(c);
  palt::stage_twiddles(stw, tw, n, 1);
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    v[u] = t < n ? src(t) : make_float2(0.0f, 0.0f);
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

// ---- row passes of the split (K4b's, the render's and the GCC's) ---------
//
// A row pass holds S rows k1 of a packed row's pass-1 output Y (n1 x n2)
// in a strip of shared memory, sequence stride ld = n2 + 1 (odd:
// conflict-free columns; `row_ld` in K4b's and K6's): block b's slot r
// holds row pair_row(b, r), half
// of them the partners n1 - k1 of the other half, so that every bin's
// mirror n - k lies in the same block.  Up to S * n2 threads.  S = kStrip
// (16) but in K4b's, K6's and `corr_rows`' row pass at n2 = 2,048, which
// holds 8, and in K4b's and K6's at 4,096, which holds 4.

// Mirror pair t of a row pass's block b (t < pair_tasks(b, n2)), the maps
// of `fft_real_rows`: bin (r, k2) of a first-half slot (row k1 < n1/2)
// with bin (r + S/2, n2 - 1 - k2) of row n1 - k1, threads row-fastest so
// that reads indexed by the bin run over consecutive bins; slot 0 of block
// 0 takes row 0's pairs (k2, -k2 mod n2) for k2 <= n2/2 and then, with one
// task more, row n1/2's (q, n2 - 1 - q) in slot S/2.  q <= n/2 is the
// lower bin; zq and zm are the strip offsets of bins q and n - q (the same
// for q = 0 and n/2, DC and Nyquist).
struct PairTask {
  int q;
  int zq;
  int zm;
};

template <int S = palt::kStrip>
__device__ __forceinline__ int pair_tasks(int b, int n2) {
  return (S / 2) * n2 + (b == 0);
}

template <int S = palt::kStrip>
__device__ __forceinline__ PairTask pair_task(int t, int b, int n1, int n2,
                                              int ld) {
  constexpr int kPairs = S / 2;
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
  const int at = r * ld + k2;
  const int mirror = pr * ld + pk;
  if (p <= ((n1 * n2) >> 1)) return {p, at, mirror};
  return {n1 * n2 - p, mirror, at};
}

// Strip <- rows pair_row(b, r), r < S, of yc (n1 x n2) at sequence
// stride ld (n2 + 1 but in `boot_rows`), E points a thread, every load of
// a thread in flight before its first store.
template <int S = palt::kStrip, int E = palt::kElems>
__device__ __forceinline__ void load_rows(const float2* yc, float2* buf,
                                          int b, int n1, int n2,
                                          int ld = 0) {
  constexpr int kPairs = S / 2;
  if (ld == 0) ld = n2 + 1;
  const int total = S * n2;
  const int shift = __ffs(n2) - 1;
  float2 v[E];
#pragma unroll
  for (int u = 0; u < E; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const size_t row = pair_row(b, idx >> shift, n1, kPairs);
    v[u] = idx < total ? yc[row * n2 + (idx & (n2 - 1))]
                       : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < E; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[(idx >> shift) * ld + (idx & (n2 - 1))] = v[u];
  }
}

// yc rows pair_row(b, r) <- the strip's inverse row DFTs times W_n^{-j2
// k1} (the tables of `stage_split_tables`); ld as `load_rows`.
template <int S = palt::kStrip>
__device__ __forceinline__ void store_rows(const float2* buf, float2* yc,
                                           const float2* lo,
                                           const float2* hi, int b, int n1,
                                           int n2, int ld = 0) {
  constexpr int kPairs = S / 2;
  if (ld == 0) ld = n2 + 1;
  const int total = S * n2;
  const int shift = __ffs(n2) - 1;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx >> shift;
    const int j2 = idx & (n2 - 1);
    const int row = pair_row(b, r, n1, kPairs);
    float2 w = split_twiddle(lo, hi, j2 * row, n1);
    w.y = -w.y;
    yc[(size_t)row * n2 + j2] = cmul(buf[r * ld + j2], w);
  }
}

// The column strip c0..c0 + S - 1 of yc (n1 x n2) and its inverse
// n1-point DFTs: buf[j1 * S + s] = sample n2*j1 + c0 + s of the packed
// inverse, unscaled (pass 1 mirrored; stw: the n1-point sub-twiddles).
template <int S = palt::kStrip>
__device__ __forceinline__ void cols_inverse(const float2* yc, float2* buf,
                                             const float2* stw, int n1,
                                             int n2, int c0) {
  using palt::kElems;
  const int total = n1 * S;
  float2 v[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    v[u] = idx < total ? yc[(size_t)(idx / S) * n2 + c0 + idx % S]
                       : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[idx] = v[u];
  }
  palt::block_fft<S>(buf, S, 1, n1, stw, -1.0f);
}

// Pass 2.  Grid (n1 / S blocks, packed rows), S rows k1 of K4a's pass 2 a
// block: forward row DFTs; the whitening, one task a mirror pair of bins
// (`pair_task`), so that s1's reads run over consecutive bins; inverse
// row DFTs; times W_n^{-j2 k1}; written back in place (the block owns its
// rows).  Block 0 of each packed row sets its two maxima to -inf for pass
// 3.  The rows go back whole, so the strip's width does not set the
// length of the output's runs as in K4a's pass 2: 16 rows keep a block at
// n2 threads (8 rows at n2 = 2,048: 1,024 threads, 172 KB; 4 rows at
// 4,096: 1,024 threads, 192-208 KB), and at n2 <= 256 (kMaxThreads 256)
// two blocks an SM with up to 128 registers a thread.  The forward and
// the inverse row DFTs are `block_fft_inline`, each inlined where it is
// called.  E points a thread (kElems, or twice as many in half the
// threads where kMaxThreads = 512, above 2^20: up to 128 registers a
// thread at one block an SM).
template <int kMaxThreads, int kMinBlocks, int S, int E = palt::kElems>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
boot_rows(const float2* __restrict__ s1, int rows, int n1, int n2, float eps,
          const float2* __restrict__ tw, float2* y, float* __restrict__ out) {
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n2 >> 1);
  float2* hi = lo + n1;
  float2* buf = hi + n2;
  const int ld = row_ld<S>(n2);  // conflict-free half-warps
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int b = blockIdx.x;
  if (b == 0 && threadIdx.x == 0) {
    out[2 * c] = -INFINITY;
    if (2 * c + 1 < rows) out[2 * c + 1] = -INFINITY;
  }
  // The 512-thread build runs only above 2^20, the others only up to it.
  constexpr int kWhere = kMaxThreads == 512 ? 1 : 0;
  stage_split_twiddles<kWhere>(stw, tw, n1, n2, true);
  stage_split_tables_of<kWhere>(lo, hi, tw, n1, n2);
  float2* yc = y + (size_t)c * n;
  load_rows<S, E>(yc, buf, b, n1, n2, ld);
  palt::block_fft_inline<S, palt::Radix16<S, E>, E>(buf, 1, ld, n2, stw,
                                                    1.0f);
  const int tasks = pair_tasks<S>(b, n2);
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const PairTask p = pair_task<S>(t, b, n1, n2, ld);
    boot_pair(s1, buf + p.zq, buf + p.zm, p.q, n, eps);
  }
  palt::block_fft_inline<S, palt::Radix16<S, E>, E>(buf, 1, ld, n2, stw,
                                                    -1.0f);
  store_rows<S>(buf, yc, lo, hi, b, n1, n2, ld);
}

// Pass 3, pass 1 mirrored.  Grid (n2 / S column strips, packed rows),
// pass 1's S: the inverse n1-point DFTs down the strip's columns give
// samples n2*j1 + j2 of the packed inverse; the block's maxima of their
// real and imaginary parts, times 1/n, go into out[2c] and out[2c + 1]
// (`atomic_max_float`).
template <int S>
__global__ void __launch_bounds__(1024)
boot_cols(const float2* __restrict__ y, int rows, int n1, int n2,
          const float2* __restrict__ tw, float* out) {
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n1 >> 1);
  float* red = reinterpret_cast<float*>(buf + n1 * S);
  const int n = n1 * n2;
  const int c = blockIdx.y;
  // Column strips below 16 occur only above 2^20, of 16 only up to it.
  stage_split_twiddles<(S < palt::kStrip ? 1 : 0)>(stw, tw, n1, n2, false);
  cols_inverse<S>(y + (size_t)c * n, buf, stw, n1, n2, blockIdx.x * S);
  const int total = n1 * S;
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

// K4b's and K6's row pass, strips of S rows: fft_threads(n2, S) threads
// a block up to 2^20, half as many with twice the points a thread above
// (1,024 -> 512 at every strip there; strips of 8 and 4 rows occur only
// there).
template <int S>
cudaError_t boot_rows_launch(const float2* s1, int rows, int n1, int n2,
                             float eps, const float2* tw, float2* buf,
                             float* out, cudaStream_t s) {
  const dim3 grid(n1 / S, (rows + 1) / 2);
  const int threads = palt::fft_threads(n2, S);
  const int smem =
      (n2 / 2 + n1 + n2 + S * row_ld<S>(n2)) * (int)sizeof(float2);
  cudaError_t err;
  if constexpr (S == palt::kStrip) {  // 8 or 4 rows at n2 = 2,048, 4,096
    if (n2 <= 256) {
      err = palt::allow_smem<boot_rows<256, 2, S>>();
      if (err != cudaSuccess) return err;
      boot_rows<256, 2, S><<<grid, threads, smem, s>>>(s1, rows, n1, n2, eps,
                                                       tw, buf, out);
      return cudaGetLastError();
    }
  }
  if (S < palt::kStrip || (size_t)n1 * n2 > ((size_t)1 << 20)) {
    err = palt::allow_smem<boot_rows<512, 1, S, 2 * palt::kElems>>();
    if (err != cudaSuccess) return err;
    boot_rows<512, 1, S, 2 * palt::kElems><<<grid, threads / 2, smem, s>>>(
        s1, rows, n1, n2, eps, tw, buf, out);
    return cudaGetLastError();
  }
  if constexpr (S == palt::kStrip) {  // strips below 16 run above 2^20
    err = palt::allow_smem<boot_rows<1024, 1, S>>();
    if (err != cudaSuccess) return err;
    boot_rows<1024, 1, S><<<grid, threads, smem, s>>>(s1, rows, n1, n2, eps,
                                                      tw, buf, out);
  }
  return cudaGetLastError();
}

// K4b / K6 on the split (n1 > 1) or in one block (n1 = 1) for rows given
// by load; buf (ceil(rows/2), n) is the split's scratch.  cs: the columns
// of a column pass's strip, rs: the rows of the row pass's (16, 8 or 4).
template <class Load>
cudaError_t boot_split(const float2* s1, Load load, int rows, int n, int n1,
                       int cs, int rs, float eps, const float2* tw,
                       float2* buf, float* out, cudaStream_t s) {
  using palt::fft_threads;
  const int packed = (rows + 1) / 2;
  const int red = 16 * (int)sizeof(float2);  // block_max's 32 floats
  cudaError_t err;
  if (n1 == 1) {
    int threads = fft_threads(n, 1);
    threads = threads < 32 ? 32 : threads;  // whole warps for block_max
    err = palt::allow_smem<boot_block<Load>>();
    if (err != cudaSuccess) return err;
    boot_block<Load><<<packed, threads, (n / 2 + n) * (int)sizeof(float2) +
                                            red, s>>>(s1, load, rows, n, eps,
                                                      tw, out);
    return cudaGetLastError();
  }
  const int n2 = n / n1;
  err = with_split_strip<true>(cs, [&](auto strip) {
    return cols_launch<decltype(strip)::value>(load, packed, n1, n2, tw, buf,
                                               s);
  });
  if (err != cudaSuccess) return err;
  err = with_split_strip<true>(rs, [&](auto strip) {
    return boot_rows_launch<decltype(strip)::value>(s1, rows, n1, n2, eps, tw,
                                                    buf, out, s);
  });
  if (err != cudaSuccess) return err;
  return with_split_strip<true>(cs, [&](auto strip) {
    constexpr int S = decltype(strip)::value;
    const cudaError_t e = palt::allow_smem<boot_cols<S>>();
    if (e != cudaSuccess) return e;
    boot_cols<S><<<dim3(n2 / S, packed), fft_threads(n1, S),
                   (n1 / 2 + n1 * S) * (int)sizeof(float2) + red, s>>>(
        buf, rows, n1, n2, tw, out);
    return cudaGetLastError();
  });
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

// ---- K6 above 2^24: the draws in the first radix-2 pass -----------------

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

// The finish of H mic rows after their scale and fade, in place: sample t
// of row h at o[t * stride + h], t < out_len, `peak[h]` the calling
// thread's max |o| over its samples of row h, row h being mic mic[h] of
// scene scene[h].  The optional finalize (peak-normalize,
// sign*log1p(|x|/0.8+1e-8), re-normalize; silent rows pass through), then
// the optional measurement noise: sigma = rms * 10^(-snr/20) over the kept
// samples, times Philox normals keyed by (seed0, seed1 + mic * 0x9E3779B9)
// (the TPU kernel's _render_postprocess, ops/pallas_fft.py:1788-1834).
// The H rows share each block reduction (shared: 32 * H floats).  Each
// thread revisits only the samples t = threadIdx.x + k * blockDim.x, which
// it scaled, so the steps need no cross-thread ordering beyond the
// reductions; every thread of the block calls it.
template <int H>
__device__ __forceinline__ void finish_rows(float* o, int stride, int out_len,
                                            float (&peak)[H], int finalize,
                                            const float* __restrict__ snr_db,
                                            const int* __restrict__ seeds,
                                            const int (&scene)[H],
                                            const int (&mic)[H],
                                            float* shared) {
  if (finalize) {
    block_reduce<true>(peak, shared);
    float cpeak[H];
#pragma unroll
    for (int h = 0; h < H; ++h) cpeak[h] = 0.0f;
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float y = o[(size_t)t * stride + h];
        if (peak[h] != 0.0f) y = y / peak[h];
        const float sgn = (y > 0.0f) - (y < 0.0f);
        const float comp = sgn * log1pf(fabsf(y) / 0.8f + 1e-8f);
        o[(size_t)t * stride + h] = comp;
        cpeak[h] = fmaxf(cpeak[h], fabsf(comp));
      }
    }
    block_reduce<true>(cpeak, shared);
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (cpeak[h] > 0.0f)
          o[(size_t)t * stride + h] = o[(size_t)t * stride + h] / cpeak[h];
    }
  }
  if (snr_db != nullptr) {
    float ss[H];
#pragma unroll
    for (int h = 0; h < H; ++h) ss[h] = 0.0f;
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float y = o[(size_t)t * stride + h];
        ss[h] += y * y;
      }
    }
    block_reduce<false>(ss, shared);
    float sigma[H];
    uint32_t k0[H], k1[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float rms = sqrtf(ss[h] / (float)out_len);
      sigma[h] = rms * expf(-snr_db[scene[h]] * 0.11512925464970229f);
      k0[h] = (uint32_t)seeds[2 * scene[h]];
      k1[h] = (uint32_t)seeds[2 * scene[h] + 1] +
              (uint32_t)mic[h] * palt::kPhiloxW0;
    }
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        o[(size_t)t * stride + h] +=
            sigma[h] * palt::philox_normal((uint32_t)t, k0[h], k1[h]);
    }
  }
}

// One block per mic row r = scene * mics + mic of the packed inverse z
// (unscaled): scale, fade and trim, then `finish_rows`.  With packed_out
// the row is written in place into the packed buffer (the forward input of
// K5's GCC stage), zero-padded to n; otherwise to out (rows, out_len).
// Where the rows are too few to fill the card, `finish_spread` does the
// same over more blocks (``cuda_fft.finish_groups``).
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
  float peaks[1] = {peak};
  const int scenes[1] = {scene};
  const int mic[1] = {r - scene * mics};
  finish_rows(o, stride, out_len, peaks, finalize, snr_db, seeds, scenes,
              mic, shared);
}

// `render_finalize`'s finish spread over G = gridDim.x blocks a packed
// mic row, for calls whose rows are too few to fill the card (from 2^20,
// ``cuda_fft.finish_groups``): one block a mic row would leave most SMs
// idle for milliseconds at a few million samples a row.  Grid (G, packed
// rows c), one launch a step; block g takes samples t = g * blockDim.x +
// threadIdx.x + k * G * blockDim.x of both mic rows 2c and 2c + 1 and
// revisits only those.  Each step reduces its block's values of the two
// rows (`block_reduce`) into part (rows, 3, G) = [peak, compressed peak,
// sum of squares] of each block, and the next step combines a row's G
// partials in block order: the maxima are exact in any order, the sums
// are taken in that order, so nothing depends on the order in which the
// blocks run and no float atomics are needed.  The samples' arithmetic is
// `finish_rows`'.
//   step 0: scale, fade and trim (to out, or in place zero-padded to n
//           where packed_out), the peaks and sums of squares;
//   step 1: (finalize) peak-normalize and compress, the compressed peaks;
//   step 2: (finalize) re-normalize, the sums of squares;
//   step 3: (noise) sigma from the sums, plus the Philox normals.
__global__ void __launch_bounds__(1024)
finish_spread(float2* z, int rows, int n, int mics, int out_len,
              const float* __restrict__ fade, float scale,
              const float* __restrict__ snr_db, const int* __restrict__ seeds,
              float* out, int packed_out, int step, float* part) {
  __shared__ float red[64];
  const int groups = gridDim.x;
  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const int ra = 2 * c;
  const bool two = ra + 1 < rows;
  float2* zc = z + (size_t)c * (size_t)n;
  float* oa = packed_out ? nullptr : out + (size_t)ra * (size_t)out_len;
  float* pa = part + (size_t)ra * 3 * groups;
  float* pb = pa + 3 * groups;
  const int first = g * blockDim.x + threadIdx.x;
  const int stride = groups * blockDim.x;
  auto get = [&](int t) {
    if (packed_out) return zc[t];
    return make_float2(oa[t], two ? oa[out_len + t] : 0.0f);
  };
  auto put = [&](int t, float2 v) {
    if (packed_out) {
      zc[t] = v;
      return;
    }
    oa[t] = v.x;
    if (two) oa[out_len + t] = v.y;
  };
  // The combined partial k (0 peak, 1 compressed peak, 2 sum of squares)
  // of the block's two rows.
  auto combined = [&](int k, float (&v)[2]) {
    v[0] = 0.0f;
    v[1] = 0.0f;
    for (int i = 0; i < groups; ++i) {
      const float a = pa[k * groups + i];
      const float b = two ? pb[k * groups + i] : 0.0f;
      v[0] = k == 2 ? v[0] + a : fmaxf(v[0], a);
      v[1] = k == 2 ? v[1] + b : fmaxf(v[1], b);
    }
  };
  float acc[2] = {0.0f, 0.0f};
  float ss[2] = {0.0f, 0.0f};
  int k = 0;
  if (step == 0) {
    const int end = packed_out ? n : out_len;
    for (int t = first; t < end; t += stride) {
      if (t >= out_len) {
        zc[t] = make_float2(0.0f, 0.0f);
        continue;
      }
      const float2 v = zc[t];
      const float f = fade[t];
      const float2 y =
          make_float2(v.x * scale * f, two ? v.y * scale * f : 0.0f);
      put(t, y);
      acc[0] = fmaxf(acc[0], fabsf(y.x));
      acc[1] = fmaxf(acc[1], fabsf(y.y));
      ss[0] += y.x * y.x;
      ss[1] += y.y * y.y;
    }
  } else if (step == 1) {
    float peak[2];
    combined(0, peak);
    for (int t = first; t < out_len; t += stride) {
      const float2 v = get(t);
      float y[2] = {v.x, v.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (peak[h] != 0.0f) y[h] = y[h] / peak[h];
        const float sgn = (y[h] > 0.0f) - (y[h] < 0.0f);
        y[h] = sgn * log1pf(fabsf(y[h]) / 0.8f + 1e-8f);
        acc[h] = fmaxf(acc[h], fabsf(y[h]));
      }
      put(t, make_float2(y[0], y[1]));
    }
    k = 1;
  } else if (step == 2) {
    float cpeak[2];
    combined(1, cpeak);
    for (int t = first; t < out_len; t += stride) {
      const float2 v = get(t);
      float y[2] = {v.x, v.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cpeak[h] > 0.0f) y[h] = y[h] / cpeak[h];
        ss[h] += y[h] * y[h];
      }
      put(t, make_float2(y[0], y[1]));
    }
  } else {
    float total[2];
    combined(2, total);
    float sigma[2];
    uint32_t k0[2], k1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = two ? ra + h : ra;
      const int scene = r / mics;
      const float rms = sqrtf(total[h] / (float)out_len);
      sigma[h] = rms * expf(-snr_db[scene] * 0.11512925464970229f);
      k0[h] = (uint32_t)seeds[2 * scene];
      k1[h] = (uint32_t)seeds[2 * scene + 1] +
              (uint32_t)(r - scene * mics) * palt::kPhiloxW0;
    }
    for (int t = first; t < out_len; t += stride) {
      float2 v = get(t);
      v.x += sigma[0] * palt::philox_normal((uint32_t)t, k0[0], k1[0]);
      if (two)
        v.y += sigma[1] * palt::philox_normal((uint32_t)t, k0[1], k1[1]);
      put(t, v);
    }
    return;
  }
  // Steps 0 and 1 keep a maximum (k), steps 0 and 2 a sum of squares.
  if (step != 2) block_reduce<true>(acc, red);
  if (step != 1) block_reduce<false>(ss, red);
  if (threadIdx.x == 0) {
    if (step != 2) {
      pa[k * groups + g] = acc[0];
      if (two) pb[k * groups + g] = acc[1];
    }
    if (step != 1) {
      pa[2 * groups + g] = ss[0];
      if (two) pb[2 * groups + g] = ss[1];
    }
  }
}

// ---- the render and windowed-GCC stages on the split ---------------------
//
// K3's render and K2's windowed GCC (K5 runs both) on K4b's four-step
// split n = n1 * n2, for 8,192 <= n <= 2^19 where their strips fit one
// block (``cuda_fft.render_route`` and ``gcc_route`` choose, from n and
// the mic count, for K3, K2 and K5 alike: the rows routes); up to 4,096
// points one block holds a packed
// base row (`render_block`) or a scene (`window_block`, where its rows
// fit).  Elsewhere up to 2^22 both stages go through spectra on the
// split: the render through the base rows' (`render_spectra`), the GCC
// through the mic rows' (`window_route`); above 2^22 both run the radix-2
// passes (`render_stage`, `window_stage`).  Three launches a stage on the
// split with two-strip row passes:
//
// render:  K4a's pass 1 over the base rows (two scenes a packed row);
//          `render_rows`: the base strip's forward row DFTs, then for
//          each of the two scenes' `mics` packed mic rows the mixes
//          (`mic_response`, `render_mix`'s arithmetic) packed two mic rows
//          a complex row, the inverse row DFTs and the conjugate twiddle;
//          `render_cols`: the inverse column DFTs, written in place in
//          natural order, the unscaled packed inverse `render_finalize`
//          reads.
// GCC:     K4a's pass 1 over the mic rows (real rows, or K5's finalized
//          signals, packed in place); `gcc_rows`: one scene's strips of
//          every packed mic row that holds one of its mics, and for each
//          couple of pairs the whitened, band-masked cross-spectra
//          (`gcc_cross`'s arithmetic) packed two pairs a row, the inverse
//          row DFTs and the conjugate twiddle; `window_cols`: the inverse
//          column DFTs, 1/n, the lag window and the three statistics,
//          combined across the row's blocks in a fixed order.
//
// A row pass loops over its output rows with one spare strip, so shared
// memory does not grow with the path count or, in the render, the mic
// count; where its grid would not fill the card (one scene), gridDim.z
// blocks share a block's output rows (`row_groups`), each transforming the
// input strips again.  Bound: device memory, one write and one read of
// each packed buffer a pass (and the row passes' instructions, as K4b's).

// Bins q and n - q of the packed Hermitian pair ya + i*yb at the strip
// offsets of p, as `store_packed` writes them.
__device__ __forceinline__ void store_pair(float2* strip, PairTask p, int n,
                                           float2 ya, float2 yb) {
  const bool edge = p.q == 0 || p.q == (n >> 1);
  if (edge) {
    ya.y = 0.0f;
    yb.y = 0.0f;
  }
  strip[p.zq] = make_float2(ya.x - yb.y, ya.y + yb.x);
  if (!edge) strip[p.zm] = make_float2(ya.x + yb.y, yb.x - ya.y);
}

// Render pass 2.  Grid (n1 / S, packed base rows, groups): block (b, cb,
// g) holds rows k1 of the packed base row cb (scenes 2cb and 2cb+1), whose
// mic rows are packed rows [cb * mics, (cb + 1) * mics) (any mic count:
// mic rows are numbered scene * mics + mic), and writes every gridDim.z-th
// of them from the g-th; mic row r mixes the base spectrum of scene r /
// mics.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
render_rows(const float* __restrict__ tau, const float* __restrict__ gain,
            int rows, int mics, int paths, int n1, int n2,
            const float2* __restrict__ tw, const float2* __restrict__ zb,
            float2* __restrict__ z) {
  constexpr int S = palt::kStrip;
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n2 >> 1);
  float2* hi = lo + n1;
  float2* buf = hi + n2;
  const int ld = n2 + 1;
  float2* work = buf + S * ld;
  const int n = n1 * n2;
  const int cb = blockIdx.y;
  const int b = blockIdx.x;
  palt::stage_twiddles(stw, tw, n2, n1);
  stage_split_tables(lo, hi, tw, n1, n2);
  load_rows(zb + (size_t)cb * n, buf, b, n1, n2);
  palt::block_fft<S>(buf, 1, ld, n2, stw, 1.0f);
  const int tasks = pair_tasks(b, n2);
  const int packed = (rows + 1) / 2;
  const int last = min((cb + 1) * mics, packed);
  for (int pm = cb * mics + blockIdx.z; pm < last; pm += gridDim.z) {
    const int ra = 2 * pm;
    const bool two = ra + 1 < rows;
    const int oa = (ra / mics) & 1;
    const int ob = ((ra + 1) / mics) & 1;
    const float* ta = tau + (size_t)ra * paths;
    const float* ga = gain + (size_t)ra * paths;
    for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
      const PairTask p = pair_task(t, b, n1, n2, ld);
      const float2 zq = buf[p.zq];
      const float2 zm = buf[p.zm];
      const float2 ya = cmul(split_bin(zq, zm, oa),
                             mic_response(ta, ga, paths, p.q, n));
      float2 yb = make_float2(0.0f, 0.0f);
      if (two)
        yb = cmul(split_bin(zq, zm, ob),
                  mic_response(ta + paths, ga + paths, paths, p.q, n));
      store_pair(work, p, n, ya, yb);
    }
    palt::block_fft<S>(work, 1, ld, n2, stw, -1.0f);
    store_rows(work, z + (size_t)pm * n, lo, hi, b, n1, n2);
    __syncthreads();  // the next mic row's tasks rewrite work
  }
}

// Render pass 2 through the base rows' spectra (`render_spectra`).  Grid
// (n1 / S, packed mic rows): block (b, pm) forms rows pair_row(b, r) of
// packed mic row pm, whose mic rows 2pm and 2pm + 1 (row scene * mics +
// mic: an odd mic count packs across scenes) mix the half spectra spec
// (scenes, n/2 + 1) of their scenes: bin q <= n/2 of each mirror pair
// (`pair_task`, so that the reads run over consecutive bins) times
// `mic_response`, stored as the Hermitian pair (`store_pair`); then the
// inverse row DFTs and the conjugate twiddle into z.  One strip at any
// mic count, of S = 16 rows (8 at n2 = 2,048: 172 KB), where
// `render_rows`' two strips pass a block's shared memory (from 2^20).
// The grid holds a block for each strip of each packed mic row, 128 to
// 512 blocks for one scene of 4 mics, so it needs no `row_groups`.
template <int S>
__global__ void __launch_bounds__(1024)
render_spec_rows(const float2* __restrict__ spec,
                 const float* __restrict__ tau,
                 const float* __restrict__ gain, int rows, int mics,
                 int paths, int n1, int n2, const float2* __restrict__ tw,
                 float2* __restrict__ z) {
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n2 >> 1);
  float2* hi = lo + n1;
  float2* work = hi + n2;
  const int ld = n2 + 1;
  const int n = n1 * n2;
  const int pm = blockIdx.y;
  const int b = blockIdx.x;
  const int ra = 2 * pm;
  const bool two = ra + 1 < rows;
  const size_t bins = (size_t)(n >> 1) + 1;
  const float2* sa = spec + (size_t)(ra / mics) * bins;
  const float2* sb = spec + (size_t)((two ? ra + 1 : ra) / mics) * bins;
  const float* ta = tau + (size_t)ra * paths;
  const float* ga = gain + (size_t)ra * paths;
  palt::stage_twiddles(stw, tw, n2, n1);
  stage_split_tables(lo, hi, tw, n1, n2);
  const int tasks = pair_tasks<S>(b, n2);
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const PairTask p = pair_task<S>(t, b, n1, n2, ld);
    const float2 ya = cmul(sa[p.q], mic_response(ta, ga, paths, p.q, n));
    float2 yb = make_float2(0.0f, 0.0f);
    if (two)
      yb = cmul(sb[p.q],
                mic_response(ta + paths, ga + paths, paths, p.q, n));
    store_pair(work, p, n, ya, yb);
  }
  palt::block_fft<S>(work, 1, ld, n2, stw, -1.0f);
  store_rows<S>(work, z + (size_t)pm * n, lo, hi, b, n1, n2);
}

// Render pass 3.  Grid (n2 / S column strips, packed mic rows): the
// inverse column DFTs; sample n2*j1 + j2 goes back to the address the
// strip read it from, which is its natural place.  S = kStrip (16)
// columns, 8 at n1 = 2,048 (``cuda_fft.split_strips``).
template <int S>
__global__ void __launch_bounds__(1024)
render_cols(int n1, int n2, const float2* __restrict__ tw, float2* z) {
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n1 >> 1);
  const int c0 = blockIdx.x * S;
  float2* zc = z + (size_t)blockIdx.y * (size_t)(n1 * n2);
  palt::stage_twiddles(stw, tw, n1, n2);
  cols_inverse<S>(zc, buf, stw, n1, n2, c0);
  for (int idx = threadIdx.x; idx < n1 * S; idx += blockDim.x)
    zc[(size_t)(idx / S) * n2 + c0 + idx % S] = buf[idx];
}

// `render_cols` over `packed` packed mic rows of z, strips of S columns.
template <int S>
cudaError_t render_cols_launch(int packed, int n1, int n2, const float2* tw,
                               float2* z, cudaStream_t s) {
  const cudaError_t err = palt::allow_smem<render_cols<S>>();
  if (err != cudaSuccess) return err;
  render_cols<S><<<dim3(n2 / S, packed), palt::fft_threads(n1, S),
                   (n1 / 2 + n1 * S) * (int)sizeof(float2), s>>>(n1, n2, tw,
                                                                 z);
  return cudaGetLastError();
}

// GCC pass 2.  Grid (n1 / S, scenes, groups): block (b, scene, g) holds
// rows k1 of each packed mic row that holds one of the scene's mics (with
// an odd mic count a packed row may hold the last mic of one scene and the
// first of the next), then for every gridDim.z-th couple c from the g-th
// writes packed cross row scene * couples + c.  Where keys is not null
// (K2), block (0, scene, 0) clears the couples' argmax keys and block
// counters for `window_cols`; K1's `corr_cols` needs neither.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
gcc_rows(const int* __restrict__ pairs_i, const int* __restrict__ pairs_j,
         int num_pairs, int mics, const float* __restrict__ band, float eps,
         int n1, int n2, const float2* __restrict__ tw,
         const float2* __restrict__ zm, float2* __restrict__ zc,
         unsigned long long* __restrict__ keys,
         unsigned int* __restrict__ count) {
  constexpr int S = palt::kStrip;
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n2 >> 1);
  float2* hi = lo + n1;
  float2* strips = hi + n2;
  const int ld = n2 + 1;
  const int strip = S * ld;
  const int n = n1 * n2;
  const int scene = blockIdx.y;
  const int b = blockIdx.x;
  const int couples = (num_pairs + 1) / 2;
  const int row0 = scene * mics;
  const int first = row0 >> 1;
  const int span = ((row0 + mics - 1) >> 1) - first + 1;
  float2* work = strips + span * strip;
  if (keys != nullptr && b == 0 && blockIdx.z == 0) {
    for (int i = threadIdx.x; i < 2 * couples; i += blockDim.x)
      keys[(size_t)scene * 2 * couples + i] = 0ull;
    for (int i = threadIdx.x; i < couples; i += blockDim.x)
      count[(size_t)scene * couples + i] = 0u;
  }
  palt::stage_twiddles(stw, tw, n2, n1);
  stage_split_tables(lo, hi, tw, n1, n2);
  for (int k = 0; k < span; ++k)
    load_rows(zm + (size_t)(first + k) * n, strips + k * strip, b, n1, n2);
  for (int k = 0; k < span; ++k)
    palt::block_fft<S>(strips + k * strip, 1, ld, n2, stw, 1.0f);
  const int tasks = pair_tasks(b, n2);
  for (int c = blockIdx.z; c < couples; c += gridDim.z) {
    const int p0 = 2 * c;
    const bool two = p0 + 1 < num_pairs;
    const int p1 = two ? p0 + 1 : p0;
    const int i0 = row0 + pairs_i[p0];
    const int j0 = row0 + pairs_j[p0];
    const int i1 = row0 + pairs_i[p1];
    const int j1 = row0 + pairs_j[p1];
    const float2* si0 = strips + ((i0 >> 1) - first) * strip;
    const float2* sj0 = strips + ((j0 >> 1) - first) * strip;
    const float2* si1 = strips + ((i1 >> 1) - first) * strip;
    const float2* sj1 = strips + ((j1 >> 1) - first) * strip;
    for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
      const PairTask p = pair_task(t, b, n1, n2, ld);
      const float bq = band[p.q];
      float2 r0 = whiten(split_bin(si0[p.zq], si0[p.zm], i0 & 1),
                         split_bin(sj0[p.zq], sj0[p.zm], j0 & 1), eps);
      r0 = make_float2(r0.x * bq, r0.y * bq);
      float2 r1 = make_float2(0.0f, 0.0f);
      if (two) {
        r1 = whiten(split_bin(si1[p.zq], si1[p.zm], i1 & 1),
                    split_bin(sj1[p.zq], sj1[p.zm], j1 & 1), eps);
        r1 = make_float2(r1.x * bq, r1.y * bq);
      }
      store_pair(work, p, n, r0, r1);
    }
    palt::block_fft<S>(work, 1, ld, n2, stw, -1.0f);
    store_rows(work, zc + ((size_t)scene * couples + c) * n, lo, hi, b, n1,
               n2);
    __syncthreads();  // the next couple's tasks rewrite work
  }
}

// (v, j) as one 64-bit key whose unsigned order is v's (-0 taken as +0),
// then the smallest j: the maximum key is the maximum at its smallest
// index, as `arg_update` keeps it, whatever order the blocks come in.
__device__ __forceinline__ unsigned long long arg_key(float v, int j) {
  const unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
  const unsigned int ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (unsigned int)~j;
}

__device__ __forceinline__ void arg_unkey(unsigned long long key, float& v,
                                          int& j) {
  const unsigned int ord = (unsigned int)(key >> 32);
  v = __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
  j = (int)~(unsigned int)key;
}

// GCC pass 3.  Grid (n2 / S column strips, scenes * couples): the
// inverse column DFTs, times 1/n, of packed cross row scene * couples + c
// (pairs 2c and 2c+1 as its real and imaginary parts); the window's
// samples (j < w or j >= n - w, the lags of `last_pass_window`); each
// block's sums of |corr| (a block tree) into part (scenes * couples, 2,
// blocks) and its (max, smallest index) into keys by 64-bit atomicMax.
// The row's last block (counted in count) sums the partials in block
// order and writes the statistics: no float atomics, so the result does
// not depend on the order in which the blocks run.  S = kStrip (16)
// columns a strip, 8 at n1 = 2,048 (the spectra route's,
// ``cuda_fft.split_strips``).
template <int S>
__global__ void __launch_bounds__(1024)
window_cols(const float2* __restrict__ zc, int num_pairs, int couples,
            int n1, int n2, int w, const float2* __restrict__ tw,
            float* __restrict__ win, float* __restrict__ stats, float* part,
            unsigned long long* keys, unsigned int* count) {
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ bool last;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n1 >> 1);
  const int n = n1 * n2;
  const int row_c = blockIdx.y;
  const int scene = row_c / couples;
  const int p0 = 2 * (row_c - scene * couples);
  const bool two = p0 + 1 < num_pairs;
  const int c0 = blockIdx.x * S;
  const int nb = gridDim.x;
  palt::stage_twiddles(stw, tw, n1, n2);
  cols_inverse<S>(zc + (size_t)row_c * n, buf, stw, n1, n2, c0);
  const float scale = 1.0f / (float)n;
  const size_t q0 = (size_t)scene * num_pairs + p0;
  float* w0 = win + q0 * (size_t)(2 * w);
  float* w1 = w0 + 2 * w;
  float sum0 = 0.0f, sum1 = 0.0f;
  float max0 = -INFINITY, max1 = -INFINITY;
  int idx0 = INT_MAX, idx1 = INT_MAX;
  for (int idx = threadIdx.x; idx < n1 * S; idx += blockDim.x) {
    const int j = (idx / S) * n2 + c0 + idx % S;
    const float2 v = buf[idx];
    const float a = v.x * scale;
    const float d = v.y * scale;
    sum0 += fabsf(a);
    sum1 += fabsf(d);
    arg_update(max0, idx0, a, j);
    arg_update(max1, idx1, d, j);
    const int at = j < w ? w + j : (j >= n - w ? j - (n - w) : -1);
    if (at >= 0) {
      w0[at] = a;
      if (two) w1[at] = d;
    }
  }
  sum0 = block_sum(sum0, sv);
  sum1 = block_sum(sum1, sv);
  block_argmax(max0, idx0, sv, si);
  block_argmax(max1, idx1, sv, si);
  if (threadIdx.x == 0) {
    float* pr = part + (size_t)row_c * 2 * nb;
    pr[blockIdx.x] = sum0;
    pr[nb + blockIdx.x] = sum1;
    atomicMax(keys + 2 * row_c, arg_key(max0, idx0));
    atomicMax(keys + 2 * row_c + 1, arg_key(max1, idx1));
    __threadfence();
    last = atomicAdd(count + row_c, 1u) == (unsigned int)(nb - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile float* pr = part + (size_t)row_c * 2 * nb;
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < nb; ++i) {
      t0 += pr[i];
      t1 += pr[nb + i];
    }
    float m;
    int j;
    float* s0 = stats + q0 * 3;
    arg_unkey(atomicAdd(keys + 2 * row_c, 0ull), m, j);
    s0[0] = t0 / (float)n;
    s0[1] = m;
    s0[2] = (float)j;
    if (two) {
      arg_unkey(atomicAdd(keys + 2 * row_c + 1, 0ull), m, j);
      s0[3] = t1 / (float)n;
      s0[4] = m;
      s0[5] = (float)j;
    }
  }
}

// Blocks a row pass's grid (blocks of `threads`) adds along z to share
// `rows` output rows: enough to give each of the card's SMs 256 threads
// (one scene's grid has 16 blocks), at most one a row; 1 for a batch.
inline int row_groups(int blocks, int threads, int rows) {
  const long long want = 256LL * sm_count();
  const long long have = (long long)blocks * threads;
  const long long groups = (want + have - 1) / have;
  return (int)(groups < rows ? groups : rows);
}

// The render stage on the split (n1 > 1): base rows (scenes, len) -> z
// (ceil(scenes * mics / 2), n), the unscaled packed inverse of the mixes
// in natural order, through zb (ceil(scenes / 2), n).
cudaError_t render_split(const float* base, int scenes, int len,
                         const float* tau, const float* gain, int mics,
                         int paths, int n, int n1, const float2* tw,
                         float2* zb, float2* z, cudaStream_t s) {
  using palt::fft_threads;
  using palt::kStrip;
  const int n2 = n / n1;
  const int packed_b = (scenes + 1) / 2;
  const int rows = scenes * mics;
  cudaError_t err =
      cols_launch(RowLoad{base, scenes, len}, packed_b, n1, n2, tw, zb, s);
  if (err != cudaSuccess) return err;
  const int threads2 = fft_threads(n2, kStrip);
  const dim3 grid2(n1 / kStrip, packed_b,
                   row_groups(n1 / kStrip * packed_b, threads2, mics));
  const int smem2 =
      (n2 / 2 + n1 + n2 + 2 * kStrip * (n2 + 1)) * (int)sizeof(float2);
  if (n2 <= 256) {
    err = palt::allow_smem<render_rows<256, 2>>();
    if (err != cudaSuccess) return err;
    render_rows<256, 2><<<grid2, threads2, smem2, s>>>(
        tau, gain, rows, mics, paths, n1, n2, tw, zb, z);
  } else {
    err = palt::allow_smem<render_rows<1024, 1>>();
    if (err != cudaSuccess) return err;
    render_rows<1024, 1><<<grid2, threads2, smem2, s>>>(
        tau, gain, rows, mics, paths, n1, n2, tw, zb, z);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return render_cols_launch<kStrip>((rows + 1) / 2, n1, n2, tw, z, s);
}

// The render stage through the base rows' spectra (2^20 <= n <= 2^22, the
// split n = n1 * n2), where `render_rows`' two strips do not fit: K4a's
// two passes over the base rows (two scenes a packed row) into their half
// spectra spec (scenes, n/2 + 1) through zb (ceil(scenes / 2), n; may be
// z, which is written only after), `render_spec_rows`, then
// `render_cols`, leaving in z (ceil(scenes * mics / 2), n) the unscaled
// packed inverse of the mixes in natural order, as `render_split` does.
// cs: the column passes' strip, s2: K4a's pass-2 strip, rs: the row
// pass's.  Bound: device memory, the bases' read, K4a's packed rows out
// and back, the spectra out and (a scene's once for each of its mic rows)
// back, the packed mic rows out and back and the inverse's write.
cudaError_t render_spectra(const float* base, int scenes, int len,
                           const float* tau, const float* gain, int mics,
                           int paths, int n, int n1, int cs, int s2, int rs,
                           const float2* tw, float2* zb, float2* spec,
                           float2* z, cudaStream_t s) {
  const int n2 = n / n1;
  const int rows = scenes * mics;
  const int packed = (rows + 1) / 2;
  cudaError_t err = with_split_strip(cs, [&](auto strip) {
    return cols_launch<decltype(strip)::value>(
        RowLoad{base, scenes, len}, (scenes + 1) / 2, n1, n2, tw, zb, s);
  });
  if (err != cudaSuccess) return err;
  err = (cudaError_t)fft_real_rows_launch(zb, scenes, n1, n2, s2, tw, spec,
                                          s);
  if (err != cudaSuccess) return err;
  err = with_split_strip(rs, [&](auto strip) {
    constexpr int S = decltype(strip)::value;
    const cudaError_t e = palt::allow_smem<render_spec_rows<S>>();
    if (e != cudaSuccess) return e;
    render_spec_rows<S><<<dim3(n1 / S, packed), palt::fft_threads(n2, S),
                          (n2 / 2 + n1 + n2 + S * (n2 + 1)) *
                              (int)sizeof(float2),
                          s>>>(spec, tau, gain, rows, mics, paths, n1, n2,
                               tw, z);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return with_split_strip(cs, [&](auto strip) {
    return render_cols_launch<decltype(strip)::value>(packed, n1, n2, tw, z,
                                                      s);
  });
}

// GCC pass 2 (`gcc_rows`) over the packed mic rows zm (after pass 1) of
// `scenes` scenes -> the packed cross rows zc (scenes * couples, n);
// keys and count are K2's (null for K1).
cudaError_t gcc_rows_launch(int scenes, int mics, const int* pairs_i,
                            const int* pairs_j, int num_pairs,
                            const float* band, float eps, int n1, int n2,
                            const float2* tw, const float2* zm, float2* zc,
                            unsigned long long* keys, unsigned int* count,
                            cudaStream_t s) {
  using palt::kStrip;
  const int couples = (num_pairs + 1) / 2;
  const int strips = (mics + 1) / 2 + 1;  // a scene's widest span + 1
  const int threads = palt::fft_threads(n2, kStrip);
  const dim3 grid(n1 / kStrip, scenes,
                  row_groups(n1 / kStrip * scenes, threads, couples));
  const int smem =
      (n2 / 2 + n1 + n2 + strips * kStrip * (n2 + 1)) * (int)sizeof(float2);
  cudaError_t err;
  if (n2 <= 256) {
    err = palt::allow_smem<gcc_rows<256, 2>>();
    if (err != cudaSuccess) return err;
    gcc_rows<256, 2><<<grid, threads, smem, s>>>(
        pairs_i, pairs_j, num_pairs, mics, band, eps, n1, n2, tw, zm, zc,
        keys, count);
  } else {
    err = palt::allow_smem<gcc_rows<1024, 1>>();
    if (err != cudaSuccess) return err;
    gcc_rows<1024, 1><<<grid, threads, smem, s>>>(
        pairs_i, pairs_j, num_pairs, mics, band, eps, n1, n2, tw, zm, zc,
        keys, count);
  }
  return cudaGetLastError();
}

// GCC pass 3 (`window_cols`, strips of S columns) over the packed cross
// rows zc (scenes * couples, n) -> win / stats; keys and count zeroed by
// the row pass, part (scenes * couples * 2 * n2 / S) the partials.
template <int S>
cudaError_t window_cols_launch(const float2* zc, int scenes, int num_pairs,
                               int n1, int n2, int wq, const float2* tw,
                               float* win, float* stats, float* part,
                               unsigned long long* keys, unsigned int* count,
                               cudaStream_t s) {
  const int couples = (num_pairs + 1) / 2;
  const cudaError_t err = palt::allow_smem<window_cols<S>>();
  if (err != cudaSuccess) return err;
  window_cols<S><<<dim3(n2 / S, scenes * couples), palt::fft_threads(n1, S),
                   (n1 / 2 + n1 * S) * (int)sizeof(float2), s>>>(
      zc, num_pairs, couples, n1, n2, wq * 128, tw, win, stats, part, keys,
      count);
  return cudaGetLastError();
}

// The windowed-GCC stage on the split with `gcc_rows` (n1 > 1): the mic
// rows given by load (rows scene * mics + mic) -> win / stats, through zm
// (ceil(scenes * mics / 2), n; may be the loader's buffer) and zc (scenes
// * couples, n); keys (scenes * couples * 2), count (scenes * couples) and
// part (scenes * couples * 2 * n2 / kStrip) hold the statistics' partials.
template <class Load>
cudaError_t gcc_split(Load load, int scenes, int mics, const int* pairs_i,
                      const int* pairs_j, int num_pairs, const float* band,
                      float eps, int wq, int n, int n1, const float2* tw,
                      float2* zm, float2* zc, unsigned long long* keys,
                      unsigned int* count, float* part, float* win,
                      float* stats, cudaStream_t s) {
  using palt::kStrip;
  const int n2 = n / n1;
  cudaError_t err =
      cols_launch(load, (scenes * mics + 1) / 2, n1, n2, tw, zm, s);
  if (err != cudaSuccess) return err;
  err = gcc_rows_launch(scenes, mics, pairs_i, pairs_j, num_pairs, band, eps,
                        n1, n2, tw, zm, zc, keys, count, s);
  if (err != cudaSuccess) return err;
  return window_cols_launch<kStrip>(zc, scenes, num_pairs, n1, n2, wq, tw,
                                    win, stats, part, keys, count, s);
}

// ---- K1, K2, K5 and K9: whole correlations, and the GCC routes ---------
//
// K1 (all pairs of every scene; replaces `bfly_gcc_all_pairs`,
// ops/pallas_fft.py:922 of the TPU package) and K9 (row pairs of two
// natural-order spectra; replaces `bfly_whitened_corr`, :707) write the
// whole circular correlation, two pairs a packed Hermitian row; K2's
// GCC stage (K5's too) keeps the lag window and the statistics of it.
// The TPU kernels kept a row's butterfly planes in VMEM; a 65,536-point
// row (512 KB) does not fit a block's 227 KB.  K1, K2 and K5 take one
// route a shape (`GccRoute`, ``cuda_fft.gcc_route`` from nfft and the mic
// count), so that K5 and K3 then K2 compute the same bits:
//
// block (n <= 4,096 where a scene's packed mic rows and a spare row fit
//      one block): `gcc_block` / `window_block`, one launch.
// rows (8,192 to 2^19 where the row pass's strips fit, up to 10 mics at
//      65,536): K4a's pass 1 over the mic rows; `gcc_rows`, which holds a
//      strip of every packed mic row a scene spans and one more, (mics +
//      1) / 2 + 1 strips; `corr_cols` (K1) or `window_cols` (K2, K5).
// spectra (8,192 to 2^22 where `gcc_rows` does not fit, so at 2^20 to
//      2^22 at any mic count):  K4a's two passes over the mic rows into
//      their natural-order spectra (scenes * mics, n/2 + 1); `corr_rows`
//      with `PairIndexLoad`, which reads rows scene * mics + pairs_i[p]
//      and scene * mics + pairs_j[p] of them into the packed cross rows
//      (K2's argmax keys and block counters zeroed there); `corr_cols` or
//      `window_cols`.  One strip at any mic count, at the price of the
//      spectra's write and one read of two spectra a pair.
// spectra block (n <= 4,096 beyond the one-block mic limit):  K4a's
//      `fft_real_block` into the spectra; `corr_block` with
//      `PairIndexLoad`, a block a packed cross row, and K1's (`CorrOut`)
//      or K2's (`WindowOut`) epilogue.
// passes (above 2^22):  the radix-2 passes through device memory.
//
// K9:  `corr_rows` with `RowPairLoad` (rows 2c and 2c + 1 of a and b),
//      `corr_cols`; `corr_block` with `RowPairLoad` up to 4,096.
//
// `corr_rows` gathers each strip's bins of the two spectra of a pair (bin
// q <= n/2; the mirror comes from the Hermitian pair), whitens, runs the
// inverse row DFTs and the conjugate twiddle.  `corr_cols` is pass 1
// mirrored: the inverse column DFTs, times 1/n, written in natural order,
// the real part to pair 2c and the imaginary part to pair 2c + 1.  The
// strips are K4a's (``cuda_fft.split_strips``): 16 columns and 16 rows up
// to 1,024 x 1,024, 8 columns at n1 = 2,048 and 8 rows at n2 = 2,048.
// Bound: device memory (the rows' read and the correlations' or windows'
// write, plus on the split one write and one read of each packed buffer a
// pass, and the spectra on the spectra routes) and, in the row passes,
// their instructions; a single scene's or pair's call by its launches'
// latency.

// K1 / K9 pass 3.  Grid (n2 / S column strips, scenes * couples): the
// inverse column DFTs of packed cross row rc = scene * couples + c, times
// 1/n, into rows 2c (real part) and 2c + 1 (imaginary part, unless
// num_pairs is odd and c the last couple) of out (scenes, num_pairs, n).
template <int S>
__global__ void __launch_bounds__(1024)
corr_cols(const float2* __restrict__ zc, int num_pairs, int couples, int n1,
          int n2, const float2* __restrict__ tw, float* __restrict__ out) {
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n1 >> 1);
  const int n = n1 * n2;
  const int rc = blockIdx.y;
  const int scene = rc / couples;
  const int p0 = 2 * (rc - scene * couples);
  const bool two = p0 + 1 < num_pairs;
  const int c0 = blockIdx.x * S;
  palt::stage_twiddles(stw, tw, n1, n2);
  cols_inverse<S>(zc + (size_t)rc * n, buf, stw, n1, n2, c0);
  const float scale = 1.0f / (float)n;
  float* o0 = out + ((size_t)scene * num_pairs + p0) * (size_t)n;
  for (int idx = threadIdx.x; idx < n1 * S; idx += blockDim.x) {
    const size_t j = (size_t)(idx / S) * n2 + c0 + idx % S;
    const float2 v = buf[idx];
    o0[j] = v.x * scale;
    if (two) o0[n + j] = v.y * scale;
  }
}

template <int S = palt::kStrip>
cudaError_t corr_cols_launch(const float2* zc, int scenes, int num_pairs,
                             int n1, int n2, const float2* tw, float* out,
                             cudaStream_t s) {
  const int couples = (num_pairs + 1) / 2;
  const cudaError_t err = palt::allow_smem<corr_cols<S>>();
  if (err != cudaSuccess) return err;
  corr_cols<S><<<dim3(n2 / S, scenes * couples), palt::fft_threads(n1, S),
                 (n1 / 2 + n1 * S) * (int)sizeof(float2), s>>>(
      zc, num_pairs, couples, n1, n2, tw, out);
  return cudaGetLastError();
}

// Loaders of `corr_rows`: `load.pair(c, bins)` gives the four spectra
// rows (bins 0..n/2 each, ``bins`` = n/2 + 1 apart) whose whitened
// cross-spectra a0 * conj(b0) and a1 * conj(b1) packed cross row c holds;
// with no second pair, a1 and b1 repeat the first and `two` is false.
// scene and p0 say where the pairs' results go: pairs p0 and p0 + 1 of
// that scene.
struct CorrPair {
  const float2* a0;
  const float2* b0;
  const float2* a1;
  const float2* b1;
  bool two;
  int scene;
  int p0;
};

// K9: rows 2c and 2c + 1 of a and b (rows, n/2 + 1).
struct RowPairLoad {
  const float2* a;
  const float2* b;
  int rows;
  __device__ __forceinline__ CorrPair pair(int c, size_t bins) const {
    const bool two = 2 * c + 1 < rows;
    const size_t r0 = (size_t)(2 * c) * bins;
    const size_t r1 = two ? r0 + bins : r0;
    return {a + r0, b + r0, a + r1, b + r1, two, 0, 2 * c};
  }
};

// K1's, K2's and K5's spectra routes: packed cross row rc = scene *
// couples + c holds pairs 2c and 2c + 1 of the scene, whose mics are rows
// scene * mics + i of the spectra spec (scenes * mics, n/2 + 1).
struct PairIndexLoad {
  const float2* spec;
  const int* pairs_i;
  const int* pairs_j;
  int num_pairs;
  int mics;
  __device__ __forceinline__ CorrPair pair(int rc, size_t bins) const {
    const int couples = (num_pairs + 1) / 2;
    const int scene = rc / couples;
    const int p0 = 2 * (rc - scene * couples);
    const bool two = p0 + 1 < num_pairs;
    const int p1 = two ? p0 + 1 : p0;
    const size_t m0 = (size_t)scene * mics;
    return {spec + (m0 + pairs_i[p0]) * bins, spec + (m0 + pairs_j[p0]) * bins,
            spec + (m0 + pairs_i[p1]) * bins, spec + (m0 + pairs_j[p1]) * bins,
            two, scene, p0};
  }
};

// K1's, K2's, K5's and K9's pass 2.  Grid (n1 / S, packed cross rows):
// block (b, c) forms rows pair_row(b, r) of packed cross row c, whiten(a
// * conj(b)) * band of the loader's two pairs, from bins q <= n/2 of the
// natural-order spectra (one task a mirror pair, `pair_task`, so that
// reads run over consecutive bins), then the inverse row DFTs and the
// conjugate twiddle into zc.  S = 16 rows a strip, 8 at n2 = 2,048 (172
// KB).  Where keys is not null (K2's and K5's spectra route), block (0,
// c) clears row c's two argmax keys and its block counter for
// `window_cols`.
template <int kMaxThreads, int kMinBlocks, int S, class Load>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
corr_rows(Load load, const float* __restrict__ band, float eps, int n1,
          int n2, const float2* __restrict__ tw, float2* __restrict__ zc,
          unsigned long long* __restrict__ keys,
          unsigned int* __restrict__ count) {
  float2* stw = palt::fft_shared();
  float2* lo = stw + (n2 >> 1);
  float2* hi = lo + n1;
  float2* work = hi + n2;
  const int ld = n2 + 1;
  const int n = n1 * n2;
  const int c = blockIdx.y;
  const int blk = blockIdx.x;
  if (keys != nullptr && blk == 0 && threadIdx.x < 2) {
    keys[2 * (size_t)c + threadIdx.x] = 0ull;
    if (threadIdx.x == 0) count[c] = 0u;
  }
  const CorrPair src = load.pair(c, (size_t)(n >> 1) + 1);
  palt::stage_twiddles(stw, tw, n2, n1);
  stage_split_tables(lo, hi, tw, n1, n2);
  const int tasks = pair_tasks<S>(blk, n2);
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const PairTask p = pair_task<S>(t, blk, n1, n2, ld);
    const float bq = band[p.q];
    float2 r0 = whiten(src.a0[p.q], src.b0[p.q], eps);
    r0 = make_float2(r0.x * bq, r0.y * bq);
    float2 r1 = make_float2(0.0f, 0.0f);
    if (src.two) {
      r1 = whiten(src.a1[p.q], src.b1[p.q], eps);
      r1 = make_float2(r1.x * bq, r1.y * bq);
    }
    store_pair(work, p, n, r0, r1);
  }
  palt::block_fft<S>(work, 1, ld, n2, stw, -1.0f);
  store_rows<S>(work, zc + (size_t)c * n, lo, hi, blk, n1, n2);
}

// Pass 2 over `rows_c` packed cross rows of load into zc, strips of rs
// rows (16 or 8); at n2 <= 256 (16 rows) two blocks an SM, as K4b's.
// keys and count: K2's (null for K1 and K9).
template <class Load>
cudaError_t corr_rows_launch(Load load, int rows_c, const float* band,
                             float eps, int n1, int n2, int rs,
                             const float2* tw, float2* zc,
                             unsigned long long* keys, unsigned int* count,
                             cudaStream_t s) {
  return with_split_strip(rs, [&](auto strip) {
    constexpr int S = decltype(strip)::value;
    const dim3 grid(n1 / S, rows_c);
    const int threads = palt::fft_threads(n2, S);
    const int smem = (n2 / 2 + n1 + n2 + S * (n2 + 1)) * (int)sizeof(float2);
    cudaError_t err;
    if constexpr (S == palt::kStrip) {  // 8 rows only at n2 = 2,048
      if (n2 <= 256) {
        err = palt::allow_smem<corr_rows<256, 2, S, Load>>();
        if (err != cudaSuccess) return err;
        corr_rows<256, 2, S, Load><<<grid, threads, smem, s>>>(
            load, band, eps, n1, n2, tw, zc, keys, count);
        return cudaGetLastError();
      }
    }
    err = palt::allow_smem<corr_rows<1024, 1, S, Load>>();
    if (err != cudaSuccess) return err;
    corr_rows<1024, 1, S, Load><<<grid, threads, smem, s>>>(
        load, band, eps, n1, n2, tw, zc, keys, count);
    return cudaGetLastError();
  });
}

// K1's and K9's epilogue of `gcc_body` and `corr_block`: both
// correlations of the packed inverse (pairs p0 and p0 + 1 of the scene)
// times 1/n into out (scenes, num_pairs, n).
struct CorrOut {
  float* out;
  __device__ __forceinline__ void operator()(const float2* work, int scene,
                                             int num_pairs, int p0, bool two,
                                             int n) const {
    const float scale = 1.0f / (float)n;
    float* o0 = out + ((size_t)scene * num_pairs + p0) * (size_t)n;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float2 v = work[t];
      o0[t] = v.x * scale;
      if (two) o0[n + t] = v.y * scale;
    }
  }
};

// K2's and K5's epilogue of `gcc_body` (`window_block`) and, on the
// spectra block route, of `corr_block`: both correlations times
// 1/n, reduced as `last_pass_window` reduces them: the lags [-w, w) into
// win (scenes, num_pairs, 2w) (window sample s holds natural index n - w +
// s, then s - w) and stats (scenes, num_pairs, 3): mean |corr|, the
// maximum and the smallest natural index attaining it (-0 taken as +0, so
// a silent row's maximum is +0 at index 0, as `arg_key` takes it on the
// split).  Block reductions in a fixed order (a serial sum a thread over
// t = threadIdx.x + k * blockDim.x, then the shuffle trees of `block_sum`
// and `block_argmax`, which break ties by index): no atomics, no partials.
struct WindowOut {
  float* win;
  float* stats;
  int w;
  __device__ __forceinline__ void operator()(const float2* work, int scene,
                                             int num_pairs, int p0, bool two,
                                             int n) const {
    __shared__ float sv[32];
    __shared__ int si[32];
    const float scale = 1.0f / (float)n;
    const size_t q0 = (size_t)scene * num_pairs + p0;
    float* w0 = win + q0 * (size_t)(2 * w);
    float* w1 = w0 + 2 * w;
    float sum0 = 0.0f, sum1 = 0.0f;
    float max0 = -INFINITY, max1 = -INFINITY;
    int idx0 = INT_MAX, idx1 = INT_MAX;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float2 v = work[t];
      const float a = v.x * scale;
      const float d = v.y * scale;
      sum0 += fabsf(a);
      sum1 += fabsf(d);
      arg_update(max0, idx0, a == 0.0f ? 0.0f : a, t);
      arg_update(max1, idx1, d == 0.0f ? 0.0f : d, t);
      const int at = t < w ? w + t : (t >= n - w ? t - (n - w) : -1);
      if (at >= 0) {
        w0[at] = a;
        if (two) w1[at] = d;
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
};

// A scene's GCC in one block (n <= 4096), K1's and K2's.  Grid (scenes,
// groups): block (scene, g) loads the packed mic rows that hold the
// scene's mics (rows packed across scenes, as on the split; `load` gives
// them: K1's and K2's rows, K5's finished signals) and transforms them in
// shared memory; then for every gridDim.y-th couple c from the g-th it
// forms the whitened, band-masked cross-spectra of pairs 2c and 2c + 1
// (`gcc_cross`'s arithmetic) as one packed Hermitian row in the spare row,
// runs its inverse and hands it to `epi` (K1: `CorrOut`; K2 and K5:
// `WindowOut`).  Needs blockDim.x >= fft_threads(n, 1), whole warps.
template <class Load, class Epilogue>
__device__ __forceinline__ void gcc_body(Load load, int mics,
                                         const int* __restrict__ pairs_i,
                                         const int* __restrict__ pairs_j,
                                         int num_pairs,
                                         const float* __restrict__ band,
                                         float eps, int n,
                                         const float2* __restrict__ tw,
                                         const Epilogue& epi) {
  float2* stw = palt::fft_shared();
  float2* spec = stw + (n >> 1);
  const int scene = blockIdx.x;
  const int couples = (num_pairs + 1) / 2;
  const int row0 = scene * mics;
  const int first = row0 >> 1;
  const int span = ((row0 + mics - 1) >> 1) - first + 1;
  const int shift = __ffs(n) - 1;
  float2* work = spec + (size_t)span * n;
  palt::stage_twiddles(stw, tw, n, 1);
  for (int idx = threadIdx.x; idx < span * n; idx += blockDim.x)
    spec[idx] = load.row(first + (idx >> shift))(idx & (n - 1));
  for (int k = 0; k < span; ++k)
    palt::block_fft<1>(spec + (size_t)k * n, 1, 0, n, stw, 1.0f);
  for (int c = blockIdx.y; c < couples; c += gridDim.y) {
    const int p0 = 2 * c;
    const bool two = p0 + 1 < num_pairs;
    const int p1 = two ? p0 + 1 : p0;
    const int i0 = row0 + pairs_i[p0];
    const int j0 = row0 + pairs_j[p0];
    const int i1 = row0 + pairs_i[p1];
    const int j1 = row0 + pairs_j[p1];
    const float2* si0 = spec + (size_t)((i0 >> 1) - first) * n;
    const float2* sj0 = spec + (size_t)((j0 >> 1) - first) * n;
    const float2* si1 = spec + (size_t)((i1 >> 1) - first) * n;
    const float2* sj1 = spec + (size_t)((j1 >> 1) - first) * n;
    for (int q = threadIdx.x; q <= (n >> 1); q += blockDim.x) {
      const int m = (n - q) & (n - 1);
      const float bq = band[q];
      float2 r0 = whiten(split_bin(si0[q], si0[m], i0 & 1),
                         split_bin(sj0[q], sj0[m], j0 & 1), eps);
      r0 = make_float2(r0.x * bq, r0.y * bq);
      float2 r1 = make_float2(0.0f, 0.0f);
      if (two) {
        r1 = whiten(split_bin(si1[q], si1[m], i1 & 1),
                    split_bin(sj1[q], sj1[m], j1 & 1), eps);
        r1 = make_float2(r1.x * bq, r1.y * bq);
      }
      store_packed(work, q, n, r0, r1);
    }
    palt::block_fft<1>(work, 1, 0, n, stw, -1.0f);
    epi(work, scene, num_pairs, p0, two, n);
    __syncthreads();  // the next couple rewrites work
  }
}

// K1 in one block (`gcc_body` with `CorrOut`).
__global__ void __launch_bounds__(256)
gcc_block(RowLoad load, int mics, const int* __restrict__ pairs_i,
          const int* __restrict__ pairs_j, int num_pairs,
          const float* __restrict__ band, float eps, int n,
          const float2* __restrict__ tw, float* __restrict__ out) {
  gcc_body(load, mics, pairs_i, pairs_j, num_pairs, band, eps, n, tw,
           CorrOut{out});
}

// K2's windowed-GCC stage in one block (`gcc_body` with `WindowOut`): K2
// over its rows (`RowLoad`), K5 over the finished signals that
// `render_block` packed (`PackedLoad`).  Two blocks an SM cap a thread at
// 128 registers (with spills).
template <class Load>
__global__ void __launch_bounds__(256, 2)
window_block(Load load, int mics, const int* __restrict__ pairs_i,
             const int* __restrict__ pairs_j, int num_pairs,
             const float* __restrict__ band, float eps, int n,
             const float2* __restrict__ tw, int w, float* __restrict__ win,
             float* __restrict__ stats) {
  gcc_body(load, mics, pairs_i, pairs_j, num_pairs, band, eps, n, tw,
           WindowOut{win, stats, w});
}

// One block a packed cross row (n <= 4096): K9's, and the spectra block
// route's of K1, K2 and K5.  Block c: whiten(a * conj(b)) * band of the
// loader's two pairs (`RowPairLoad`: rows 2c and 2c + 1 of a and b;
// `PairIndexLoad`: pairs 2c and 2c + 1 of a scene, from its mics'
// spectra) over bins 0..n/2 as one packed Hermitian row in shared memory,
// its inverse, handed to `epi` with the pairs' scene and first pair (K9
// and K1: `CorrOut`; K2 and K5: `WindowOut`).  Needs blockDim.x >=
// fft_threads(n, 1), whole warps.
template <class Load, class Epilogue>
__global__ void __launch_bounds__(256)
corr_block(Load load, int num_pairs, const float* __restrict__ band,
           float eps, int n, const float2* __restrict__ tw, Epilogue epi) {
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n >> 1);
  const CorrPair src = load.pair(blockIdx.x, (size_t)(n >> 1) + 1);
  palt::stage_twiddles(stw, tw, n, 1);
  for (int q = threadIdx.x; q <= (n >> 1); q += blockDim.x) {
    const float bq = band[q];
    float2 r0 = whiten(src.a0[q], src.b0[q], eps);
    r0 = make_float2(r0.x * bq, r0.y * bq);
    float2 r1 = make_float2(0.0f, 0.0f);
    if (src.two) {
      r1 = whiten(src.a1[q], src.b1[q], eps);
      r1 = make_float2(r1.x * bq, r1.y * bq);
    }
    store_packed(buf, q, n, r0, r1);
  }
  palt::block_fft<1>(buf, 1, 0, n, stw, -1.0f);
  epi(buf, src.scene, num_pairs, src.p0, src.two, n);
}

// Threads of K1's and K9's one-block kernels (every n <= 4096 needs at
// most 256 for block_fft; the rest take part in the loads and stores).
constexpr int kBlockThreads = 256;

// Threads of `render_block` and `window_block` at n <= 4096: what
// block_fft needs (n / 16, so 256 at 4,096), at least two warps, so that
// the mixes, the finalize and the epilogue's reductions keep more than one
// warp busy while a short row's transform needs one (32 blocks of 64
// threads fill an SM at n <= 1,024).  K3, K2 and K5 take the same count at
// a length, so their block reductions sum in the same order.
inline int block_threads(int n) {
  const int threads = palt::fft_threads(n, 1);
  return threads < 64 ? 64 : threads;
}

// `corr_block` over `rows_c` packed cross rows of load, `threads` a block.
template <class Load, class Epilogue>
cudaError_t corr_block_launch(Load load, int rows_c, int num_pairs,
                              const float* band, float eps, int n,
                              int threads, const float2* tw,
                              const Epilogue& epi, cudaStream_t s) {
  const cudaError_t err = palt::allow_smem<corr_block<Load, Epilogue>>();
  if (err != cudaSuccess) return err;
  corr_block<Load, Epilogue><<<rows_c, threads,
                               (n / 2 + n) * (int)sizeof(float2), s>>>(
      load, num_pairs, band, eps, n, tw, epi);
  return cudaGetLastError();
}

// K3's render stage in one block (n <= 4096), with the finish of
// `render_finalize`.  Grid (packed base rows, groups): block (cb, g) loads
// the packed base row cb (scenes 2cb and 2cb + 1) and transforms it in
// shared memory once; its mic rows are packed rows [cb * mics, (cb + 1) *
// mics) (any mic count: mic rows are numbered scene * mics + mic, so a
// packed row of an odd count may hold the last mic of scene 2cb and the
// first of 2cb + 1).  For every gridDim.y-th of them from the g-th: the
// mixes (`render_mix`'s arithmetic, mic row r from the spectrum of scene r
// / mics) packed two mic rows a Hermitian row in the work row, its
// inverse, then for its two mic rows at once the scale 1/n, the fade, the
// trim and `finish_rows` in shared memory; the finished rows go to out
// (rows, out_len) (K3) or, zero-padded to n, to packed row pm of `packed`
// (K5: the forward input of its GCC stage, as `render_finalize` writes
// it, so `window_block` reads K3's floats in K2's packing).  Shared memory
// n/2 twiddles, the base row and one work row, whatever the mic and path
// counts.
__global__ void __launch_bounds__(256, 2)
render_block(RowLoad load, const float* __restrict__ tau,
             const float* __restrict__ gain, int rows, int mics, int paths,
             int n, int out_len, const float* __restrict__ fade,
             int finalize, const float* __restrict__ snr_db,
             const int* __restrict__ seeds, const float2* __restrict__ tw,
             float* __restrict__ out, float2* __restrict__ packed) {
  __shared__ float red[64];
  float2* stw = palt::fft_shared();
  float2* spec = stw + (n >> 1);
  float2* work = spec + n;
  const int cb = blockIdx.x;
  const auto src = load.row(cb);
  palt::stage_twiddles(stw, tw, n, 1);
  for (int t = threadIdx.x; t < n; t += blockDim.x) spec[t] = src(t);
  palt::block_fft<1>(spec, 1, 0, n, stw, 1.0f);
  const float scale = 1.0f / (float)n;
  const int last = min((cb + 1) * mics, (rows + 1) / 2);
  for (int pm = cb * mics + blockIdx.y; pm < last; pm += gridDim.y) {
    const int ra = 2 * pm;
    const bool two = ra + 1 < rows;
    const int oa = (ra / mics) & 1;
    const int ob = ((ra + 1) / mics) & 1;
    const float* ta = tau + (size_t)ra * paths;
    const float* ga = gain + (size_t)ra * paths;
    for (int q = threadIdx.x; q <= (n >> 1); q += blockDim.x) {
      const float2 zq = spec[q];
      const float2 zm = spec[(n - q) & (n - 1)];
      const float2 ya = cmul(split_bin(zq, zm, oa),
                             mic_response(ta, ga, paths, q, n));
      float2 yb = make_float2(0.0f, 0.0f);
      if (two)
        yb = cmul(split_bin(zq, zm, ob),
                  mic_response(ta + paths, ga + paths, paths, q, n));
      store_packed(work, q, n, ya, yb);
    }
    palt::block_fft<1>(work, 1, 0, n, stw, -1.0f);
    float peak[2] = {0.0f, 0.0f};
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
      const float2 v = work[t];
      const float f = fade[t];
      const float2 y = make_float2(v.x * scale * f, v.y * scale * f);
      work[t] = y;
      peak[0] = fmaxf(peak[0], fabsf(y.x));
      peak[1] = fmaxf(peak[1], fabsf(y.y));
    }
    float* o = reinterpret_cast<float*>(work);
    const int sa = ra / mics;
    const int sb = (ra + 1) / mics;
    if (two) {
      const int scene[2] = {sa, sb};
      const int mic[2] = {ra - sa * mics, ra + 1 - sb * mics};
      finish_rows(o, 2, out_len, peak, finalize, snr_db, seeds, scene, mic,
                  red);
    } else {
      float peak_a[1] = {peak[0]};
      const int scene[1] = {sa};
      const int mic[1] = {ra - sa * mics};
      finish_rows(o, 2, out_len, peak_a, finalize, snr_db, seeds, scene, mic,
                  red);
    }
    // Each thread writes the samples it finished.
    if (packed != nullptr) {
      float2* zc = packed + (size_t)pm * n;
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const float2 v = work[t];
        zc[t] = t < out_len ? make_float2(v.x, two ? v.y : 0.0f)
                            : make_float2(0.0f, 0.0f);
      }
    } else {
      float* oa_row = out + (size_t)ra * out_len;
      for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
        const float2 v = work[t];
        oa_row[t] = v.x;
        if (two) oa_row[out_len + t] = v.y;
      }
    }
    __syncthreads();  // the next mic row's mixes rewrite work
  }
}

// `render_block` over `scenes` scenes: base rows (scenes, len) -> out
// (scenes * mics, out_len), or the packed rows (ceil(scenes * mics / 2),
// n) of `packed` where it is not null.
cudaError_t render_block_launch(const float* base, int scenes, int len,
                                const float* tau, const float* gain, int mics,
                                int paths, int n, int out_len,
                                const float* fade, int finalize,
                                const float* snr_db, const int* seeds,
                                const float2* tw, float* out, float2* packed,
                                cudaStream_t s) {
  const int packed_b = (scenes + 1) / 2;
  const int threads = block_threads(n);
  const cudaError_t err = palt::allow_smem<render_block>();
  if (err != cudaSuccess) return err;
  render_block<<<dim3(packed_b, row_groups(packed_b, threads, mics)),
                 threads, (n / 2 + 2 * n) * (int)sizeof(float2), s>>>(
      RowLoad{base, scenes, len}, tau, gain, scenes * mics, mics, paths, n,
      out_len, fade, finalize, snr_db, seeds, tw, out, packed);
  return cudaGetLastError();
}

// `window_block` over the mic rows given by load (rows scene * mics + mic)
// of `scenes` scenes -> win / stats.
template <class Load>
cudaError_t window_block_launch(Load load, int scenes, int mics,
                                const int* pairs_i, const int* pairs_j,
                                int num_pairs, const float* band, float eps,
                                int wq, int n, const float2* tw, float* win,
                                float* stats, cudaStream_t s) {
  const int couples = (num_pairs + 1) / 2;
  const int threads = block_threads(n);
  const int smem = (n / 2 + ((mics + 1) / 2 + 1) * n) * (int)sizeof(float2);
  const dim3 grid(scenes, row_groups(scenes, threads, couples));
  const cudaError_t err = palt::allow_smem<window_block<Load>>();
  if (err != cudaSuccess) return err;
  window_block<Load><<<grid, threads, smem, s>>>(
      load, mics, pairs_i, pairs_j, num_pairs, band, eps, n, tw, wq * 128,
      win, stats);
  return cudaGetLastError();
}

// K1 on the split (n1 > 1), through zm (ceil(scenes * mics / 2), n) and zc
// (scenes * couples, n).
cudaError_t gcc_all_split(const float* x, int scenes, int mics, int len,
                          const int* pairs_i, const int* pairs_j,
                          int num_pairs, const float* band, float eps, int n,
                          int n1, const float2* tw, float2* zm, float2* zc,
                          float* out, cudaStream_t s) {
  const int n2 = n / n1;
  const int rows = scenes * mics;
  cudaError_t err =
      cols_launch(RowLoad{x, rows, len}, (rows + 1) / 2, n1, n2, tw, zm, s);
  if (err != cudaSuccess) return err;
  err = gcc_rows_launch(scenes, mics, pairs_i, pairs_j, num_pairs, band, eps,
                        n1, n2, tw, zm, zc, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  return corr_cols_launch(zc, scenes, num_pairs, n1, n2, tw, out, s);
}

// The spectra route's first three launches (8,192 <= n <= 2^22): K4a's
// two passes over the mic rows given by load (rows scene * mics + mic)
// into their natural-order spectra spec (scenes * mics, n/2 + 1) through
// zm (ceil(scenes * mics / 2), n; may be the loader's buffer), then
// `corr_rows` with `PairIndexLoad` into the pairs' packed cross rows zc
// (scenes * couples, n; may be zm, which is dead by then).  keys and
// count are K2's (null for K1).  cs: the column passes' strip, s2: K4a's
// pass-2 strip, rs: the row pass's.
template <class Load>
cudaError_t spectra_cross(Load load, int scenes, int mics, const int* pairs_i,
                          const int* pairs_j, int num_pairs,
                          const float* band, float eps, int n, int n1, int cs,
                          int s2, int rs, const float2* tw, float2* zm,
                          float2* spec, float2* zc, unsigned long long* keys,
                          unsigned int* count, cudaStream_t s) {
  const int n2 = n / n1;
  const int rows = scenes * mics;
  cudaError_t err = with_split_strip(cs, [&](auto strip) {
    return cols_launch<decltype(strip)::value>(load, (rows + 1) / 2, n1, n2,
                                               tw, zm, s);
  });
  if (err != cudaSuccess) return err;
  err = (cudaError_t)fft_real_rows_launch(zm, rows, n1, n2, s2, tw, spec, s);
  if (err != cudaSuccess) return err;
  return corr_rows_launch(
      PairIndexLoad{spec, pairs_i, pairs_j, num_pairs, mics},
      scenes * ((num_pairs + 1) / 2), band, eps, n1, n2, rs, tw, zc, keys,
      count, s);
}

// The spectra block route (n <= 4096): K4a's `fft_real_block` over the
// mic rows given by load into their spectra spec (scenes * mics, n/2 +
// 1), then `corr_block` with `PairIndexLoad`, a block a packed cross row
// of `threads` threads, ending in epi.
template <class Load, class Epilogue>
cudaError_t spectra_block(Load load, int scenes, int mics, const int* pairs_i,
                          const int* pairs_j, int num_pairs,
                          const float* band, float eps, int n, int threads,
                          const float2* tw, float2* spec, const Epilogue& epi,
                          cudaStream_t s) {
  const cudaError_t err =
      fft_real_block_launch(load, scenes * mics, n, tw, spec, s);
  if (err != cudaSuccess) return err;
  return corr_block_launch(
      PairIndexLoad{spec, pairs_i, pairs_j, num_pairs, mics},
      scenes * ((num_pairs + 1) / 2), num_pairs, band, eps, n, threads, tw,
      epi, s);
}

// K2's windowed-GCC stage (K5's too) on `route`, every route but the
// passes, for the mic rows given by load (rows scene * mics + mic) of
// `scenes` scenes -> win / stats: one block a scene (`window_block`); the
// split with `gcc_rows` through zm and zc (`gcc_split`); the split
// through the spectra (`spectra_cross` through zm, spec and zc, then
// `window_cols` with strips of cs columns); one block a packed cross row
// through spec (`spectra_block` with `WindowOut`).  keys, count and part
// hold the split's partials.
template <class Load>
cudaError_t window_route(Load load, int route, int scenes, int mics,
                         const int* pairs_i, const int* pairs_j,
                         int num_pairs, const float* band, float eps, int wq,
                         int n, int n1, int cs, int s2, int rs,
                         const float2* tw, float2* zm, float2* spec,
                         float2* zc, unsigned long long* keys,
                         unsigned int* count, float* part, float* win,
                         float* stats, cudaStream_t s) {
  if (route == kRouteBlock)
    return window_block_launch(load, scenes, mics, pairs_i, pairs_j,
                               num_pairs, band, eps, wq, n, tw, win, stats, s);
  if (route == kRouteRows)
    return gcc_split(load, scenes, mics, pairs_i, pairs_j, num_pairs, band,
                     eps, wq, n, n1, tw, zm, zc, keys, count, part, win,
                     stats, s);
  if (route == kRouteSpectraBlock)
    return spectra_block(load, scenes, mics, pairs_i, pairs_j, num_pairs,
                         band, eps, n, block_threads(n), tw, spec,
                         WindowOut{win, stats, wq * 128}, s);
  if (route != kRouteSpectra) return cudaErrorInvalidValue;
  const cudaError_t err =
      spectra_cross(load, scenes, mics, pairs_i, pairs_j, num_pairs, band,
                    eps, n, n1, cs, s2, rs, tw, zm, spec, zc, keys, count, s);
  if (err != cudaSuccess) return err;
  return with_split_strip(cs, [&](auto strip) {
    return window_cols_launch<decltype(strip)::value>(
        zc, scenes, num_pairs, n1, n / n1, wq, tw, win, stats, part, keys,
        count, s);
  });
}

// K9 on the split (n1 > 1), through zc (ceil(rows / 2), n), strips of cs
// columns and rs rows.
cudaError_t corr_split(const float2* a, const float2* b, int rows,
                       const float* band, float eps, int n, int n1, int cs,
                       int rs, const float2* tw, float2* zc, float* out,
                       cudaStream_t s) {
  const int n2 = n / n1;
  const cudaError_t err =
      corr_rows_launch(RowPairLoad{a, b, rows}, (rows + 1) / 2, band, eps, n1,
                       n2, rs, tw, zc, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  return with_split_strip(cs, [&](auto strip) {
    return corr_cols_launch<decltype(strip)::value>(zc, 1, rows, n1, n2, tw,
                                                    out, s);
  });
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

// K3's render stage (K5's too) on `route`, every route but one block:
// base rows (scenes, len) -> the unscaled packed inverse of the mixes
// (rows scene * mics + mic) in *sig: z0 on the split with `render_rows`
// (through zb0) and through the base rows' spectra (through zb0 and
// spec), z0 or z1 on the radix-2 passes (through zb0 / zb1).
cudaError_t render_route(const float* base, int scenes, int len,
                         const float* tau, const float* gain, int mics,
                         int paths, int n, int n1, int route, int cs, int s2,
                         int rs, const float2* tw, float2* zb0, float2* zb1,
                         float2* z0, float2* z1, float2* spec, float2** sig,
                         cudaStream_t s) {
  *sig = z0;
  if (route == kRouteSpectra)
    return render_spectra(base, scenes, len, tau, gain, mics, paths, n, n1,
                          cs, s2, rs, tw, zb0, spec, z0, s);
  if (route == kRouteRows)
    return render_split(base, scenes, len, tau, gain, mics, paths, n, n1, tw,
                        zb0, z0, s);
  if (route != kRoutePasses) return cudaErrorInvalidValue;
  *sig = render_stage(base, scenes, len, tau, gain, mics, paths, n, tw, zb0,
                      zb1, z0, z1, s);
  return cudaGetLastError();
}

// The finish of the packed inverse z's mic rows (rows scene * mics + mic)
// into out (rows, out_len), or in place where packed_out: one launch of
// `render_finalize`, a block a mic row, where groups is 1; else
// `finish_spread`'s steps over groups blocks a packed row (4 launches
// with the finalize and the noise, 3 with the finalize, 2 with the
// noise, else 1), with the partials in part (rows * 3 * groups).
cudaError_t finish_launch(float2* z, int rows, int n, int mics, int out_len,
                          const float* fade, int finalize,
                          const float* snr_db, const int* seeds, float* out,
                          int packed_out, int groups, float* part,
                          cudaStream_t s) {
  const float scale = 1.0f / (float)n;
  if (groups == 1) {
    render_finalize<<<rows, kRowThreads, 0, s>>>(z, n, mics, out_len, fade,
                                                 scale, finalize, snr_db,
                                                 seeds, out, packed_out);
    return cudaGetLastError();
  }
  for (int step = 0; step < 4; ++step) {
    if ((step == 1 || step == 2) && !finalize) continue;
    if (step == 3 && snr_db == nullptr) continue;
    finish_spread<<<dim3(groups, (rows + 1) / 2), kRowThreads, 0, s>>>(
        z, rows, n, mics, out_len, fade, scale, snr_db, seeds, out,
        packed_out, step, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// K6's pipeline (and K4b's above 2^24) on the radix-2 passes, after buf0
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
// one block per packed row (n <= 4096); n1 = 0 (n > 2^24): the packed
// rows, log2(n) radix-2 passes through buf's two halves of ceil(rows/2)
// rows each, and `split_spectra`; else the two passes of the four-step
// split n = n1 * n2 through buf (ceil(rows/2), n) complex (n1 < n2 above
// 2^22), pass 1 with strips of cs (16, 8 or 4) columns, pass 2 with
// strips of s2 (4, 8, 16, 32 or 64) rows.
int palt_fft_real(const float* x, int rows, int len, int n, int n1, int cs,
                  int s2, const float2* tw, float2* buf, float2* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int packed = (rows + 1) / 2;
  if (n1 == 0) {
    pack_rows<<<dim3(palt::pass_blocks(n), packed), kThreads, 0, s>>>(
        x, rows, len, len, n, buf);
    PALT_CHECK();
    const float2* spec = fft_rows(buf, buf + (size_t)packed * n, tw, n,
                                  packed, 0, log2_int(n), s);
    PALT_CHECK();
    split_spectra<<<dim3(bin_blocks(n), packed), kThreads, 0, s>>>(
        spec, rows, n, out);
    PALT_CHECK();
    return 0;
  }
  if (n1 == 1)
    return (int)fft_real_block_launch(RowLoad{x, rows, len}, rows, n, tw, out,
                                      s);
  const int n2 = n / n1;
  const cudaError_t err = with_split_strip<true>(cs, [&](auto strip) {
    return cols_launch<decltype(strip)::value>(RowLoad{x, rows, len}, packed,
                                               n1, n2, tw, buf, s);
  });
  if (err != cudaSuccess) return (int)err;
  return fft_real_rows_launch(buf, rows, n1, n2, s2, tw, out, s);
}

// K1: x (scenes, mics, len) -> out (scenes, num_pairs, n) PHAT
// correlations, circular.  Rows scene * mics + mic are packed two to a
// transform across scenes (an odd mic count still packs), as in K2.  By
// route (`GccRoute`): one block a scene (`gcc_block`), no buffer; `gcc_rows`
// on the split n = n1 * n2, three launches through spec0 and z0; the split
// through the mic rows' spectra (`spectra_cross`, then `corr_cols`), four
// launches through spec0 (K4a's packed rows), spec1 (the spectra, scenes *
// mics rows of n/2 + 1 complex) and z0 (the cross rows; may be spec0),
// with strips of cs columns, s2 rows in K4a's pass 2 and rs rows in the
// row pass; one block a packed cross row through the spectra
// (`spectra_block`), two launches through spec1; the radix-2 passes
// through spec0 / spec1 and z0 / z1.
int palt_gcc_all_pairs(const float* x, int scenes, int mics, int len, int n,
                       int n1, int route, int cs, int s2, int rs,
                       const int* pairs_i, const int* pairs_j, int num_pairs,
                       const float* band, float eps, const float2* tw,
                       float2* spec0, float2* spec1, float2* z0, float2* z1,
                       float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = scenes * mics;
  const int packed = (rows + 1) / 2;
  const int couples = (num_pairs + 1) / 2;
  const int cross = scenes * couples;
  const RowLoad load{x, rows, len};
  if (route == kRouteBlock) {
    const int smem = (n / 2 + ((mics + 1) / 2 + 1) * n) * (int)sizeof(float2);
    const cudaError_t err = palt::allow_smem<gcc_block>();
    if (err != cudaSuccess) return (int)err;
    gcc_block<<<dim3(scenes, row_groups(scenes, kBlockThreads, couples)),
                kBlockThreads, smem, s>>>(load, mics, pairs_i, pairs_j,
                                          num_pairs, band, eps, n, tw, out);
    PALT_CHECK();
    return 0;
  }
  if (route == kRouteRows)
    return (int)gcc_all_split(x, scenes, mics, len, pairs_i, pairs_j,
                              num_pairs, band, eps, n, n1, tw, spec0, z0, out,
                              s);
  if (route == kRouteSpectraBlock)
    return (int)spectra_block(load, scenes, mics, pairs_i, pairs_j,
                              num_pairs, band, eps, n, kBlockThreads, tw,
                              spec1, CorrOut{out}, s);
  if (route == kRouteSpectra) {
    const cudaError_t err = spectra_cross(
        load, scenes, mics, pairs_i, pairs_j, num_pairs, band, eps, n, n1, cs,
        s2, rs, tw, spec0, spec1, z0, nullptr, nullptr, s);
    if (err != cudaSuccess) return (int)err;
    return (int)with_split_strip(cs, [&](auto strip) {
      return corr_cols_launch<decltype(strip)::value>(z0, scenes, num_pairs,
                                                      n1, n / n1, tw, out, s);
    });
  }
  if (route != kRoutePasses) return (int)cudaErrorInvalidValue;
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
// correlation windows and stats (scenes, num_pairs, 3).  By route
// (`window_route`): one block a scene (`window_block`), no buffer;
// `gcc_rows` on the split n = n1 * n2 (`gcc_split`) through spec0 and c0;
// the split through the spectra, K1's buffers and strips (spec0 K4a's
// packed rows, spec1 the spectra, c0 the cross rows; may be spec0); one
// block a packed cross row through the spectra in spec1; the split routes
// with keys, count and part; the radix-2 passes through spec0 / spec1 and
// c0 / c1.
int palt_gcc_windowed(const float* x, int scenes, int mics, int len, int n,
                      int n1, int route, int cs, int s2, int rs,
                      const int* pairs_i, const int* pairs_j, int num_pairs,
                      const float* band, float eps, int wq, const float2* tw,
                      float2* spec0, float2* spec1, float2* c0, float2* c1,
                      unsigned long long* keys, unsigned int* count,
                      float* part, float* win, float* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = scenes * mics;
  if (route != kRoutePasses)
    return (int)window_route(RowLoad{x, rows, len}, route, scenes, mics,
                             pairs_i, pairs_j, num_pairs, band, eps, wq, n,
                             n1, cs, s2, rs, tw, spec0, spec1, c0, keys,
                             count, part, win, stats, s);
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
// 2^24) through buf's two halves of ceil(rows/2) rows each; else the three
// launches of the split n = n1 * n2 through buf (ceil(rows/2), n) in
// place, the column passes with strips of cs columns and the row pass
// with strips of rs rows (16, 8 or 4 each).
int palt_bootstrap_peaks(const float2* s1, const float* x, int rows, int len,
                         int n, int n1, int cs, int rs, float eps,
                         const float2* tw, float2* buf, float* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n1 == 0) {
    const int packed = (rows + 1) / 2;
    pack_rows<<<dim3(palt::pass_blocks(n), packed), kThreads, 0, s>>>(
        x, rows, len, len, n, buf);
    PALT_CHECK();
    boot_stage(s1, rows, n, eps, 0, tw, buf, buf + (size_t)packed * n, out,
               s);
    PALT_CHECK();
    return 0;
  }
  return (int)boot_split(s1, RowLoad{x, rows, len}, rows, n, n1, cs, rs, eps,
                         tw, buf, out, s);
}

// K6: s1 (n/2+1) complex, seeds (rows, 2) int32 -> out (rows,) maxima of
// the PHAT correlations between s1's signal and `rows` in-kernel uniform
// noise draws of n_samp samples each, zero-padded to n: K4b's schedules
// and buffer (n1, cs, rs and buf as there) with the draws made by the
// loader; the passes (n1 = 0) draw in their first pass.
int palt_noise_bootstrap_peaks(const float2* s1, const int* seeds, int rows,
                               int n_samp, int n, int n1, int cs, int rs,
                               float eps, const float2* tw, float2* buf,
                               float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n1 == 0) {
    const int packed = (rows + 1) / 2;
    noise_first_pass<<<dim3(palt::pass_blocks(n), packed), kThreads, 0,
                       s>>>(seeds, rows, n_samp, n, buf);
    PALT_CHECK();
    boot_stage(s1, rows, n, eps, 1, tw, buf, buf + (size_t)packed * n, out,
               s);
    PALT_CHECK();
    return 0;
  }
  return (int)boot_split(s1, NoiseLoad{seeds, rows, n_samp}, rows, n, n1, cs,
                         rs, eps, tw, buf, out, s);
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
// scaled by 1/n (K1's back half with arbitrary row pairs).  n1 = 1: one
// block a packed row (`corr_block`), no buffer; n1 > 1: the two launches of
// the split n = n1 * n2 through z0, strips of cs columns and rs rows (16
// or 8 each); n1 = 0: the radix-2 passes through z0 / z1.
int palt_whitened_corr(const float2* a, const float2* b, int rows, int n,
                       int n1, int cs, int rs, const float* band, float eps,
                       const float2* tw, float2* z0, float2* z1, float* out,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int couples = (rows + 1) / 2;
  if (n1 == 1)
    return (int)corr_block_launch(RowPairLoad{a, b, rows}, couples, rows, band,
                                  eps, n, kBlockThreads, tw, CorrOut{out}, s);
  if (n1 > 1)
    return (int)corr_split(a, b, rows, band, eps, n, n1, cs, rs, tw, z0, out,
                           s);
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
// snr_db is NULL.  By route (`render_route`; n1 the split's): one block a
// packed base row (`render_block`), no buffer; the split with
// `render_rows` through zb0 and z0; the split through the base rows'
// spectra (`render_spectra`) through zb0 (may be z0), spec (scenes, n/2 +
// 1) and z0, with strips of cs columns, s2 rows in K4a's pass 2 and rs
// rows in the row pass; the radix-2 passes through zb0 / zb1 and z0 / z1.
// Off one block the finish follows (`finish_launch`, over groups blocks a
// packed mic row, its partials in part).
int palt_delay_sum(const float* base, int scenes, int len, const float* tau,
                   const float* gain, int mics, int paths, int n, int n1,
                   int out_len, const float* fade, int finalize,
                   const float* snr_db, const int* seeds, const float2* tw,
                   float2* zb0, float2* zb1, float2* z0, float2* z1,
                   int route, int cs, int s2, int rs, float2* spec,
                   int groups, float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteBlock)
    return (int)render_block_launch(base, scenes, len, tau, gain, mics,
                                    paths, n, out_len, fade, finalize,
                                    snr_db, seeds, tw, out, nullptr, s);
  float2* sig = nullptr;
  const cudaError_t err =
      render_route(base, scenes, len, tau, gain, mics, paths, n, n1, route,
                   cs, s2, rs, tw, zb0, zb1, z0, z1, spec, &sig, s);
  if (err != cudaSuccess) return (int)err;
  return (int)finish_launch(sig, scenes * mics, n, mics, out_len, fade,
                            finalize, snr_db, seeds, out, 0, groups, part, s);
}

// K5: the whole scene.  K3's render with finalize (and noise) for every
// scene, each finished signal written as the packed forward input of K2's
// GCC, then K2's GCC stage.  Outputs as K2.  The render on K3's route
// (rroute, with n1r, rcs, rs2 and rrs as K3 takes them; through zb0 /
// zb1, z0 / z1 and, through the base rows' spectra, spec, which the GCC's
// spectra overwrite later) with K3's finish (`finish_launch` over groups
// blocks a packed mic row, its partials in fpart); the GCC stage on K2's
// route (`window_route`, with n1g, cs, s2 and rs as K2 takes them) over
// the finished signals (`PackedLoad`) in z0 or z1, where the render left
// them: at n <= 4096 `render_block` packs them into z0; a split route
// transforms them in place, the rows route into the cross rows c0, the
// spectra route into the spectra spec and then the cross rows c0 (z0: the
// packed rows are dead by then); the spectra block route into spec; the
// radix-2 passes through the other of z0 / z1 and c0 / c1.
int palt_scene_windowed(const float* base, int scenes, int len,
                        const float* tau, const float* gain, int mics,
                        int paths, int n, int n1r, int n1g, int route, int cs,
                        int s2, int rs, int out_len, const float* fade,
                        const float* snr_db, const int* seeds,
                        const int* pairs_i, const int* pairs_j, int num_pairs,
                        const float* band, float eps, int wq, const float2* tw,
                        float2* zb0, float2* zb1, float2* z0, float2* z1,
                        float2* c0, float2* c1, float2* spec,
                        unsigned long long* keys, unsigned int* count,
                        float* part, int rroute, int rcs, int rs2, int rrs,
                        int groups, float* fpart, float* win, float* stats,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = scenes * mics;
  float2* sig = z0;
  if (rroute == kRouteBlock) {
    const cudaError_t err = render_block_launch(
        base, scenes, len, tau, gain, mics, paths, n, out_len, fade, 1,
        snr_db, seeds, tw, nullptr, z0, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    cudaError_t err =
        render_route(base, scenes, len, tau, gain, mics, paths, n, n1r,
                     rroute, rcs, rs2, rrs, tw, zb0, zb1, z0, z1, spec, &sig,
                     s);
    if (err != cudaSuccess) return (int)err;
    err = finish_launch(sig, rows, n, mics, out_len, fade, 1, snr_db, seeds,
                        nullptr, 1, groups, fpart, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (route != kRoutePasses)
    return (int)window_route(PackedLoad{sig, rows, n}, route, scenes, mics,
                             pairs_i, pairs_j, num_pairs, band, eps, wq, n,
                             n1g, cs, s2, rs, tw, sig, spec, c0, keys, count,
                             part, win, stats, s);
  float2* other = sig == z0 ? z1 : z0;
  float2* spectra = fft_rows(sig, other, tw, n, (rows + 1) / 2, 0,
                             log2_int(n), s);
  PALT_CHECK();
  window_stage(spectra, scenes, mics, pairs_i, pairs_j, num_pairs, band, eps,
               wq, n, tw, c0, c1, win, stats, s);
  PALT_CHECK();
  return 0;
}

}  // extern "C"

// K10: the four-step row DFT, its radix-2 passes and the lane DFT.
#include "rowdft.cu"
