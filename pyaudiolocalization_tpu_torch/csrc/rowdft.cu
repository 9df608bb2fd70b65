// K10: the four-step row DFT of (B, n2, 128) float32 planes: the row DFT
// by butterfly stages and with its radix-16 stages on the tensor cores,
// and the 128-point lane DFT (sm_90a).  Included from kernels.cu (after
// its helpers); bound by ops/rowdft.py.
//
// A length-N row (N = n2 * 128) is held as a plane x2d[q, p] = x[q*128 + p]
// (the TPU package's layout, pallas_fft.py:57-59).  Every plane here is a
// pair of float32 arrays (re, im), rows in natural order.
//
// K10b palt_row_stages replaces `_stages_kernel` (tools/mxu_rowdft_bench.py
//   :170, `_dif_stages` pallas_fft.py:336): the length-n2 DFT along the
//   rows of every lane by butterfly stages, all of them on chip: one block
//   loads a strip of n2 rows x S lanes (each row's S lanes contiguous),
//   runs fft.cuh's `block_fft` (a radix-2, 4 or 8 stage where log2(n2) is
//   not a multiple of 4, then radix-16 Stockham stages, in float32
//   registers, shared-memory exchanges between them) and writes the strip
//   in natural order, one launch per transform.
//   Bound: one read and one write of the plane (16 bytes a point).
//
// K10a palt_row_dft replaces `_rowdft_kernel` / `_rowinv_kernel` (:181,
//   :192, bodies `_rowdft_mxu` :101 and `_rowinv_mxu` :135, launched by
//   `_call` :328): the same function by K10b's strip schedule (the same
//   load, stage loop, index maps and store), each radix-16 stage a product
//   on the tensor cores.  For a warp's n8 tile of 8 butterflies, B (k16 x
//   n8) holds their 16 inputs, already times the stage twiddle in float32,
//   and A (m16 x k16) is W16 = exp(-2 pi i m k / 16) (its conjugate for the
//   unscaled inverse); the accumulator goes to the Stockham output slots.
//   mma.sync m16n8k8 TF32 in 3xTF32: x = hi + lo, each part rounded by
//   cvt.rna, accumulating hi*lo + lo*hi + hi*hi in float32 (the
//   counterpart of the TPU's Precision.HIGHEST; TF32 alone keeps ~3
//   digits).  W16's split fragments are made once per thread and held in
//   registers for the whole kernel (32 a thread); the data are split in
//   registers at use.  Tensor work: 192 TF32 MACs a point a radix-16 stage
//   (24 MMAs a tile of 8 butterflies).  Bound: the plane's read and write,
//   as K10b; the plane is read once.  The fragments and a stage's
//   accumulators (32 registers each) take a thread to ~124 registers
//   unbounded; a block has at most 256 threads (one block of 512 an SM
//   serializes its load, stages and store), strips of 16 lanes up to
//   n2 = 256, 8 at 512 and 4 at 1024, and is held to 80 registers so that
//   three blocks share an SM.  What bounds it on the card is its
//   instructions, not shared-memory banks: the four k-lanes of a fragment
//   read points n2/16 rows apart in one lane, one bank (4 wavefronts a
//   half-warp), yet a layout that spreads them over four banks measured
//   slower on an H100 (PERF.md, the K10a ablations).
//
// K10c palt_lane_dft replaces `_lane_kernel` (:317, `_lane_dft`
//   pallas_fft.py:619) and the twiddle / whitening / layout glue of
//   `_fwd_*_kernel` and `_chain_*_kernel` (:198-314): the 128-point DFT
//   along the contiguous axis of kLaneRows rows a block by `block_fft` in
//   shared memory (one radix-8 and one radix-16 stage in float32, rows at
//   the odd stride kLaneLd so that a half-warp's 16 rows fall in 16
//   banks).  Optional prologues (the long twiddle W_N^{p t}; the
//   PHAT-whitened cross spectrum of two spectra) are applied as the rows
//   are loaded with 16-byte loads, and optional epilogues (the conjugate
//   twiddle after a conjugate DFT; the full forward written in natural bin
//   order s*n2 + t, each s a run of kLaneRows consecutive t through shared
//   memory) as they are stored.  Bound: the plane's read and write (16
//   bytes a point, 24 with the whitening, 32 with a twiddle); ~15 float32
//   flops a point a stage.
//
// The rep chains (`rep` > 1) scale by 1e-3 between transforms, as the TPU
// bodies do (:173-176), but chain in natural order.

namespace {

constexpr int kLanes = 128;             // lane width of every plane
constexpr int kLaneRows = 32;           // rows one lane-DFT block holds
constexpr int kLaneLd = kLanes + 1;     // their stride in float2 (odd)
constexpr int kRowMmaThreads = 256;     // K10a's largest block
constexpr int kRowMmaBlocks = 3;        // K10a's blocks an SM
constexpr uint32_t kSignBit = 0x80000000u;

// cos(2*pi*e/16), e < 16: W16^e = (kCos16[e], -kCos16[(e + 12) & 15]).
__constant__ float kCos16[16] = {
    1.0f, 0.92387953251128674f, 0.70710678118654752f,
    0.38268343236508977f, 0.0f, -0.38268343236508977f,
    -0.70710678118654752f, -0.92387953251128674f, -1.0f,
    -0.92387953251128674f, -0.70710678118654752f, -0.38268343236508977f,
    0.0f, 0.38268343236508977f, 0.70710678118654752f,
    0.92387953251128674f};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo carries the next 11 bits of the mantissa).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: c += a * b with the lo * lo term dropped, small terms first.
// kTerms < 3 drops hi * lo, the data's low part (2: the data in TF32), or
// both cross terms (1, plain TF32): the precision controls that the card
// checks must see fail.
template <int kTerms>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (kTerms > 2) mma_tf32(c, ah, bl);
  if (kTerms > 1) mma_tf32(c, al, bh);
  mma_tf32(c, ah, bh);
}

// A complex m16 x k8 operand, split.
struct AFrag {
  uint32_t rh[4], rl[4], ih[4], il[4];
};

__device__ __forceinline__ void make_afrag(const float (&re)[4],
                                           const float (&im)[4], AFrag& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(re[j], a.rh[j], a.rl[j]);
    split_tf32(im[j], a.ih[j], a.il[j]);
  }
}

// (cr, ci) += A * B for a complex A fragment and a complex k8 x n8 B
// fragment given by its two values of each part; -Im(B) is Im(B)'s split
// with the signs flipped (exact).
template <int kTerms>
__device__ __forceinline__ void cmma(float (&cr)[4], float (&ci)[4],
                                     const AFrag& a, const float (&br)[2],
                                     const float (&bi)[2]) {
  uint32_t brh[2], brl[2], bih[2], bil[2], nih[2], nil[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split_tf32(br[j], brh[j], brl[j]);
    split_tf32(bi[j], bih[j], bil[j]);
    nih[j] = bih[j] ^ kSignBit;
    nil[j] = bil[j] ^ kSignBit;
  }
  mma3<kTerms>(cr, a.rh, a.rl, brh, brl);
  mma3<kTerms>(cr, a.ih, a.il, nih, nil);
  mma3<kTerms>(ci, a.rh, a.rl, bih, bil);
  mma3<kTerms>(ci, a.ih, a.il, brh, brl);
}

// This thread's fragments of W16 (sgn < 0: its conjugate) as the A operand
// of a DFT-16, one per k8 half: w[ks] holds rows gid, gid + 8 and columns
// 8 ks + tig, 8 ks + tig + 4 (m16n8k8's A layout; gid = lane / 4, tig =
// lane % 4), W16[m, k] = W16^{m k mod 16}.
__device__ __forceinline__ void make_w16(AFrag (&w)[2], float sgn) {
  const int gid = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    float re[4], im[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = ((gid + 8 * (j & 1)) * (8 * ks + tig + 4 * (j >> 1))) & 15;
      re[j] = kCos16[e];
      im[j] = -sgn * kCos16[(e + 12) & 15];
    }
    make_afrag(re, im, w[ks]);
  }
}

// K10a's radix-16 stage: stockham_stage<S, 16>'s index maps and twiddles,
// its DFT-16 a W16 product on the tensor cores.  Warp w takes butterflies
// 32w .. 32w + 31 (sequence fastest, as stockham_stage), four n8 tiles of
// 8; in a tile, thread (gid, tig) loads inputs m = tig + 4c, c < 4 (B rows
// tig and tig + 4 of both k8 halves) of butterfly gid, and holds outputs
// m = gid and gid + 8 of butterflies 2 tig and 2 tig + 1 (the
// accumulator's rows and columns), neighbouring sequences of one i in the
// strips' layout (ss = 1, S even), written as one 16-byte store.
template <int S, int kTerms>
struct MmaRadix16 {
  AFrag w[2];

  __device__ __forceinline__ void operator()(float2* x, int js, int ss,
                                             int L, int p, const float2* stw,
                                             float sgn) const {
    constexpr int kTiles = palt::kElems / 4;
    const int q = L >> 4;
    const int half = L >> 1;
    const int tstep = L / (p * 16);  // W_{16p}^{mk} = W_L^{mk * tstep}
    const int gid = (threadIdx.x & 31) >> 2;
    const int tig = threadIdx.x & 3;
    const int task0 = (threadIdx.x >> 5) * 8 * kTiles;
    const bool live = task0 < q * S;  // the same for the whole warp
    float acc[kTiles][2][4];
    if (live) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int task = task0 + 8 * j + gid;
        const int s = task % S;
        const int i = task / S;
        const int k = i & (p - 1);
        const float2* xs = x + s * ss;
        float br[2][2], bi[2][2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = tig + 4 * c;
          float2 v = xs[(i + m * q) * js];
          if (p > 1)
            v = palt::cmul(v, palt::sub_twiddle(stw, m * k * tstep, half, sgn));
          br[c >> 1][c & 1] = v.x;
          bi[c >> 1][c & 1] = v.y;
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[j][0][h] = acc[j][1][h] = 0.0f;
        cmma<kTerms>(acc[j][0], acc[j][1], w[0], br[0], bi[0]);
        cmma<kTerms>(acc[j][0], acc[j][1], w[1], br[1], bi[1]);
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const int task = task0 + 8 * j + 2 * tig;
        const int s = task % S;
        const int i = task / S;
        const int k = i & (p - 1);
        float2* xs = x + s * ss;
        const int base = (i - k) * 16 + k;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(xs + (base + (gid + 8 * h) * p) * js) =
              make_float4(acc[j][0][2 * h], acc[j][1][2 * h],
                          acc[j][0][2 * h + 1], acc[j][1][2 * h + 1]);
      }
    }
    __syncthreads();
  }
};

// Output modes of the row transforms: store the complex result, store its
// real part only, or add its real part to the output (the chain's sum).
enum RowMode { kStoreComplex = 0, kStoreReal = 1, kAddReal = 2 };

// K10a's and K10b's body: the whole length-n2 transform of a strip of S
// lanes in one block (block_fft over the strip, lanes as its sequences,
// `stage16` its radix-16 stages).  Grid (128 / S strips, planes).  Rows >=
// rows_in read as zero (zero_top); xi may be null (real input); the input
// is scaled on load.  In and out may be the same planes (each block reads
// its whole strip before it writes).
template <int S, class Stage16>
__device__ __forceinline__ void row_strip(const float* xr, const float* xi,
                                          int n2, int rows_in, float scale,
                                          float sgn,
                                          const float2* __restrict__ tw,
                                          float* out_r, float* out_i,
                                          int mode, const Stage16& stage16) {
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n2 >> 1);
  const int lane0 = blockIdx.x * S;
  const size_t plane = blockIdx.y;
  const size_t in_off = plane * (size_t)rows_in * kLanes + lane0;
  const float* pr = xr + in_off;
  const float* pi = xi ? xi + in_off : nullptr;
  palt::stage_twiddles(stw, tw, n2, 1);
  // Every load of the thread in flight before the first store.
  const int total = n2 * S;
  float2 v[palt::kElems];
#pragma unroll
  for (int u = 0; u < palt::kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const int j = idx / S;
    const size_t off = (size_t)j * kLanes + idx % S;
    v[u] = make_float2(0.0f, 0.0f);
    if (idx < total && j < rows_in)
      v[u] = make_float2(pr[off] * scale, pi ? pi[off] * scale : 0.0f);
  }
#pragma unroll
  for (int u = 0; u < palt::kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[idx] = v[u];
  }
  palt::block_fft<S>(buf, S, 1, n2, stw, sgn, stage16);
  const size_t out_off = plane * (size_t)n2 * kLanes + lane0;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t o = out_off + (size_t)(idx / S) * kLanes + idx % S;
    const float2 y = buf[idx];
    if (mode == kAddReal) {
      out_r[o] += y.x;
    } else {
      out_r[o] = y.x;
      if (mode == kStoreComplex) out_i[o] = y.y;
    }
  }
}

// K10b: block_fft's float32 stages over strips of kStrip lanes.
__global__ void __launch_bounds__(1024)
row_fft_kernel(const float* xr, const float* xi, int n2, int rows_in,
               float scale, int inverse, const float2* __restrict__ tw,
               float* out_r, float* out_i, int mode) {
  row_strip<palt::kStrip>(xr, xi, n2, rows_in, scale, inverse ? -1.0f : 1.0f,
                          tw, out_r, out_i, mode,
                          palt::Radix16<palt::kStrip>());
}

// K10a: the same strips (S lanes) with the radix-16 stages on the tensor
// cores, kTerms TF32 products a real product.
template <int S, int kTerms>
__global__ void __launch_bounds__(kRowMmaThreads, kRowMmaBlocks)
row_dft_kernel(const float* xr, const float* xi, int n2, int rows_in,
               float scale, int inverse, const float2* __restrict__ tw,
               float* out_r, float* out_i, int mode) {
  const float sgn = inverse ? -1.0f : 1.0f;
  MmaRadix16<S, kTerms> stage;
  make_w16(stage.w, sgn);
  row_strip<S>(xr, xi, n2, rows_in, scale, sgn, tw, out_r, out_i, mode,
               stage);
}

using RowKernel = void (*)(const float*, const float*, int, int, float, int,
                           const float2*, float*, float*, int);

// `rep` chained launches of a row kernel over strips of `strip` lanes; the
// transforms between the first and the last run in place in s0.
int row_launches(RowKernel kernel, int strip, const float* xr,
                 const float* xi, int planes, int n2, int rows_in,
                 int inverse, int rep, float scale, const float2* tw,
                 float* s0r, float* s0i, float* out_r, float* out_i,
                 int mode, cudaStream_t s) {
  const int smem = (n2 / 2 + n2 * strip) * (int)sizeof(float2);
  const float* src_r = xr;
  const float* src_i = xi;
  int rows = rows_in;
  for (int it = 0; it < rep; ++it) {
    const bool last = it == rep - 1;
    float* dr = last ? out_r : s0r;
    float* di = last ? out_i : s0i;
    kernel<<<dim3(kLanes / strip, planes), palt::fft_threads(n2, strip),
             smem, s>>>(src_r, src_i, n2, rows, it ? 1e-3f : scale, inverse,
                        tw, dr, di, last ? mode : kStoreComplex);
    PALT_CHECK();
    src_r = dr;
    src_i = di;
    rows = n2;
  }
  return 0;
}

// K10a's kernel for a strip of S lanes and a precision, with its shared
// memory allowed; null if the allowance fails.
template <int S, int kTerms>
RowKernel row_dft_ready() {
  return palt::allow_smem<row_dft_kernel<S, kTerms>>() == cudaSuccess
             ? row_dft_kernel<S, kTerms>
             : nullptr;
}

// K10a's strip: 16 lanes up to n2 = 256, 8 at 512, 4 at 1024 (at most
// kRowMmaThreads threads a block).
int row_dft_strip(int n2) { return n2 <= 256 ? 16 : 4096 / n2; }

template <int S>
RowKernel row_kernel_at(int terms) {
  return terms == 3 ? row_dft_ready<S, 3>()
       : terms == 2 ? row_dft_ready<S, 2>()
       : terms == 1 ? row_dft_ready<S, 1>() : nullptr;
}

// The product's precision: 3 terms (3xTF32, the kernel's design), 2 or 1
// (the controls); anything else is refused.
RowKernel row_kernel_for(int terms, int strip) {
  return strip == 16 ? row_kernel_at<16>(terms)
       : strip == 8  ? row_kernel_at<8>(terms)
                     : row_kernel_at<4>(terms);
}

// K10c.  Grid (n2 / kLaneRows row tiles, planes); fft_threads(128,
// kLaneRows) threads.  Prologue (into shared memory): v = a, or the
// whitened a * conj(b) when b is given; times tw[t, c] when forward with a
// twiddle.  block_fft (conj: the conjugate DFT, unscaled).  Epilogue:
// times conj(tw[t, s]) when conjugate with a twiddle; written as planes,
// or to out_nat[s*n2 + t] (complex).
__global__ void __launch_bounds__(kLaneRows * kLanes / palt::kElems)
lane_dft_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                const float* __restrict__ br, const float* __restrict__ bi,
                int n2, float eps, int conj, const float* __restrict__ twr,
                const float* __restrict__ twi,
                const float2* __restrict__ tw128, float* __restrict__ out_r,
                float* __restrict__ out_i, float2* __restrict__ out_nat) {
  constexpr int kQuads = kLaneRows * kLanes / 4;  // 32 float4 a row
  float2* stw = palt::fft_shared();
  float2* buf = stw + kLanes / 2;
  palt::stage_twiddles(stw, tw128, kLanes, 1);
  const size_t plane = blockIdx.y;
  const int t0 = blockIdx.x * kLaneRows;
  const size_t base = (plane * n2 + t0) * kLanes;
  const size_t tw_base = (size_t)t0 * kLanes;
  const bool untwiddle = twr && conj;
  for (int idx = threadIdx.x; idx < kQuads; idx += blockDim.x) {
    const int r = idx >> 5;
    const int c = (idx & 31) * 4;
    const size_t o = (size_t)r * kLanes + c;
    const float4 xr4 = *reinterpret_cast<const float4*>(ar + base + o);
    const float4 xi4 = *reinterpret_cast<const float4*>(ai + base + o);
    float vr[4] = {xr4.x, xr4.y, xr4.z, xr4.w};
    float vi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
    if (br) {  // PHAT-whitened cross spectrum (mxu_rowdft_bench.py:275-279)
      const float4 ur4 = *reinterpret_cast<const float4*>(br + base + o);
      const float4 ui4 = *reinterpret_cast<const float4*>(bi + base + o);
      const float ur[4] = {ur4.x, ur4.y, ur4.z, ur4.w};
      const float ui[4] = {ui4.x, ui4.y, ui4.z, ui4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float rr = vr[e] * ur[e] + vi[e] * ui[e];
        const float ri = vi[e] * ur[e] - vr[e] * ui[e];
        const float mag = sqrtf(rr * rr + ri * ri) + eps;
        vr[e] = rr / mag;
        vi[e] = ri / mag;
      }
    }
    if (twr && !conj) {
      const float4 wr4 = *reinterpret_cast<const float4*>(twr + tw_base + o);
      const float4 wi4 = *reinterpret_cast<const float4*>(twi + tw_base + o);
      const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
      const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float tr = vr[e] * wr[e] - vi[e] * wi[e];
        vi[e] = vr[e] * wi[e] + vi[e] * wr[e];
        vr[e] = tr;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      buf[r * kLaneLd + c + e] = make_float2(vr[e], vi[e]);
  }
  palt::block_fft<kLaneRows>(buf, 1, kLaneLd, kLanes, stw,
                             conj ? -1.0f : 1.0f);
  if (out_nat) {
    // Bin s*n2 + t: each s a run of kLaneRows consecutive t.
    float2* row = out_nat + plane * (size_t)n2 * kLanes + t0;
    for (int idx = threadIdx.x; idx < kLaneRows * kLanes;
         idx += blockDim.x) {
      const int r = idx % kLaneRows;
      const int s = idx / kLaneRows;
      float2 z = buf[r * kLaneLd + s];
      if (untwiddle) {
        const size_t o = tw_base + (size_t)r * kLanes + s;
        z = palt::cmul(z, make_float2(twr[o], -twi[o]));
      }
      row[(size_t)s * n2 + r] = z;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kQuads; idx += blockDim.x) {
    const int r = idx >> 5;
    const int c = (idx & 31) * 4;
    const size_t o = (size_t)r * kLanes + c;
    float zr[4], zi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 z = buf[r * kLaneLd + c + e];
      zr[e] = z.x;
      zi[e] = z.y;
    }
    if (untwiddle) {
      const float4 wr4 = *reinterpret_cast<const float4*>(twr + tw_base + o);
      const float4 wi4 = *reinterpret_cast<const float4*>(twi + tw_base + o);
      const float wr[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
      const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float er = zr[e] * wr[e] + zi[e] * wi[e];
        zi[e] = zi[e] * wr[e] - zr[e] * wi[e];
        zr[e] = er;
      }
    }
    *reinterpret_cast<float4*>(out_r + base + o) =
        make_float4(zr[0], zr[1], zr[2], zr[3]);
    *reinterpret_cast<float4*>(out_i + base + o) =
        make_float4(zi[0], zi[1], zi[2], zi[3]);
  }
}

}  // namespace

extern "C" {

// K10a: x (planes, rows_in, 128) (xi may be NULL: real) -> the length-n2
// DFT along the rows, forward or unscaled inverse, natural order, chained
// `rep` times (x1e-3 between); the first transform scales its input by
// `scale` and reads only the lower n2/2 rows when rows_in = n2/2
// (zero_top).  tw is the (n2/2, 2) table exp(-2*pi*i*m/n2).  s0r/s0i are
// (planes, n2, 128) scratch planes for rep > 1.  mode: 0 complex out, 1
// real part out, 2 real part added to out_r.  terms: 3 (3xTF32), or 2 / 1
// for the precision controls.
int palt_row_dft(const float* xr, const float* xi, int planes, int n2,
                 int rows_in, int inverse, int rep, float scale,
                 const float2* tw, float* s0r, float* s0i, float* out_r,
                 float* out_i, int mode, int terms, void* stream) {
  const int strip = row_dft_strip(n2);
  const RowKernel kernel = row_kernel_for(terms, strip);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return row_launches(kernel, strip, xr, xi, planes, n2, rows_in, inverse,
                      rep, scale, tw, s0r, s0i, out_r, out_i, mode,
                      (cudaStream_t)stream);
}

// K10b: the same function as palt_row_dft, by float32 stages.
int palt_row_stages(const float* xr, const float* xi, int planes, int n2,
                    int rows_in, int inverse, int rep, float scale,
                    const float2* tw, float* s0r, float* s0i, float* out_r,
                    float* out_i, int mode, void* stream) {
  const cudaError_t err = palt::allow_smem<row_fft_kernel>();
  if (err != cudaSuccess) return (int)err;
  return row_launches(row_fft_kernel, palt::kStrip, xr, xi, planes, n2,
                      rows_in, inverse, rep, scale, tw, s0r, s0i, out_r,
                      out_i, mode, (cudaStream_t)stream);
}

// K10c: a (planes, n2, 128) complex planes -> the 128-point DFT along the
// lanes (conj: the conjugate DFT, unscaled).  b (NULL for none): a is
// first replaced by the whitened a * conj(b).  tw (NULL for none): the
// (n2, 128) long twiddle, applied before a forward DFT and conjugated after
// a conjugate one.  tw128 is the (64, 2) table exp(-2*pi*i*m/128).  Output
// planes out_r/out_i, or, when out_nat is not NULL, the (planes, n2 * 128)
// complex row in natural bin order s * n2 + t.  The planes are read and
// written 16 bytes at a time: their pointers are 16-byte aligned.
int palt_lane_dft(const float* ar, const float* ai, const float* br,
                  const float* bi, int planes, int n2, float eps, int conj,
                  const float* twr, const float* twi, const float2* tw128,
                  float* out_r, float* out_i, float2* out_nat, void* stream) {
  const size_t smem = (kLanes / 2 + kLaneRows * kLaneLd) * sizeof(float2);
  lane_dft_kernel<<<dim3(n2 / kLaneRows, planes),
                    palt::fft_threads(kLanes, kLaneRows), smem,
                    (cudaStream_t)stream>>>(ar, ai, br, bi, n2, eps, conj,
                                            twr, twi, tw128, out_r, out_i,
                                            out_nat);
  PALT_CHECK();
  return 0;
}

}  // extern "C"
