// K10: the four-step row DFT of (B, n2, 128) float32 planes on the tensor
// cores, the butterfly stages it is measured against, and the 128-point
// lane DFT (sm_90a).  Included from kernels.cu (after its helpers); bound by
// ops/rowdft.py.
//
// A length-N row (N = n2 * 128) is held as a plane x2d[q, p] = x[q*128 + p]
// (the TPU package's layout, pallas_fft.py:57-59).  Every plane here is a
// pair of float32 arrays (re, im), rows in natural order; G = n2 / 8.
//
// K10a palt_row_dft replaces `_rowdft_kernel` / `_rowinv_kernel`
//   (tools/mxu_rowdft_bench.py:181,192, bodies `_rowdft_mxu` :101 and
//   `_rowinv_mxu` :135, launched by `_call` :328).  Length-n2 DFT along the
//   rows of each lane: with q = b*G + g and t = 8*m + p,
//     X[8m + p] = sum_g W'_p[m, g] * sum_b W8^{b p} x[b*G + g],
//     W'_p[m, g] = W_G^{g m} * w^{g p},  w = exp(-2 pi i / n2),
//   i.e. a DFT-8 over the leading digit b (registers), then one complex
//   (G x G) x (G x 32-lane) product per digit p on the tensor cores
//   (mma.sync m16n8k8 TF32, 3xTF32: a = a_hi + a_lo with each part rounded
//   by cvt.rna, accumulating lo*hi + hi*lo + hi*hi in float32, the
//   counterpart of the TPU's Precision.HIGHEST; TF32 alone keeps ~3
//   digits).  Output row 8m + p is written to its natural slot.  The
//   unscaled inverse (rowinv(rowdft(x)) = n2 * x) is the same schedule with
//   every twiddle conjugated, which is the TPU body's function (conjugate
//   matrices, inverse DFT-8) in natural order.
//   Bound on an H100: one read and one write of the plane (16 bytes a
//   point); 12 tensor-core MMAs per complex product tile.  What the card
//   showed bounds this design is operand traffic through L2 and shared
//   memory: each block (one plane, 32 lanes) makes two digits' DFT-8
//   outputs per read of the eight input rows (four reads in all), stages
//   them in shared memory, and reads W'_p[m, g] = w^{g (8m + p) mod n2}
//   from an n2-entry table in shared memory instead of the (8, G, G)
//   matrices from L2.  G = 8 (n2 = 64) pads M to one 16-row tile.
//
// K10b palt_row_stages replaces `_stages_kernel` (:170, `_dif_stages`
//   pallas_fft.py:336): the same row DFT by butterfly stages, all of them
//   on chip: one block loads a strip of n2 rows x kStrip lanes (each row's
//   kStrip lanes contiguous), runs fft.cuh's `block_fft` (radix-16
//   Stockham stages in registers, shared-memory exchanges between them)
//   and writes the strip in natural order, one launch per transform.
//   Bound: one read and one write of the plane (16 bytes a point), as
//   K10a.
//
// K10c palt_lane_dft replaces `_lane_kernel` (:317, `_lane_dft`
//   pallas_fft.py:619) and the twiddle / whitening / layout glue of
//   `_fwd_*_kernel` and `_chain_*_kernel` (:198-314): the 128-point DFT
//   along the contiguous axis as a complex (32 rows x 128) x (128 x 128)
//   product on the tensor cores (3xTF32), with optional prologues (the long
//   twiddle W_N^{p t}; the PHAT-whitened cross spectrum of two spectra) and
//   epilogues (the conjugate twiddle after a conjugate DFT; the full
//   forward written in natural bin order s*n2 + t).  Bound: the plane's
//   read and write; the 128 x 128 matrix is read through a 128-entry table
//   in shared memory (W1[p, s] = W128^{p s mod 128}).
//
// The rep chains (`rep` > 1) scale by 1e-3 between transforms, as the TPU
// bodies do (:173-176), but chain in natural order.

namespace {

constexpr int kLanes = 128;            // lane width of every plane
constexpr int kRowTile = 32;           // lanes one row-DFT block covers
constexpr int kRowLd = kRowTile + 8;   // smem stride: conflict-free B loads
constexpr int kLaneRows = 32;          // rows one lane-DFT block covers
constexpr int kLaneLd = kLanes + 4;    // smem stride: conflict-free A loads
constexpr int kLaneThreads = 256;      // 8 warps: 2 row tiles x 4 col groups
constexpr uint32_t kSignBit = 0x80000000u;

// exp(-2*pi*i*e/8), e = 0..7 (pallas_fft.py:243 `_W8`).
__constant__ float kW8r[8] = {1.0f, 0.70710678118654752f, 0.0f,
                              -0.70710678118654752f, -1.0f,
                              -0.70710678118654752f, 0.0f,
                              0.70710678118654752f};
__constant__ float kW8i[8] = {0.0f, -0.70710678118654752f, -1.0f,
                              -0.70710678118654752f, 0.0f,
                              0.70710678118654752f, 1.0f,
                              0.70710678118654752f};

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
// kTerms < 3 drops lo * hi (2) or both cross terms (1, plain TF32): the
// precision controls that the card checks must see fail.
template <int kTerms>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (kTerms > 2) mma_tf32(c, al, bh);
  if (kTerms > 1) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// A complex m16 x k8 operand, split, with its imaginary part also negated
// (sign flips of TF32 values are exact).
struct AFrag {
  uint32_t rh[4], rl[4], ih[4], il[4], nih[4], nil[4];
};

__device__ __forceinline__ void make_afrag(const float (&re)[4],
                                           const float (&im)[4], AFrag& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(re[j], a.rh[j], a.rl[j]);
    split_tf32(im[j], a.ih[j], a.il[j]);
    a.nih[j] = a.ih[j] ^ kSignBit;
    a.nil[j] = a.il[j] ^ kSignBit;
  }
}

// (cr, ci) += A * B for a complex A fragment and a complex k8 x n8 B
// fragment given by its two values of each part.
template <int kTerms>
__device__ __forceinline__ void cmma(float (&cr)[4], float (&ci)[4],
                                     const AFrag& a, const float (&br)[2],
                                     const float (&bi)[2]) {
  uint32_t brh[2], brl[2], bih[2], bil[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split_tf32(br[j], brh[j], brl[j]);
    split_tf32(bi[j], bih[j], bil[j]);
  }
  mma3<kTerms>(cr, a.rh, a.rl, brh, brl);
  mma3<kTerms>(cr, a.nih, a.nil, bih, bil);
  mma3<kTerms>(ci, a.rh, a.rl, bih, bil);
  mma3<kTerms>(ci, a.ih, a.il, brh, brl);
}

// Output modes of the row transforms: store the complex result, store its
// real part only, or add its real part to the output (the chain's sum).
enum RowMode { kStoreComplex = 0, kStoreReal = 1, kAddReal = 2 };

__device__ __forceinline__ void row_store(float* out_r, float* out_i,
                                          size_t off, float2 re, float2 im,
                                          int mode) {
  float2* r2 = reinterpret_cast<float2*>(out_r + off);
  if (mode == kAddReal) {
    const float2 old = *r2;
    *r2 = make_float2(old.x + re.x, old.y + re.y);
    return;
  }
  *r2 = re;
  if (mode == kStoreComplex) *reinterpret_cast<float2*>(out_i + off) = im;
}

// K10a.  Grid (128 / 32 lane tiles, planes); max(1, G/16) warps, warp w
// owning rows m = 16w..16w+15 of every digit's product and the block's 32
// lanes (4 n8 tiles).  Input rows: rows_in (n2, or n2/2 with zero_top:
// nb = 4 leading slices), scaled by `scale` on load; xi may be null (real).
// The fused matrices are read through the table tab[e] = w^e, e < n2
// (W'_p[m, g] = w^{g (8m + p) mod n2}), staged in shared memory with two
// digit planes: one pass over the eight input rows makes the DFT-8 outputs
// of digits p and p + 4 (the even- and odd-b sums, added and subtracted).
template <int kTerms>
__global__ void row_dft_kernel(const float* __restrict__ xr,
                               const float* __restrict__ xi, int n2,
                               int rows_in, int nb, float scale, int inverse,
                               const float2* __restrict__ tab,
                               float* __restrict__ out_r,
                               float* __restrict__ out_i, int mode) {
  extern __shared__ float smem[];
  const int g_len = n2 >> 3;
  const int plane_words = g_len * kRowLd;
  float2* stab = reinterpret_cast<float2*>(smem);
  float* dig = smem + 2 * n2;  // [digit p, p + 4][re, im][g * kRowLd + l]
  const int lane0 = blockIdx.x * kRowTile;
  const size_t plane = blockIdx.y;
  const size_t in_off = plane * (size_t)rows_in * kLanes + lane0;
  const float* pxr = xr + in_off;
  const float* pxi = xi ? xi + in_off : nullptr;
  const float sgn = inverse ? -1.0f : 1.0f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int m_a = warp * 16 + gid;
  const int m_b = m_a + 8;
  for (int e = threadIdx.x; e < n2; e += blockDim.x) {
    float2 w = tab[e];
    w.y *= sgn;  // the inverse uses conj(W'_p)
    stab[e] = w;
  }
  for (int p0 = 0; p0 < 4; ++p0) {
    __syncthreads();  // the previous digits' products are done with smem
    // A_p[g, l] = sum_b W8^{b p} x[b G + g, l] for p = p0 and p0 + 4:
    // W8^{b (p0 + 4)} = (-1)^b W8^{b p0}.
    for (int idx = threadIdx.x; idx < g_len * kRowTile; idx += blockDim.x) {
      const int g = idx / kRowTile;
      const int l = idx % kRowTile;
      float er = 0.0f, ei = 0.0f, orr = 0.0f, oi = 0.0f;
      for (int b = 0; b < nb; ++b) {
        const size_t off = (size_t)(b * g_len + g) * kLanes + l;
        const float vr = pxr[off];
        const float vi = pxi ? pxi[off] : 0.0f;
        const int e = (b * p0) & 7;
        const float cr = kW8r[e];
        const float ci = sgn * kW8i[e];
        const float tr = cr * vr - ci * vi;
        const float ti = cr * vi + ci * vr;
        if (b & 1) {
          orr += tr;
          oi += ti;
        } else {
          er += tr;
          ei += ti;
        }
      }
      const int o = g * kRowLd + l;
      dig[o] = (er + orr) * scale;
      dig[plane_words + o] = (ei + oi) * scale;
      dig[2 * plane_words + o] = (er - orr) * scale;
      dig[3 * plane_words + o] = (ei - oi) * scale;
    }
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + 4 * half;
      const float* ar = dig + 2 * half * plane_words;
      const float* ai = ar + plane_words;
      float acc[4][2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][0][j] = acc[nt][1][j] = 0.0f;
      for (int k0 = 0; k0 < g_len; k0 += 8) {
        // A = W'_p (row m, column g): a0 (m_a, k), a1 (m_b, k), a2 (m_a,
        // k+4), a3 (m_b, k+4); rows beyond G are the zero padding of G = 8.
        const int rows[4] = {m_a, m_b, m_a, m_b};
        const int cols[4] = {k0 + tig, k0 + tig, k0 + tig + 4, k0 + tig + 4};
        float fr[4], fi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool live = rows[j] < g_len;
          const float2 w = stab[(cols[j] * (8 * rows[j] + p)) & (n2 - 1)];
          fr[j] = live ? w.x : 0.0f;
          fi[j] = live ? w.y : 0.0f;
        }
        AFrag a;
        make_afrag(fr, fi, a);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = nt * 8 + gid;
          const float br[2] = {ar[(k0 + tig) * kRowLd + n],
                               ar[(k0 + tig + 4) * kRowLd + n]};
          const float bi[2] = {ai[(k0 + tig) * kRowLd + n],
                               ai[(k0 + tig + 4) * kRowLd + n]};
          cmma<kTerms>(acc[nt][0], acc[nt][1], a, br, bi);
        }
      }
      // Row m of digit p is bin t = 8m + p.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = h ? m_b : m_a;
        if (m >= g_len) continue;
        const size_t row = (plane * n2 + 8 * m + p) * kLanes + lane0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const size_t off = row + nt * 8 + 2 * tig;
          row_store(out_r, out_i, off,
                    make_float2(acc[nt][0][2 * h], acc[nt][0][2 * h + 1]),
                    make_float2(acc[nt][1][2 * h], acc[nt][1][2 * h + 1]),
                    mode);
        }
      }
    }
  }
}

// K10b: the whole length-n2 transform of a strip of kStrip lanes in one
// block (fft.cuh's block_fft over the strip, lanes as its sequences).
// Grid (128 / kStrip strips, planes).  Rows >= rows_in read as zero
// (zero_top); xi may be null (real input); the input is scaled on load.
// In and out may be the same planes (each block reads its whole strip
// before it writes).
__global__ void __launch_bounds__(1024)
row_fft_kernel(const float* xr, const float* xi, int n2, int rows_in,
               float scale, int inverse, const float2* __restrict__ tw,
               float* out_r, float* out_i, int mode) {
  using palt::kStrip;
  float2* stw = palt::fft_shared();
  float2* buf = stw + (n2 >> 1);
  const int lane0 = blockIdx.x * kStrip;
  const size_t plane = blockIdx.y;
  const size_t in_off = plane * (size_t)rows_in * kLanes + lane0;
  const float* pr = xr + in_off;
  const float* pi = xi ? xi + in_off : nullptr;
  palt::stage_twiddles(stw, tw, n2, 1);
  // Every load of the thread in flight before the first store.
  const int total = n2 * kStrip;
  float2 v[palt::kElems];
#pragma unroll
  for (int u = 0; u < palt::kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    const int j = idx / kStrip;
    const size_t off = (size_t)j * kLanes + idx % kStrip;
    v[u] = make_float2(0.0f, 0.0f);
    if (idx < total && j < rows_in)
      v[u] = make_float2(pr[off] * scale, pi ? pi[off] * scale : 0.0f);
  }
#pragma unroll
  for (int u = 0; u < palt::kElems; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < total) buf[idx] = v[u];
  }
  palt::block_fft<kStrip>(buf, kStrip, 1, n2, stw, inverse ? -1.0f : 1.0f);
  const size_t out_off = plane * (size_t)n2 * kLanes + lane0;
  for (int idx = threadIdx.x; idx < n2 * kStrip; idx += blockDim.x) {
    const size_t o = out_off + (size_t)(idx / kStrip) * kLanes + idx % kStrip;
    const float2 v = buf[idx];
    if (mode == kAddReal) {
      out_r[o] += v.x;
    } else {
      out_r[o] = v.x;
      if (mode == kStoreComplex) out_i[o] = v.y;
    }
  }
}

// K10c.  Grid (n2 / 32 row tiles, planes), 8 warps: warp w owns rows
// 16*(w&1).. of the tile and output columns 32*(w>>1).. (4 n8 tiles).  The
// DFT matrix is read through the table tab128[e] = W128^e in shared
// memory (W1[p, s] = W128^{p s mod 128}).
// Prologue (into smem): v = a, or the whitened a * conj(b) when b is given;
// times tw[t, c] when forward with a twiddle.  Product: Z = V * W1 (or
// conj(W1)).  Epilogue: times conj(tw[t, s]) when conjugate with a
// twiddle; written as planes, or to out_nat[s*n2 + t] (complex).
template <int kTerms>
__global__ void __launch_bounds__(kLaneThreads)
lane_dft_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                const float* __restrict__ br, const float* __restrict__ bi,
                int n2, float eps, int conj, const float* __restrict__ twr,
                const float* __restrict__ twi,
                const float2* __restrict__ tab128,
                float* __restrict__ out_r, float* __restrict__ out_i,
                float2* __restrict__ out_nat) {
  extern __shared__ float smem[];
  float* cr = smem;
  float* ci = smem + kLaneRows * kLaneLd;
  float2* stab = reinterpret_cast<float2*>(smem + 2 * kLaneRows * kLaneLd);
  for (int e = threadIdx.x; e < kLanes; e += blockDim.x) {
    float2 w = tab128[e];
    if (conj) w.y = -w.y;
    stab[e] = w;
  }
  const size_t plane = blockIdx.y;
  const int t0 = blockIdx.x * kLaneRows;
  const size_t base = (plane * n2 + t0) * kLanes;
  const size_t tw_base = (size_t)t0 * kLanes;
  for (int idx = threadIdx.x; idx < kLaneRows * kLanes; idx += blockDim.x) {
    float vr = ar[base + idx];
    float vi = ai[base + idx];
    if (br) {  // PHAT-whitened cross spectrum (mxu_rowdft_bench.py:275-279)
      const float ur = br[base + idx];
      const float ui = bi[base + idx];
      const float rr = vr * ur + vi * ui;
      const float ri = vi * ur - vr * ui;
      const float mag = sqrtf(rr * rr + ri * ri) + eps;
      vr = rr / mag;
      vi = ri / mag;
    }
    if (twr && !conj) {
      const float wr_ = twr[tw_base + idx];
      const float wi_ = twi[tw_base + idx];
      const float tr = vr * wr_ - vi * wi_;
      vi = vr * wi_ + vi * wr_;
      vr = tr;
    }
    const int r = idx >> 7;
    const int c = idx & (kLanes - 1);
    cr[r * kLaneLd + c] = vr;
    ci[r * kLaneLd + c] = vi;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r_a = (warp & 1) * 16 + gid;
  const int r_b = r_a + 8;
  const int n_base = (warp >> 1) * 32;
  float acc[4][2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][0][j] = acc[nt][1][j] = 0.0f;
  for (int k0 = 0; k0 < kLanes; k0 += 8) {
    const int ka = k0 + tig;
    const float fr[4] = {cr[r_a * kLaneLd + ka], cr[r_b * kLaneLd + ka],
                         cr[r_a * kLaneLd + ka + 4],
                         cr[r_b * kLaneLd + ka + 4]};
    const float fi[4] = {ci[r_a * kLaneLd + ka], ci[r_b * kLaneLd + ka],
                         ci[r_a * kLaneLd + ka + 4],
                         ci[r_b * kLaneLd + ka + 4]};
    AFrag a;
    make_afrag(fr, fi, a);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n_base + nt * 8 + gid;
      // W1[k, n] = W128^{k n mod 128}
      const float2 w0 = stab[(ka * n) & (kLanes - 1)];
      const float2 w1 = stab[((ka + 4) * n) & (kLanes - 1)];
      const float wbr[2] = {w0.x, w1.x};
      const float wbi[2] = {w0.y, w1.y};
      cmma<kTerms>(acc[nt][0], acc[nt][1], a, wbr, wbi);
    }
  }
  const size_t big_n = (size_t)n2 * kLanes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + (h ? r_b : r_a);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int s = n_base + nt * 8 + 2 * tig;
      float zr[2] = {acc[nt][0][2 * h], acc[nt][0][2 * h + 1]};
      float zi[2] = {acc[nt][1][2 * h], acc[nt][1][2 * h + 1]};
      if (twr && conj) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const size_t o = (size_t)t * kLanes + s + j;
          const float wr_ = twr[o];
          const float wi_ = twi[o];
          const float er = zr[j] * wr_ + zi[j] * wi_;
          zi[j] = zi[j] * wr_ - zr[j] * wi_;
          zr[j] = er;
        }
      }
      if (out_nat) {
        float2* row = out_nat + plane * big_n;
        row[(size_t)s * n2 + t] = make_float2(zr[0], zi[0]);
        row[(size_t)(s + 1) * n2 + t] = make_float2(zr[1], zi[1]);
      } else {
        const size_t o = (plane * n2 + t) * kLanes + s;
        *reinterpret_cast<float2*>(out_r + o) = make_float2(zr[0], zr[1]);
        *reinterpret_cast<float2*>(out_i + o) = make_float2(zi[0], zi[1]);
      }
    }
  }
}

using RowKernel = void (*)(const float*, const float*, int, int, int, float,
                           int, const float2*, float*, float*, int);
using LaneKernel = void (*)(const float*, const float*, const float*,
                            const float*, int, float, int, const float*,
                            const float*, const float2*, float*, float*,
                            float2*);

// The product's precision: 3 terms (3xTF32, the kernels' design), 2 or 1
// (the controls); anything else is refused.
RowKernel row_kernel_for(int terms) {
  return terms == 3 ? row_dft_kernel<3>
       : terms == 2 ? row_dft_kernel<2>
       : terms == 1 ? row_dft_kernel<1> : nullptr;
}

LaneKernel lane_kernel_for(int terms) {
  return terms == 3 ? lane_dft_kernel<3>
       : terms == 2 ? lane_dft_kernel<2>
       : terms == 1 ? lane_dft_kernel<1> : nullptr;
}

}  // namespace

extern "C" {

// K10a: x (planes, rows_in, 128) (xi may be NULL: real) -> the length-n2
// DFT along the rows, forward or unscaled inverse, natural order, chained
// `rep` times (x1e-3 between); the first transform scales its input by
// `scale` and reads only the lower n2/2 rows when rows_in = n2/2
// (zero_top).  s0/s1 are (planes, n2, 128) scratch planes for rep > 1.
// mode: 0 complex out, 1 real part out, 2 real part added to out_r.
// terms: 3 (3xTF32), or 2 / 1 for the precision controls.
int palt_row_dft(const float* xr, const float* xi, int planes, int n2,
                 int rows_in, int inverse, int rep, float scale,
                 const float2* tab, float* s0r, float* s0i, float* s1r,
                 float* s1i, float* out_r, float* out_i, int mode, int terms,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const RowKernel kernel = row_kernel_for(terms);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int g_len = n2 >> 3;
  const int threads = 32 * (g_len >= 16 ? g_len / 16 : 1);
  const int smem = (2 * n2 + 4 * g_len * kRowLd) * (int)sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  PALT_CHECK();
  float* sr[2] = {s0r, s1r};
  float* si[2] = {s0i, s1i};
  const float* src_r = xr;
  const float* src_i = xi;
  int rows = rows_in;
  for (int it = 0; it < rep; ++it) {
    const bool last = it == rep - 1;
    float* dr = last ? out_r : sr[it & 1];
    float* di = last ? out_i : si[it & 1];
    kernel<<<dim3(kLanes / kRowTile, planes), threads, smem, s>>>(
        src_r, src_i, n2, rows, rows < n2 ? 4 : 8, it ? 1e-3f : scale,
        inverse, tab, dr, di, last ? mode : kStoreComplex);
    PALT_CHECK();
    src_r = dr;
    src_i = di;
    rows = n2;
  }
  return 0;
}

// K10b: the same function as palt_row_dft, one launch per transform (the
// on-chip sub-transform of fft.cuh); tw is the (n2/2, 2) table
// exp(-2*pi*i*m/n2).  s0r/s0i are (planes, n2, 128) scratch planes for
// rep > 1 (the transforms between the first and the last run in place).
int palt_row_stages(const float* xr, const float* xi, int planes, int n2,
                    int rows_in, int inverse, int rep, float scale,
                    const float2* tw, float* s0r, float* s0i, float* out_r,
                    float* out_i, int mode, void* stream) {
  using palt::kStrip;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = (n2 / 2 + n2 * kStrip) * (int)sizeof(float2);
  const cudaError_t err = palt::allow_smem<row_fft_kernel>();
  if (err != cudaSuccess) return (int)err;
  const float* src_r = xr;
  const float* src_i = xi;
  int rows = rows_in;
  for (int it = 0; it < rep; ++it) {
    const bool last = it == rep - 1;
    float* dr = last ? out_r : s0r;
    float* di = last ? out_i : s0i;
    row_fft_kernel<<<dim3(kLanes / kStrip, planes),
                     palt::fft_threads(n2, kStrip), smem, s>>>(
        src_r, src_i, n2, rows, it ? 1e-3f : scale, inverse, tw, dr, di,
        last ? mode : kStoreComplex);
    PALT_CHECK();
    src_r = dr;
    src_i = di;
    rows = n2;
  }
  return 0;
}

// K10c: a (planes, n2, 128) complex planes -> the
// 128-point DFT along the lanes (conj: with conj(W1), unscaled).  b (NULL
// for none): a is first replaced by the whitened a * conj(b).  tw (NULL
// for none): the (n2, 128) long twiddle, applied before a forward DFT and
// conjugated after a conjugate one.  Output planes out_r/out_i, or, when
// out_nat is not NULL, the (planes, n2 * 128) complex row in natural bin
// order s * n2 + t.  terms as palt_row_dft's.
int palt_lane_dft(const float* ar, const float* ai, const float* br,
                  const float* bi, int planes, int n2, float eps, int conj,
                  const float* twr, const float* twi, const float2* tab128,
                  float* out_r, float* out_i, float2* out_nat, int terms,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const LaneKernel kernel = lane_kernel_for(terms);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (2 * (size_t)kLaneRows * kLaneLd + 2 * kLanes) * sizeof(float);
  kernel<<<dim3(n2 / kLaneRows, planes), kLaneThreads, smem, s>>>(
      ar, ai, br, bi, n2, eps, conj, twr, twi, tab128, out_r, out_i,
      out_nat);
  PALT_CHECK();
  return 0;
}

}  // extern "C"
