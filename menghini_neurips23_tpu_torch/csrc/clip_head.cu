// K3: the fused CLIP head, softmax(scale * normalize(img) . normalize(txt)^T).
//
// Replaces: menghini_neurips23_tpu/ops/clip_head.py `_head_kernel` (reached
// through `_fused_probs_pallas` and `fused_probs`), the Pallas kernel of the
// JAX package.  It turns image and class-prompt features into the zero-shot
// class probabilities that the FPL pseudolabels are picked from.
//
// What it computes, for image rows (B, E) and class rows (C, E) of one float
// type, with fp32 output (B, C):
//   logits = (img . txt^T) * rsqrt(sum(img^2)) * rsqrt(sum(txt^2)) * scale
//   probs = exp(logits - max) / sum(exp(logits - max)) per row
// (the Pallas kernel normalises first and then takes the product: the same
// value, rounded in another order).
//
// What bounds it on an H100: memory.  B*E + C*E elements are read and B*C
// floats written, against 2*B*C*E operations.  At a pool of 65,536 rows,
// E = 512 and C = 102 the products are 6.85 GFLOP: 0.10 ms on the fp32 FMA
// units, against 0.048 ms to read the bytes.  Only the tensor cores keep it
// memory-bound, so every product runs there:
// - bf16 inputs: mma.sync m16n8k16 with fp32 accumulators (a product of two
//   bf16 values is exact in fp32);
// - fp32 inputs: 3xTF32, mma.sync m16n8k8 on the split x = hi + lo (hi the
//   TF32 rounding of x, lo the rest cut to TF32), summing lo.hi + hi.lo +
//   hi.hi; what is dropped is ~2^-21 of the product.  The tensor cores' own
//   sums are kept short (one k16 step, then an fp32 add), so the result
//   keeps the fp32 tolerance.
//
// Design:
// - a block takes a tile of TB image rows, TB in {16, 32, 64, 128}: the
//   largest that still gives two blocks per SM, so a small pool spreads over
//   the card and a large one re-reads the class matrix (from L2) B/TB times;
// - its 4-16 warps split the tile's m16 row tiles and the classes in n16
//   pairs, at most 4 pairs (32 accumulators) a warp; where a short class
//   list leaves warps without a pair, they split E instead and add their
//   sums in a fixed order (that sets the small pools' time); the class count is a
//   template capacity (16, 32, 64, 128 columns), so the accumulators of a
//   short class list take no registers;
// - image and class rows are staged in E-chunks of 128 bytes with 16-byte
//   cp.async, in a ring of 2-8 stages (as many as fit: small tiles keep most
//   of E in flight, which sets their time); ldmatrix reads the fragments
//   (for fp32 too: an 8x8 matrix of b16 pairs is an 8x4 matrix of floats);
// - each staged row's sum of squares is accumulated in fp32 from the same
//   chunks (4 threads a row, a fixed order), so the norms cost no extra read;
// - C <= 128: the whole logits row stays in the accumulators; row max and
//   row sum come from quad shuffles and, across warps that split the
//   columns, shared memory; the probabilities go through a shared tile and
//   are written once, coalesced.  C > 128 (up to kMaxC): TB = 16, the
//   classes are swept 128 at a time into a (16, C) logits tile in shared
//   memory, then one row softmax;
// - ragged edges: missing image rows are zero-filled and not stored; class
//   columns past C are -inf before the softmax; E past its last chunk is
//   zero-filled.  Rows whose width or address is not 16-byte aligned are
//   staged with plain loads instead of cp.async;
// - deterministic: no atomics, every sum in a fixed order.

#include <type_traits>

#include "attention_common.cuh"

namespace {

using mnt::cp_async16;
using mnt::cp_async_commit;
using mnt::cp_async_wait;
using mnt::ldmatrix_x4;
using mnt::mma_tf32;
using mnt::split_tf32;

constexpr int kMaxE = 1024;
constexpr int kMaxC = 2048;
constexpr int kLdBytes = 144;  // a staged row: 128 bytes of one E-chunk + 16 of padding,
                               // so the 8 rows of an ldmatrix fall on distinct banks
constexpr int kSeg = 4;        // threads (segments) per staged row in the sum of squares

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kChunk = 32, kLd = 36;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kChunk = 64, kLd = 72;
};

template <typename T, int TB, int NCAP, bool kBig>
struct Cfg {
  static constexpr int kMT = TB / 16;                     // m16 row tiles
  static constexpr int kPairs = NCAP / 2;                 // n16 class pairs of a sweep
  // at least 4 warps (they stage the rows), and at most 4 pairs (32
  // accumulators) a warp
  static constexpr int kWarps = kMT * ((kPairs + 3) / 4) > 4 ? kMT * ((kPairs + 3) / 4) : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNS = kWarps / kMT;                // warps sharing one row tile
  static constexpr int kNG = kNS < kPairs ? kNS : kPairs; // ... in groups that split the pairs
  static constexpr int kKS = kNS / kNG;                   // ... whose warps split E (short C)
  static constexpr int kPPW = (kPairs + kNG - 1) / kNG;   // pairs per warp
  static constexpr int kCols = NCAP * 8;                  // class rows staged per sweep
  static constexpr int kRows = TB + kCols;                // staged rows: images, then classes
  static constexpr int kChunk = Elem<T>::kChunk, kLd = Elem<T>::kLd;
  static constexpr int kStageBytes = kRows * kLdBytes;
  // as many chunks in flight as fit: a 16-warp block has its SM alone,
  // smaller ones share it with one or more others
  static constexpr int kRingBytes = (kWarps == 16 ? 190 : 100) * 1024;
  static constexpr int kStages = kRingBytes / kStageBytes < 2   ? 2
                                 : kRingBytes / kStageBytes > 8 ? 8
                                                                : kRingBytes / kStageBytes;
  static constexpr int kStageElems = kStageBytes / (int)sizeof(T);
  static constexpr int kItems = kRows * kSeg;             // (row, segment) sums of squares
  static constexpr int kPerThread = (kItems + kThreads - 1) / kThreads;
  static constexpr int kMinBlocks = 65536 / (kThreads * 128);  // a register budget of 128
  static constexpr int kLdo = kCols + 4;                  // the probability tile (C <= 128)
  static_assert(kWarps <= 16 && kPPW <= 4 && kNS * TB <= 256, "warp layout");
  static_assert(kBig || TB * kLdo * 4 <= kStages * kStageBytes,
                "the probability tile reuses the staging ring");
  static_assert(!kBig || (TB == 16 && NCAP == 16), "C > 128 sweeps 128 classes at TB = 16");
  static_assert((kKS - 1) * TB * kLdo * 4 <= kStages * kStageBytes,
                "the split-E partial sums reuse the staging ring");
};

// sum of squares of the 32 bytes at p (8 floats or 16 bf16), in order
__device__ __forceinline__ float sumsq32(const float* p, float s) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  const float x[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) s = fmaf(x[i], x[i], s);
  return s;
}

__device__ __forceinline__ float sumsq32(const __nv_bfloat16* p, float s) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const uint4 v = reinterpret_cast<const uint4*>(p)[1];
  const uint32_t w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lo = __uint_as_float(w[i] << 16), hi = __uint_as_float(w[i] & 0xffff0000u);
    s = fmaf(lo, lo, s);
    s = fmaf(hi, hi, s);
  }
  return s;
}

// Stage columns [k0, k0 + kChunk) of the tile's image rows (rows of them
// real) and of npairs * 16 class rows (ncls real) into one ring slot.
template <typename K, typename T>
__device__ __forceinline__ void stage(T* buf, const T* img, const T* txt, int rows, int ncls,
                                      int npairs, int E, int k0, bool vec, int tid) {
  constexpr int TB = K::kRows - K::kCols;
  constexpr int kPer = 16 / (int)sizeof(T), kPieces = K::kChunk / kPer;
  using Raw = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
  const int n = (TB + npairs * 16) * kPieces;
  for (int idx = tid; idx < n; idx += K::kThreads) {
    const int r = idx / kPieces, c = (idx % kPieces) * kPer;
    const bool is_img = r < TB;
    const int rr = is_img ? r : r - TB;
    const T* src = is_img ? img : txt;
    const bool row_ok = rr < (is_img ? rows : ncls);
    const size_t off = (size_t)rr * E + k0 + c;
    T* dst = buf + r * K::kLd + c;
    if (vec) {
      const bool valid = row_ok && k0 + c < E;
      cp_async16(dst, src + (valid ? off : 0), valid);
    } else {
      const Raw* s = reinterpret_cast<const Raw*>(src);
      Raw* d = reinterpret_cast<Raw*>(dst);
#pragma unroll
      for (int t = 0; t < kPer; ++t) d[t] = row_ok && k0 + c + t < E ? s[off + t] : Raw(0);
    }
  }
}

// ssp[i] += the squares of segment i % kSeg of staged row i / kSeg; each
// thread owns the same items in every chunk
template <typename K, typename T>
__device__ __forceinline__ void sum_squares(float* ssp, const T* buf, int tid) {
#pragma unroll
  for (int j = 0; j < K::kPerThread; ++j) {
    const int i = tid + j * K::kThreads;
    if (i < K::kItems)
      ssp[i] = sumsq32(buf + (i / kSeg) * K::kLd + (i % kSeg) * (K::kChunk / kSeg), ssp[i]);
  }
}

// acc += image rows [m0, m0 + 16) . class pairs of this warp, one chunk.
// fp32: each k16 step's 3xTF32 products of a pair are summed on the tensor
// cores in a zeroed tile, then added to acc with fp32 adds (rounded to
// nearest), so no sum runs long inside the tensor cores' adders.
template <typename K>
__device__ __forceinline__ void products(float (&acc)[K::kPPW][2][4], const float* buf, int m0,
                                         int grp, int npairs, int lane, int ks, int step0) {
  constexpr int TB = K::kRows - K::kCols, LD = K::kLd;
  const float* A = buf;
  const float* Bt = buf + TB * LD;
  const int i = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K::kChunk; kk += 16) {
    if (K::kKS > 1 && (step0 + kk / 16) % K::kKS != ks) continue;  // another warp's k16 step
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[4];
      ldmatrix_x4(a, A + (m0 + rr + (i & 1) * 8) * LD + kk + 8 * s + (i >> 1) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[s][e], al[s][e]);
    }
#pragma unroll
    for (int p = 0; p < K::kPPW; ++p) {
      const int pair = grp * K::kPPW + p;
      if (pair < npairs) {
        float t[2][4] = {};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t b[4], bh[4], bl[4];
          // matrices: (n0.., k0..3), (n0.., k4..7), (n0+8.., k0..3), (n0+8.., k4..7)
          ldmatrix_x4(b, Bt + (pair * 16 + rr + (i >> 1) * 8) * LD + kk + 8 * s + (i & 1) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(b[e], bh[e], bl[e]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_tf32(t[u], al[s], bh[2 * u], bh[2 * u + 1]);
            mma_tf32(t[u], ah[s], bl[2 * u], bl[2 * u + 1]);
            mma_tf32(t[u], ah[s], bh[2 * u], bh[2 * u + 1]);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][u][e] += t[u][e];
      }
    }
  }
}

template <typename K>
__device__ __forceinline__ void products(float (&acc)[K::kPPW][2][4], const __nv_bfloat16* buf,
                                         int m0, int grp, int npairs, int lane, int ks, int step0) {
  constexpr int TB = K::kRows - K::kCols, LD = K::kLd;
  const __nv_bfloat16* Bt = buf + TB * LD;
#pragma unroll
  for (int kk = 0; kk < K::kChunk; kk += 16) {
    if (K::kKS > 1 && (step0 + kk / 16) % K::kKS != ks) continue;  // another warp's k16 step
    uint32_t a[4];
    mnt::load_a(a, buf, LD, m0, kk, lane);
#pragma unroll
    for (int p = 0; p < K::kPPW; ++p) {
      const int pair = grp * K::kPPW + p;
      if (pair < npairs) {
        uint32_t b[4];
        mnt::load_b_rows(b, Bt, LD, pair * 16, kk, lane);
        mnt::mma_bf16(acc[p][0], a, b[0], b[1]);
        mnt::mma_bf16(acc[p][1], a, b[2], b[3]);
      }
    }
  }
}

// the probabilities (or, with kBig, the logits) of a tile's valid rows,
// held in shared memory with row stride ld, written as one contiguous run
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float* tile, int ld,
                                           int rows, int C, int tid, int nthreads) {
  const float inv_c = 1.f / (float)C;
  const int n = rows * C;
  for (int i = tid; i < n; i += nthreads) {
    // (i + 0.5) / C lies at least 0.5 / C from an integer: exact for n < 2^16
    const int r = __float2int_rz(((float)i + 0.5f) * inv_c);
    out[i] = tile[r * ld + (i - r * C)];
  }
}

template <typename T, int TB, int NCAP, bool kBig>
__global__ void __launch_bounds__(Cfg<T, TB, NCAP, kBig>::kThreads,
                                  Cfg<T, TB, NCAP, kBig>::kMinBlocks)
clip_head_kernel(const T* __restrict__ img, const T* __restrict__ txt, float* __restrict__ out,
                 int B, int C, int E, float scale, bool vec) {
  using K = Cfg<T, TB, NCAP, kBig>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* ssp = reinterpret_cast<float*>(smem + K::kStages * K::kStageBytes);  // partial norms
  float* rn = ssp + K::kItems;  // 1 / norm of each staged row
  float* lg = rn + K::kRows;    // kBig: the (TB, ldl) logits tile
  __shared__ float red[2][256];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = (warp % K::kMT) * 16, cg = warp / K::kMT;
  const int grp = cg % K::kNG, ks = cg / K::kNG;  // class group, and share of E
  const int row0 = blockIdx.x * TB;
  const int rows = min(TB, B - row0);
  const int nchunks = (E + K::kChunk - 1) / K::kChunk;
  const int nsweeps = kBig ? (C + K::kCols - 1) / K::kCols : 1;
  const int ldl = nsweeps * K::kCols + 4;
  const T* img_tile = img + (size_t)row0 * E;

  for (int sw = 0; sw < nsweeps; ++sw) {
    const int c0 = sw * K::kCols;
    const int ncls = min(K::kCols, C - c0);
    const int npairs = (ncls + 15) / 16;
    const T* txt_sweep = txt + (size_t)c0 * E;

    float acc[K::kPPW][2][4];
#pragma unroll
    for (int p = 0; p < K::kPPW; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][t][e] = 0.f;
#pragma unroll
    for (int j = 0; j < K::kPerThread; ++j) {
      const int i = tid + j * K::kThreads;
      if (i < K::kItems) ssp[i] = 0.f;
    }

#pragma unroll
    for (int s = 0; s < K::kStages - 1; ++s) {
      if (s < nchunks)
        stage<K>(ring + s * K::kStageElems, img_tile, txt_sweep, rows, ncls, npairs, E,
                 s * K::kChunk, vec, tid);
      cp_async_commit();
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      cp_async_wait<K::kStages - 2>();
      __syncthreads();  // chunk ch has landed; every warp is done with chunk ch - 1
      const int nx = ch + K::kStages - 1;
      if (nx < nchunks)
        stage<K>(ring + (nx % K::kStages) * K::kStageElems, img_tile, txt_sweep, rows, ncls,
                 npairs, E, nx * K::kChunk, vec, tid);
      cp_async_commit();
      const T* buf = ring + (ch % K::kStages) * K::kStageElems;
      sum_squares<K>(ssp, buf, tid);
      products<K>(acc, buf, m0, grp, npairs, lane, ks, ch * (K::kChunk / 16));
    }
    cp_async_wait<0>();

    // the norms: four partial sums a row, added in order
    __syncthreads();
    for (int r = tid; r < K::kRows; r += K::kThreads)
      rn[r] = rsqrtf(ssp[kSeg * r] + ssp[kSeg * r + 1] + ssp[kSeg * r + 2] + ssp[kSeg * r + 3]);
    __syncthreads();

    if constexpr (K::kKS > 1) {  // the warps of a group add their shares of E, in order
      float* part = reinterpret_cast<float*>(smem);  // the ring is free: slots 1 .. kKS - 1
      const int at = (m0 + g) * K::kLdo + grp * K::kPPW * 16 + 2 * q;
      if (ks > 0) {
#pragma unroll
        for (int p = 0; p < K::kPPW; ++p)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(part + ((ks - 1) * TB + 8 * h) * K::kLdo + at +
                                         p * 16 + t * 8) =
                  make_float2(acc[p][t][2 * h], acc[p][t][2 * h + 1]);
      }
      __syncthreads();
      if (ks == 0) {
        for (int k = 1; k < K::kKS; ++k)
#pragma unroll
          for (int p = 0; p < K::kPPW; ++p)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 v = *reinterpret_cast<const float2*>(
                    part + ((k - 1) * TB + 8 * h) * K::kLdo + at + p * 16 + t * 8);
                acc[p][t][2 * h] += v.x;
                acc[p][t][2 * h + 1] += v.y;
              }
      }
      __syncthreads();
    }

    // scaled logits of rows m0 + g (e = 0, 1) and m0 + g + 8 (e = 2, 3);
    // columns past C are -inf
    const float rx[2] = {rn[m0 + g], rn[m0 + g + 8]};
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int p = 0; p < K::kPPW; ++p)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (grp * K::kPPW + p) * 16 + t * 8 + 2 * q + (e & 1);
          const float v = ks == 0 && col < ncls
                              ? acc[p][t][e] * rx[e >> 1] * rn[TB + col] * scale
                              : -INFINITY;
          acc[p][t][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }

    if constexpr (kBig) {
#pragma unroll
      for (int p = 0; p < K::kPPW; ++p) {
        const int pair = grp * K::kPPW + p;
        if (pair < K::kPairs)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(lg + (m0 + g + 8 * h) * ldl + c0 + pair * 16 + t * 8 +
                                         2 * q) = make_float2(acc[p][t][2 * h],
                                                              acc[p][t][2 * h + 1]);
      }
    } else {
      // row softmax in registers: quads hold a row's columns, and kNS warps
      // share a row tile
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[h] = mnt::group_max<4>(mx[h]);
      if constexpr (K::kNS > 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (q == 0) red[0][cg * TB + m0 + g + 8 * h] = mx[h];
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = red[0][m0 + g + 8 * h];
#pragma unroll
          for (int c = 1; c < K::kNS; ++c) m = fmaxf(m, red[0][c * TB + m0 + g + 8 * h]);
          mx[h] = m;
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int p = 0; p < K::kPPW; ++p)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(acc[p][t][e] - mx[e >> 1]);
            acc[p][t][e] = x;
            sum[e >> 1] += x;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) sum[h] = mnt::group_sum<4>(sum[h]);
      if constexpr (K::kNS > 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (q == 0) red[1][cg * TB + m0 + g + 8 * h] = sum[h];
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = red[1][m0 + g + 8 * h];
#pragma unroll
          for (int c = 1; c < K::kNS; ++c) s += red[1][c * TB + m0 + g + 8 * h];
          sum[h] = s;
        }
      }
      float* tile = reinterpret_cast<float*>(smem);  // the ring is free now
#pragma unroll
      for (int p = 0; p < K::kPPW; ++p) {
        const int pair = grp * K::kPPW + p;
        if (ks == 0 && pair < K::kPairs)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(tile + (m0 + g + 8 * h) * K::kLdo + pair * 16 + t * 8 +
                                         2 * q) =
                  make_float2(acc[p][t][2 * h] / sum[h], acc[p][t][2 * h + 1] / sum[h]);
      }
      __syncthreads();
      store_rows(out + (size_t)row0 * C, tile, K::kLdo, rows, C, tid, K::kThreads);
    }
  }

  if constexpr (kBig) {
    __syncthreads();
    for (int r = warp; r < TB; r += K::kWarps) {  // one row softmax a warp
      float* L = lg + r * ldl;
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) m = fmaxf(m, L[c]);
      m = mnt::group_max<32>(m);
      float s = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float x = expf(L[c] - m);
        L[c] = x;
        s += x;
      }
      s = mnt::group_sum<32>(s);
      for (int c = lane; c < C; c += 32) L[c] = L[c] / s;
    }
    __syncthreads();
    store_rows(out + (size_t)row0 * C, lg, ldl, rows, C, tid, K::kThreads);
  }
}

template <typename T, int TB, int NCAP, bool kBig>
size_t smem_bytes(int C) {
  using K = Cfg<T, TB, NCAP, kBig>;
  size_t bytes = (size_t)K::kStages * K::kStageBytes + (size_t)(K::kItems + K::kRows) * 4;
  if (kBig) bytes += (size_t)TB * ((C + K::kCols - 1) / K::kCols * K::kCols + 4) * 4;
  return bytes;
}

template <typename T, int TB, int NCAP, bool kBig>
cudaError_t launch_cfg(const void* img, const void* txt, void* out, int B, int C, int E,
                       float scale, bool vec, cudaStream_t stream) {
  using K = Cfg<T, TB, NCAP, kBig>;
  auto kernel = clip_head_kernel<T, TB, NCAP, kBig>;
  const size_t smem = smem_bytes<T, TB, NCAP, kBig>(C);
  cudaError_t e = mnt::set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(B + TB - 1) / TB, K::kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(txt), static_cast<float*>(out), B, C, E,
      scale, vec);
  return cudaGetLastError();
}

template <typename T, int TB>
cudaError_t launch_tb(const void* img, const void* txt, void* out, int B, int C, int E,
                      float scale, bool vec, cudaStream_t s) {
  if (C <= 16) return launch_cfg<T, TB, 2, false>(img, txt, out, B, C, E, scale, vec, s);
  if (C <= 32) return launch_cfg<T, TB, 4, false>(img, txt, out, B, C, E, scale, vec, s);
  if (C <= 64) return launch_cfg<T, TB, 8, false>(img, txt, out, B, C, E, scale, vec, s);
  return launch_cfg<T, TB, 16, false>(img, txt, out, B, C, E, scale, vec, s);
}

// the largest row tile that still gives two blocks per SM
int pick_tb(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int tb = 128; tb > 16; tb /= 2)
    if ((B + tb - 1) / tb >= 2 * sms) return tb;
  return 16;
}

template <typename T>
cudaError_t launch(const void* img, const void* txt, void* out, int B, int C, int E,
                   float scale, cudaStream_t s) {
  const bool vec = (E * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(txt) % 16 == 0;
  if (C > 128) return launch_cfg<T, 16, 16, true>(img, txt, out, B, C, E, scale, vec, s);
  switch (pick_tb(B)) {
    case 128: return launch_tb<T, 128>(img, txt, out, B, C, E, scale, vec, s);
    case 64: return launch_tb<T, 64>(img, txt, out, B, C, E, scale, vec, s);
    case 32: return launch_tb<T, 32>(img, txt, out, B, C, E, scale, vec, s);
    default: return launch_tb<T, 16>(img, txt, out, B, C, E, scale, vec, s);
  }
}

}  // namespace

extern "C" {

// The largest feature width and class count the kernel takes.
int mnt_clip_head_max_e() { return kMaxE; }
int mnt_clip_head_max_c() { return kMaxC; }

// img: (B, E), txt: (C, E), both contiguous and of one type (0 = float32,
// 1 = bfloat16); out: (B, C) float32.  1 <= E <= kMaxE, 1 <= C <= kMaxC,
// B >= 1.  Returns a cudaError_t.
int mnt_clip_head(const void* img, const void* txt, void* out, int B, int C, int E,
                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || C < 1 || C > kMaxC || E < 1 || E > kMaxE)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(img, txt, out, B, C, E, scale, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(img, txt, out, B, C, E, scale, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
