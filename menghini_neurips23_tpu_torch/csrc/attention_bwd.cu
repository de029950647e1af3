// K2: multi-head self-attention backward over CLIP's fused qkv projection.
//
// Replaces: menghini_neurips23_tpu/ops/attention.py `_bwd_kernel` (reached
// through `_bwd`, the custom VJP of `fused_attention`), the Pallas kernel of
// the JAX package.
//
// What it computes, per batch row b and head h (D = W / heads), given the
// forward's input qkv and the gradient g of its (B, T, W) output:
//   q, k, v, g_h = the head's column slices of qkv (h*D, W+h*D, 2W+h*D) and g
//   P     = softmax(q . k^T * D^-0.5 [+ causal mask]) in fp32, recomputed
//   dv    = P_lp^T . g_h            (P_lp: P rounded to the input type)
//   dP    = g_h . v^T               (fp32)
//   dS    = P * (dP - rowsum(dP * P)) * D^-0.5, rounded to the input type
//           (the row sum takes the fp32 P)
//   dq    = dS . k,  dk = dS^T . q
//   dqkv[b, :, h*D...], [W+h*D...], [2W+h*D...] = dq, dk, dv (input type)
// Every product accumulates in fp32.  Nothing of size (B, H, T, T) reaches
// device memory, and no atomics are used: dk and dv are reduced over the
// query rows inside the block, in a fixed order, so the result is
// bit-identical from launch to launch.
//
// What bounds it on an H100: memory.  It reads qkv (3W) and g (W) and writes
// dqkv (3W) per token, about 7*W elements, against about 10*T*D operations
// per head and token: at the VPT vision shape (T = 66, D = 64) some 24
// operations per byte in bf16, far below the ~295 per byte where the tensor
// cores would become the limit.  The design keeps every product off the
// shared-memory-bound FFMA path in bf16 and stages with 16-byte copies.  At
// ViT-L/14's T = 273 bf16 is still below that line (~195 per byte); fp32,
// against the FMA units' ~20, is bound by operations.
//
// Design, one block per (batch row, head), T <= 128, a warp per 16-row tile:
// - staging: q and k rows, then v and g rows in a second group that lands
//   while S runs, with 16-byte cp.async copies (rows past T zero-filled),
//   read from the fused layout in place, rows padded against bank conflicts;
// - the key capacity KC (16 to 128, the smallest holding T) is a template
//   parameter, as in K1;
// - pass 1, each warp owns 16 query rows: it recomputes S and P, then dP,
//   r = rowsum(dP * P) and dS, and forms dq = dS . k; it leaves P_lp and dS
//   in shared memory;
// - pass 2, after a barrier, each warp owns 16 key rows and forms
//   dv = P_lp^T . g and dk = dS^T . q over the query rows, in a fixed order;
// - bf16: every product on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 accumulators, ldmatrix / ldmatrix.trans from shared
//   memory); S and P stay in registers (16 x 128 fp32 per warp at most), dP
//   is formed twice (once for r, once for dS) rather than held, dS is
//   rounded straight into the A fragments of dS . k; P_lp and dS, bf16,
//   take 2 * T^2 * 2 bytes (74 KB of shared memory in all at T = 66);
// - fp32: full-fp32 FFMA (no TF32), register-tiled like K1's fp32 path;
//   dP passes through the dS buffer of the tile's own rows; P stays in
//   registers until every warp has read k and v, then takes their place, so
//   that T = 128 fits in 227 KB; up to 32 keys each tile has two warps,
//   which split the columns of dq and of pass 2;
// - causal rows skip whole key tiles above the diagonal, and pass 2 skips
//   the query tiles above it; masked and padded entries give P = dS = 0.
//
// Tiled design, 128 < T <= 320 (ViT-L/14: VPT's 273, UPT's 261, 257): P_lp
// and dS of a whole (row, head) no longer fit a block (2 * 288 * 296 * 2 B =
// 341 KB at T = 273), so the work splits into two launches of 4-warp blocks
// over 64-row tiles, each streaming the other side's rows through shared
// memory in 64-row chunks (rows past T zero-filled), with no atomics:
// - query side, grid (batch row x head, query tile): sweep 1 over the key
//   chunks takes each row's max m and sum l (rescaled from chunk to chunk,
//   as K1's sweep 1); sweep 2 forms P = exp(S - m) / l and dP = g . v^T in
//   fp32 and r = rowsum(dP * P); sweep 3 forms them again, rounds dS and
//   accumulates dq = dS . k.  It writes dq and (m, l, r) of every row, fp32,
//   to a (B, H, 3, T) workspace that the wrapper allocates;
// - key side, grid (batch row x head, key tile): over the query chunks in a
//   fixed order (causal: from the block's own diagonal), it recomputes the
//   transposed tile S^T = k . q^T, forms P from the stored m and l, dv +=
//   P_lp^T . g, then dS from the stored r and dk += dS^T . q.  Scores,
//   P and dS are formed by the same expressions on both sides;
// - the rounding points are the ones above: P normalised in fp32 before it
//   is rounded for dv, r from the fp32 P and dP, dS rounded before dq and
//   dk (no rowsum(dO * O) shortcut: O is rounded);
// - bf16: every product on the tensor cores, the key side entirely in
//   registers (S^T and dP^T in the accumulator layout are the A fragments of
//   P_lp^T . g and dS^T . q); fp32: FFMA register tiles as above, with dS
//   (query side) and P, then dS (key side) of the warp's 16 rows passing
//   through a per-warp buffer.
// T above 320 raises (K1's forward takes no more at D = 64).

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

constexpr int kMaxSeq = 320;       // the longest T (K1's forward range at D = 64)
constexpr int kWholeMaxSeq = 128;  // up to here one block holds a whole (row, head)
constexpr int kTile = 64;          // tiled path: rows per block and per chunk
constexpr int kTileThreads = 128;  // ... a warp per 16 rows

size_t bf16_smem(int seq, int D) {
  const size_t tp = round16(seq);
  return (4 * tp * (D + 8) + 2 * tp * (tp + 8)) * sizeof(bf16);
}

size_t f32_smem(int seq, int D) {
  const size_t tp = round16(seq), tile = tp * (D + 4), pd = tp * (tp + 4);
  return (2 * tile + pd + std::max(2 * tile, pd)) * sizeof(float);
}

// ------------------------------------------------------------------ bf16

template <int D, int KC>
__global__ void __launch_bounds__(2 * KC, KC <= 64 ? 256 / KC : 1)
attention_bwd_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                   bf16* __restrict__ dqkv, int seq, int width, int heads, float scale,
                   int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  const int tp = round16(seq), ldp = tp + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + tp * LD;
  bf16* vs = ks + tp * LD;
  bf16* gs = vs + tp * LD;
  bf16* ps = gs + tp * LD;   // P_lp, (query, key)
  bf16* ds = ps + tp * ldp;  // dS * scale rounded, (query, key)

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // q and k first, v and g in a second group that lands while S runs
  stage_rows<bf16, D>(qs, LD, base, stride, seq, tp, tid, nthreads);
  stage_rows<bf16, D>(ks, LD, base + width, stride, seq, tp, tid, nthreads);
  cp_async_commit();
  stage_rows<bf16, D>(vs, LD, base + 2 * width, stride, seq, tp, tid, nthreads);
  stage_rows<bf16, D>(gs, LD, grad + (size_t)b * seq * width + h * D, width, seq, tp, tid,
                      nthreads);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp, row0 = r0 + lane / 4;  // rows row0 and row0 + 8
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;

  // pass 1: this warp's 16 query rows
  {
    const int kend = causal ? r0 + 16 : tp;
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, LD, r0, 16 * kk, lane);
    float p[KC / 8][4];
    scores_bf16<D, KC>(p, qf, ks, 0, kend, seq, r0, causal, scale, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) m = fmaxf(m, fmaxf(p[n][2 * r], p[n][2 * r + 1]));
      m = group_max<4>(m);
      float l = 0.f;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          p[n][e] = expf(p[n][e] - m);
          l += p[n][e];
        }
      l = group_sum<4>(l);
      const float inv_l = row0 + 8 * r < seq ? 1.f / l : 0.f;  // padded rows: P = 0
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) p[n][e] *= inv_l;
    }
    cp_async_wait<0>();
    __syncthreads();
    uint32_t gf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(gf[kk], gs, LD, r0, 16 * kk, lane);
    // P_lp to shared memory; r = rowsum(dP * P) with dP = g . v^T
    float r[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const int n0 = 16 * j;
      if (n0 >= kend) break;
      float dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bv[4];
        load_b_rows(bv, vs, LD, n0, 16 * kk, lane);
        mma_bf16(dp[0], gf[kk], bv[0], bv[1]);
        mma_bf16(dp[1], gf[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float(&pt)[4] = p[2 * j + t];
        const int col = n0 + 8 * t + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(ps + row0 * ldp + col) = pack_bf16(pt[0], pt[1]);
        *reinterpret_cast<uint32_t*>(ps + (row0 + 8) * ldp + col) = pack_bf16(pt[2], pt[3]);
        r[0] = fmaf(dp[t][0], pt[0], fmaf(dp[t][1], pt[1], r[0]));
        r[1] = fmaf(dp[t][2], pt[2], fmaf(dp[t][3], pt[3], r[1]));
      }
    }
    r[0] = group_sum<4>(r[0]);
    r[1] = group_sum<4>(r[1]);
    // dS (dP formed again rather than held), to shared memory and, rounded,
    // straight into the A fragments of dq = dS . k
    float dq[D / 8][4] = {};
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const int n0 = 16 * j;
      if (n0 >= kend) break;
      float dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bv[4];
        load_b_rows(bv, vs, LD, n0, 16 * kk, lane);
        mma_bf16(dp[0], gf[kk], bv[0], bv[1]);
        mma_bf16(dp[1], gf[kk], bv[2], bv[3]);
      }
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float(&pt)[4] = p[2 * j + t];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = pt[e] * (dp[t][e] - r[e >> 1]) * scale;
        a[2 * t] = pack_bf16(v[0], v[1]);
        a[2 * t + 1] = pack_bf16(v[2], v[3]);
        const int col = n0 + 8 * t + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(ds + row0 * ldp + col) = a[2 * t];
        *reinterpret_cast<uint32_t*>(ds + (row0 + 8) * ldp + col) = a[2 * t + 1];
      }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bk[4];
        load_b_cols(bk, ks, LD, n0, 16 * dd, lane);
        mma_bf16(dq[2 * dd], a, bk[0], bk[1]);
        mma_bf16(dq[2 * dd + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        if (row0 + 8 * h2 < seq)
          *reinterpret_cast<uint32_t*>(out + (row0 + 8 * h2) * stride + col) =
              pack_bf16(dq[n][2 * h2], dq[n][2 * h2 + 1]);
    }
  }
  __syncthreads();

  // pass 2: this warp's 16 key rows (j0 = r0): dv = P_lp^T . g, dk = dS^T . q
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int i0 = causal ? r0 : 0; i0 < tp; i0 += 16) {
    uint32_t ap[4], ad[4];
    load_a_trans(ap, ps, ldp, r0, i0, lane);
    load_a_trans(ad, ds, ldp, r0, i0, lane);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bg[4], bq[4];
      load_b_cols(bg, gs, LD, i0, 16 * dd, lane);
      load_b_cols(bq, qs, LD, i0, 16 * dd, lane);
      mma_bf16(dv[2 * dd], ap, bg[0], bg[1]);
      mma_bf16(dv[2 * dd + 1], ap, bg[2], bg[3]);
      mma_bf16(dk[2 * dd], ad, bq[0], bq[1]);
      mma_bf16(dk[2 * dd + 1], ad, bq[2], bq[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = row0 + 8 * h2;
      if (row < seq) {
        *reinterpret_cast<uint32_t*>(out + row * stride + width + col) =
            pack_bf16(dk[n][2 * h2], dk[n][2 * h2 + 1]);
        *reinterpret_cast<uint32_t*>(out + row * stride + 2 * width + col) =
            pack_bf16(dv[n][2 * h2], dv[n][2 * h2 + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ fp32

// Warps per 16-row tile of the fp32 kernel: short sequences give each tile
// two warps, which split the columns of dq and of pass 2 (the block is
// otherwise only ceil(T/16) warps deep and its latency shows).
__host__ __device__ constexpr int f32_split(int KC, int D) {
  return KC <= 32 && D >= 32 ? 2 : 1;
}

template <int D, int KC>
__global__ void __launch_bounds__(2 * KC * f32_split(KC, D),
                                  KC <= 64 ? 256 / (KC * f32_split(KC, D)) : 1)
attention_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ grad,
                  float* __restrict__ dqkv, int seq, int width, int heads, float scale,
                  int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int CS = f32_split(KC, D);
  using C = Cols<D / CS>;
  constexpr int LD = D + 4, NS = KC / 8, NG = NS <= 8 ? NS : NS / 2;
  const int tp = round16(seq), ldp = tp + 4;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = qs + tp * LD;
  float* ds = gs + tp * LD;   // dP, then dS, (query, key)
  float* ks = ds + tp * ldp;  // k and v during pass 1 ...
  float* vs = ks + tp * LD;
  float* ps = ks;             // ... P in their place for pass 2

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  stage_rows<float, D>(qs, LD, base, stride, seq, tp, tid, nthreads);
  stage_rows<float, D>(ks, LD, base + width, stride, seq, tp, tid, nthreads);
  cp_async_commit();
  stage_rows<float, D>(vs, LD, base + 2 * width, stride, seq, tp, tid, nthreads);
  stage_rows<float, D>(gs, LD, grad + (size_t)b * seq * width + h * D, width, seq, tp, tid,
                       nthreads);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, ry = lane / 8, kx = lane % 8;
  const int part = warp % CS, c0 = part * (D / CS);  // the warp's share of the columns
  const int r0 = 16 * (warp / CS), row0 = r0 + 4 * ry;  // rows (pass 1) / keys (pass 2) row0 ..
  // keys the tile's rows see, to the last 8-key slot holding a real key
  const int kend = min(causal ? r0 + 16 : tp, (seq + 7) / 8 * 8);
  float* out = dqkv + (size_t)b * seq * stride + h * D + c0;

  // pass 1 (the tile's first warp): P in registers, dP through the tile's
  // rows of ds, then dS; then dq, its columns split over the tile's warps
  float p[4][NS];
  if (part == 0) {
    scores_f32<D, KC>(p, qs + r0 * LD, ks, 0, kend, seq, r0, causal, scale, ry, kx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) m = fmaxf(m, p[i][jj]);
      m = group_max<8>(m);
      float l = 0.f;
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        p[i][jj] = expf(p[i][jj] - m);
        l += p[i][jj];
      }
      l = group_sum<8>(l);
      const float inv_l = row0 + i < seq ? 1.f / l : 0.f;  // padded rows: P = 0
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) p[i][jj] *= inv_l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (part == 0) {
    float r[4] = {};
#pragma unroll
    for (int g0 = 0; g0 < NS; g0 += NG) {  // dP = g . v^T, NG key slots at a time
      float dp[4][NG] = {};
#pragma unroll (NS <= 8 ? 4 : 1)
      for (int d = 0; d < D; d += 4) {
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_vec<4>(g[i], gs + (row0 + i) * LD + d);
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          const int key = 8 * (g0 + jj);
          if (key < kend) {
            float v[4];
            load_vec<4>(v, vs + (key + kx) * LD + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int t = 0; t < 4; ++t) dp[i][jj] = fmaf(g[i][t], v[t], dp[i][jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < NG; ++jj) {
        const int key = 8 * (g0 + jj);
        if (key < kend) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            r[i] = fmaf(dp[i][jj], p[i][g0 + jj], r[i]);
            ds[(row0 + i) * ldp + key + kx] = dp[i][jj];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = group_sum<8>(r[i]);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        if (8 * jj < kend) {
          float* e = ds + (row0 + i) * ldp + 8 * jj + kx;
          *e = p[i][jj] * (*e - r[i]) * scale;
        }
    }
  }
  __syncthreads();
  {
    float dq[4][C::kPer] = {};
#pragma unroll (NS <= 8 ? 2 : 1)
    for (int j = 0; j < kend; j += 4) {
      float s4[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(s4[i], ds + (row0 + i) * ldp + j);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int u = 0; u < C::kRuns; ++u) {
          float kv[C::kVec];
          load_vec<C::kVec>(kv, ks + (j + t) * LD + c0 + C::col(u, kx));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < C::kVec; ++e)
              dq[i][u * C::kVec + e] = fmaf(s4[i][t], kv[e], dq[i][u * C::kVec + e]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (row0 + i < seq)
#pragma unroll
        for (int u = 0; u < C::kRuns; ++u)
          store_vec<C::kVec>(out + (row0 + i) * stride + C::col(u, kx), dq[i] + u * C::kVec);
  }
  __syncthreads();  // every warp is done with k and v
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        if (8 * jj < kend) ps[(row0 + i) * ldp + 8 * jj + kx] = p[i][jj];
  }
  __syncthreads();

  // pass 2: keys row0 .. row0 + 3 of the tile's 16, over query rows i
  float dk[4][C::kPer] = {}, dv[4][C::kPer] = {};
#pragma unroll 4
  for (int i = causal ? r0 : 0; i < seq; ++i) {
    float s4[4], p4[4];
    load_vec<4>(s4, ds + i * ldp + row0);
    load_vec<4>(p4, ps + i * ldp + row0);
#pragma unroll
    for (int u = 0; u < C::kRuns; ++u) {
      float qv[C::kVec], gv[C::kVec];
      load_vec<C::kVec>(qv, qs + i * LD + c0 + C::col(u, kx));
      load_vec<C::kVec>(gv, gs + i * LD + c0 + C::col(u, kx));
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < C::kVec; ++e) {
          dk[t][u * C::kVec + e] = fmaf(s4[t], qv[e], dk[t][u * C::kVec + e]);
          dv[t][u * C::kVec + e] = fmaf(p4[t], gv[e], dv[t][u * C::kVec + e]);
        }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (row0 + t < seq)
#pragma unroll
      for (int u = 0; u < C::kRuns; ++u) {
        float* row = out + (row0 + t) * stride + C::col(u, kx);
        store_vec<C::kVec>(row + width, dk[t] + u * C::kVec);
        store_vec<C::kVec>(row + 2 * width, dv[t] + u * C::kVec);
      }
}

// ------------------------------------------------------------ tiled path

// One layout for both sides: four 64-row tiles, the key side's (m, 1/l, r)
// of a query chunk, and for fp32 a 16 x (kTile + 4) buffer per warp.
size_t tiled_bf16_smem(int D) {
  return 4 * kTile * (size_t)(D + 8) * sizeof(bf16) + 3 * kTile * sizeof(float);
}

size_t tiled_f32_smem(int D) {
  return (4 * kTile * (size_t)(D + 4) + 3 * kTile + 4 * 16 * (kTile + 4)) * sizeof(float);
}

// c[t] = A . B over D for the 16 rows n0 .. n0 + 15 of `rows` (B[k][n] =
// rows[n][k]): two n8 accumulator tiles from the warp's A fragments.
template <int D>
__device__ __forceinline__ void dots_bf16(float (&c)[2][4], const uint32_t (&af)[D / 16][4],
                                          const bf16* rows, int n0, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    load_b_rows(b, rows, D + 8, n0, 16 * kk, lane);
    mma_bf16(c[0], af[kk], b[0], b[1]);
    mma_bf16(c[1], af[kk], b[2], b[3]);
  }
}

// acc[i][jj] = sum_d a[4ry + i][d] * b[8jj + kx][d]: the warp's 16 rows of
// `a` against the kTile rows of `b`, both row-major with D + 4 floats a row.
template <int D>
__device__ __forceinline__ void dots_f32(float (&acc)[4][kTile / 8], const float* a,
                                         const float* b, int ry, int kx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kTile / 8; ++jj) acc[i][jj] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(x[i], a + (4 * ry + i) * LD + d);
#pragma unroll
    for (int jj = 0; jj < kTile / 8; ++jj) {
      float y[4];
      load_vec<4>(y, b + (8 * jj + kx) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[i][jj] = fmaf(x[i][t], y[t], acc[i][jj]);
    }
  }
}

// acc[i][c] += sum_{j < n} w[4ry + i][j] * b[j][col c]: the lane's 4 rows of
// the warp's (16, kTile + 4) buffer against the first n (a multiple of 4)
// rows of a chunk, in the lane's Cols<D> columns.
template <int D>
__device__ __forceinline__ void rows_times_f32(float (&acc)[4][D / 8], const float* w,
                                               const float* b, int n, int ry, int kx) {
  using C = Cols<D>;
  constexpr int LD = D + 4, LDW = kTile + 4;
  for (int j = 0; j < n; j += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(p[i], w + (4 * ry + i) * LDW + j);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < C::kRuns; ++u) {
        float v[C::kVec];
        load_vec<C::kVec>(v, b + (j + t) * LD + C::col(u, kx));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < C::kVec; ++e)
            acc[i][u * C::kVec + e] = fmaf(p[i][t], v[e], acc[i][u * C::kVec + e]);
      }
  }
}

// Query side, bf16.  Block (batch row x head, 64-row query tile), a warp
// per 16 rows; the key chunks stream through ks / vs.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attention_bwd_q_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                     bf16* __restrict__ dqkv, float* __restrict__ stats, int seq, int width,
                     int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // the block's query rows
  bf16* gs = qs + kTile * LD;
  bf16* ks = gs + kTile * LD;  // the chunk's keys
  bf16* vs = ks + kTile * LD;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, rb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  stage_rows<bf16, D>(qs, LD, base + rb * stride, stride, min(kTile, seq - rb), kTile, tid,
                      kTileThreads);
  stage_rows<bf16, D>(gs, LD, grad + ((size_t)b * seq + rb) * width + h * D, width,
                      min(kTile, seq - rb), kTile, tid, kTileThreads);
  cp_async_commit();

  const int r0 = rb + 16 * warp, row0 = r0 + lane / 4;  // rows row0 and row0 + 8
  const bool active = r0 < seq;
  const int kend = causal ? min(seq, r0 + 16) : seq;  // the keys this warp's rows see
  const int nch = ((causal ? min(seq, rb + kTile) : seq) + kTile - 1) / kTile;
  uint32_t qf[D / 16][4], gf[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, dq[D / 8][4] = {};
  for (int step = 0; step < 3 * nch; ++step) {
    const int sweep = step / nch, c0 = (step % nch) * kTile, nk = min(kTile, seq - c0);
    __syncthreads();  // every warp is done with the last chunk
    stage_rows<bf16, D>(ks, LD, base + width + c0 * stride, stride, nk, kTile, tid,
                        kTileThreads);
    if (sweep > 0)
      stage_rows<bf16, D>(vs, LD, base + 2 * width + c0 * stride, stride, nk, kTile, tid,
                          kTileThreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(qf[kk], qs, LD, 16 * warp, 16 * kk, lane);
        load_a(gf[kk], gs, LD, 16 * warp, 16 * kk, lane);
      }
    }
    if (sweep == 1 && c0 == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) inv_l[e] = row0 + 8 * e < seq ? 1.f / l[e] : 0.f;
    }
    if (sweep == 2 && c0 == 0) {
      r[0] = group_sum<4>(r[0]);
      r[1] = group_sum<4>(r[1]);
    }
    if (c0 >= kend) continue;
    if (sweep == 0) {  // the row max and sum over this chunk
      float s[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        const int n0 = c0 + 16 * j;
        float c[2][4] = {};
        if (n0 < kend) dots_bf16<D>(c, qf, ks, 16 * j, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * t + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
            const bool valid = n0 < kend && col < seq && (!causal || col <= row);
            s[2 * j + t][e] = valid ? c[t][e] * scale : -INFINITY;
          }
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float cm = -INFINITY;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
          cm = fmaxf(cm, fmaxf(s[n][2 * e2], s[n][2 * e2 + 1]));
        const float mn = fmaxf(m[e2], group_max<4>(cm));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
          sum += expf(s[n][2 * e2] - mn) + expf(s[n][2 * e2 + 1] - mn);
        l[e2] = l[e2] * expf(m[e2] - mn) + group_sum<4>(sum);
        m[e2] = mn;
      }
      continue;
    }
    // sweeps 2 and 3, a 16-key tile at a time: P and dP in fp32
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      const int n0 = c0 + 16 * j;
      if (n0 >= kend) break;
      float s[2][4], dp[2][4];
      dots_bf16<D>(s, qf, ks, 16 * j, lane);
      dots_bf16<D>(dp, gf, vs, 16 * j, lane);
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * t + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
          const bool valid = col < seq && (!causal || col <= row);
          const float p = valid ? expf(s[t][e] * scale - m[e >> 1]) * inv_l[e >> 1] : 0.f;
          if (sweep == 1) r[e >> 1] = fmaf(dp[t][e], p, r[e >> 1]);
          v[e] = p * (dp[t][e] - r[e >> 1]) * scale;
        }
        a[2 * t] = pack_bf16(v[0], v[1]);
        a[2 * t + 1] = pack_bf16(v[2], v[3]);
      }
      if (sweep == 1) continue;
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bk[4];
        load_b_cols(bk, ks, LD, 16 * j, 16 * dd, lane);
        mma_bf16(dq[2 * dd], a, bk[0], bk[1]);
        mma_bf16(dq[2 * dd + 1], a, bk[2], bk[3]);
      }
    }
  }
  if (!active) return;
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;
  float* st = stats + (size_t)blockIdx.x * 3 * seq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + 8 * e;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + row * stride + 8 * n + 2 * (lane & 3)) =
          pack_bf16(dq[n][2 * e], dq[n][2 * e + 1]);
    if ((lane & 3) == 0) st[row] = m[e], st[seq + row] = l[e], st[2 * seq + row] = r[e];
  }
}

// Key side, bf16.  Block (batch row x head, 64-row key tile), a warp per 16
// keys; the query chunks and their (m, 1/l, r) stream through qs / gs / ws.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attention_bwd_kv_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                      bf16* __restrict__ dqkv, const float* __restrict__ stats, int seq,
                      int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // the block's keys
  bf16* vs = ks + kTile * LD;
  bf16* qs = vs + kTile * LD;  // the chunk's queries
  bf16* gs = qs + kTile * LD;
  float* ws = reinterpret_cast<float*>(gs + kTile * LD);  // their m, 1/l, r

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, jb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const bf16* gbase = grad + (size_t)b * seq * width + h * D;
  const float* st = stats + (size_t)blockIdx.x * 3 * seq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  stage_rows<bf16, D>(ks, LD, base + width + jb * stride, stride, min(kTile, seq - jb), kTile,
                      tid, kTileThreads);
  stage_rows<bf16, D>(vs, LD, base + 2 * width + jb * stride, stride, min(kTile, seq - jb),
                      kTile, tid, kTileThreads);
  cp_async_commit();

  const int j0 = jb + 16 * warp, key0 = j0 + lane / 4;  // keys key0 and key0 + 8
  const bool active = j0 < seq;
  const int first = causal ? blockIdx.y : 0, nch = (seq + kTile - 1) / kTile;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int c = first; c < nch; ++c) {
    const int i0c = c * kTile, nq = min(kTile, seq - i0c);
    __syncthreads();  // every warp is done with the last chunk
    stage_rows<bf16, D>(qs, LD, base + i0c * stride, stride, nq, kTile, tid, kTileThreads);
    stage_rows<bf16, D>(gs, LD, gbase + (size_t)i0c * width, width, nq, kTile, tid,
                        kTileThreads);
    cp_async_commit();
    for (int i = tid; i < kTile; i += kTileThreads) {
      const bool ok = i < nq;
      ws[i] = ok ? st[i0c + i] : 0.f;
      ws[kTile + i] = ok ? 1.f / st[seq + i0c + i] : 0.f;
      ws[2 * kTile + i] = ok ? st[2 * seq + i0c + i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    if (c == first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(kf[kk], ks, LD, 16 * warp, 16 * kk, lane);
        load_a(vf[kk], vs, LD, 16 * warp, 16 * kk, lane);
      }
    }
#pragma unroll 1
    for (int t = 0; t < kTile / 16; ++t) {
      const int i0 = i0c + 16 * t;
      if (i0 >= seq) break;
      if (causal && i0 + 15 < j0) continue;  // every query of the tile is before these keys
      float s[2][4], dp[2][4];
      dots_bf16<D>(s, kf, qs, 16 * t, lane);  // S^T: (key, query)
      dots_bf16<D>(dp, vf, gs, 16 * t, lane);  // dP^T
      uint32_t ap[4], ad[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1), qi = 16 * t + 8 * u + 2 * (lane & 3) + (e & 1);
          const int q = i0c + qi;
          const bool valid = key < seq && q < seq && (!causal || key <= q);
          p[e] = valid ? expf(s[u][e] * scale - ws[qi]) * ws[kTile + qi] : 0.f;
          ds[e] = p[e] * (dp[u][e] - ws[2 * kTile + qi]) * scale;
        }
        ap[2 * u] = pack_bf16(p[0], p[1]);
        ap[2 * u + 1] = pack_bf16(p[2], p[3]);
        ad[2 * u] = pack_bf16(ds[0], ds[1]);
        ad[2 * u + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bg[4], bq[4];
        load_b_cols(bg, gs, LD, 16 * t, 16 * dd, lane);
        load_b_cols(bq, qs, LD, 16 * t, 16 * dd, lane);
        mma_bf16(dv[2 * dd], ap, bg[0], bg[1]);
        mma_bf16(dv[2 * dd + 1], ap, bg[2], bg[3]);
        mma_bf16(dk[2 * dd], ad, bq[0], bq[1]);
        mma_bf16(dk[2 * dd + 1], ad, bq[2], bq[3]);
      }
    }
  }
  if (!active) return;
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = key0 + 8 * e;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(out + row * stride + width + col) =
          pack_bf16(dk[n][2 * e], dk[n][2 * e + 1]);
      *reinterpret_cast<uint32_t*>(out + row * stride + 2 * width + col) =
          pack_bf16(dv[n][2 * e], dv[n][2 * e + 1]);
    }
  }
}

// Query side, fp32: lane (ry, kx) holds rows r0 + 4ry + i against keys
// c0 + 8jj + kx; dS of the warp's rows passes through its buffer for dq.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attention_bwd_q_f32(const float* __restrict__ qkv, const float* __restrict__ grad,
                    float* __restrict__ dqkv, float* __restrict__ stats, int seq, int width,
                    int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int LD = D + 4, NS = kTile / 8, LDW = kTile + 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ry = lane / 8, kx = lane % 8;
  float* qs = reinterpret_cast<float*>(smem_raw);  // the block's query rows
  float* gs = qs + kTile * LD;
  float* ks = gs + kTile * LD;  // the chunk's keys
  float* vs = ks + kTile * LD;
  float* ws = vs + kTile * LD + 3 * kTile + warp * 16 * LDW;  // the warp's dS

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, rb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  stage_rows<float, D>(qs, LD, base + rb * stride, stride, min(kTile, seq - rb), kTile, tid,
                       kTileThreads);
  stage_rows<float, D>(gs, LD, grad + ((size_t)b * seq + rb) * width + h * D, width,
                       min(kTile, seq - rb), kTile, tid, kTileThreads);
  cp_async_commit();

  const int r0 = rb + 16 * warp, row0 = r0 + 4 * ry;  // rows row0 .. row0 + 3
  const bool active = r0 < seq;
  const int kend = causal ? min(seq, r0 + 16) : seq;
  const int nch = ((causal ? min(seq, rb + kTile) : seq) + kTile - 1) / kTile;
  float m[4], l[4], r[4], inv_l[4], dq[4][C::kPer] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = r[i] = inv_l[i] = 0.f;
  for (int step = 0; step < 3 * nch; ++step) {
    const int sweep = step / nch, c0 = (step % nch) * kTile, nk = min(kTile, seq - c0);
    __syncthreads();
    stage_rows<float, D>(ks, LD, base + width + c0 * stride, stride, nk, kTile, tid,
                         kTileThreads);
    if (sweep > 0)
      stage_rows<float, D>(vs, LD, base + 2 * width + c0 * stride, stride, nk, kTile, tid,
                           kTileThreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    if (sweep == 1 && c0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) inv_l[i] = row0 + i < seq ? 1.f / l[i] : 0.f;
    }
    if (sweep == 2 && c0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = group_sum<8>(r[i]);
    }
    if (c0 >= kend) continue;
    float s[4][NS];
    dots_f32<D>(s, qs + 16 * warp * LD, ks, ry, kx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int col = c0 + 8 * jj + kx;
        const bool valid = col < seq && (!causal || col <= row0 + i);
        s[i][jj] = valid ? s[i][jj] * scale : -INFINITY;
      }
    if (sweep == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float cm = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) cm = fmaxf(cm, s[i][jj]);
        const float mn = fmaxf(m[i], group_max<8>(cm));
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) sum += expf(s[i][jj] - mn);
        l[i] = l[i] * expf(m[i] - mn) + group_sum<8>(sum);
        m[i] = mn;
      }
      continue;
    }
    float dp[4][NS];
    dots_f32<D>(dp, gs + 16 * warp * LD, vs, ry, kx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const float p = expf(s[i][jj] - m[i]) * inv_l[i];
        if (sweep == 1) {
          r[i] = fmaf(dp[i][jj], p, r[i]);
        } else {
          ws[(4 * ry + i) * LDW + 8 * jj + kx] = p * (dp[i][jj] - r[i]) * scale;
        }
      }
    if (sweep == 2) {
      __syncwarp();
      rows_times_f32<D>(dq, ws, ks, (min(kTile, kend - c0) + 3) / 4 * 4, ry, kx);
      __syncwarp();
    }
  }
  if (!active) return;
  float* out = dqkv + (size_t)b * seq * stride + h * D;
  float* st = stats + (size_t)blockIdx.x * 3 * seq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= seq) continue;
#pragma unroll
    for (int u = 0; u < C::kRuns; ++u)
      store_vec<C::kVec>(out + row * stride + C::col(u, kx), dq[i] + u * C::kVec);
    if (kx == 0) st[row] = m[i], st[seq + row] = l[i], st[2 * seq + row] = r[i];
  }
}

// Key side, fp32: lane (ry, kx) holds keys j0 + 4ry + t against queries
// i0c + 8jj + kx; P, then dS, of the warp's keys pass through its buffer.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attention_bwd_kv_f32(const float* __restrict__ qkv, const float* __restrict__ grad,
                     float* __restrict__ dqkv, const float* __restrict__ stats, int seq,
                     int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int LD = D + 4, NS = kTile / 8, LDW = kTile + 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ry = lane / 8, kx = lane % 8;
  float* ks = reinterpret_cast<float*>(smem_raw);  // the block's keys
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;  // the chunk's queries
  float* gs = qs + kTile * LD;
  float* sts = gs + kTile * LD;  // their m, 1/l, r
  float* ws = sts + 3 * kTile + warp * 16 * LDW;  // the warp's P, then dS

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, jb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const float* gbase = grad + (size_t)b * seq * width + h * D;
  const float* st = stats + (size_t)blockIdx.x * 3 * seq;
  stage_rows<float, D>(ks, LD, base + width + jb * stride, stride, min(kTile, seq - jb), kTile,
                       tid, kTileThreads);
  stage_rows<float, D>(vs, LD, base + 2 * width + jb * stride, stride, min(kTile, seq - jb),
                       kTile, tid, kTileThreads);
  cp_async_commit();

  const int j0 = jb + 16 * warp, key0 = j0 + 4 * ry;  // keys key0 .. key0 + 3
  const bool active = j0 < seq;
  const int first = causal ? blockIdx.y : 0, nch = (seq + kTile - 1) / kTile;
  float dk[4][C::kPer] = {}, dv[4][C::kPer] = {};
  for (int c = first; c < nch; ++c) {
    const int i0c = c * kTile, nq = min(kTile, seq - i0c);
    __syncthreads();
    stage_rows<float, D>(qs, LD, base + i0c * stride, stride, nq, kTile, tid, kTileThreads);
    stage_rows<float, D>(gs, LD, gbase + (size_t)i0c * width, width, nq, kTile, tid,
                         kTileThreads);
    cp_async_commit();
    for (int i = tid; i < kTile; i += kTileThreads) {
      const bool ok = i < nq;
      sts[i] = ok ? st[i0c + i] : 0.f;
      sts[kTile + i] = ok ? 1.f / st[seq + i0c + i] : 0.f;
      sts[2 * kTile + i] = ok ? st[2 * seq + i0c + i] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    const int n4 = (nq + 3) / 4 * 4;
    float s[4][NS];
    dots_f32<D>(s, ks + 16 * warp * LD, qs, ry, kx);  // S^T: (key, query)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int qi = 8 * jj + kx, key = key0 + t;
        const bool valid = key < seq && qi < nq && (!causal || key <= i0c + qi);
        ws[(4 * ry + t) * LDW + qi] =
            valid ? expf(s[t][jj] * scale - sts[qi]) * sts[kTile + qi] : 0.f;
      }
    __syncwarp();
    rows_times_f32<D>(dv, ws, gs, n4, ry, kx);
    __syncwarp();
    dots_f32<D>(s, vs + 16 * warp * LD, gs, ry, kx);  // dP^T
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int qi = 8 * jj + kx;
        float* e = ws + (4 * ry + t) * LDW + qi;
        *e = *e * (s[t][jj] - sts[2 * kTile + qi]) * scale;
      }
    __syncwarp();
    rows_times_f32<D>(dk, ws, qs, n4, ry, kx);
    __syncwarp();
  }
  if (!active) return;
  float* out = dqkv + (size_t)b * seq * stride + h * D;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int row = key0 + t;
    if (row >= seq) continue;
#pragma unroll
    for (int u = 0; u < C::kRuns; ++u) {
      float* dst = out + row * stride + C::col(u, kx);
      store_vec<C::kVec>(dst + width, dk[t] + u * C::kVec);
      store_vec<C::kVec>(dst + 2 * width, dv[t] + u * C::kVec);
    }
  }
}

// The tiled path: the query side (dq and the row statistics), then the key
// side (dk, dv), on one stream.
template <int D>
cudaError_t launch_tiled(const void* qkv, const void* grad, void* dqkv, float* stats, int B,
                         int seq, int width, int heads, float scale, int causal, int dtype,
                         cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(B * heads, (seq + kTile - 1) / kTile);
  if (dtype == 0) {
    const size_t smem = tiled_f32_smem(D);
    if ((e = set_smem(attention_bwd_q_f32<D>, smem)) != cudaSuccess) return e;
    if ((e = set_smem(attention_bwd_kv_f32<D>, smem)) != cudaSuccess) return e;
    attention_bwd_q_f32<D><<<grid, kTileThreads, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(grad),
        static_cast<float*>(dqkv), stats, seq, width, heads, scale, causal);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    attention_bwd_kv_f32<D><<<grid, kTileThreads, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(grad),
        static_cast<float*>(dqkv), stats, seq, width, heads, scale, causal);
  } else {
    const size_t smem = tiled_bf16_smem(D);
    if ((e = set_smem(attention_bwd_q_bf16<D>, smem)) != cudaSuccess) return e;
    if ((e = set_smem(attention_bwd_kv_bf16<D>, smem)) != cudaSuccess) return e;
    attention_bwd_q_bf16<D><<<grid, kTileThreads, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad), static_cast<bf16*>(dqkv),
        stats, seq, width, heads, scale, causal);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    attention_bwd_kv_bf16<D><<<grid, kTileThreads, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad), static_cast<bf16*>(dqkv),
        stats, seq, width, heads, scale, causal);
  }
  return cudaGetLastError();
}

template <int D, int KC>
cudaError_t launch(const void* qkv, const void* grad, void* dqkv, int B, int seq, int width,
                   int heads, float scale, int causal, int dtype, cudaStream_t stream) {
  cudaError_t e;
  const int threads = round16(seq) / 16 * 32;  // a warp per 16-row tile
  if (dtype == 0) {
    const size_t smem = f32_smem(seq, D);
    if ((e = set_smem(attention_bwd_f32<D, KC>, smem)) != cudaSuccess) return e;
    attention_bwd_f32<D, KC><<<B * heads, threads * f32_split(KC, D), smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(grad),
        static_cast<float*>(dqkv), seq, width, heads, scale, causal);
  } else {
    const size_t smem = bf16_smem(seq, D);
    if ((e = set_smem(attention_bwd_bf16<D, KC>, smem)) != cudaSuccess) return e;
    attention_bwd_bf16<D, KC><<<B * heads, threads, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad), static_cast<bf16*>(dqkv),
        seq, width, heads, scale, causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_kc(const void* qkv, const void* grad, void* dqkv, int B, int seq,
                        int width, int heads, float scale, int causal, int dtype,
                        cudaStream_t s) {
  switch (key_capacity(round16(seq))) {
    case 16: return launch<D, 16>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
    case 32: return launch<D, 32>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
    case 64: return launch<D, 64>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
    case 96: return launch<D, 96>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
    default: return launch<D, 128>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the larger of the two
// types'); the wrapper checks it, and T <= mnt_attention_bwd_max_seq(),
// before launching.
size_t mnt_attention_bwd_smem(int seq, int head_dim) {
  if (seq > kWholeMaxSeq) return std::max(tiled_bf16_smem(head_dim), tiled_f32_smem(head_dim));
  return std::max(bf16_smem(seq, head_dim), f32_smem(seq, head_dim));
}

// The longest sequence the kernels take.
int mnt_attention_bwd_max_seq() { return kMaxSeq; }

// Bytes of fp32 workspace a call needs: the tiled path's (m, l, r) of every
// (row, head, query), 0 up to 128 tokens.
size_t mnt_attention_bwd_workspace(int B, int seq, int heads) {
  return seq > kWholeMaxSeq ? 3 * sizeof(float) * (size_t)B * heads * seq : 0;
}

// qkv: (B, seq, 3*width) contiguous; grad: (B, seq, width) contiguous;
// dqkv: (B, seq, 3*width) contiguous; all of one type, 16-byte aligned.
// workspace: mnt_attention_bwd_workspace(B, seq, heads) bytes (may be null
// when that is 0).  scale: D^-0.5 as the caller rounds it to float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int mnt_attention_bwd(const void* qkv, const void* grad, void* dqkv, void* workspace, int B,
                      int seq, int width, int heads, float scale, int causal, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tiled = seq > kWholeMaxSeq;
  if ((dtype != 0 && dtype != 1) || heads <= 0 || width % heads || seq > kMaxSeq ||
      (tiled && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* ws = static_cast<float*>(workspace);
  cudaError_t e;
  switch (width / heads) {
    case 16:
      e = tiled ? launch_tiled<16>(qkv, grad, dqkv, ws, B, seq, width, heads, scale, causal,
                                   dtype, s)
                : dispatch_kc<16>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
      break;
    case 32:
      e = tiled ? launch_tiled<32>(qkv, grad, dqkv, ws, B, seq, width, heads, scale, causal,
                                   dtype, s)
                : dispatch_kc<32>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
      break;
    case 64:
      e = tiled ? launch_tiled<64>(qkv, grad, dqkv, ws, B, seq, width, heads, scale, causal,
                                   dtype, s)
                : dispatch_kc<64>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, dtype, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
