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
// Above 128 tokens (ViT-L/14: VPT's 273, UPT's 261, 257, and any longer T): P_lp
// and dS of a whole (row, head) no longer fit a block (2 * 288 * 296 * 2 B =
// 341 KB at T = 273), so no T x T tile is kept; the softmax statistics are
// taken in one sweep and the rest is recomputed from them:
// - sweep 1 over 64-key chunks (fp32: 32) keeps each query row's online max
//   m, sum l = sum exp(s - m) and rho = sum exp(s - m) * dP, rescaling l and
//   rho alike when m grows, and ends with r = rho / l (= rowsum(dP * P));
//   sweep 2 forms P = exp(s - m) / l and dP again, rounds dS and
//   accumulates dq = dS . k;
// - the key side, a warp per 16 keys, forms the transposed tile S^T =
//   k . q^T and dP^T = v . g^T, P from the query row's statistics, dv +=
//   P_lp^T . g, dS from its r, dk += dS^T . q, over the query rows in a fixed order
//   (causal: from its own diagonal).  Scores, P and dS are formed by the
//   same expressions on both sides;
// - the rounding points are the ones above: P normalised in fp32 before it
//   is rounded for dv, r from the fp32 P and dP, dS rounded before dq and dk
//   (no rowsum(dO * O) shortcut: O is rounded); one owner per output, no
//   atomics;
// - bf16, one launch: a block per (batch row, head) holds q, k, v and g of
//   all round32(T) rows in shared memory (4 * 320 * 72 * 2 B = 184 KB at
//   T = 320, D = 64, plus 8 bytes of statistics a row), staged with
//   16-byte cp.async in groups (q and g of the first round's rows and the
//   first key chunk, then one group per key chunk, which lands while sweep
//   1 runs, then the other rows' q and g); phase A, a warp per 16 query
//   rows, runs the two sweeps and leaves each row's base-2 log-sum-exp and
//   r * D^-0.5 in shared memory; phase B, after one barrier, a warp per 16
//   keys reads q, g and the statistics where they lie.  The warps are as
//   few as keep every warp's count of 16-row tiles at its least (T = 273:
//   9 warps of 2 tiles; at most 10, which ptxas fits in 168 registers).
//   Every product on the tensor cores; the key side's S^T and dP^T in the
//   accumulator layout are the A fragments of P_lp^T . g and dS^T . q, so
//   no T x T tile touches shared memory.  What bounds it on an H100 is the
//   fp32 work per score (three exponentials of every (query, key) pair, and
//   the rounding of P and dS), not the tensor cores: P = 2^(s * c - lse)
//   costs one FFMA and one MUFU operation, dS one FFMA and one multiply;
// - fp32, two launches of 4-warp blocks over 64-row tiles (a resident head
//   would take 348 KB): the query side streams 32-key chunks of k and v
//   through a 3-stage cp.async ring (chunk c + 2 lands while c computes)
//   and writes dq and each row's (m, 1/l, r) to a (B, H, 3, round64(T))
//   workspace; the key side streams 32-query chunks of q, g and their
//   statistics through the same ring.  Full-fp32 FFMA register tiles, with
//   dS (query side) and P, then dS (key side) of the warp's 16 rows passing
//   through a per-warp buffer; about 95 KB a block, two blocks an SM;
// - bf16 above 320 tokens (ViT-L/14 with a prompt above 63 tokens, 577 at
//   ViT-L/14@336), where the resident head would pass 227 KB: two launches,
//   the resident kernel's phase A and phase B, each a block per (batch row,
//   head, 64-row tile) of 4 warps with one operand pair streamed.  The query
//   side holds the tile's q and g (their A fragments loaded once) and
//   streams 64-key chunks of k and v through a 3-stage cp.async ring, both
//   sweeps as one stream of steps; it writes dq and each row's base-2
//   log-sum-exp and r * D^-0.5 to a (B, H, 2, round64(T)) fp32 workspace.
//   The key side holds the tile's k and v and streams 64-query chunks of q,
//   g and their two statistics (causal: from its own diagonal chunk).
//   Every product on mma.sync m16n8k16, at the resident kernel's rounding
//   points; about 75 KB a block, three blocks an SM.  Nothing depends on T
//   but the grid and the workspace, so every T is taken.

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

constexpr int kWholeMaxSeq = 128;  // up to here one block holds a whole (row, head) and P, dS
// bf16 up to here holds the head resident (184 KB of shared memory at 320);
// above, it takes its own streamed pair (fp32 a pair above kWholeMaxSeq)
constexpr int kResidentMaxSeq = 320;
// T > 128, bf16: the most warps a block takes (10 fit ptxas's 168 registers;
// scripts/k2_resident_warps.py measures other counts on the card), and keys
// per staging group and sweep-1 step
constexpr int kResidentWarps = 10;
constexpr int kChunk = 64;
// The streamed pairs (fp32 above 128 tokens, bf16 above kResidentMaxSeq):
// rows per block, a warp per 16 of them, and stages in the ring; fp32
// streams chunks of kSub rows, bf16 of kChunk
constexpr int kTile = 64;
constexpr int kTileThreads = 128;
constexpr int kSub = 32;
constexpr int kStages = 3;

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

// ------------------------------------------------------------ T > 128

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

// bf16: the whole (row, head) resident, q, g, k and v of round32(T) rows
// (so that 32-row steps stay inside), then each query row's base-2
// log-sum-exp and r * D^-0.5.
size_t resident_bf16_smem(int seq, int D) {
  const size_t tp = (seq + 31) / 32 * 32;
  return 4 * tp * (D + 8) * sizeof(bf16) + 2 * tp * sizeof(float);
}

// Warps of the bf16 kernel: at most kResidentWarps, and as few as keep each
// warp's rounds of 16-row tiles at their least (T = 273: 18 tiles, 9 warps
// of 2), so that no warp waits at the barrier for one with a round more.
__host__ __device__ constexpr int resident_warps(int seq) {
  const int ntiles = round16(seq) / 16, rounds = (ntiles + kResidentWarps - 1) / kResidentWarps;
  return (ntiles + rounds - 1) / rounds;
}

// bf16, 128 < T <= 320: one block per (batch row, head), resident_warps(T)
// warps.  Phase A, a warp per 16 query rows: dq and the row statistics;
// phase B, a warp per 16 keys: dk and dv, from the statistics phase A left
// in shared memory.  The softmax is taken in base 2, D^-0.5 * log2(e)
// folded into the scale: sweep 1 leaves each row's lse = m + log2(l) (+inf
// past T), so that both sides form P = 2^(s * scale2 - lse) with one FFMA
// and one MUFU operation, and dS = P * (dP * D^-0.5 - r * D^-0.5) with one
// more FFMA and a multiply.  Sweep 2 steps 32 keys at a time, so that one
// 16-key tile's products are in flight while the other's elementwise work
// runs.  Sweep 1 evaluates the mask on the tiles that cross T or the
// diagonal, sweep 2 and phase B only on those that cross the diagonal.
template <int D>
__global__ void __launch_bounds__(32 * kResidentWarps, 1)
attention_bwd_resident_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                            bf16* __restrict__ dqkv, int seq, int width, int heads,
                            float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  const int nt = blockDim.x, nw = nt / 32;
  const int tq = round16(seq), tp = (seq + 31) / 32 * 32, ntiles = tq / 16;
  const int nch = (tp + kChunk - 1) / kChunk;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + tp * LD;
  bf16* ks = gs + tp * LD;
  bf16* vs = ks + tp * LD;
  float* st_lse = reinterpret_cast<float*>(vs + tp * LD);
  float* st_rs = st_lse + tp;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // group 0: q and g of round 0's query rows and the first key chunk's k
  // and v; group c: key chunk c, which lands while sweep 1 runs over the
  // chunks before it; group nch: the other query rows' q and g, which land
  // during round 0
  const bf16* gbase = grad + (size_t)b * seq * width + h * D;
  const int rows0 = min(tp, 16 * nw);
  stage_rows<bf16, D>(qs, LD, base, stride, seq, rows0, tid, nt);
  stage_rows<bf16, D>(gs, LD, gbase, width, seq, rows0, tid, nt);
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * kChunk, pad = min(kChunk, tp - c0);
    stage_rows<bf16, D>(ks + c0 * LD, LD, base + width + c0 * stride, stride, seq - c0, pad,
                        tid, nt);
    stage_rows<bf16, D>(vs + c0 * LD, LD, base + 2 * width + c0 * stride, stride, seq - c0,
                        pad, tid, nt);
    cp_async_commit();
  }
  {
    const int r1 = min(rows0, seq - 1);  // (a row inside the tensor: rows >= seq are zero-filled)
    stage_rows<bf16, D>(qs + rows0 * LD, LD, base + r1 * stride, stride, seq - rows0,
                        tp - rows0, tid, nt);
    stage_rows<bf16, D>(gs + rows0 * LD, LD, gbase + (size_t)r1 * width, width, seq - rows0,
                        tp - rows0, tid, nt);
    cp_async_commit();
  }
  // the rows no query tile holds (tq .. tp) read as P = dS = 0 in phase B
  for (int i = tq + tid; i < tp; i += nt) st_lse[i] = INFINITY, st_rs[i] = 0.f;
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;

  // phase A: query tiles warp, warp + nw, ...; every warp takes part in
  // round 0's waits for the key chunks
  for (int round = 0; round * nw < ntiles; ++round) {
    const int t = warp + round * nw, r0 = 16 * t, row0 = r0 + lane / 4;  // rows row0, row0 + 8
    const bool mine = t < ntiles;
    const int kend = causal ? min(seq, r0 + 16) : seq;  // the keys this warp's rows see
    uint32_t qf[D / 16][4], gf[D / 16][4];
    // sweep 1, 64 keys at a time: the online max m (of the raw dots: the
    // scale is positive), sum l and rho = sum of 2^(s * scale2 - m * scale2)
    // * dP, l and rho rescaled alike when m grows (lane-partial sums over a
    // quad-uniform m, reduced after the last chunk)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rho[2] = {0.f, 0.f};
    if (round == 1) {  // the later query rows have landed
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int c = 0; c < nch; ++c) {
      if (round == 0) {
        cp_async_wait_upto(nch - c);
        __syncthreads();
      }
      const int c0 = c * kChunk;
      if (!mine) continue;
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          load_a(qf[kk], qs, LD, r0, 16 * kk, lane);
          load_a(gf[kk], gs, LD, r0, 16 * kk, lane);
        }
      }
      if (c0 >= kend) continue;
      float s[kChunk / 16][2][4], dp[kChunk / 16][2][4];
#pragma unroll
      for (int j = 0; j < kChunk / 16; ++j) {
        const int n0 = c0 + 16 * j;
        if (n0 < kend) {
          dots_bf16<D>(s[j], qf, ks, n0, lane);
          dots_bf16<D>(dp[j], gf, vs, n0, lane);
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][u][e] = dp[j][u][e] = 0.f;
        }
        if (n0 + 16 > seq || (causal && n0 + 15 > r0)) {  // a tile across T or the diagonal
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n0 + 8 * u + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
              const bool valid = n0 < kend && col < seq && (!causal || col <= row);
              s[j][u][e] = valid ? s[j][u][e] : -INFINITY;
            }
        }
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float cm = -INFINITY;
#pragma unroll
        for (int j = 0; j < kChunk / 16; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) cm = fmaxf(cm, fmaxf(s[j][u][2 * e2], s[j][u][2 * e2 + 1]));
        // key 0 is in every row's first chunk, so mn is finite from there on
        const float mn = fmaxf(m[e2], group_max<4>(cm)), mn2 = mn * scale2;
        const float alpha = ex2(m[e2] * scale2 - mn2);
        float ls = 0.f, rs = 0.f;
#pragma unroll
        for (int j = 0; j < kChunk / 16; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 2 * e2; e < 2 * e2 + 2; ++e) {
              const float p = ex2(fmaf(s[j][u][e], scale2, -mn2));
              ls += p;
              rs = fmaf(p, dp[j][u][e], rs);
            }
        l[e2] = fmaf(l[e2], alpha, ls);
        rho[e2] = fmaf(rho[e2], alpha, rs);
        m[e2] = mn;
      }
    }
    if (!mine) continue;
    float lse[2], rs[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const float lsum = group_sum<4>(l[e2]);
      lse[e2] = row0 + 8 * e2 < seq ? fmaf(m[e2], scale2, log2f(lsum)) : INFINITY;  // padded: P = 0
      rs[e2] = group_sum<4>(rho[e2]) / lsum * scale;
    }
    // sweep 2, two 16-key tiles a step: P and dP in fp32, dS rounded
    // straight into the A fragments of dq = dS . k.  Only the causal mask
    // is evaluated: keys past T have zero k rows, so their dS adds exact
    // zeros to dq, and rows past T have lse = +inf, so P = 0
    float dq[D / 8][4] = {};
    for (int n1 = 0; n1 < kend; n1 += 32) {
      float s[2][2][4], dp[2][2][4];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        dots_bf16<D>(s[w], qf, ks, n1 + 16 * w, lane);
        dots_bf16<D>(dp[w], gf, vs, n1 + 16 * w, lane);
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int n0 = n1 + 16 * w;
        const bool edge = causal && n0 + 15 > r0;  // a tile across the diagonal
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * u + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
            const bool valid = !edge || col <= row;
            const float p = valid ? ex2(fmaf(s[w][u][e], scale2, -lse[e >> 1])) : 0.f;
            v[e] = p * fmaf(dp[w][u][e], scale, -rs[e >> 1]);
          }
          a[2 * u] = pack_bf16(v[0], v[1]);
          a[2 * u + 1] = pack_bf16(v[2], v[3]);
        }
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bk[4];
          load_b_cols(bk, ks, LD, n0, 16 * dd, lane);
          mma_bf16(dq[2 * dd], a, bk[0], bk[1]);
          mma_bf16(dq[2 * dd + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = row0 + 8 * e2;
      if (row < seq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(out + row * stride + 8 * n + 2 * (lane & 3)) =
              pack_bf16(dq[n][2 * e2], dq[n][2 * e2 + 1]);
      }
      if ((lane & 3) == 0) st_lse[row] = lse[e2], st_rs[row] = rs[e2];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every row's q, g and statistics are in shared memory

  // phase B: key tiles warp, warp + nw, ..., a 16-query tile a step (the
  // next tile's S^T and dP^T start while this one's dv and dk run); S^T and
  // dP^T in the accumulator layout are the A fragments of P_lp^T . g and
  // dS^T . q.  Only the causal mask is evaluated: queries past T have
  // lse = +inf, so P = dS = 0, and keys past T own dk and dv rows that are
  // never written
  for (int t = warp; t < ntiles; t += nw) {
    const int j0 = 16 * t, key0 = j0 + lane / 4;  // keys key0 and key0 + 8
    uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a(kf[kk], ks, LD, j0, 16 * kk, lane);
      load_a(vf[kk], vs, LD, j0, 16 * kk, lane);
    }
    float dk[D / 8][4] = {}, dv[D / 8][4] = {};
    for (int i0 = causal ? j0 : 0; i0 < seq; i0 += 16) {
      float s[2][4], dp[2][4];
      dots_bf16<D>(s, kf, qs, i0, lane);   // S^T: (key, query)
      dots_bf16<D>(dp, vf, gs, i0, lane);  // dP^T
      const bool edge = causal && j0 + 15 > i0;  // a tile across the diagonal
      uint32_t ap[4], ad[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q0 = i0 + 8 * u + 2 * (lane & 3);  // queries q0, q0 + 1
        const float2 lq = *reinterpret_cast<const float2*>(st_lse + q0);
        const float2 rq = *reinterpret_cast<const float2*>(st_rs + q0);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1), q = q0 + (e & 1);
          const bool valid = !edge || key <= q;
          const float lv = e & 1 ? lq.y : lq.x, rv = e & 1 ? rq.y : rq.x;
          p[e] = valid ? ex2(fmaf(s[u][e], scale2, -lv)) : 0.f;
          ds[e] = p[e] * fmaf(dp[u][e], scale, -rv);
        }
        ap[2 * u] = pack_bf16(p[0], p[1]);
        ap[2 * u + 1] = pack_bf16(p[2], p[3]);
        ad[2 * u] = pack_bf16(ds[0], ds[1]);
        ad[2 * u + 1] = pack_bf16(ds[2], ds[3]);
      }
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
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = key0 + 8 * e2;
      if (row >= seq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(out + row * stride + width + col) =
            pack_bf16(dk[n][2 * e2], dk[n][2 * e2 + 1]);
        *reinterpret_cast<uint32_t*>(out + row * stride + 2 * width + col) =
            pack_bf16(dv[n][2 * e2], dv[n][2 * e2 + 1]);
      }
    }
  }
}

// The fp32 streamed pair (above 128 tokens): the block's 64 rows of two
// operands, a ring of kStages chunks of two 32-row operands and three fp32
// statistics rows (the key side's; the query side leaves them unused), and
// a 16 x (kSub + 4) fp32 buffer per warp.  Rows are padded to D + 4 floats
// (16-byte multiples, free of bank conflicts for the float4 reads).
__host__ __device__ constexpr size_t ring_bytes(int D) {
  return 2 * kSub * (size_t)(D + 4) * sizeof(float) + 3 * kSub * sizeof(float);
}

size_t tiled_smem(int D) {
  return 2 * kTile * (size_t)(D + 4) * sizeof(float) + kStages * ring_bytes(D) +
         4 * 16 * (kSub + 4) * sizeof(float);
}

// the workspace's rows per (batch row, head): T rounded up to the 64-row tile
__host__ __device__ constexpr int stats_rows(int seq) { return (seq + kTile - 1) / kTile * kTile; }

// acc[i][jj] = sum_d a[4ry + i][d] * b[8jj + kx][d]: the warp's 16 rows of
// `a` against the 8 * NS rows of `b`, both row-major with D + 4 floats a
// row.
template <int D, int NS>
__device__ __forceinline__ void dots_tiled(float (&acc)[4][NS], const float* a, const float* b,
                                           int ry, int kx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(x[i], a + (4 * ry + i) * LD + d);
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
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
// the warp's (16, LDW) fp32 buffer against the first n (a multiple of 4)
// rows of a chunk, in the lane's Cols<D> columns.
template <int D, int LDW>
__device__ __forceinline__ void rows_times_tiled(float (&acc)[4][D / 8], const float* w,
                                                 const float* b, int n, int ry, int kx) {
  using C = Cols<D>;
  constexpr int LD = D + 4;
#pragma unroll 2
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

// Query side.  Block (batch row x head, 64-row query tile), a warp per 16
// rows, lane (ry, kx) holding rows r0 + 4ry + i against keys c0 + 8jj + kx;
// the key chunks stream through the ring, sweep 1 (the statistics) and
// sweep 2 (dS, dq) one after the other, so that chunk step + 2 is staged
// while step computes.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 2)
attention_bwd_q_tiled(const float* __restrict__ qkv, const float* __restrict__ grad,
                      float* __restrict__ dqkv, float* __restrict__ stats, int seq, int width,
                      int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int LD = D + 4, NS = kSub / 8, LDW = kSub + 4;
  constexpr size_t RING = ring_bytes(D);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ry = lane / 8, kx = lane % 8;
  float* qs = reinterpret_cast<float*>(smem_raw);  // the block's query rows
  float* gs = qs + kTile * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(gs + kTile * LD);  // keys, values
  float* ws = reinterpret_cast<float*>(ring + kStages * RING) + warp * 16 * LDW;  // its dS

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, rb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int r0 = rb + 16 * warp, row0 = r0 + 4 * ry;  // rows row0 .. row0 + 3
  const bool active = r0 < seq;
  const int kend = causal ? min(seq, r0 + 16) : seq;
  const int nch = ((causal ? min(seq, rb + kTile) : seq) + kSub - 1) / kSub, steps = 2 * nch;
  auto stage = [&](int step) {
    const int c0 = (step % nch) * kSub;
    float* dst = reinterpret_cast<float*>(ring + (step % kStages) * RING);
    stage_rows<float, D>(dst, LD, base + width + c0 * stride, stride, seq - c0, kSub, tid,
                         kTileThreads);
    stage_rows<float, D>(dst + kSub * LD, LD, base + 2 * width + c0 * stride, stride, seq - c0,
                         kSub, tid, kTileThreads);
  };
  stage_rows<float, D>(qs, LD, base + rb * stride, stride, seq - rb, kTile, tid, kTileThreads);
  stage_rows<float, D>(gs, LD, grad + ((size_t)b * seq + rb) * width + h * D, width, seq - rb,
                       kTile, tid, kTileThreads);
  stage(0);
  cp_async_commit();
  stage(1);
  cp_async_commit();

  float m[4], l[4], rho[4], inv_l[4], r[4], dq[4][C::kPer] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = rho[i] = inv_l[i] = r[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<1>();  // this step's chunk has landed
    __syncthreads();     // ... for every thread; and step - 1's stage is free
    if (step + 2 < steps) stage(step + 2);
    cp_async_commit();
    if (!active) continue;
    if (step == nch) {  // sweep 1 is done: reduce over the row's 8 lanes
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lsum = group_sum<8>(l[i]);
        inv_l[i] = row0 + i < seq ? 1.f / lsum : 0.f;  // padded rows: P = 0
        r[i] = group_sum<8>(rho[i]) / lsum;
      }
    }
    const int c0 = (step % nch) * kSub;
    if (c0 >= kend) continue;
    const float* ks = reinterpret_cast<const float*>(ring + (step % kStages) * RING);
    const float* vs = ks + kSub * LD;
    float s[4][NS], dp[4][NS];
    dots_tiled<D, NS>(s, qs + 16 * warp * LD, ks, ry, kx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int col = c0 + 8 * jj + kx;
        const bool valid = col < seq && (!causal || col <= row0 + i);
        s[i][jj] = valid ? s[i][jj] * scale : -INFINITY;
      }
    dots_tiled<D, NS>(dp, gs + 16 * warp * LD, vs, ry, kx);
    if (step < nch) {  // sweep 1: online m, l, rho (key 0 keeps m finite)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float cm = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) cm = fmaxf(cm, s[i][jj]);
        const float mn = fmaxf(m[i], group_max<8>(cm)), alpha = expf(m[i] - mn);
        float ls = 0.f, rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          const float p = expf(s[i][jj] - mn);
          ls += p;
          rs = fmaf(p, dp[i][jj], rs);
        }
        l[i] = fmaf(l[i], alpha, ls);
        rho[i] = fmaf(rho[i], alpha, rs);
        m[i] = mn;
      }
      continue;
    }
    // sweep 2: dS of the warp's rows through its buffer, then dq += dS . k
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const float p = expf(s[i][jj] - m[i]) * inv_l[i];
        ws[(4 * ry + i) * LDW + 8 * jj + kx] = p * (dp[i][jj] - r[i]) * scale;
      }
    __syncwarp();
    rows_times_tiled<D, LDW>(dq, ws, ks, (min(kSub, kend - c0) + 3) / 4 * 4, ry, kx);
    __syncwarp();
  }
  // dq, and (m, 1/l, r) of every row of the tile (zeros past the warps
  // that hold a row), which the key side reads
  float* out = dqkv + (size_t)b * seq * stride + h * D;
  const int tw = stats_rows(seq);
  float* st = stats + (size_t)blockIdx.x * 3 * tw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (active && row < seq) {
#pragma unroll
      for (int u = 0; u < C::kRuns; ++u)
        store_vec<C::kVec>(out + row * stride + C::col(u, kx), dq[i] + u * C::kVec);
    }
    if (kx == 0) {
      st[row] = active ? m[i] : 0.f;
      st[tw + row] = inv_l[i];
      st[2 * tw + row] = r[i];
    }
  }
}

// Key side: lane (ry, kx) holds keys j0 + 4ry + t against queries
// i0c + 8jj + kx; the query chunks and their statistics stream through the
// ring (chunk c + 2 staged while c computes); P, then dS (from P, kept in
// registers), of the warp's keys pass through its buffer.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 2)
attention_bwd_kv_tiled(const float* __restrict__ qkv, const float* __restrict__ grad,
                       float* __restrict__ dqkv, const float* __restrict__ stats, int seq,
                       int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int LD = D + 4, NS = kSub / 8, LDW = kSub + 4;
  constexpr size_t RING = ring_bytes(D);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, ry = lane / 8, kx = lane % 8;
  float* ks = reinterpret_cast<float*>(smem_raw);  // the block's keys
  float* vs = ks + kTile * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kTile * LD);  // queries, g, stats
  float* ws = reinterpret_cast<float*>(ring + kStages * RING) + warp * 16 * LDW;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, jb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const float* gbase = grad + (size_t)b * seq * width + h * D;
  const int tw = stats_rows(seq);
  const float* st = stats + (size_t)blockIdx.x * 3 * tw;
  // causal: query chunks before the block's first key see none of its keys
  const int first = causal ? jb / kSub : 0, nch = (seq + kSub - 1) / kSub;
  auto stage = [&](int c) {
    const int i0c = c * kSub;
    unsigned char* slot = ring + ((c - first) % kStages) * RING;
    float* dst = reinterpret_cast<float*>(slot);
    stage_rows<float, D>(dst, LD, base + i0c * stride, stride, seq - i0c, kSub, tid,
                         kTileThreads);
    stage_rows<float, D>(dst + kSub * LD, LD, gbase + (size_t)i0c * width, width, seq - i0c,
                         kSub, tid, kTileThreads);
    // the statistics rows run to stats_rows(seq) >= i0c + kSub
    float* sdst = reinterpret_cast<float*>(dst + 2 * kSub * LD);
    for (int idx = tid; idx < 3 * kSub / 4; idx += kTileThreads) {
      const int a = idx / (kSub / 4), o = 4 * (idx % (kSub / 4));
      cp_async16(sdst + a * kSub + o, st + a * tw + i0c + o, true);
    }
  };
  stage_rows<float, D>(ks, LD, base + width + jb * stride, stride, seq - jb, kTile, tid,
                       kTileThreads);
  stage_rows<float, D>(vs, LD, base + 2 * width + jb * stride, stride, seq - jb, kTile, tid,
                       kTileThreads);
  stage(first);
  cp_async_commit();
  if (first + 1 < nch) stage(first + 1);
  cp_async_commit();

  const int j0 = jb + 16 * warp, key0 = j0 + 4 * ry;  // keys key0 .. key0 + 3
  const bool active = j0 < seq;
  float dk[4][C::kPer] = {}, dv[4][C::kPer] = {};
  for (int c = first; c < nch; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    if (c + 2 < nch) stage(c + 2);
    cp_async_commit();
    const int i0c = c * kSub;
    // (causal: every query of the chunk is before the warp's keys)
    if (!active || (causal && i0c + kSub <= j0)) continue;
    const float* qs = reinterpret_cast<const float*>(ring + ((c - first) % kStages) * RING);
    const float* gs = qs + kSub * LD;
    const float* sts = reinterpret_cast<const float*>(gs + kSub * LD);  // m, 1/l, r
    const int n4 = (min(kSub, seq - i0c) + 3) / 4 * 4;
    float s[4][NS], p[4][NS];
    dots_tiled<D, NS>(s, ks + 16 * warp * LD, qs, ry, kx);  // S^T: (key, query)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int qi = 8 * jj + kx, key = key0 + t;
        const bool valid = key < seq && i0c + qi < seq && (!causal || key <= i0c + qi);
        p[t][jj] = valid ? expf(s[t][jj] * scale - sts[qi]) * sts[kSub + qi] : 0.f;
        ws[(4 * ry + t) * LDW + qi] = p[t][jj];
      }
    __syncwarp();
    rows_times_tiled<D, LDW>(dv, ws, gs, n4, ry, kx);
    __syncwarp();
    dots_tiled<D, NS>(s, vs + 16 * warp * LD, gs, ry, kx);  // dP^T
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int qi = 8 * jj + kx;
        ws[(4 * ry + t) * LDW + qi] = p[t][jj] * (s[t][jj] - sts[2 * kSub + qi]) * scale;
      }
    __syncwarp();
    rows_times_tiled<D, LDW>(dk, ws, qs, n4, ry, kx);
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

// ------------------------------------------------ bf16, T > kResidentMaxSeq

// The bf16 streamed pair: the resident kernel's phase A (query side) and
// phase B (key side), each a launch of blocks over one 64-row tile with one
// operand pair streamed in 64-row chunks through a ring of kStages stages.
// A stage holds 64 rows of two operands (k and v, or q and g; D + 8 bf16 a
// row) and, on the key side, the chunk's lse and r * D^-0.5 (64 floats
// each); the block's own two operands stay resident (75 KB at D = 64,
// three blocks an SM).
__host__ __device__ constexpr size_t bf16_stage_bytes(int D) {
  return 2 * kChunk * (size_t)(D + 8) * sizeof(bf16) + 2 * kChunk * sizeof(float);
}

size_t bf16_streamed_smem(int D) {
  return 2 * kTile * (size_t)(D + 8) * sizeof(bf16) + kStages * bf16_stage_bytes(D);
}

// Query side.  Block (batch row x head, 64-query tile), a warp per 16 rows
// with the A fragments of its q and g rows loaded once.  The key chunks
// stream through the ring as one stream of 2 * nch steps (causal: up to the
// block's last row's diagonal), chunk step + 2 staged while step computes:
// sweep 1 keeps the online m, l and rho in base 2 (updated every 32 keys),
// sweep 2 forms P = 2^(s * scale2 - lse), dP and dS = P * (dP * D^-0.5 -
// r * D^-0.5) rounded straight into the A fragments of dq = dS . k.  Every row of the tile
// leaves lse (+inf past T: P = 0) and r * D^-0.5 in the workspace.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 3)
attention_bwd_q_streamed_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                              bf16* __restrict__ dqkv, float* __restrict__ stats, int seq,
                              int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  constexpr size_t SB = bf16_stage_bytes(D);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // the block's query rows
  bf16* gs = qs + kTile * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(gs + kTile * LD);  // k, v

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, rb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int r0 = rb + 16 * warp, row0 = r0 + lane / 4;  // rows row0 and row0 + 8
  const bool active = r0 < seq;
  const int kend = causal ? min(seq, r0 + 16) : seq;  // the keys this warp's rows see
  const int nch = ((causal ? min(seq, rb + kTile) : seq) + kChunk - 1) / kChunk;
  const int steps = 2 * nch;
  auto stage = [&](int step) {
    if (step >= steps) return;
    const int c0 = (step < nch ? step : step - nch) * kChunk;
    bf16* dst = reinterpret_cast<bf16*>(ring + (step % kStages) * SB);
    stage_rows<bf16, D>(dst, LD, base + width + c0 * stride, stride, seq - c0, kChunk, tid,
                        kTileThreads);
    stage_rows<bf16, D>(dst + kChunk * LD, LD, base + 2 * width + c0 * stride, stride, seq - c0,
                        kChunk, tid, kTileThreads);
  };
  stage_rows<bf16, D>(qs, LD, base + rb * stride, stride, seq - rb, kTile, tid, kTileThreads);
  stage_rows<bf16, D>(gs, LD, grad + ((size_t)b * seq + rb) * width + h * D, width, seq - rb,
                      kTile, tid, kTileThreads);
  stage(0);
  cp_async_commit();
  stage(1);
  cp_async_commit();

  uint32_t qf[D / 16][4], gf[D / 16][4];
  // sweep 1: the online max m (of the raw dots: the scale is positive), sum
  // l and rho = sum of 2^(s * scale2 - m * scale2) * dP, l and rho rescaled
  // alike when m grows (lane-partial sums over a quad-uniform m)
  // (from sweep 2 on, m and rho hold each row's lse and r * D^-0.5)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rho[2] = {0.f, 0.f};
  float dq[D / 8][4] = {};
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<1>();  // this step's chunk has landed
    __syncthreads();     // ... for every thread; and step - 1's stage is free
    stage(step + 2);
    cp_async_commit();
    if (!active) continue;
    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(qf[kk], qs, LD, 16 * warp, 16 * kk, lane);
        load_a(gf[kk], gs, LD, 16 * warp, 16 * kk, lane);
      }
    }
    if (step == nch) {  // sweep 1 is done: lse (+inf past T: P = 0) and r * D^-0.5
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const float lsum = group_sum<4>(l[e2]);
        rho[e2] = group_sum<4>(rho[e2]) / lsum * scale;
        m[e2] = row0 + 8 * e2 < seq ? fmaf(m[e2], scale2, log2f(lsum)) : INFINITY;
      }
    }
    const int c0 = (step < nch ? step : step - nch) * kChunk;
    if (c0 >= kend) continue;
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (step % kStages) * SB);
    const bf16* vs = ks + kChunk * LD;
    if (step < nch) {
      // 32 keys at a time (two 16-key tiles), so that few scores are live
#pragma unroll 1
      for (int n1 = 0; n1 < kChunk && c0 + n1 < kend; n1 += 32) {
        float s[2][2][4], dp[2][2][4];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int n0 = c0 + n1 + 16 * w;
          if (n0 < kend) {
            dots_bf16<D>(s[w], qf, ks, n1 + 16 * w, lane);
            dots_bf16<D>(dp[w], gf, vs, n1 + 16 * w, lane);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[w][u][e] = dp[w][u][e] = 0.f;
          }
          if (n0 + 16 > seq || (causal && n0 + 15 > r0) || n0 >= kend) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = n0 + 8 * u + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
                const bool valid = n0 < kend && col < seq && (!causal || col <= row);
                s[w][u][e] = valid ? s[w][u][e] : -INFINITY;
              }
          }
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float cm = -INFINITY;
#pragma unroll
          for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int u = 0; u < 2; ++u)
              cm = fmaxf(cm, fmaxf(s[w][u][2 * e2], s[w][u][2 * e2 + 1]));
          // key 0 is in every row's first step, so mn is finite from there on
          const float mn = fmaxf(m[e2], group_max<4>(cm)), mn2 = mn * scale2;
          const float alpha = ex2(m[e2] * scale2 - mn2);
          float ls = 0.f, rsum = 0.f;
#pragma unroll
          for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 2 * e2; e < 2 * e2 + 2; ++e) {
                const float p = ex2(fmaf(s[w][u][e], scale2, -mn2));
                ls += p;
                rsum = fmaf(p, dp[w][u][e], rsum);
              }
          l[e2] = fmaf(l[e2], alpha, ls);
          rho[e2] = fmaf(rho[e2], alpha, rsum);
          m[e2] = mn;
        }
      }
      continue;
    }
    // sweep 2, two 16-key tiles a step: P and dP in fp32, dS rounded
    // straight into the A fragments of dq = dS . k.  Keys past T (zero k
    // and v rows) are masked on the tile that crosses T
    const int nk = min(kChunk, kend - c0);
#pragma unroll 1
    for (int n1 = 0; n1 < nk; n1 += 32) {
      float s[2][2][4], dp[2][2][4];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        dots_bf16<D>(s[w], qf, ks, n1 + 16 * w, lane);
        dots_bf16<D>(dp[w], gf, vs, n1 + 16 * w, lane);
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int n0 = c0 + n1 + 16 * w;
        const bool edge = n0 + 16 > seq || (causal && n0 + 15 > r0);
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * u + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
            const bool valid = !edge || (col < seq && (!causal || col <= row));
            const float p = valid ? ex2(fmaf(s[w][u][e], scale2, -m[e >> 1])) : 0.f;
            v[e] = p * fmaf(dp[w][u][e], scale, -rho[e >> 1]);
          }
          a[2 * u] = pack_bf16(v[0], v[1]);
          a[2 * u + 1] = pack_bf16(v[2], v[3]);
        }
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bk[4];
          load_b_cols(bk, ks, LD, n1 + 16 * w, 16 * dd, lane);
          mma_bf16(dq[2 * dd], a, bk[0], bk[1]);
          mma_bf16(dq[2 * dd + 1], a, bk[2], bk[3]);
        }
      }
    }
  }
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;
  const int tw = stats_rows(seq);
  float* st = stats + (size_t)blockIdx.x * 2 * tw;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row0 + 8 * e2;
    if (active && row < seq) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + row * stride + 8 * n + 2 * (lane & 3)) =
            pack_bf16(dq[n][2 * e2], dq[n][2 * e2 + 1]);
    }
    if ((lane & 3) == 0) st[row] = active ? m[e2] : INFINITY, st[tw + row] = rho[e2];
  }
}

// Key side.  Block (batch row x head, 64-key tile), a warp per 16 keys with
// the A fragments of its k and v rows loaded once.  The query chunks, with
// their lse and r * D^-0.5, stream through the ring (causal: from the
// block's own diagonal chunk), chunk c + 2 staged while c computes; a warp
// takes its chunk's 16-query tiles in order (causal: from its own
// diagonal).  S^T = k . q^T and dP^T = v . g^T in the accumulator layout
// are the A fragments of P_lp^T . g and dS^T . q, so no T x T tile touches
// shared memory.  Queries past T have lse = +inf, so P = dS = 0; keys past
// T own dk and dv rows that are never written.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 3)
attention_bwd_kv_streamed_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                               bf16* __restrict__ dqkv, const float* __restrict__ stats,
                               int seq, int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  constexpr size_t SB = bf16_stage_bytes(D);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // the block's keys
  bf16* vs = ks + kTile * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kTile * LD);  // q, g, statistics

  const int b = blockIdx.x / heads, h = blockIdx.x % heads, jb = kTile * blockIdx.y;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const bf16* gbase = grad + (size_t)b * seq * width + h * D;
  const int tw = stats_rows(seq);
  const float* st = stats + (size_t)blockIdx.x * 2 * tw;
  // causal: query chunks before the block's first key see none of its keys
  const int first = causal ? jb / kChunk : 0, nch = (seq + kChunk - 1) / kChunk;
  auto stage = [&](int c) {
    if (c >= nch) return;
    const int c0 = c * kChunk;
    bf16* dst = reinterpret_cast<bf16*>(ring + ((c - first) % kStages) * SB);
    stage_rows<bf16, D>(dst, LD, base + c0 * stride, stride, seq - c0, kChunk, tid,
                        kTileThreads);
    stage_rows<bf16, D>(dst + kChunk * LD, LD, gbase + (size_t)c0 * width, width, seq - c0,
                        kChunk, tid, kTileThreads);
    // the statistics rows run to stats_rows(seq) >= c0 + kChunk
    float* sdst = reinterpret_cast<float*>(dst + 2 * kChunk * LD);
    for (int idx = tid; idx < 2 * kChunk / 4; idx += kTileThreads) {
      const int a = idx / (kChunk / 4), o = 4 * (idx % (kChunk / 4));
      cp_async16(sdst + a * kChunk + o, st + a * tw + c0 + o, true);
    }
  };
  stage_rows<bf16, D>(ks, LD, base + width + jb * stride, stride, seq - jb, kTile, tid,
                      kTileThreads);
  stage_rows<bf16, D>(vs, LD, base + 2 * width + jb * stride, stride, seq - jb, kTile, tid,
                      kTileThreads);
  stage(first);
  cp_async_commit();
  stage(first + 1);
  cp_async_commit();

  const int j0 = jb + 16 * warp, key0 = j0 + lane / 4;  // keys key0 and key0 + 8
  const bool active = j0 < seq;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int c = first; c < nch; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    stage(c + 2);
    cp_async_commit();
    if (!active) continue;
    if (c == first) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(kf[kk], ks, LD, 16 * warp, 16 * kk, lane);
        load_a(vf[kk], vs, LD, 16 * warp, 16 * kk, lane);
      }
    }
    const int c0 = c * kChunk;
    const bf16* qs = reinterpret_cast<const bf16*>(ring + ((c - first) % kStages) * SB);
    const bf16* gs = qs + kChunk * LD;
    const float* st_lse = reinterpret_cast<const float*>(gs + kChunk * LD);
    const float* st_rs = st_lse + kChunk;
    const int iend = min(kChunk, seq - c0);
    for (int i1 = causal ? max(0, j0 - c0) : 0; i1 < iend; i1 += 16) {
      const int i0 = c0 + i1;
      float s[2][4], dp[2][4];
      dots_bf16<D>(s, kf, qs, i1, lane);   // S^T: (key, query)
      dots_bf16<D>(dp, vf, gs, i1, lane);  // dP^T
      const bool edge = causal && j0 + 15 > i0;  // a tile across the diagonal
      uint32_t ap[4], ad[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q1 = i1 + 8 * u + 2 * (lane & 3);  // queries c0 + q1, c0 + q1 + 1
        const float2 lq = *reinterpret_cast<const float2*>(st_lse + q1);
        const float2 rq = *reinterpret_cast<const float2*>(st_rs + q1);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1), q = c0 + q1 + (e & 1);
          const bool valid = !edge || key <= q;
          const float lv = e & 1 ? lq.y : lq.x, rv = e & 1 ? rq.y : rq.x;
          p[e] = valid ? ex2(fmaf(s[u][e], scale2, -lv)) : 0.f;
          ds[e] = p[e] * fmaf(dp[u][e], scale, -rv);
        }
        ap[2 * u] = pack_bf16(p[0], p[1]);
        ap[2 * u + 1] = pack_bf16(p[2], p[3]);
        ad[2 * u] = pack_bf16(ds[0], ds[1]);
        ad[2 * u + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bg[4], bq[4];
        load_b_cols(bg, gs, LD, i1, 16 * dd, lane);
        load_b_cols(bq, qs, LD, i1, 16 * dd, lane);
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
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = key0 + 8 * e2;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(out + row * stride + width + col) =
          pack_bf16(dk[n][2 * e2], dk[n][2 * e2 + 1]);
      *reinterpret_cast<uint32_t*>(out + row * stride + 2 * width + col) =
          pack_bf16(dv[n][2 * e2], dv[n][2 * e2 + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem_shared_carveout(Kernel kernel, size_t bytes) {
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  // several blocks of a streamed pair's kernel share an SM only with the largest carveout
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A streamed pair on one stream: the query side (dq and the row
// statistics), then the key side (dk, dv), on 64-row tiles.
template <typename T, typename Kq, typename Kkv>
cudaError_t launch_pair(Kq q_side, Kkv kv_side, size_t smem, const void* qkv, const void* grad,
                        void* dqkv, float* stats, int B, int seq, int width, int heads,
                        float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(B * heads, stats_rows(seq) / kTile);
  if ((e = set_smem_shared_carveout(q_side, smem)) != cudaSuccess) return e;
  if ((e = set_smem_shared_carveout(kv_side, smem)) != cudaSuccess) return e;
  q_side<<<grid, kTileThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                               static_cast<const T*>(grad), static_cast<T*>(dqkv),
                                               stats, seq, width, heads, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kv_side<<<grid, kTileThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                                static_cast<const T*>(grad),
                                                static_cast<T*>(dqkv), stats, seq, width, heads,
                                                scale, causal);
  return cudaGetLastError();
}

// T > 128: bf16 in one launch up to kResidentMaxSeq (the resident kernel),
// its streamed pair above; fp32 always the fp32 streamed pair.
template <int D>
cudaError_t launch_tiled(const void* qkv, const void* grad, void* dqkv, float* stats, int B,
                         int seq, int width, int heads, float scale, int causal, int dtype,
                         cudaStream_t stream) {
  if (dtype == 0) {
    return launch_pair<float>(attention_bwd_q_tiled<D>, attention_bwd_kv_tiled<D>, tiled_smem(D),
                              qkv, grad, dqkv, stats, B, seq, width, heads, scale, causal,
                              stream);
  }
  if (seq > kResidentMaxSeq) {
    return launch_pair<bf16>(attention_bwd_q_streamed_bf16<D>, attention_bwd_kv_streamed_bf16<D>,
                             bf16_streamed_smem(D), qkv, grad, dqkv, stats, B, seq, width, heads,
                             scale, causal, stream);
  }
  cudaError_t e;
  const size_t smem = resident_bf16_smem(seq, D);
  if ((e = set_smem(attention_bwd_resident_bf16<D>, smem)) != cudaSuccess) return e;
  attention_bwd_resident_bf16<D><<<B * heads, 32 * resident_warps(seq), smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad), static_cast<bf16*>(dqkv),
      seq, width, heads, scale, causal);
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
// types'); the wrapper checks it before launching.  Above kResidentMaxSeq
// it no longer depends on seq.
size_t mnt_attention_bwd_smem(int seq, int head_dim) {
  if (seq > kResidentMaxSeq) {
    return std::max(bf16_streamed_smem(head_dim), tiled_smem(head_dim));
  }
  if (seq > kWholeMaxSeq) {
    return std::max(resident_bf16_smem(seq, head_dim), tiled_smem(head_dim));
  }
  return std::max(bf16_smem(seq, head_dim), f32_smem(seq, head_dim));
}

// The longest seq bf16 holds resident; above it both types take the
// streamed pair (the wrapper counts those launches apart).
int mnt_attention_bwd_resident_max_seq() { return kResidentMaxSeq; }

// Warps per block of the kernel (or kernel pair) that takes (seq, head_dim, dtype).
int mnt_attention_bwd_warps(int seq, int head_dim, int dtype) {
  if (seq > kWholeMaxSeq) {
    return dtype == 1 && seq <= kResidentMaxSeq ? resident_warps(seq) : kTileThreads / 32;
  }
  const int tp = round16(seq);
  return tp / 16 * (dtype == 0 ? f32_split(key_capacity(tp), head_dim) : 1);
}

// Bytes of fp32 workspace a call needs: the streamed pair's row statistics
// for every (row, head, query), queries rounded up to 64: (m, 1/l, r) for
// fp32 above 128 tokens, (lse, r * D^-0.5) for bf16 above kResidentMaxSeq;
// 0 otherwise.
size_t mnt_attention_bwd_workspace(int B, int seq, int heads, int dtype) {
  const size_t rows = (size_t)B * heads * stats_rows(seq);
  if (dtype == 0) return seq > kWholeMaxSeq ? 3 * sizeof(float) * rows : 0;
  return seq > kResidentMaxSeq ? 2 * sizeof(float) * rows : 0;
}

// qkv: (B, seq, 3*width) contiguous; grad: (B, seq, width) contiguous;
// dqkv: (B, seq, 3*width) contiguous; all of one type, 16-byte aligned.
// workspace: mnt_attention_bwd_workspace(B, seq, heads, dtype) bytes,
// 16-byte aligned (may be null when that is 0).  scale: D^-0.5 as the
// caller rounds it to float32.  dtype: 0 = float32, 1 = bfloat16.  Returns
// a cudaError_t (0 on success).
int mnt_attention_bwd(const void* qkv, const void* grad, void* dqkv, void* workspace, int B,
                      int seq, int width, int heads, float scale, int causal, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tiled = seq > kWholeMaxSeq;
  if ((dtype != 0 && dtype != 1) || heads <= 0 || width % heads ||
      (mnt_attention_bwd_workspace(B, seq, heads, dtype) && workspace == nullptr)) {
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
