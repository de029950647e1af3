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
// ViT-L/14's T = 273 bf16 is still below that line (~195 per byte).  An
// fp32-accurate product on the tensor cores is three TF32 products
// (3xTF32), so fp32's least time for the operations is 3 x FLOPs at the
// TF32 rate (494 TFLOP/s), under FLOPs at the FMA rate (67 TFLOP/s): up to
// 128 tokens fp32 is still bound by memory (ViT-B/32 vision at B = 256:
// 0.082 ms of bytes against 0.030 of 3xTF32 operations), above it by
// operations.  Every fp32 kernel below runs every product as 3xTF32.
//
// Design, one block per (batch row, head), T <= 128, a warp per 16-row tile:
// - staging: q and k rows, then v and g rows in a second group that lands
//   while S runs, with 16-byte cp.async copies (rows past T zero-filled),
//   read from the fused layout in place, rows padded against bank conflicts;
// - the key capacity KC is a template parameter, as in K1: bf16 the
//   smallest of 16, 32, 64, 96 and 128 that holds T, fp32 round16(T);
// - bf16, pass 1, each warp owns 16 query rows: it recomputes S and P,
//   then dP, r = rowsum(dP * P) and dS, and forms dq = dS . k; it leaves
//   P_lp and dS in shared memory; pass 2, after a barrier, each warp owns
//   16 key rows and forms dv = P_lp^T . g and dk = dS^T . q over the query
//   rows, in a fixed order.  Every product on the tensor cores (mma.sync
//   m16n8k16, bf16 operands, fp32 accumulators, ldmatrix / ldmatrix.trans
//   from shared memory); S and P stay in registers (16 x 128 fp32 per warp
//   at most), dP is formed twice (once for r, once for dS) rather than
//   held, dS is rounded straight into the A fragments of dS . k; P_lp and
//   dS, bf16, take 2 * T^2 * 2 bytes (74 KB of shared memory in all at
//   T = 66);
// - fp32, every product as 3xTF32 on mma.sync m16n8k8 (split_tf32,
//   mma_3xtf32), two phases and no T x T tile in shared memory: phase A, a
//   warp per 16 query rows, holds S, then P, and dP in its accumulators
//   (the exact row max and sum, since every key fits; base 2, each row's
//   lse and r * D^-0.5 left in shared memory) and forms dq = dS . k with
//   dS taken from the accumulators; phase B, after one barrier, a warp per
//   16 keys forms S^T and dP^T in the accumulators, P^T and dS^T from the
//   statistics, and dv = P^T . g, dk = dS^T . q with the same accumulators
//   as A fragments (keys 2q, 2q + 1 of a tile as the fragment's k = q,
//   q + 4, the B rows read in that order): seven products of T x T x D
//   where the least is five.  Shared memory holds q, k, v and g (4 x
//   round16(T) x (D + 4) floats: 70 KB at T = 50, 87 KB at T = 77, three
//   and two blocks an SM).  Register tiles on the FMA units, with dP, dS and P as T x T
//   fp32 tiles in shared memory (114 KB at T = 77, one block an SM), would
//   be bound by the FMA rate and by residency;
// - causal rows skip whole key tiles above the diagonal, and the key side
//   skips the query tiles above it; masked and padded entries give
//   P = dS = 0.
//
// Above 128 tokens (ViT-L/14: VPT's 273, UPT's 261, 257, and any longer T): P_lp
// and dS of a whole (row, head) no longer fit a block (2 * 288 * 296 * 2 B =
// 341 KB at T = 273), so no T x T tile is kept; the softmax statistics are
// taken in one sweep and the rest is recomputed from them, in base 2
// (D^-0.5 * log2(e) folded into the scale, every exponential one ex2):
// - sweep 1 (64-key steps resident and in the bf16 pair, 32-key steps in
//   the fp32 pair) keeps each query row's online max m, sum l = sum
//   2^(s - m) and rho = sum 2^(s - m) * dP, rescaling l and rho alike when
//   m grows, and ends with
//   lse = m + log2(l) and r = rho / l (= rowsum(dP * P)); sweep 2 forms
//   P = 2^(s - lse) and dP again, rounds dS and accumulates dq = dS . k;
// - the key side (a warp per 16 keys, or a warpgroup per 64) forms the
//   transposed tile S^T =
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
// - fp32, two launches (a resident head would take 348 KB) on Hopper's
//   warpgroup MMA, every product as 3xTF32 (wgmma m64nNk8 tf32; x = hi +
//   lo, hi rounded to TF32, lo.hi + hi.lo + hi.hi): a block is one
//   warpgroup owning 64 rows of the resident side and streams the other
//   side in 32-row chunks.  The query side forms S and dP, then dq += dS . K
//   with dS's fragments taken from the accumulators; it writes dq and each
//   row's lse and r * D^-0.5 to a (B, H, 2, round64(T)) workspace (the
//   bf16 pair's).  The key side forms S^T and dP^T, then dv += P^T . g and
//   dk += dS^T . q.  32-bit wgmma operands are K-major only and B comes only
//   from shared memory, so the streamed rows live there as TF32 hi and lo
//   planes in the swizzled layout wgmma reads, and transposed (written
//   through registers in the A fragments' k order) for the products whose B
//   is their columns; the resident rows' hi parts are held as A fragments
//   in registers and their lo parts as planes.  No T x T tile touches shared
//   memory.  113 KB a block at D = 64, two blocks an SM.  mma.sync m16n8k8
//   left this pair issue-bound at two warps a scheduler (0.09-0.16 of its
//   bound), each product costing ~3.6 other instructions;
// - bf16 above 320 tokens (ViT-L/14 with a prompt above 63 tokens, 577 at
//   ViT-L/14@336), where the resident head would pass 227 KB: two launches
//   on Hopper's warpgroup MMA (wgmma m64nNk16), each a block per (batch
//   row, head, 64-row tile) of one warpgroup with the other side streamed
//   in 64-row chunks through a cp.async ring, every operand in
//   shared memory in the swizzled layout wgmma reads.  The query side holds
//   the tile's q and g and streams (K, V) chunks, both sweeps as one stream
//   of steps: S and dP on SS chains, the statistics once a chunk, then dq
//   += dS . K with dS's A fragments taken from the accumulators and K read
//   with the transpose bit; it writes dq and each row's base-2 log-sum-exp
//   and r * D^-0.5 to a (B, H, 2, round64(T)) fp32 workspace.  The key side
//   holds the tile's K and V and streams (q, g) chunks with their two
//   statistics (causal: from its own diagonal chunk): S^T and dP^T on SS
//   chains, then dv += P^T . g and dk += dS^T . q on RS chains.  Both at
//   the resident kernel's rounding points; 49 and 67 KB a block at D = 64,
//   four and three blocks an SM.
//   Nothing depends on T but the grid and the workspace, so every T is
//   taken.

#include "attention_wgmma.cuh"

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
// The bf16 pair (above kResidentMaxSeq): rows a block (one warpgroup),
// also the workspace's row multiple (the fp32 pair's tiles: kTfRows,
// kTfChunk); then the stages of the key side's ring of kChunk-row chunks
// and the blocks an SM its __launch_bounds__ ask for, and the query
// side's, whose registers leave room for four blocks
constexpr int kTile = 64;
constexpr int kTileThreads = 128;
constexpr int kStages = 3;
constexpr int kPairBlocks = 3;
constexpr int kQStages = 2;
constexpr int kQBlocks = 4;

size_t bf16_smem(int seq, int D) {
  const size_t tp = round16(seq);
  return (4 * tp * (D + 8) + 2 * tp * (tp + 8)) * sizeof(bf16);
}

// fp32: q, k, v and g of round16(T) rows, then each row's lse and r * D^-0.5
size_t f32_smem(int seq, int D) {
  const size_t tp = round16(seq);
  return (4 * tp * (D + 4) + 2 * tp) * sizeof(float);
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

// The fp32 kernel up to kWholeMaxSeq splits every operand by
// split_tf32_trunc (attention_common.cuh), two operations a value: the
// splits are most of its instructions.  ldmatrix reads fp32 rows (an 8 x 8
// matrix of b16 pairs is an 8 x 4 matrix of floats): the A fragment of
// k-step kk of 16 rows as matrices (rows 0-7, 8kk..), (8-15, 8kk..), (0-7,
// 8kk + 4..), (8-15, 8kk + 4..), the B fragments of 16 rows as (rows 0-7,
// 8kk..), (0-7, 8kk + 4..), (8-15, 8kk..), (8-15, 8kk + 4..).
template <int D>
__device__ __forceinline__ void ldsplit_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* a,
                                          int kk, int lane) {
  uint32_t x[4];
  ldmatrix_x4(x, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * (D + 4) + 8 * kk + (lane >> 4) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_trunc(x[e], hi[e], lo[e]);
}

template <int D>
__device__ __forceinline__ void ldsplit_b(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* b,
                                          int kk, int lane) {
  uint32_t y[4];
  ldmatrix_x4(y, b + ((lane & 7) + (lane >> 4) * 8) * (D + 4) + 8 * kk + ((lane >> 3) & 1) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_trunc(y[e], hi[e], lo[e]);
}

// t[0..1] += A . B over one k-step, 3xTF32, for the two n8 tiles of a B
// fragment pair (lo.hi, hi.lo, hi.hi in a tile the caller zeroed)
__device__ __forceinline__ void mma3_pair(float (&t)[2][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                          const uint32_t (&bl)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    mma_tf32(t[n], al, bh[2 * n], bh[2 * n + 1]);
    mma_tf32(t[n], ah, bl[2 * n], bl[2 * n + 1]);
    mma_tf32(t[n], ah, bh[2 * n], bh[2 * n + 1]);
  }
}

// c = A . B^T over D, 3xTF32: the warp's 16 fp32 rows at a against the rows
// of b (D + 4 floats a row) in KC / 16 groups of 16, group j as the n8
// tiles 2j, 2j + 1; the groups at or past nend are left at 0.  Each
// k-step's A fragment is split once for every group; the six products of
// two k-steps are summed in a zeroed tile and then added to c in fp32 (the
// tensor cores' adders truncate).
template <int D, int KC>
__device__ __forceinline__ void dots_rows_tf32(float (&c)[KC / 8][4], const float* a,
                                               const float* b, int nend, int lane) {
#pragma unroll
  for (int n = 0; n < KC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) ldsplit_a<D>(ah[u], al[u], a, k0 + u, lane);
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      if (16 * j >= nend) continue;
      float t[2][4] = {};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t bh[4], bl[4];
        ldsplit_b<D>(bh, bl, b + 16 * j * (D + 4), k0 + u, lane);
        mma3_pair(t, ah[u], al[u], bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[2 * j + n][e] += t[n][e];
    }
  }
}

// c1 = A1 . B1^T and c2 = A2 . B2^T over D, 3xTF32: the warp's 16 fp32
// rows at a1 and a2 against the 16 at b1 and b2, each as two n8 tiles; the
// two pairs' four tiles are independent chains, summed as dots_rows_tf32
// sums.  kUnroll pairs of k-steps are unrolled (fewer keep fewer
// fragments live).
template <int D, int kUnroll = D / 16>
__device__ __forceinline__ void dots2_rows_tf32(float (&c1)[2][4], float (&c2)[2][4],
                                                const float* a1, const float* a2,
                                                const float* b1, const float* b2, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[t][e] = c2[t][e] = 0.f;
#pragma unroll (kUnroll)
  for (int k0 = 0; k0 < D / 8; k0 += 2) {
    float t1[2][4] = {}, t2[2][4] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      ldsplit_a<D>(ah, al, a1, k0 + u, lane);
      ldsplit_b<D>(bh, bl, b1, k0 + u, lane);
      mma3_pair(t1, ah, al, bh, bl);
      ldsplit_a<D>(ah, al, a2, k0 + u, lane);
      ldsplit_b<D>(bh, bl, b2, k0 + u, lane);
      mma3_pair(t2, ah, al, bh, bl);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[t][e] += t1[t][e], c2[t][e] += t2[t][e];
  }
}

// Warps of the fp32 kernel a 16-row tile, CS: one, or up to 32 tokens two
// where the grid gives an SM one block at most (f32_split), which split the
// columns of dq, dk and dv (each forms the tile's S and dP, and S^T and
// dP^T, in full): the shortest sequences over few (row, head)s are bound
// by one block's latency, and more warps shorten it; over many, the
// repeated products would cost more than they hide.
int f32_split(int KC, int rows_x_heads) {
  int dev, sms;
  if (KC > 32 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 1;
  }
  return rows_x_heads < sms ? 2 : 1;
}

// fp32 blocks an SM that __launch_bounds__ keeps the registers within (one
// warp a tile; two warps a tile run at most one block an SM): up to 64
// keys three (170 registers a thread at 4 warps; shared memory, 4 x
// KC x 68 floats a block at D = 64, holds three at 64 keys), at 80 and 96
// two (ptxas caps 5 and 6 warps alike at 168), from 112 one
__host__ __device__ constexpr int f32_blocks(int KC) { return KC <= 64 ? 3 : KC <= 96 ? 2 : 1; }

// fp32, T <= kWholeMaxSeq.  Block (batch row, head), CS warps per 16-row
// tile (f32_split), every product as 3xTF32 on mma.sync m16n8k8; KC is
// round16(T) itself, so that the registers and the block are sized to the
// sequence.  Shared memory holds q, k, v and g of the head (KC rows each,
// D + 4 floats a row, zero past T) and each query row's base-2 lse and r *
// D^-0.5; q and k land first, v and g in a second group while S runs.
// Phase A, a warp per 16 query rows: S = q . k^T against every key the
// rows see, raw, in the accumulators (dots_rows_tf32), then dP = g . v^T
// beside it (each product's A fragments split once for every key); the
// exact row max m and
// sum l, lse = m c + log2(l) (c = D^-0.5 log2(e); +inf past T), P = 2^(s c
// - lse) in place of S, r = rowsum(dP * P) from the fp32 P, dS = P (dP
// D^-0.5 - r D^-0.5) in place of P, and dq += dS . k with dS taken from the
// accumulators, 16 keys at a time.  Phase B, after one barrier, a warp per
// 16 keys, 16 queries a step (causal: from its own diagonal): S^T = k . q^T
// and dP^T = v . g^T, then P^T and dS^T by the same expressions from the
// statistics phase A left, and dv += P^T . g, dk += dS^T . q with P^T and
// dS^T taken from the accumulators.  Queries past T have lse = +inf, so
// P = dS = 0; keys past T own dk and dv rows that are never written.  One
// owner per output and a fixed order: no atomics.
template <int D, int KC, int CS>
__global__ void __launch_bounds__(2 * KC * CS, CS == 1 ? f32_blocks(KC) : 1)
attention_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ grad,
                  float* __restrict__ dqkv, int seq, int width, int heads, float scale,
                  int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 4;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + KC * LD;
  float* vs = ks + KC * LD;
  float* gs = vs + KC * LD;
  float* st_lse = gs + KC * LD;
  float* st_rs = st_lse + KC;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int tid = threadIdx.x;
  constexpr int NC = D / 8 / CS, kThreads = 2 * KC * CS;
  stage_rows<float, D>(qs, LD, base, stride, seq, KC, tid, kThreads);
  stage_rows<float, D>(ks, LD, base + width, stride, seq, KC, tid, kThreads);
  cp_async_commit();
  stage_rows<float, D>(vs, LD, base + 2 * width, stride, seq, KC, tid, kThreads);
  stage_rows<float, D>(gs, LD, grad + (size_t)b * seq * width + h * D, width, seq, KC, tid,
                       kThreads);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, part = warp % CS;
  const int t0 = 16 * (warp / CS);  // the tile's query rows (phase A), then keys (phase B)
  const int c0 = part * (D / CS);   // the warp's share of the columns of dq, dk, dv
  float* out = dqkv + (size_t)b * seq * stride + h * D + c0;

  // phase A: rows row0 and row0 + 8 of the warp's 16
  {
    const int row0 = t0 + lane / 4;
    const int kend = causal ? t0 + 16 : KC;  // the keys the rows see
    float p[KC / 8][4], dp[KC / 8][4];
    dots_rows_tf32<D, KC>(p, qs + t0 * LD, ks, kend, lane);
    // keys past T or above the diagonal are -inf, in the tiles that cross them
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) {
      const int n0 = 8 * n;
      if (n0 >= kend) break;
      if (n0 + 8 <= seq && !(causal && n0 + 7 > t0)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 2 * (lane & 3) + (e & 1), row = row0 + 8 * (e >> 1);
        if (col >= seq || (causal && col > row)) p[n][e] = -INFINITY;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // v and g
    dots_rows_tf32<D, KC>(dp, gs + t0 * LD, vs, kend, lane);
    float lse[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the max of the raw dots (the scale is positive); key 0 keeps it finite
      float m = -INFINITY;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        if (8 * n >= kend) break;
        m = fmaxf(m, fmaxf(p[n][2 * r], p[n][2 * r + 1]));
      }
      const float m2 = group_max<4>(m) * scale2;
      float l = 0.f;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        if (8 * n >= kend) break;
        l += ex2(fmaf(p[n][2 * r], scale2, -m2)) + ex2(fmaf(p[n][2 * r + 1], scale2, -m2));
      }
      l = group_sum<4>(l);  // (every lane shuffles, then the padded rows drop out)
      lse[r] = row0 + 8 * r < seq ? m2 + log2f(l) : INFINITY;  // padded: P = 0
      // P in place of S, and r = rowsum(dP * P)
      float rr = 0.f;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        if (8 * n >= kend) break;
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          p[n][e] = ex2(fmaf(p[n][e], scale2, -lse[r]));
          rr = fmaf(dp[n][e], p[n][e], rr);
        }
      }
      rs[r] = group_sum<4>(rr) * scale;
    }
    // dS in place of P, then dq += dS . k, 16 keys at a time
    float dq[NC][4] = {};
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      if (16 * j >= kend) break;
#pragma unroll
      for (int t = 2 * j; t < 2 * j + 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[t][e] *= fmaf(dp[t][e], scale, -rs[e >> 1]);
      acc2_times_rows_tf32<D, NC, true>(dq, p[2 * j], p[2 * j + 1], ks + 16 * j * LD + c0,
                                        lane);
    }
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = row0 + 8 * e2;
      if (row < seq) {
#pragma unroll
        for (int n = 0; n < NC; ++n)
          *reinterpret_cast<float2*>(out + row * stride + 8 * n + 2 * (lane & 3)) =
              make_float2(dq[n][2 * e2], dq[n][2 * e2 + 1]);
      }
      if (part == 0 && (lane & 3) == 0) st_lse[row] = lse[e2], st_rs[row] = rs[e2];
    }
  }
  __syncthreads();  // every row's statistics are in shared memory

  // phase B: keys key0 and key0 + 8 of the tile's 16
  const int key0 = t0 + lane / 4;
  float dk[NC][4] = {}, dv[NC][4] = {};
  for (int i0 = causal ? t0 : 0; i0 < KC; i0 += 16) {
    float s[2][4], ds[2][4];
    // S^T: (key, query), and dP^T
    dots2_rows_tf32<D, KC <= 64 ? D / 16 : 1>(s, ds, ks + t0 * LD, vs + t0 * LD, qs + i0 * LD,
                                               gs + i0 * LD, lane);
    const bool edge = causal && i0 == t0;  // the tile across the diagonal
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q0 = i0 + 8 * t + 2 * (lane & 3);  // queries q0, q0 + 1
      const float2 lq = *reinterpret_cast<const float2*>(st_lse + q0);
      const float2 rq = *reinterpret_cast<const float2*>(st_rs + q0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1), q = q0 + (e & 1);
        const float lv = e & 1 ? lq.y : lq.x, rv = e & 1 ? rq.y : rq.x;
        const float pv = !edge || key <= q ? ex2(fmaf(s[t][e], scale2, -lv)) : 0.f;
        ds[t][e] = pv * fmaf(ds[t][e], scale, -rv);
        s[t][e] = pv;
      }
    }
    acc2_times_rows_tf32<D, NC, true>(dv, s[0], s[1], gs + i0 * LD + c0, lane);
    acc2_times_rows_tf32<D, NC, true>(dk, ds[0], ds[1], qs + i0 * LD + c0, lane);
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = key0 + 8 * e2;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float* dst = out + row * stride + 8 * n + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst + width) = make_float2(dk[n][2 * e2], dk[n][2 * e2 + 1]);
      *reinterpret_cast<float2*>(dst + 2 * width) = make_float2(dv[n][2 * e2], dv[n][2 * e2 + 1]);
    }
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

// the workspace's rows per (batch row, head): T rounded up to the 64-row tile
__host__ __device__ constexpr int stats_rows(int seq) { return (seq + kTile - 1) / kTile * kTile; }

// ------------------------------------------------ fp32, T > kWholeMaxSeq

// The fp32 pair on Hopper's warpgroup MMA, every product as 3xTF32
// (m64nNk8 tf32: lo.hi + hi.lo + hi.hi of x = hi + lo, hi rounded to TF32
// and lo the rest, of which the tensor cores read the top bits).  A block
// is one warpgroup owning kTfRows rows of the resident side (query rows on
// the query side, keys on the key side); it streams the other side
// through shared memory in chunks of kTfChunk rows.  The resident rows'
// hi parts stay in registers as A fragments (loaded once, rounded), their
// lo parts in shared memory as a plane, so lo.hi takes both operands from
// shared memory and hi.lo and hi.hi take A from registers: a k-step of a
// product reads 5 KB of shared memory for 48 clocks of tensor work at
// m64n32k8, within the 128 bytes a clock an SM reads (both operands from
// shared memory: 9 KB), and 113 KB a block leaves two blocks an SM.
// (Two warpgroups a block sharing each chunk, with the next chunk split
// under this one's products, ran out of registers and measured slower.)
// 32-bit wgmma
// operands are K-major only and B comes only from shared memory: the
// chunk's rows are hi and lo planes in the layout wgmma reads
// (attention_wgmma.cuh), and for the products whose B is the chunk's rows
// as columns (dq += dS . K on the query side, dv += P^T . g and dk += dS^T
// . q on the key side) those rows transposed (D rows of kTfChunk, each
// 8-row group in the order (0, 2, 4, 6, 1, 3, 5, 7): the k order of an A
// fragment taken from the accumulators, which dS and P are).  A chunk
// lands by cp.async in a landing tile; at its step the block writes its
// planes from there (split, and transposed through registers) between two
// barriers, then stages the next chunk into the landing tile, which lands
// while this one computes.  What bounds it: the products alone run at
// about 80% of the TF32 rate; the split passes, the softmax and the
// staging add to them nearly in full (PERF.md).  The tensor cores' adders
// truncate: each product sums its two small terms first, the query side's
// S and dP put their hi.hi terms in two zeroed tiles (each half of d; the
// key side's registers leave room for one), and each chunk's dq, dk or dv
// goes to a zeroed tile, each added in fp32, so no chain takes more than 8
// k-steps at full size.  The workspace is the bf16 pair's (each row's
// base-2 lse and r * D^-0.5); no atomics, one owner per output.
constexpr int kTfRows = 64;    // resident rows a block (a warpgroup)
constexpr int kTfChunk = 32;   // streamed rows a step
constexpr int kTfThreads = 128;

// bytes of a K-major fp32 tile of `rows` rows of D, and of a transposed
// chunk plane (D rows of kTfChunk floats, one 128-byte swizzle atom each)
__host__ __device__ constexpr int tf_rows_bytes(int rows, int D) { return rows * 4 * D; }
__host__ __device__ constexpr int tf_t_bytes(int D) { return D * 4 * kTfChunk; }

// a block's shared memory (the key side's, the larger): 1 KB to align the
// tiles to the swizzle's 1024-byte period; the lo planes of the two
// resident operands; the chunk's two operands' hi and lo planes, their
// transposed hi and lo planes (the query side: one operand's) and their
// landing tiles.  115,712 bytes at D = 64: two blocks an SM, to the byte
// (the SM's 233,472 less 1 KB a block).
size_t tf32_smem(int D) {
  return 1024 + 2 * (size_t)tf_rows_bytes(kTfRows, D) + 6 * (size_t)tf_rows_bytes(kTfChunk, D) +
         4 * (size_t)tf_t_bytes(D);
}

// The resident side: a warp's hi A fragments of its 16 rows of a landed
// tile (kTfRows rows in tf_offset<D, kTfRows>'s layout), k-step kk's (row
// g, d 8kk + q), (g + 8, 8kk + q), (g, 8kk + q + 4), (g + 8, 8kk + q + 4)
// rounded to TF32; the block then turns the tile into its lo plane in
// place (split_planes with hi and lo both the tile: lo is written last),
// after a barrier.
template <int D>
__device__ __forceinline__ void load_hi_frags(uint32_t (&f)[D / 8][4], const unsigned char* tile,
                                              int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + lane / 4 + 8 * (e & 1), d = 8 * kk + lane % 4 + 4 * (e >> 1);
      f[kk][e] = tf32_round(
          *reinterpret_cast<const float*>(tile + tf_offset<D, kTfRows>(row, d / 4) + 4 * (d % 4)));
    }
}

// The 16-byte pieces of a chunk tile (kTfChunk rows of D) one thread
// stages: idx = tid + kTfThreads k, so the piece tid % (D / 4) of rows tid /
// (D / 4) + kRowsPass k, each pass a multiple of 8 rows (the swizzle's
// period), so its offsets are the first row's plus k passes.
template <int D>
struct ChunkPieces {
  static constexpr int kPieces = D / 4, kRowsPass = kTfThreads / kPieces;
  static constexpr int kRowBytes = 4 * tf_sub(D);
  static_assert(kRowsPass % 8 == 0 && kTfChunk % kRowsPass == 0, "whole swizzle periods a pass");
  int row, col;  // the thread's first row, and its piece's first float
  uint32_t off;  // the piece's byte offset in the tile
  __device__ explicit ChunkPieces(int tid)
      : row(tid / kPieces),
        col(4 * (tid % kPieces)),
        off(tf_offset<D, kTfChunk>(tid / kPieces, tid % kPieces)) {}
  // rows [0, kTfChunk) of a strided (rows, D) fp32 slice into the tile at
  // `tile` (a shared address); rows >= valid are zero-filled
  __device__ __forceinline__ void stage(uint32_t tile, const float* gmem, size_t stride,
                                        int valid) const {
#pragma unroll
    for (int k = 0; k < kTfChunk / kRowsPass; ++k) {
      const int r = row + kRowsPass * k;
      const bool ok = r < valid;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       tile + off + k * kRowsPass * kRowBytes),
                   "l"(gmem + (ok ? r * stride + col : 0)), "r"(ok ? 16 : 0));
    }
  }
};

// A landed chunk tile (kTfChunk rows of D in tf_offset<D, kTfChunk>'s
// layout) into its transposed hi and lo planes: rows d, the chunk's rows
// along k.  A thread writes one 16-byte piece of each plane (four rows of
// one d, read from four rows): d = tid % D and the pieces 2j + h of the
// 8-row groups j, h = tid / D % 2 (rows 8j + h + (0, 2, 4, 6)), so its
// reads sit at fixed offsets within each group, 8 rows apart from group to
// group.  A warp's lanes take consecutive d, so the reads are one row's
// bytes and the writes, 128 bytes apart, swizzled, fill the banks.
template <int D>
__device__ __forceinline__ void transpose_split(const unsigned char* land, unsigned char* th,
                                                unsigned char* tl, int tid) {
  static_assert(kTfThreads % D == 0, "whole rows of d a pass");
  constexpr int kRowBytes = 4 * tf_sub(D), kPass = kTfThreads / D;  // pieces a pass
  const int d = tid % D, p0 = tid / D;
  const int h = p0 & 1;
  // the four source rows of group 0 (the swizzle repeats every 8 rows)
  uint32_t src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) src[i] = tf_offset<D, kTfChunk>(h + 2 * i, d / 4) + 4 * (d % 4);
#pragma unroll
  for (int k = 0; k < kTfChunk / 4 / kPass; ++k) {
    const int piece = p0 + kPass * k, j = piece >> 1;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float*>(land + src[i] + 8 * j * kRowBytes);
    }
    float4 hi, lo;
    split4(make_float4(x[0], x[1], x[2], x[3]), hi, lo);
    const uint32_t off = swizzle<128>(d * 128 + piece * 16);
    *reinterpret_cast<float4*>(th + off) = hi;
    *reinterpret_cast<float4*>(tl + off) = lo;
  }
}

// c1 (+ c2) = A . B^T, m64n32 over D, 3xTF32, issued (not waited for): A
// the block's 64 resident rows (hi fragments ah, lo plane al), B the
// chunk's rows (hi and lo planes bh, bl).  lo.hi (both from shared
// memory), then hi.lo over all of d, then hi.hi over the k-steps below
// kTwo go to the zeroed tile c1, hi.hi over the rest to the zeroed tile
// c2, which the caller adds in fp32 (kTwo = D / 8: all into c1, and c2 is
// not touched).
template <int D, int kTwo>
__device__ __forceinline__ void dots_tf32(float (&c1)[kTfChunk / 2], float (&c2)[kTfChunk / 2],
                                          const uint32_t (&ah)[D / 8][4], uint64_t al,
                                          uint64_t bh, uint64_t bl) {
  constexpr int KS = D / 8;
  auto ka = [](int kk) { return tf_k_off<D, kTfRows>(kk); };
  auto kb = [](int kk) { return tf_k_off<D, kTfChunk>(kk); };
  wgmma_tf32_ss<kTfChunk, 0>(c1, al, bh);
#pragma unroll
  for (int kk = 1; kk < KS; ++kk) wgmma_tf32_ss<kTfChunk, 1>(c1, al + ka(kk), bh + kb(kk));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_tf32_rs<kTfChunk, 1>(c1, ah[kk], bl + kb(kk));
#pragma unroll
  for (int kk = 0; kk < kTwo; ++kk) wgmma_tf32_rs<kTfChunk, 1>(c1, ah[kk], bh + kb(kk));
  if constexpr (kTwo < KS) {
    wgmma_tf32_rs<kTfChunk, 0>(c2, ah[kTwo], bh + kb(kTwo));
#pragma unroll
    for (int kk = kTwo + 1; kk < KS; ++kk) wgmma_tf32_rs<kTfChunk, 1>(c2, ah[kk], bh + kb(kk));
  }
}

// The hi and lo A fragments of k-step j (the chunk's rows 8j .. 8j + 7) of
// an accumulator over the chunk (dS, P or their transposes): tile j's
// columns 2q, 2q + 1 as the fragment's k = q, q + 4
__device__ __forceinline__ void acc_frags(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const float (&c)[kTfChunk / 2], int j) {
  const float x[4] = {c[4 * j], c[4 * j + 2], c[4 * j + 1], c[4 * j + 3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_round(x[e]);
    lo[e] = __float_as_uint(x[e] - __uint_as_float(hi[e]));
  }
}

// c = A . B over the chunk's first 8 * ks rows (k-steps), 3xTF32, in the
// zeroed tile c, issued and waited for: A the accumulator `acc` over the
// chunk (its hi and lo fragments), B a transposed chunk plane pair (bh, bl
// descriptors); lo.hi, then hi.lo, then hi.hi
template <int D>
__device__ __forceinline__ void acc_times_chunk(float (&c)[D / 2], const float (&acc)[kTfChunk / 2],
                                                uint64_t bh, uint64_t bl, int ks) {
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc_frags(ah[j], al[j], acc, j);
    fence_regs(ah[j]);
    fence_regs(al[j]);
  }
  wgmma_fence();
  wgmma_tf32_rs<D, 0>(c, al[0], bh);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (j < ks) wgmma_tf32_rs<D, 1>(c, al[j], bh + 2 * j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < ks) wgmma_tf32_rs<D, 1>(c, ah[j], bl + 2 * j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < ks) wgmma_tf32_rs<D, 1>(c, ah[j], bh + 2 * j);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(c);
}

// Shared memory of either side, from a 1024-byte boundary: the resident
// operands' lo planes (res(0), res(1): 64-row tiles), the chunk's planes
// (ch: first hi, lo, second hi, lo), the transposed planes (tr: first hi,
// lo, second hi, lo), the landing tiles (land: first, second).  The kernels
// hide the base from the compiler at each step, so that every plane's
// address and descriptor is formed where it is used: held across the step
// loop, they took some 30 registers, which the key side lacks.
template <int D>
struct TfSmem {
  static constexpr int RES = tf_rows_bytes(kTfRows, D);
  static constexpr int CH = tf_rows_bytes(kTfChunk, D), TR = tf_t_bytes(D);
  uint32_t base;
  __device__ explicit TfSmem(uint32_t b) : base(b) {}
  __device__ __forceinline__ void hide() { asm volatile("" : "+r"(base)); }
  __device__ __forceinline__ uint32_t res(int p) const { return base + p * RES; }
  __device__ __forceinline__ uint32_t ch(int p) const { return base + 2 * RES + p * CH; }
  __device__ __forceinline__ uint32_t tr(int p) const { return base + 2 * RES + 4 * CH + p * TR; }
  __device__ __forceinline__ uint32_t land(int p) const {
    return base + 2 * RES + 4 * CH + 4 * TR + p * CH;
  }
};

// Query side.  Block (batch row x head, 64-query tile), one warpgroup.
// The key chunks stream as one stream of 2 * nch steps (causal: up to the
// tile's last row's diagonal): sweep 1 (steps < nch) forms S = q . K^T and
// dP = g . V^T and keeps each row's online max m of the raw dots, l = sum
// 2^(s c - m c) and rho = sum 2^(s c - m c) dP (c = D^-0.5 log2(e)), l and
// rho rescaled alike when m grows; sweep 2 forms S and dP again, P = 2^(s
// c - lse) and dS = P (dP D^-0.5 - r D^-0.5) in fp32 in the accumulators,
// and dq += dS . K, dS taken from there (K^T's planes made only in sweep
// 2).  Every row of the tile leaves lse = m c + log2(l) (+inf past T: P =
// 0) and r D^-0.5 in the workspace.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 2)
attention_bwd_q_tf32(const float* __restrict__ qkv, const float* __restrict__ grad,
                     float* __restrict__ dqkv, float* __restrict__ stats, int seq, int width,
                     int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = TfSmem<D>;
  constexpr int NC = kTfChunk / 2, NO = D / 2, kRowBytes = 4 * tf_sub(D);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, lane = tid % 32;
  // the warp's index broadcast from lane 0 (attention_fwd.cu's
  // attention_fwd_wgmma says why)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int rt = kTfRows * blockIdx.y, r0 = rt + 16 * warp;
  const uint32_t raw = smem_u32(smem_raw);
  S sm((raw + 1023) & ~1023u);
  auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  auto fl = [&](uint32_t addr) { return reinterpret_cast<float*>(at(addr)); };
  // planes: res q lo, g lo; ch K hi, K lo, V hi, V lo; tr K^T hi, K^T lo;
  // land K, V

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int kend = causal ? min(seq, rt + kTfRows) : seq;  // the keys the tile's rows see
  const int nch = (kend + kTfChunk - 1) / kTfChunk, steps = 2 * nch;
  const bool live = r0 < seq;                             // the warp has rows
  const int row0 = r0 + lane / 4, q2 = 2 * (lane & 3);  // rows row0, row0 + 8

  auto chunk0 = [&](int step) { return (step < nch ? step : step - nch) * kTfChunk; };
  const ChunkPieces<D> pieces(tid);
  auto stage = [&](int step) {
    if (step >= steps) return;
    const int c0 = chunk0(step);
    pieces.stage(sm.land(0), base + width + c0 * stride, stride, seq - c0);
    pieces.stage(sm.land(1), base + 2 * width + c0 * stride, stride, seq - c0);
  };
  stage_tf32<D, kTfRows>(sm.res(0), base + rt * stride, stride, seq - rt, kTfRows, tid,
                         kTfThreads);
  stage_tf32<D, kTfRows>(sm.res(1), grad + ((size_t)b * seq + rt) * width + h * D, width,
                         seq - rt, kTfRows, tid, kTfThreads);
  stage(0);
  cp_async_commit();
  uint32_t qf[D / 8][4], gf[D / 8][4];  // the warp's rows of q and g: hi A fragments
  // the block's step: the chunk has landed; its planes (and at step 0 q's
  // and g's hi fragments and lo planes, in sweep 2 K^T's planes) written
  // and fenced for wgmma's reads; the next chunk staged behind the second
  // barrier
  auto landed = [&](int step) {
    cp_async_wait<0>();
    __syncthreads();
    if (step == 0) {
      load_hi_frags<D>(qf, at(sm.res(0)), warp, lane);
      load_hi_frags<D>(gf, at(sm.res(1)), warp, lane);
      __syncthreads();
      split_planes(fl(sm.res(0)), fl(sm.res(0)), fl(sm.res(0)), S::RES, tid, kTfThreads);
      split_planes(fl(sm.res(1)), fl(sm.res(1)), fl(sm.res(1)), S::RES, tid, kTfThreads);
    }
    split_planes(fl(sm.land(0)), fl(sm.ch(0)), fl(sm.ch(1)), S::CH, tid, kTfThreads);
    split_planes(fl(sm.land(1)), fl(sm.ch(2)), fl(sm.ch(3)), S::CH, tid, kTfThreads);
    if (step >= nch) transpose_split<D>(at(sm.land(0)), at(sm.tr(0)), at(sm.tr(1)), tid);
    fence_proxy_async();
    __syncthreads();
    stage(step + 1);
    cp_async_commit();
  };

  // (from sweep 2 on, m and rho hold each row's lse and r * D^-0.5)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rho[2] = {0.f, 0.f};
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    sm.hide();
    landed(step);
    if (step == nch) {  // sweep 1 is done: lse (+inf past T: P = 0) and r * D^-0.5
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const float lsum = group_sum<4>(l[e2]), rsum = group_sum<4>(rho[e2]);
        const bool in = row0 + 8 * e2 < seq;
        rho[e2] = in ? rsum / lsum * scale : 0.f;
        m[e2] = in ? fmaf(m[e2], scale2, log2f(lsum)) : INFINITY;
      }
    }
    const int c0 = chunk0(step);
    float s[NC], s2[NC], dp[NC], dp2[NC];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      fence_regs(qf[kk]);
      fence_regs(gf[kk]);
    }
    wgmma_fence();
    dots_tf32<D, D / 16>(s, s2, qf, smem_desc<kRowBytes>(sm.res(0)),
                         smem_desc<kRowBytes>(sm.ch(0)), smem_desc<kRowBytes>(sm.ch(1)));
    dots_tf32<D, D / 16>(dp, dp2, gf, smem_desc<kRowBytes>(sm.res(1)),
                         smem_desc<kRowBytes>(sm.ch(2)), smem_desc<kRowBytes>(sm.ch(3)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(s2);
    fence_regs(dp);
    fence_regs(dp2);
#pragma unroll
    for (int i = 0; i < NC; ++i) s[i] += s2[i], dp[i] += dp2[i];
    // keys past T or above a row's diagonal: -inf, so P = 0
    if (c0 + kTfChunk > seq || (causal && c0 + kTfChunk - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < NC / 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * i + q2 + (e & 1), row = row0 + 8 * (e >> 1);
          if (col >= seq || (causal && col > row)) s[4 * i + e] = -INFINITY;
        }
    }
    if (step < nch) {
      if (!live) continue;
      // online m (quad-uniform), l and rho (lane-partial); key 0 is in
      // every row's first chunk, so m is finite from there on
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float cm = -INFINITY;
#pragma unroll
        for (int i = 0; i < NC / 4; ++i) {
          cm = fmaxf(cm, fmaxf(s[4 * i + 2 * e2], s[4 * i + 2 * e2 + 1]));
        }
        const float mn = fmaxf(m[e2], group_max<4>(cm)), mn2 = mn * scale2;
        const float alpha = ex2(m[e2] * scale2 - mn2);
        float ls = 0.f, rs = 0.f;
#pragma unroll
        for (int i = 0; i < NC / 4; ++i)
#pragma unroll
          for (int e = 2 * e2; e < 2 * e2 + 2; ++e) {
            const float p = ex2(fmaf(s[4 * i + e], scale2, -mn2));
            ls += p;
            rs = fmaf(p, dp[4 * i + e], rs);
          }
        l[e2] = fmaf(l[e2], alpha, ls);
        rho[e2] = fmaf(rho[e2], alpha, rs);
        m[e2] = mn;
      }
      continue;
    }
    // sweep 2: dS in place of S (P = 0 for the -inf keys, and in rows past
    // T, whose lse is +inf), then dq += dS . K over the k-steps below kend,
    // in a zeroed tile
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float p = ex2(fmaf(s[i], scale2, -m[(i >> 1) & 1]));
      s[i] = p * fmaf(dp[i], scale, -rho[(i >> 1) & 1]);
    }
    float dqc[NO];
    acc_times_chunk<D>(dqc, s, smem_desc<128>(sm.tr(0)), smem_desc<128>(sm.tr(1)),
                       min(4, (kend - c0 + 7) / 8));
#pragma unroll
    for (int i = 0; i < NO; ++i) dq[i] += dqc[i];
  }
  float* out = dqkv + (size_t)b * seq * stride + h * D;
  const int tw = stats_rows(seq);
  float* st = stats + (size_t)blockIdx.x * 2 * tw;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row0 + 8 * e2;
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + row * stride + 8 * j + q2) =
            make_float2(dq[4 * j + 2 * e2], dq[4 * j + 2 * e2 + 1]);
    }
    if ((lane & 3) == 0) st[row] = live ? m[e2] : INFINITY, st[tw + row] = live ? rho[e2] : 0.f;
  }
}

// Key side.  Block (batch row x head, 64-key tile), one warpgroup.  The
// query chunks stream (causal: from the tile's first key on), their lse
// and r D^-0.5 read from the workspace into registers while the step's
// first products run: S^T = K . q^T and dP^T = V . g^T, then P^T = 2^(s c
// - lse) and dS^T = P^T (dP^T D^-0.5 - r D^-0.5) in the accumulators,
// whose fragments are the A of dv += P^T . g and then of dk += dS^T . q
// (g's and q's transposed planes as B).  Queries past T have lse = +inf,
// so P = dS = 0; keys past T own dk and dv rows that are never written.
template <int D>
__global__ void __launch_bounds__(kTfThreads, 2)
attention_bwd_kv_tf32(const float* __restrict__ qkv, const float* __restrict__ grad,
                      float* __restrict__ dqkv, const float* __restrict__ stats, int seq,
                      int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = TfSmem<D>;
  constexpr int NC = kTfChunk / 2, NO = D / 2, kRowBytes = 4 * tf_sub(D);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int jt = kTfRows * blockIdx.y, j0 = jt + 16 * warp;
  const uint32_t raw = smem_u32(smem_raw);
  S sm((raw + 1023) & ~1023u);
  auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  auto fl = [&](uint32_t addr) { return reinterpret_cast<float*>(at(addr)); };
  // planes: res K lo, V lo; ch q hi, q lo, g hi, g lo; tr q^T hi, lo, g^T
  // hi, lo; land q, g

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const float* gbase = grad + (size_t)b * seq * width + h * D;
  const int tw = stats_rows(seq);
  const float* st = stats + (size_t)blockIdx.x * 2 * tw;
  // causal: query chunks before the tile's first key see none of its keys
  const int first = causal ? jt / kTfChunk : 0, nch = (seq + kTfChunk - 1) / kTfChunk;
  const bool live = j0 < seq;  // the warp has keys
  const int key0 = j0 + lane / 4, q2 = 2 * (lane & 3);  // keys key0, key0 + 8

  const ChunkPieces<D> pieces(tid);
  auto stage = [&](int c) {
    if (c >= nch) return;
    const int i0c = c * kTfChunk;
    pieces.stage(sm.land(0), base + i0c * stride, stride, seq - i0c);
    pieces.stage(sm.land(1), gbase + (size_t)i0c * width, width, seq - i0c);
  };
  stage_tf32<D, kTfRows>(sm.res(0), base + width + jt * stride, stride, seq - jt, kTfRows, tid,
                         kTfThreads);
  stage_tf32<D, kTfRows>(sm.res(1), base + 2 * width + jt * stride, stride, seq - jt, kTfRows,
                         tid, kTfThreads);
  stage(first);
  cp_async_commit();
  uint32_t kf[D / 8][4], vf[D / 8][4];  // the warp's keys of K and V: hi A fragments
  auto landed = [&](int c) {
    cp_async_wait<0>();
    __syncthreads();
    if (c == first) {
      load_hi_frags<D>(kf, at(sm.res(0)), warp, lane);
      load_hi_frags<D>(vf, at(sm.res(1)), warp, lane);
      __syncthreads();
      split_planes(fl(sm.res(0)), fl(sm.res(0)), fl(sm.res(0)), S::RES, tid, kTfThreads);
      split_planes(fl(sm.res(1)), fl(sm.res(1)), fl(sm.res(1)), S::RES, tid, kTfThreads);
    }
    split_planes(fl(sm.land(0)), fl(sm.ch(0)), fl(sm.ch(1)), S::CH, tid, kTfThreads);
    split_planes(fl(sm.land(1)), fl(sm.ch(2)), fl(sm.ch(3)), S::CH, tid, kTfThreads);
    transpose_split<D>(at(sm.land(0)), at(sm.tr(0)), at(sm.tr(1)), tid);
    transpose_split<D>(at(sm.land(1)), at(sm.tr(2)), at(sm.tr(3)), tid);
    fence_proxy_async();
    __syncthreads();
    stage(c + 1);
    cp_async_commit();
  };

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  for (int c = first; c < nch; ++c) {
    sm.hide();
    landed(c);
    const int i0c = c * kTfChunk;
    // the queries of the thread's columns: their lse and r * D^-0.5
    float2 lq[NC / 4], rq[NC / 4];
#pragma unroll
    for (int i = 0; i < NC / 4; ++i) {
      lq[i] = *reinterpret_cast<const float2*>(st + i0c + 8 * i + q2);
      rq[i] = *reinterpret_cast<const float2*>(st + tw + i0c + 8 * i + q2);
    }
    // S^T: (key, query), and dP^T, each in one tile: the key side's
    // registers hold dk and dv besides
    float s[NC], dp[NC];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      fence_regs(kf[kk]);
      fence_regs(vf[kk]);
    }
    wgmma_fence();
    dots_tf32<D, D / 8>(s, s, kf, smem_desc<kRowBytes>(sm.res(0)), smem_desc<kRowBytes>(sm.ch(0)),
                        smem_desc<kRowBytes>(sm.ch(1)));
    dots_tf32<D, D / 8>(dp, dp, vf, smem_desc<kRowBytes>(sm.res(1)),
                        smem_desc<kRowBytes>(sm.ch(2)), smem_desc<kRowBytes>(sm.ch(3)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    // P^T and dS^T in place of S^T and dP^T; queries past T have lse = +inf
    // (P = 0), queries before a key (causal) are set to 0
    const bool edge = causal && j0 + 15 > i0c;
#pragma unroll
    for (int i = 0; i < NC / 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * i + e;
        const float lv = e & 1 ? lq[i].y : lq[i].x, rv = e & 1 ? rq[i].y : rq[i].x;
        float pv = ex2(fmaf(s[x], scale2, -lv));
        if (edge && key0 + 8 * (e >> 1) > i0c + 8 * i + q2 + (e & 1)) pv = 0.f;
        dp[x] = pv * fmaf(dp[x], scale, -rv);
        s[x] = pv;
      }
    }
    // dv += P^T . g, then dk += dS^T . q, over the chunk's queries below T,
    // each in a zeroed tile
    const int ks = min(4, (seq - i0c + 7) / 8);
    // (in halves of d at D >= 32: a zeroed tile of D / 4 registers)
    constexpr int NH = D >= 32 ? D / 2 : D, kHalves = D / NH;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) {
      float t[NH / 2];
      acc_times_chunk<NH>(t, s, smem_desc<128>(sm.tr(2) + hh * NH * 128),
                          smem_desc<128>(sm.tr(3) + hh * NH * 128), ks);
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) dv[hh * NH / 2 + i] += t[i];
    }
    fence_regs(dp);  // dS^T's fragments no earlier: registers
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) {
      float t[NH / 2];
      acc_times_chunk<NH>(t, dp, smem_desc<128>(sm.tr(0) + hh * NH * 128),
                          smem_desc<128>(sm.tr(1) + hh * NH * 128), ks);
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) dk[hh * NH / 2 + i] += t[i];
    }
  }
  if (!live) return;
  float* out = dqkv + (size_t)b * seq * stride + h * D;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = key0 + 8 * e2;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float* dst = out + row * stride + 8 * j + q2;
      *reinterpret_cast<float2*>(dst + width) =
          make_float2(dk[4 * j + 2 * e2], dk[4 * j + 2 * e2 + 1]);
      *reinterpret_cast<float2*>(dst + 2 * width) =
          make_float2(dv[4 * j + 2 * e2], dv[4 * j + 2 * e2 + 1]);
    }
  }
}

// ------------------------------------------------ bf16, T > kResidentMaxSeq

// The bf16 pair on Hopper's warpgroup MMA (wgmma m64nNk16, bf16 operands,
// fp32 accumulators; replacing a pair on mma.sync m16n8k16 that ran at
// 160-220 TFLOP/s over its nine products, held by its instruction rate).
// A block is one warpgroup owning kTile rows of the resident side (query
// rows on the query side, keys on the key side) in shared memory, in the
// swizzled layout wgmma reads (attention_wgmma.cuh: 128-, 64- or 32-byte
// swizzle at D = 64, 32, 16), and streams the other side's kChunk-row
// chunks through a ring of stages (kQStages on the query side, kStages on
// the key side), the chunk of step + stages - 1 landing by cp.async while
// step computes, behind one barrier a step.
// S = q . K^T and dP = g . V^T (S^T = K . q^T and dP^T = V . g^T on the key
// side) take both operands from shared memory, K-major; dq += dS . K, dv +=
// P^T . g and dk += dS^T . q take A from registers, rounded to bf16
// straight from the accumulators (two adjacent n8 tiles are one k-step's A
// fragment), and B, the chunk's rows as they landed, with the transpose
// bit.  No T x T tile touches shared memory.
//
// The traps, which ptxas reports only as `ptxas info (C75xx)` and answers
// by serialising every wgmma of the kernel:
// - a branch on threadIdx around a wgmma: the warp index is broadcast
//   from lane 0, so that every branch is uniform for the compiler;
// - a register that a wgmma in flight writes (or an A fragment it reads)
//   touched before its wait: each chain is waited for before its
//   accumulators are read, and a chunk's fragments are all formed before
//   its RS chain is issued (in K1, a P.V issued while the next fragments
//   were formed serialised at 160 live score registers);
// - cp.async writes reach wgmma's reads only through fence_proxy_async,
//   issued by every thread after its wait and before the step's barrier.
// One warpgroup a block: two sharing a double-buffered ring without
// setmaxnreg spilled and serialised in the fp32 pair.  Registers at D =
// 64: the query side holds S, dP and dq (96 accumulators), the key side
// S^T, dP^T, dv and dk (128); ptxas fits them in 124 and 166, no spill, so
// the query side takes four blocks an SM (128 registers a thread) and the
// key side three (168; at two blocks' bounds it took 194, 3-9% slower).
// Shared memory at D = 64: 1 KB of alignment, two 8 KB resident tiles and
// two 8 KB chunk tiles a stage, the query side in two stages (50,176
// bytes), the key side in three with each stage's statistics (512 bytes;
// 68,096 bytes).  (The query side in three stages, three blocks an SM,
// measured within 11% either way, shape by shape.)  What bounds it:
// the tensor cores' nine products of T x T x D, against the exponentials
// (three of every (query, key) pair, 16 a clock an SM) and the rounding of
// P and dS, which each chunk's waits put between its products.
__host__ __device__ constexpr int wg_tile(int D) { return kTile * 2 * D; }
size_t bf16_wgmma_smem(int D) {
  return 1024 + (2 + 2 * kStages) * (size_t)wg_tile(D) + kStages * 2 * kChunk * sizeof(float);
}
// the query side's: no statistics, kQStages stages
size_t bf16_wgmma_q_smem(int D) { return 1024 + (2 + 2 * kQStages) * (size_t)wg_tile(D); }

// S (or S^T) and dP (or dP^T) of a step, both operands from shared memory,
// issued as two chains of D / 16 k-steps and waited for: a_* the resident
// tiles' descriptors (q, g or K, V), b_* the chunk's (K, V or q, g)
template <int D>
__device__ __forceinline__ void wg_scores(float (&s)[32], float (&dp)[32], uint64_t a_s,
                                          uint64_t a_dp, uint64_t b_s, uint64_t b_dp) {
  wgmma_fence();
  wgmma_ss<0>(s, a_s, b_s);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(s, a_s + 2 * kk, b_s + 2 * kk);
  wgmma_ss<0>(dp, a_dp, b_dp);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(dp, a_dp + 2 * kk, b_dp + 2 * kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

// accumulator tiles 2j, 2j + 1 (columns 16j .. 16j + 15) of x, rounded to
// bf16: the A fragment of k-step j
__device__ __forceinline__ void pack_frag(uint32_t (&a)[4], const float (&x)[32], int j) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a[2 * t] = pack_bf16(x[8 * j + 4 * t], x[8 * j + 4 * t + 1]);
    a[2 * t + 1] = pack_bf16(x[8 * j + 4 * t + 2], x[8 * j + 4 * t + 3]);
  }
}

// Query side.  Block (batch row x head, 64-query tile).  q's and g's rows
// land once; the key chunks stream as one stream of 2 * nch steps (causal:
// up to the tile's diagonal chunk).  Sweep 1 forms S and dP and keeps each
// row's online max m of the raw dots, l = sum 2^(s c - m c) and rho = sum
// 2^(s c - m c) dP (c = D^-0.5 log2(e)), updated once a chunk (the quad of
// lanes that holds a row reduces its max), l and rho rescaled alike when m
// grows; sweep 2 forms S and dP again, P = 2^(s c - lse) and dS = P (dP
// D^-0.5 - r D^-0.5) in fp32 in the accumulators, and dq += dS . K over the
// chunk's 16-key steps below the tile's keys, dq held in fp32 registers
// and written once.  Every row of the tile leaves lse = m c + log2(l)
// (+inf past T: P = 0) and r D^-0.5 (0 past T) in the workspace.
template <int D>
__global__ void __launch_bounds__(kTileThreads, kQBlocks)
attention_bwd_q_wgmma_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                           bf16* __restrict__ dqkv, float* __restrict__ stats, int seq,
                           int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile(D), NO = D / 2, kAhead = kQStages - 1;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // uniform for the compiler
  const int rt = kTile * blockIdx.y, r0 = rt + 16 * warp;
  // q, g, then the ring's stages of (K, V) chunk pairs
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u, gs = qs + TILE, ring = gs + TILE;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int kend = causal ? min(seq, rt + kTile) : seq;  // the keys the tile's rows see
  const int nch = (kend + kChunk - 1) / kChunk, steps = 2 * nch;
  const int row0 = r0 + lane / 4, q2 = 2 * (lane & 3);  // rows row0, row0 + 8

  auto chunk0 = [&](int step) { return (step < nch ? step : step - nch) * kChunk; };
  auto k_tile = [&](int step) -> uint32_t { return ring + (step % kQStages) * 2 * TILE; };
  auto stage = [&](int step) {
    if (step >= steps) return;
    const int c0 = chunk0(step);
    stage_swizzled<D>(k_tile(step), base + width + c0 * stride, stride, seq - c0, kChunk, tid,
                      kTileThreads);
    stage_swizzled<D>(k_tile(step) + TILE, base + 2 * width + c0 * stride, stride, seq - c0,
                      kChunk, tid, kTileThreads);
  };
  // group 0: q, g and step 0's chunk; group i: step i's
  stage_swizzled<D>(qs, base + rt * stride, stride, seq - rt, kTile, tid, kTileThreads);
  stage_swizzled<D>(gs, grad + ((size_t)b * seq + rt) * width + h * D, width, seq - rt, kTile,
                    tid, kTileThreads);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    stage(i);
    cp_async_commit();
  }
  const uint64_t q_desc = wg_desc<D>(qs), g_desc = wg_desc<D>(gs);

  // (from sweep 2 on, m and rho hold each row's lse and r * D^-0.5)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rho[2] = {0.f, 0.f};
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    // the step's chunk has landed for every thread, and the stage of step
    // - 1 (its products waited for) takes the chunk of step + kAhead
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    stage(step + kAhead);
    cp_async_commit();
    if (step == nch) {  // sweep 1 is done: lse (+inf past T: P = 0) and r * D^-0.5
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const float lsum = group_sum<4>(l[e2]), rsum = group_sum<4>(rho[e2]);
        const bool in = row0 + 8 * e2 < seq;
        rho[e2] = in ? rsum / lsum * scale : 0.f;
        m[e2] = in ? fmaf(m[e2], scale2, log2f(lsum)) : INFINITY;
      }
    }
    const int c0 = chunk0(step);
    const uint32_t kt = k_tile(step);
    float s[32], dp[32];
    wg_scores<D>(s, dp, q_desc, g_desc, wg_desc<D>(kt), wg_desc<D>(kt + TILE));
    // keys past T or above a row's diagonal: -inf, so P = 0
    if (c0 + kChunk > seq || (causal && c0 + kChunk - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * i + q2 + (e & 1), row = row0 + 8 * (e >> 1);
          if (col >= seq || (causal && col > row)) s[4 * i + e] = -INFINITY;
        }
    }
    if (step < nch) {
      // key 0 is in every row's first chunk, and every chunk holds a key
      // that each of the tile's rows sees, so m is finite from there on
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float cm = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) cm = fmaxf(cm, fmaxf(s[4 * i + 2 * e2], s[4 * i + 2 * e2 + 1]));
        const float mn = fmaxf(m[e2], group_max<4>(cm)), mn2 = mn * scale2;
        const float alpha = ex2(m[e2] * scale2 - mn2);
        float ls = 0.f, rs = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 2 * e2; e < 2 * e2 + 2; ++e) {
            const float p = ex2(fmaf(s[4 * i + e], scale2, -mn2));
            ls += p;
            rs = fmaf(p, dp[4 * i + e], rs);
          }
        l[e2] = fmaf(l[e2], alpha, ls);
        rho[e2] = fmaf(rho[e2], alpha, rs);
        m[e2] = mn;
      }
      continue;
    }
    // sweep 2: dS in place of S (P = 0 for the -inf keys, and in rows past
    // T, whose lse is +inf), every fragment formed, then dq += dS . K
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(s[i], scale2, -m[(i >> 1) & 1]));
      s[i] = p * fmaf(dp[i], scale, -rho[(i >> 1) & 1]);
    }
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pack_frag(a[j], s, j);
      fence_regs(a[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + 16 * j < kend) wgmma_rs<D>(dq, a[j], wg_desc<D>(kt + j * 16 * 2 * D));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
  }
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;
  const int tw = stats_rows(seq);
  float* st = stats + (size_t)blockIdx.x * 2 * tw;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = row0 + 8 * e2;
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + row * stride + 8 * j + q2) =
            pack_bf16(dq[4 * j + 2 * e2], dq[4 * j + 2 * e2 + 1]);
    }
    if ((lane & 3) == 0) st[row] = m[e2], st[tw + row] = rho[e2];
  }
}

// Key side.  Block (batch row x head, 64-key tile).  K's and V's rows land
// once; the query chunks stream with their lse and r D^-0.5 (causal: from
// the tile's diagonal chunk, masked elementwise there): S^T = K . q^T and
// dP^T = V . g^T, then P^T = 2^(s c - lse) and dS^T = P^T (dP^T D^-0.5 -
// r D^-0.5) in fp32 in the accumulators (each thread reads the statistics
// of its columns, queries 8j + 2q and 8j + 2q + 1), both rounded to bf16
// fragments, then dv += P^T . g and dk += dS^T . q as one group of chains
// over the chunk's 16-query steps below T.  Queries past T have lse =
// +inf, so P = dS = 0; keys past T own dk and dv rows that are never
// written.
template <int D>
__global__ void __launch_bounds__(kTileThreads, kPairBlocks)
attention_bwd_kv_wgmma_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                            bf16* __restrict__ dqkv, const float* __restrict__ stats, int seq,
                            int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile(D), NO = D / 2, kAhead = kStages - 1;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // uniform for the compiler
  const int jt = kTile * blockIdx.y, j0 = jt + 16 * warp;
  // K, V, the ring's stages of (q, g) chunk pairs, then the stages'
  // statistics (lse, then r * D^-0.5: kChunk floats each)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u, vs = ks + TILE, ring = vs + TILE;
  const uint32_t sts = ring + kStages * 2 * TILE;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const bf16* gbase = grad + (size_t)b * seq * width + h * D;
  const int tw = stats_rows(seq);
  const float* st = stats + (size_t)blockIdx.x * 2 * tw;
  // causal: query chunks before the tile's first key see none of its keys
  const int first = causal ? jt / kChunk : 0, nch = (seq + kChunk - 1) / kChunk;
  const int key0 = j0 + lane / 4, q2 = 2 * (lane & 3);  // keys key0, key0 + 8

  auto q_tile = [&](int c) -> uint32_t { return ring + ((c - first) % kStages) * 2 * TILE; };
  auto st_tile = [&](int c) -> uint32_t {
    return sts + ((c - first) % kStages) * 2 * kChunk * (uint32_t)sizeof(float);
  };
  auto stage = [&](int c) {
    if (c >= nch) return;
    const int i0 = c * kChunk;
    stage_swizzled<D>(q_tile(c), base + i0 * stride, stride, seq - i0, kChunk, tid,
                      kTileThreads);
    stage_swizzled<D>(q_tile(c) + TILE, gbase + (size_t)i0 * width, width, seq - i0, kChunk,
                      tid, kTileThreads);
    // the statistics rows run to stats_rows(seq) >= i0 + kChunk
    if (tid < 2 * kChunk / 4) {
      const int a = tid / (kChunk / 4), o = 4 * (tid % (kChunk / 4));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       st_tile(c) + (a * kChunk + o) * (uint32_t)sizeof(float)),
                   "l"(st + a * tw + i0 + o));
    }
  };
  stage_swizzled<D>(ks, base + width + jt * stride, stride, seq - jt, kTile, tid, kTileThreads);
  stage_swizzled<D>(vs, base + 2 * width + jt * stride, stride, seq - jt, kTile, tid,
                    kTileThreads);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    stage(first + i);
    cp_async_commit();
  }
  const uint64_t k_desc = wg_desc<D>(ks), v_desc = wg_desc<D>(vs);

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  for (int c = first; c < nch; ++c) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    stage(c + kAhead);
    cp_async_commit();
    const int i0 = c * kChunk;
    const uint32_t qt = q_tile(c);
    // S^T: (key, query), and dP^T
    float s[32], dp[32];
    wg_scores<D>(s, dp, k_desc, v_desc, wg_desc<D>(qt), wg_desc<D>(qt + TILE));
    // P^T and dS^T in place of S^T and dP^T; queries before a key (causal,
    // the diagonal chunk) get P = 0
    const float* lse = reinterpret_cast<const float*>(smem_raw + (st_tile(c) - raw));
    const float* rs = lse + kChunk;
    const bool edge = causal && j0 + 15 > i0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 lq = *reinterpret_cast<const float2*>(lse + 8 * i + q2);
      const float2 rq = *reinterpret_cast<const float2*>(rs + 8 * i + q2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * i + e;
        const float lv = e & 1 ? lq.y : lq.x, rv = e & 1 ? rq.y : rq.x;
        float pv = ex2(fmaf(s[x], scale2, -lv));
        if (edge && key0 + 8 * (e >> 1) > i0 + 8 * i + q2 + (e & 1)) pv = 0.f;
        dp[x] = pv * fmaf(dp[x], scale, -rv);
        s[x] = pv;
      }
    }
    uint32_t ap[4][4], ad[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pack_frag(ap[j], s, j);
      pack_frag(ad[j], dp, j);
      fence_regs(ap[j]);
      fence_regs(ad[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + 16 * j < seq) wgmma_rs<D>(dv, ap[j], wg_desc<D>(qt + TILE + j * 16 * 2 * D));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + 16 * j < seq) wgmma_rs<D>(dk, ad[j], wg_desc<D>(qt + j * 16 * 2 * D));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk);
    fence_regs(dv);
  }
  bf16* out = dqkv + (size_t)b * seq * stride + h * D;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = key0 + 8 * e2;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + q2;
      *reinterpret_cast<uint32_t*>(out + row * stride + width + col) =
          pack_bf16(dk[4 * j + 2 * e2], dk[4 * j + 2 * e2 + 1]);
      *reinterpret_cast<uint32_t*>(out + row * stride + 2 * width + col) =
          pack_bf16(dv[4 * j + 2 * e2], dv[4 * j + 2 * e2 + 1]);
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

// A pair on one stream: the query side (dq and the row statistics), then
// the key side (dk, dv), each a block per (batch row x head, `rows` rows)
// of `threads` threads.
template <typename T, typename Kq, typename Kkv>
cudaError_t launch_pair(Kq q_side, Kkv kv_side, size_t q_smem, size_t smem, int rows,
                        int threads, const void* qkv, const void* grad, void* dqkv, float* stats,
                        int B, int seq, int width, int heads, float scale, int causal,
                        cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(B * heads, (seq + rows - 1) / rows);
  if ((e = set_smem_shared_carveout(q_side, q_smem)) != cudaSuccess) return e;
  if ((e = set_smem_shared_carveout(kv_side, smem)) != cudaSuccess) return e;
  q_side<<<grid, threads, q_smem, stream>>>(static_cast<const T*>(qkv), static_cast<const T*>(grad),
                                          static_cast<T*>(dqkv), stats, seq, width, heads, scale,
                                          causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kv_side<<<grid, threads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<const T*>(grad), static_cast<T*>(dqkv),
                                           stats, seq, width, heads, scale, causal);
  return cudaGetLastError();
}

// T > 128: bf16 in one launch up to kResidentMaxSeq (the resident kernel),
// its streamed pair above; fp32 always the fp32 (3xTF32, wgmma) pair.
template <int D>
cudaError_t launch_tiled(const void* qkv, const void* grad, void* dqkv, float* stats, int B,
                         int seq, int width, int heads, float scale, int causal, int dtype,
                         cudaStream_t stream) {
  if (dtype == 0) {
    return launch_pair<float>(attention_bwd_q_tf32<D>, attention_bwd_kv_tf32<D>, tf32_smem(D),
                              tf32_smem(D), kTfRows, kTfThreads, qkv, grad, dqkv, stats, B, seq,
                              width, heads, scale, causal, stream);
  }
  if (seq > kResidentMaxSeq) {
    return launch_pair<bf16>(attention_bwd_q_wgmma_bf16<D>, attention_bwd_kv_wgmma_bf16<D>,
                             bf16_wgmma_q_smem(D), bf16_wgmma_smem(D), kTile, kTileThreads, qkv,
                             grad, dqkv, stats, B, seq, width, heads, scale, causal, stream);
  }
  cudaError_t e;
  const size_t smem = resident_bf16_smem(seq, D);
  if ((e = set_smem(attention_bwd_resident_bf16<D>, smem)) != cudaSuccess) return e;
  attention_bwd_resident_bf16<D><<<B * heads, 32 * resident_warps(seq), smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad), static_cast<bf16*>(dqkv),
      seq, width, heads, scale, causal);
  return cudaGetLastError();
}

#define MNT_ARGS qkv, grad, dqkv, B, seq, width, heads, scale, causal, s
// up to kWholeMaxSeq: a block per (row, head), a warp per 16-row tile
template <int D, int KC>
cudaError_t launch_bf16(const void* qkv, const void* grad, void* dqkv, int B, int seq, int width,
                        int heads, float scale, int causal, cudaStream_t s) {
  cudaError_t e;
  const size_t smem = bf16_smem(seq, D);
  if ((e = set_smem(attention_bwd_bf16<D, KC>, smem)) != cudaSuccess) return e;
  attention_bwd_bf16<D, KC><<<B * heads, round16(seq) / 16 * 32, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(grad), static_cast<bf16*>(dqkv),
      seq, width, heads, scale, causal);
  return cudaGetLastError();
}

template <int D, int KC, int CS>
cudaError_t launch_f32_cs(const void* qkv, const void* grad, void* dqkv, int B, int seq,
                          int width, int heads, float scale, int causal, cudaStream_t s) {
  cudaError_t e;
  const size_t smem = f32_smem(seq, D);
  if ((e = set_smem_shared_carveout(attention_bwd_f32<D, KC, CS>, smem)) != cudaSuccess) return e;
  attention_bwd_f32<D, KC, CS><<<B * heads, 2 * KC * CS, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(grad),
      static_cast<float*>(dqkv), seq, width, heads, scale, causal);
  return cudaGetLastError();
}

template <int D, int KC>
cudaError_t launch_f32(const void* qkv, const void* grad, void* dqkv, int B, int seq, int width,
                       int heads, float scale, int causal, cudaStream_t s) {
  if (f32_split(KC, B * heads) == 2) return launch_f32_cs<D, KC, KC <= 32 ? 2 : 1>(MNT_ARGS);
  return launch_f32_cs<D, KC, 1>(MNT_ARGS);
}

template <int D>
cudaError_t dispatch_kc(const void* qkv, const void* grad, void* dqkv, int B, int seq,
                        int width, int heads, float scale, int causal, int dtype,
                        cudaStream_t s) {
  if (dtype == 0) {  // fp32: KC = round16(T)
    switch (round16(seq)) {
      case 16: return launch_f32<D, 16>(MNT_ARGS);
      case 32: return launch_f32<D, 32>(MNT_ARGS);
      case 48: return launch_f32<D, 48>(MNT_ARGS);
      case 64: return launch_f32<D, 64>(MNT_ARGS);
      case 80: return launch_f32<D, 80>(MNT_ARGS);
      case 96: return launch_f32<D, 96>(MNT_ARGS);
      case 112: return launch_f32<D, 112>(MNT_ARGS);
      default: return launch_f32<D, 128>(MNT_ARGS);
    }
  }
  switch (key_capacity(round16(seq))) {
    case 16: return launch_bf16<D, 16>(MNT_ARGS);
    case 32: return launch_bf16<D, 32>(MNT_ARGS);
    case 64: return launch_bf16<D, 64>(MNT_ARGS);
    case 96: return launch_bf16<D, 96>(MNT_ARGS);
    default: return launch_bf16<D, 128>(MNT_ARGS);
  }
}
#undef MNT_ARGS

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the larger of the two
// types'); the wrapper checks it before launching.  Above kResidentMaxSeq
// it no longer depends on seq.
size_t mnt_attention_bwd_smem(int seq, int head_dim) {
  if (seq > kResidentMaxSeq) {
    return std::max(bf16_wgmma_smem(head_dim), tf32_smem(head_dim));
  }
  if (seq > kWholeMaxSeq) {
    return std::max(resident_bf16_smem(seq, head_dim), tf32_smem(head_dim));
  }
  return std::max(bf16_smem(seq, head_dim), f32_smem(seq, head_dim));
}

// The longest seq bf16 holds resident; above it both types take the
// streamed pair (the wrapper counts those launches apart).
int mnt_attention_bwd_resident_max_seq() { return kResidentMaxSeq; }

// Kernels one call launches for (seq, dtype): 2 where it takes a pair (the
// query side, then the key side: fp32 above kWholeMaxSeq, bf16 above
// kResidentMaxSeq), else 1.
int mnt_attention_bwd_kernels(int seq, int dtype) {
  return seq > (dtype == 0 ? kWholeMaxSeq : kResidentMaxSeq) ? 2 : 1;
}

// Warps per block of the kernel (or kernel pair) that takes (seq, head_dim,
// dtype) over B * heads = rows_x_heads (batch row, head)s on the current
// device.
int mnt_attention_bwd_warps(int seq, int head_dim, int dtype, int rows_x_heads) {
  if (seq > kWholeMaxSeq) {
    if (dtype == 0) return kTfThreads / 32;
    return seq <= kResidentMaxSeq ? resident_warps(seq) : kTileThreads / 32;
  }
  return round16(seq) / 16 * (dtype == 0 ? f32_split(round16(seq), rows_x_heads) : 1);
}

// Bytes of fp32 workspace a call needs: a pair's row statistics, each
// query row's base-2 lse and r * D^-0.5, for every (row, head, query),
// queries rounded up to 64, where the call takes a pair; 0 otherwise.
size_t mnt_attention_bwd_workspace(int B, int seq, int heads, int dtype) {
  const size_t rows = (size_t)B * heads * stats_rows(seq);
  return mnt_attention_bwd_kernels(seq, dtype) == 2 ? 2 * sizeof(float) * rows : 0;
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
