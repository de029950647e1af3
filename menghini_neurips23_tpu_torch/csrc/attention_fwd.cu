// K1: multi-head self-attention forward over CLIP's fused qkv projection.
//
// Replaces: menghini_neurips23_tpu/ops/attention.py `_fwd_kernel` (reached
// through `_fwd` and `fused_attention`), the Pallas kernel of the JAX package.
//
// What it computes, per batch row b and head h (D = W / heads):
//   q, k, v = qkv[b, :, h*D:(h+1)*D], qkv[b, :, W+h*D:...], qkv[b, :, 2W+h*D:...]
//   s = (q . k^T) accumulated in fp32, times D^-0.5, plus -inf above the
//       diagonal when causal
//   p = softmax(s) in fp32 (exp(s - max) / sum), rounded to the input type
//   out[b, :, h*D:(h+1)*D] = (p . v) accumulated in fp32, rounded to the input type
// The (B, H, T, T) scores never reach device memory.  P is normalised before
// it is rounded and multiplied by V, as the Pallas kernel does (no deferred
// flash-style normalisation, which would move a rounding point).
//
// What bounds it on an H100.  The work is 4*B*H*T^2*D operations against
// B*T*4W elements read and written.  bf16: memory.  CLIP's sequences are
// short (T = 50 vision tokens, <= 77 text tokens, 257/273 for ViT-L/14)
// and D = 64: about 25 operations per byte at the ViT-B/32 vision shape and
// about 170 at T = 337, below the ~295 per byte where the bf16 tensor cores
// would become the limit.  What the design has to avoid is
// paying more than the bytes: scalar 2-byte staging, fp32 conversions, two
// shared-memory loads per FMA, loads that wait on nothing to overlap.
// fp32: an fp32-accurate product on the tensor cores is three TF32
// products (3xTF32, below), so the least time for the operations is 3 x
// FLOPs at the TF32 rate (494 TFLOP/s), under FLOPs at the FMA rate (67
// TFLOP/s); PyTorch's own fp32 attention takes the same route.  That keeps
// fp32 up to 128 tokens bound by memory (ViT-B/32 vision: 0.047 ms of bytes
// against 0.012 of 3xTF32 operations at B = 256) and past it by operations.
//
// Design up to 128 keys (CLIP's text tower, ViT-B/32's vision tower), one
// block per (batch row, head), reading the fused layout in place (no
// head-split copies), one warp per 16-row query tile:
// - staging: q and k rows, then v rows in a second group that lands while
//   the scores run, go to shared memory with 16-byte cp.async copies; rows
//   past T are zero-filled; rows are padded (D + 8 bf16, D + 4 floats) so
//   that ldmatrix and the column reads of V are free of bank conflicts;
// - the key capacity KC is a template parameter: score tiles and unrolled
//   loops are sized by it, so short text sequences and the 50-token vision
//   tower keep few enough registers for several blocks per SM; bf16 takes
//   the smallest of 16, 32, 64, 96 and 128 that holds T, fp32 round16(T)
//   itself (T = 66 computes 80 keys, not 96), and the work stops at the
//   tile's diagonal when causal;
// - the scores are computed once and kept in registers, and the
//   exponential of each is taken once (the bf16 kernel keeps the loop over
//   128-key chunks, with its rescaled row statistics, from when it also
//   took longer rows: up to 128 keys it runs once);
// - bf16, on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
//   accumulators): each warp's S = Q.K^T for up to 128 keys stays in
//   registers (16 x 128 fp32 across the warp), the row max and sum are quad
//   shuffles, and P = exp(s - m) * (1/l) is rounded to bf16 straight into
//   the A fragments of P.V;
// - fp32, on the tensor cores as 3xTF32 (mma.sync m16n8k8, split_tf32 and
//   mma_3xtf32 in attention_common.cuh): the warp's S
//   stays in the accumulators, in base 2 (D^-0.5 * log2(e) folded into the
//   scale, one ex2 a score), and P = 2^(s - m) * (1/l), normalised in fp32,
//   goes from there into the A fragments of P.V (the keys 2q, 2q + 1 of a
//   tile as the fragment's k = q, q + 4, V's rows read in that order), so
//   no P touches shared memory.  Register tiles on the FMA units, each
//   shared-memory float4 feeding 4-16 FMAs and a P tile of 16 x (KC + 4)
//   floats a warp (97 KB a block at T = 66), would be bound by the FMA
//   rate and by residency; this block takes K, V and its q rows, 3 x
//   round16(T) x (D + 4) floats (52 KB at T = 50, 65 KB at T = 66-80), for
//   four and three blocks an SM;
// - causal rows skip whole 16-key tiles above the diagonal and mask inside
//   the diagonal tile (and the tile holding T); masked and padded keys give
//   P = 0 exactly.
//
// bf16 above kShortMaxSeq (ViT-L/14's vision tower: 257 tokens, 273 with a
// 16-token VPT prompt, 261 with UPT's, 337 with an 80-token prompt;
// ViT-L/14@336's 577) both products run on Hopper's warpgroup MMA
// (wgmma.mma_async m64nNk16, bf16 operands, fp32 accumulators), the only
// way to the tensor cores' full rate; mma.sync left the two sweeps
// issue-bound at 1.4-4x a library call:
// - a warpgroup (4 warps) per 64 query rows;
// - q, K and V land by 16-byte cp.async in the swizzled layout wgmma's
//   matrix descriptors read: rows of 2D bytes, the 128-, 64- or 32-byte
//   swizzle for D = 64, 32 or 16 (a row is one swizzle atom wide); keys
//   past T are zero-filled;
// - S = q . K^T has both operands in shared memory (q and K, both
//   K-major), 32 fp32 scores a thread per 64 keys in the accumulator layout
//   of mma.sync's 16 x 8 tiles;
// - P.V takes P from registers: 2^((s - m) D^-0.5 log2(e)) / l, normalised
//   in fp32 and rounded to bf16, is the A fragments of m64n(D)k16, and V's
//   chunk (rows [key][d], MN-major for this product) is B with the
//   transpose bit; P never touches shared memory;
// - up to kResidentMaxSeq (320) keys (attention_fwd_onesweep) a block is
//   one warpgroup that holds the head's K and V (80 KB at 320 and D = 64)
//   and walks a run of its query tiles; each tile's scores over every key
//   stay in registers (160 a thread at 257-320 keys), so each score and
//   each exponential is computed once: the exact row max by fmax, one ex2
//   a score, the sum, then P.V;
// - past it (attention_fwd_wgmma) one or two warpgroups a block
//   (wgmma_groups: two share every K and V chunk, halving what a block reads
//   from L2, unless the grid would then give an SM fewer than two blocks),
//   two blocks an SM in 128 registers a thread, stream a ring of (K, V)
//   chunk pairs (sweep 1 stages K alone, sweep 2 K and V), the next step's
//   chunk landing while this one computes, in two sweeps: sweep 1 keeps each
//   row's online max m and sum l, sweep 2 recomputes the scores and adds the
//   normalised, rounded P times V;
// - the base-2 softmax with D^-0.5 log2(e) folded into one FFMA and one ex2
//   a score, chunks past a causal diagonal skipped, the 8-key groups past
//   T left out of the exponentials (their P is exactly 0 either way), warps
//   whose rows all lie past T left out of the softmax; one owner per output
//   element, no atomics.
// Every branch around a wgmma is uniform for the compiler (the warp index
// is broadcast from lane 0) and no register a wgmma writes is touched while
// one is in flight: ptxas otherwise serialises every wgmma of the kernel.
// What bounds it on an H100: the exponentials (MUFU, 16 a clock an SM),
// then the products, and past 320 tokens each run twice (PERF.md: the
// one-sweep form's products alone and softmax alone).

// fp32 above kShortMaxSeq (ViT-L/14's vision tower at the default type:
// 257 tokens for the frozen passes, 273 for VPT, 261 for UPT;
// attention_fwd_tf32) runs on warpgroup MMA as 3xTF32, on the bf16 form's
// 64-row tiles, 64-key chunks and two sweeps (replacing a 3xTF32 kernel on
// mma.sync m16n8k8, which Ampere has, at 1.0-1.25x SDPA's forward and
// 0.10-0.16 of its bound, held by the instructions that split every
// fragment into hi and lo in every warp at every product).  What bounds it on an H100:
// operations, 3 x FLOPs at the TF32 rate (the two sweeps form S twice, so
// the design's own floor is 1.5x that, and a 64-row tile over T = 257
// computes 320 rows and keys).  The design:
// - every product is hi.hi + hi.lo + lo.hi of x = hi + lo (hi x rounded to
//   TF32 as split_tf32 rounds it, lo = x - hi exactly, of which the tensor
//   cores read the top bits), m64nNk8 tf32;
// - 32-bit operands of wgmma are K-major only (no transpose bit), and B
//   comes from shared memory: S = q . K^T takes q and K's chunk from shared
//   memory as they land (rows [row][d]), P.V takes P from registers and V^T
//   (rows [d][key]).  The split lives in shared memory as planes: the block
//   turns each landed tile of q and K into its hi in place and writes its lo
//   beside it, and transposes V's landed rows through registers into V^T's
//   two planes, each 8-key group in the order (0, 2, 4, 6, 1, 3, 5, 7), the
//   k order of P's A fragment taken straight from the scores' accumulators
//   (which is mma.sync's m16n8k8 A layout a warp);
// - an fp32 row of D = 64 is 256 bytes, two swizzle atoms: q's and K's
//   tiles are cut along d into sub-tiles of 32 floats (128-byte rows,
//   128-byte swizzle; D = 16 one of 64 bytes), V^T's along the keys into two
//   of 32;
// - the tensor cores' adders truncate: each product sums its small terms
//   first (lo.hi, then hi.lo, then hi.hi), and each half chunk's P.V (32
//   keys) goes to a zeroed tile of its own, added to O in fp32, so P.V's
//   chains take 4 k-steps at full size (one tile a chunk took 16; over 12
//   inputs at (8, 1024) with V 4x larger the card's mean error fell from
//   7.9e-6 to 7.2e-6; a second tile for S's hi.hi did not lower it, and the
//   largest error, ~1e-5 either way, comes from elsewhere: PERF.md);
// - three warpgroups a block share each chunk's planes (q's two planes a
//   warpgroup, two stages of K, K's lo plane, V^T's two, V's landing rows:
//   194 KB at D = 64, one block an SM), the next chunk landing while this
//   one computes; 4 x 32 fp32 registers a thread at D = 64 (S and then P's
//   hi fragments, P's lo, the chunk's P.V, O) would just exceed the 168
//   that 384 threads an SM leave (28 bytes of spills), so P.V takes each
//   chunk in two halves of 32 keys, each waited for before the next half's
//   fragments are formed (163 registers, and no slower).
// Why three products: one TF32 product keeps 10 fraction bits, and the
// schedule over T = 337 keys at D = 64 then errs by 3.2e-4 (1.2e-3 causal)
// against the JAX package's forward, past the 1e-5 the kernel is held to;
// hi.hi + hi.lo + lo.hi leaves out lo.lo and the bits below lo and errs by
// 6.0e-7 (7.7e-7) in the emulation, 2-2.5e-6 on the card, where the
// tensor cores' adders truncate (tests/test_torch_port_wgmma_tf32.py
// emulates both).

#include "attention_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

// Up to kShortMaxSeq keys a warp's scores stay in its registers (one block
// a (row, head), a warp per 16-row tile); above that bf16 runs on warpgroup
// MMA, holding K and V resident in shared memory (and a tile's scores in
// registers) up to kResidentMaxSeq keys and streaming them past it, and
// fp32 runs on it as 3xTF32, streaming them.
constexpr int kShortMaxSeq = 128;
constexpr int kResidentMaxSeq = 320;

int resident_max_seq(int dtype) { return dtype == 0 ? kShortMaxSeq : kResidentMaxSeq; }

size_t bf16_smem(int seq, int D) {
  return (size_t)3 * round16(seq) * (D + 8) * sizeof(bf16);
}
// fp32: K, V and the warps' q rows, round16(T) rows each
size_t f32_smem(int seq, int D) { return (size_t)3 * round16(seq) * (D + 4) * sizeof(float); }

// fp32 blocks an SM for KC = round16(T) keys (a warp per 16 of them): as
// many as shared memory holds at D = 64 (3 x KC x 68 floats a block), at
// most 8; __launch_bounds__ then keeps the registers within them
__host__ __device__ constexpr int f32_blocks(int KC) {
  return KC <= 32 ? 8 : KC <= 48 ? 5 : KC <= 64 ? 4 : KC <= 80 ? 3 : 2;
}

// bf16 above kShortMaxSeq: query rows a warpgroup and keys a chunk (a step
// of either sweep), the most warpgroups a block (attention_fwd_wgmma),
// blocks an SM (attention_fwd_wgmma: the 128 registers a thread that two
// blocks of two warpgroups leave, 49 KB of shared memory each;
// attention_fwd_onesweep: one warpgroup in up to 255 registers, 97 KB at T
// = 257-320 and D = 64), and the streamed ring's stages of (K, V) chunk
// pairs
constexpr int kWgRows = 64;
constexpr int kWgKeys = 64;
constexpr int kWgMaxGroups = 2;
constexpr int kWgBlocks = 2;
constexpr int kWgStages = 2;

// bytes of a 64-row tile of q, K or V (rows of 2D bytes, swizzled)
__host__ __device__ constexpr int wg_tile_bytes(int D) { return kWgRows * 2 * D; }

// a block's shared memory: 1 KB to align the tiles to the 128-byte
// swizzle's 1024-byte period, then (attention_fwd_wgmma, streamed) a q tile
// a warpgroup and K and V of kWgStages chunks, or (attention_fwd_onesweep,
// resident) two q tiles and K and V of all `chunks`: 99,328 bytes at T =
// 257-320 and D = 64
size_t wgmma_smem(int groups, int D) {
  return 1024 + (size_t)(groups + 2 * kWgStages) * wg_tile_bytes(D);
}
size_t onesweep_smem(int chunks, int D) {
  return 1024 + (size_t)(2 + 2 * chunks) * wg_tile_bytes(D);
}

// Warpgroups a block: kWgMaxGroups share each K and V chunk, unless the
// grid of blocks that gives would give an SM fewer than kWgBlocks of them
int wgmma_groups(int seq, int rows_x_heads, int sms) {
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const long long blocks = (long long)rows_x_heads * ((tiles + kWgMaxGroups - 1) / kWgMaxGroups);
  return blocks < (long long)kWgBlocks * sms ? 1 : kWgMaxGroups;
}

// fp32 above kShortMaxSeq (attention_fwd_tf32), on attention_fwd_wgmma's
// 64-row tiles and 64-key chunks: warpgroups a block (they share each
// chunk's planes; one block an SM at D = 64, so three warpgroups there in
// up to 168 registers a thread), and the bytes of a 64-row fp32 tile (q or
// a chunk of K) and of a chunk of V^T
constexpr int kTfGroups = 3;
__host__ __device__ constexpr int tf_tile_bytes(int D) { return kWgRows * 4 * D; }
__host__ __device__ constexpr int tf_vt_bytes(int D) { return D * 4 * kWgKeys; }

// a block's shared memory: 1 KB to align the tiles to the swizzle's
// 1024-byte period, q's hi and lo planes a warpgroup, K's chunk in two
// stages and its lo plane, V^T's hi and lo planes, and V's landing rows
// (D + 4 floats, free of bank conflicts for the transposing reads):
// 198,656 bytes at D = 64
size_t tf32_smem(int D) {
  return 1024 + (size_t)(2 * kTfGroups + 3) * tf_tile_bytes(D) + 2 * (size_t)tf_vt_bytes(D) +
         (size_t)kWgKeys * (D + 4) * sizeof(float);
}

// ------------------------------------------------------------------ bf16

template <int D, int KC>
__global__ void __launch_bounds__(2 * KC, KC <= 64 ? 256 / KC : 1)
attention_fwd_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
                   int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int rb = 16 * nwarps * blockIdx.y;  // the block's first query row
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + 16 * nwarps * LD;
  bf16* vs = ks + tp * LD;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  // q and k first, v in a second group that lands while the scores run
  stage_rows<bf16, D>(qs, LD, base + rb * stride, stride, seq - rb,
                      min(16 * nwarps, tp - rb), tid, blockDim.x);
  stage_rows<bf16, D>(ks, LD, base + width, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  stage_rows<bf16, D>(vs, LD, base + 2 * width, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int r0 = rb + 16 * warp;
  const bool active = r0 < tp;
  const int kend = causal ? min(tp, r0 + 16) : tp;
  const int nch = KC < 128 ? 1 : (kend + KC - 1) / KC;  // below 128 keys, KC holds them all
  uint32_t qf[D / 16][4];
  float s[KC / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, inv_l[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, LD, r0 - rb, 16 * kk, lane);
    // sweep 1: row max and sum (rescaled from chunk to chunk past KC keys);
    // with one chunk, s keeps exp(s - m) for the P.V sweep
    float l[2] = {0.f, 0.f};
    for (int c = 0; c < nch; ++c) {
      scores_bf16<D, KC>(s, qf, ks, c * KC, kend, seq, r0, causal, scale, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = -INFINITY;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) cm = fmaxf(cm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float mn = fmaxf(m[r], group_max<4>(cm));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float ex = expf(s[n][e] - mn);
            sum += ex;
            if (nch == 1) s[n][e] = ex;
          }
        l[r] = l[r] * expf(m[r] - mn) + group_sum<4>(sum);  // one chunk: 0 + sum
        m[r] = mn;
      }
    }
    inv_l[0] = 1.f / l[0];
    inv_l[1] = 1.f / l[1];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // sweep 2: P = exp(s - m) / l rounded to bf16 into the A fragments of P.V
  float o[D / 8][4] = {};
  for (int c = 0; c < nch; ++c) {
    if (nch > 1) {
      scores_bf16<D, KC>(s, qf, ks, c * KC, kend, seq, r0, causal, scale, lane);
#pragma unroll
      for (int n = 0; n < KC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
    }
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const int n0 = c * KC + 16 * j;
      if (n0 >= kend) break;
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        a[2 * t] = pack_bf16(s[2 * j + t][0] * inv_l[0], s[2 * j + t][1] * inv_l[0]);
        a[2 * t + 1] = pack_bf16(s[2 * j + t][2] * inv_l[1], s[2 * j + t][3] * inv_l[1]);
      }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bv[4];
        load_b_cols(bv, vs, LD, n0, 16 * dd, lane);
        mma_bf16(o[2 * dd], a, bv[0], bv[1]);
        mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
      }
    }
  }
  bf16* out_b = out + (size_t)b * seq * width + h * D;
  const int row0 = r0 + lane / 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < seq)
        *reinterpret_cast<uint32_t*>(out_b + (size_t)(row0 + 8 * r) * width + col) =
            pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------------ fp32

// fp32, T <= kShortMaxSeq.  Block (batch row, head), a warp per 16-row
// query tile, every product as 3xTF32 on mma.sync m16n8k8.  KC is
// round16(T) itself, so that the registers and the block are sized to the
// sequence (f32_blocks blocks an SM).  One sweep: the warp's scores against the keys its rows
// see (kend: KC, or the tile's diagonal when causal) stay in the
// accumulators, scaled by D^-0.5 * log2(e), so that P = 2^(s - m) * (1 / l)
// is formed there in fp32 with one MUFU operation a score and goes straight
// into the A fragments of P.V (acc2_times_rows_tf32).  Shared memory: the
// head's K and V and each warp's 16 q rows, D + 4 floats a row; q and K
// land first, V in a second group while the scores run.
template <int D, int KC>
__global__ void __launch_bounds__(2 * KC, f32_blocks(KC))
attention_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out, int seq, int width,
                  int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 4;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + tp * LD;
  float* qw = vs + tp * LD + warp * 16 * LD;  // this warp's q rows

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int r0 = 16 * warp;  // < T: the block has round16(T) / 16 warps
  stage_rows<float, D>(qw, LD, base + r0 * stride, stride, seq - r0, 16, lane, 32);
  stage_rows<float, D>(ks, LD, base + width, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  stage_rows<float, D>(vs, LD, base + 2 * width, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int kend = causal ? r0 + 16 : tp;  // the keys this warp's rows see
  float s[KC / 8][4];
  scores_tf32<D, KC>(s, qw, ks, 0, kend, seq, r0, causal, scale2, lane);
  // each row's max m (key 0 is among its keys: m is finite) and 1 / l,
  // reduced over the row's quad; s becomes 2^(s - m)
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    m = group_max<4>(m);
    float l = 0.f;
#pragma unroll
    for (int n = 0; n < KC / 8; ++n) {
      if (8 * n >= kend) break;
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[n][e] = ex2(s[n][e] - m);
        l += s[n][e];
      }
    }
    inv_l[r] = 1.f / group_sum<4>(l);
  }
  cp_async_wait<0>();
  __syncthreads();  // V

  // P = 2^(s - m) / l in fp32, then O += P . V 16 keys at a time
  float o[D / 8][4] = {};
#pragma unroll
  for (int j = 0; j < KC / 16; ++j) {
    if (16 * j >= kend) break;
    float p[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = s[2 * j + t][e] * inv_l[e >> 1];
    acc2_times_rows_tf32<D>(o, p[0], p[1], vs + 16 * j * LD, lane);
  }
  float* out_b = out + (size_t)b * seq * width + h * D;
  const int row0 = r0 + lane / 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < seq)
        *reinterpret_cast<float2*>(out_b + (size_t)(row0 + 8 * r) * width + col) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------ wgmma

// (the bf16 layouts and products are attention_wgmma.cuh's)

// bf16, kShortMaxSeq < T <= kResidentMaxSeq: one sweep with the scores held
// in registers.  Block (batch row x head, run of 64-row query tiles): one
// warpgroup, which stages the head's K and V once and takes the run's
// tiles in turn, the next tile's q landing while this one computes; two
// blocks an SM, each in up to 255 registers, not in step with each other
// (two warpgroups a block sharing K and V, one block an SM, measured 1.5-1.6x
// slower: each block's staging and each phase ran with nothing to overlap).
// NCH = ceil(T / 64) key chunks is a template parameter, so that the NCH
// score accumulators (32 fp32 a thread each: 160 registers at NCH = 5) are
// indexed at compile time.  Shared memory, from a 1024-byte boundary: two q
// tiles, then K's NCH chunks and V's, all in the swizzled layout: 99,328
// bytes at NCH = 5 and D = 64.  The first tile's q and K's chunk 0 land in
// cp.async group 0, K's chunk c in group c, V in group NCH, and each
// chunk's S = q . K^T (SS m64n64k16) is issued as the chunk lands (one
// m64n256 product for four chunks measured 5-8% slower); a later tile
// issues them all at once.  After one wait: -inf past
// T and past a causal row's diagonal, each row's exact max m by fmax over
// the held scores (no exponential), one ex2 a score (D^-0.5 log2(e) folded
// into its FFMA), the quad sum l and 1/l; then P = 2^((s - m) scale2) *
// (1/l), normalised in fp32, rounded to bf16 into the A fragments of P.V
// (RS m64n(D)k16, V with the transpose bit) for every chunk, and every P.V
// step issued at once (a chunk's P.V in flight while the next chunk's
// fragments were formed made ptxas serialise every wgmma at NCH = 5, short
// of registers: 13-15% slower); one wait before O is stored.  A causal tile
// computes every chunk's scores (its chunks past the diagonal are -inf,
// their P 0) but only the exponentials and P.V steps up to its keys; 8-key
// groups past the tile's keys are left out of the exponentials (their P is
// exactly 0) and warps whose rows all lie past T out of the softmax.
//
// MNT_K1_PART, a build flag that only scripts/streamed_attention_compare.py
// --resident sets (the package builds with 0): 1 leaves the softmax out (P
// is the raw scores, rounded), 2 the products (the scores are a function of
// the thread, and O sums the P fragments' bits), so that the two halves
// can be timed apart.
#ifndef MNT_K1_PART
#define MNT_K1_PART 0
#endif
template <int D, int NCH>
__global__ void __launch_bounds__(128, kWgBlocks)
attention_fwd_onesweep(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
                       int heads, float scale, int causal, int run) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile_bytes(D), NO = D / 2;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, lane = tid % 32;
  // the warp's index broadcast from lane 0 (attention_fwd_wgmma says why)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;  // two q tiles
  const uint32_t ks = qs + 2 * TILE, vs = ks + NCH * TILE;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int t0 = blockIdx.y * run, t1 = min((seq + kWgRows - 1) / kWgRows, t0 + run);
  const int q2 = 2 * (lane & 3);
  auto stage_q = [&](int t) {
    stage_swizzled<D>(qs + (t & 1) * TILE, base + t * kWgRows * stride, stride,
                      seq - t * kWgRows, kWgRows, tid, 128);
  };
  stage_q(t0);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    stage_swizzled<D>(ks + c * TILE, base + width + c * kWgKeys * stride, stride,
                      seq - c * kWgKeys, kWgKeys, tid, 128);
    cp_async_commit();
  }
  stage_swizzled<D>(vs, base + 2 * width, stride, seq, NCH * kWgKeys, tid, 128);
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const int r0 = t * kWgRows + 16 * warp;
    const bool live = r0 < seq;                                   // the warp has rows
    const int kend = causal ? min(seq, (t + 1) * kWgRows) : seq;  // the keys the tile's rows see
    // the last key each of the thread's two rows sees
    const int row = r0 + lane / 4;
    const int last[2] = {causal ? min(seq - 1, row) : seq - 1,
                         causal ? min(seq - 1, row + 8) : seq - 1};

    // S = q . K^T, all chunks in flight at once (the first tile's as K
    // lands); the scores stay unscaled (scale2 is folded into each
    // exponential's FFMA)
    const uint64_t q_desc = wg_desc<D>(qs + (t & 1) * TILE);
    float s[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (t == t0) {
        cp_async_wait_upto(NCH - c);  // q and K's chunks up to c
        fence_proxy_async();
        __syncthreads();
      } else if (c == 0) {
        cp_async_wait<0>();  // this tile's q
        fence_proxy_async();
        __syncthreads();
      }
#if MNT_K1_PART == 2
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[c][i] = __uint_as_float(0x3f800000u | (((tid + 7 * i + 13 * c) & 63u) << 17));
      }
#else
      const uint64_t k_desc = wg_desc<D>(ks + c * TILE);
      wgmma_fence();
      wgmma_ss<0>(s[c], q_desc, k_desc);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(s[c], q_desc + 2 * kk, k_desc + 2 * kk);
      wgmma_commit();
#endif
    }
    if (t == t0) {
      cp_async_wait<0>();  // V, under the products
      fence_proxy_async();
      __syncthreads();
    }
    // the next tile's q, into the tile the one before used (its products
    // were waited for before every thread met above)
    if (t + 1 < t1) stage_q(t + 1);
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(s[c]);

    // the exact row max m (key 0 is in every row's first chunk: m is
    // finite), then s becomes 2^((s - m) scale2), summed into l
    // (lane-partial, then over the row's quad); groups past the tile's
    // keys become 0
    float ms[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int c0 = c * kWgKeys;
      if (c0 + kWgKeys > seq || (causal && c0 + kWgKeys - 1 > r0)) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + 8 * i + q2 + (e & 1) > last[e >> 1]) s[c][4 * i + e] = -INFINITY;
      }
    }
#if MNT_K1_PART == 1
    inv_l[0] = inv_l[1] = 1.f;
#else
    if (live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            m = fmaxf(m, fmaxf(s[c][4 * i + 2 * r], s[c][4 * i + 2 * r + 1]));
          }
        ms[r] = group_max<4>(m) * scale2;
      }
      float l[2] = {0.f, 0.f};
      auto expo = [&](float(&sc)[32], int i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * i + e] = ex2(fmaf(sc[4 * i + e], scale2, -ms[e >> 1]));
          l[e >> 1] += sc[4 * i + e];
        }
      };
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (!causal && c < NCH - 1) {  // the chunk's keys all lie below T
#pragma unroll
          for (int i = 0; i < 8; ++i) expo(s[c], i);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (c * kWgKeys + 8 * i < kend) {
              expo(s[c], i);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) s[c][4 * i + e] = 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / group_sum<4>(l[r]);
    }
#endif

    // P.V (chunk c's k-step j: keys 64c + 16j ..), up to the tile's keys
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    // every chunk's fragments first, then every P.V step
    uint32_t a[NCH][4][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t& lo = a[c][i / 2][2 * (i % 2)];
        uint32_t& hi = a[c][i / 2][2 * (i % 2) + 1];
        if (live) {
          lo = pack_bf16(s[c][4 * i] * inv_l[0], s[c][4 * i + 1] * inv_l[0]);
          hi = pack_bf16(s[c][4 * i + 2] * inv_l[1], s[c][4 * i + 3] * inv_l[1]);
        } else {
          lo = hi = 0u;
        }
      }
    }
#if MNT_K1_PART == 2
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[(4 * j + e) % NO] += __uint_as_float(a[c][j][e] & 0x3fff3fffu);
        }
#else
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(a[c][j]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c * kWgKeys + 16 * j < kend) {
          wgmma_rs<D>(o, a[c][j], wg_desc<D>(vs + c * TILE + j * 16 * 2 * D));
        }
      }
    wgmma_commit();
#endif
    wgmma_wait_all();
    fence_regs(o);
    if (!live) continue;
    bf16* out_b = out + (size_t)b * seq * width + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < seq)
          *reinterpret_cast<uint32_t*>(out_b + (size_t)(row + 8 * r) * width + 8 * j + q2) =
              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

// bf16, T > kResidentMaxSeq.  Block (batch row x head, group of 64-row query
// tiles), a warpgroup per tile (blockDim / 128 of them), every product on
// warpgroup MMA.  Shared memory, from a 1024-byte boundary: a q tile a
// warpgroup, then kWgStages (K, V) chunk pairs, all in the swizzled layout.
// The two sweeps are one
// stream of 2 * nch steps over the block's chunks (causal: up to its last
// row's diagonal): steps 0 .. nch - 1 take each row's online max m and
// sum l of P = 2^((s - m) scale2) (scale2 = D^-0.5 * log2(e)); steps nch ..
// 2 nch - 1 recompute the scores and add the normalised P / l, rounded to
// bf16 in the A fragments of P.V, times V.  The chunk
// of step + kWgStages - 1 is staged while step computes, behind one barrier
// a step.  A warpgroup skips the chunks its rows see none of (causal) and
// the rest of the block's steps when its tile lies past T, but keeps to
// the barriers.
template <int D>
__global__ void __launch_bounds__(128 * kWgMaxGroups, kWgBlocks)
attention_fwd_wgmma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
                    int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile_bytes(D), NO = D / 2;
  // chunks staged this many steps ahead, into the stage of the step before
  // (each step ends with nothing in flight)
  constexpr int kAhead = kWgStages - 1;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid % 32;
  // the warp's index broadcast from lane 0, so that the compiler sees it
  // warp-uniform: the branches on the tile and row bounds derived from it
  // are then uniform, and wgmma's register dependences need no barrier
  // inside a divergent path (which would serialise every wgmma)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4, warp = warp_id % 4;
  const int rows = nthreads / 2;  // the block's query rows, 64 a warpgroup
  const int rb = rows * blockIdx.y, rt = rb + kWgRows * wg, r0 = rt + 16 * warp;
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv = qs + (nthreads / 128) * TILE;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  // the keys the block's rows see (causal: up to its last row's diagonal)
  const int nch = ((causal ? min(seq, rb + rows) : seq) + kWgKeys - 1) / kWgKeys;
  const int steps = 2 * nch;
  const bool active = rt < seq;                             // the warpgroup has rows
  const bool live = r0 < seq;                               // the warp has rows
  const int kend = causal ? min(seq, rt + kWgRows) : seq;  // the keys the tile's rows see
  // the last key each of the thread's two rows sees, and its columns' offset
  const int row = r0 + lane / 4, q2 = 2 * (lane & 3);
  const int last[2] = {causal ? min(seq - 1, row) : seq - 1,
                       causal ? min(seq - 1, row + 8) : seq - 1};

  auto chunk0 = [&](int step) { return (step < nch ? step : step - nch) * kWgKeys; };
  // K's and V's chunk of a step
  auto k_tile = [&](int step) -> uint32_t { return kv + (step % kWgStages) * 2 * TILE; };
  auto v_tile = [&](int step) -> uint32_t { return kv + (step % kWgStages) * 2 * TILE + TILE; };
  auto stage = [&](int step) {  // sweep 1 stages K, sweep 2 K and V
    if (step >= steps) return;
    const int c0 = chunk0(step);
    stage_swizzled<D>(k_tile(step), base + width + c0 * stride, stride, seq - c0, kWgKeys, tid,
                      nthreads);
    if (step >= nch) {
      stage_swizzled<D>(v_tile(step), base + 2 * width + c0 * stride, stride, seq - c0, kWgKeys,
                        tid, nthreads);
    }
  };
  // group i the chunk of step i, q with the first
  stage_swizzled<D>(qs, base + rb * stride, stride, seq - rb, rows, tid, nthreads);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    stage(i);
    cp_async_commit();
  }
  // the block's barrier before a step: its chunk has landed for every
  // thread; the chunk of step + kAhead is staged behind it
  auto landed = [&](int step) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    stage(step + kAhead);
    cp_async_commit();
  };
  // S = q . K^T for the chunk of `step`, both operands from shared memory,
  // waited for; -inf where a key lies past T or the row's diagonal.  The
  // scores stay unscaled: scale2 is folded into each exponential's FFMA.
  const uint64_t q_desc = wg_desc<D>(qs + wg * TILE);
  auto scores = [&](float(&s)[32], int step) {
    const uint64_t k_desc = wg_desc<D>(k_tile(step));
    wgmma_fence();
    wgmma_ss<0>(s, q_desc, k_desc);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(s, q_desc + 2 * kk, k_desc + 2 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    const int c0 = chunk0(step);
    if (c0 + kWgKeys > seq || (causal && c0 + kWgKeys - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * i + q2 + (e & 1) > last[e >> 1]) s[4 * i + e] = -INFINITY;
    }
  };

  // sweep 1: online m (the raw scores' max, quad-uniform) and l
  // (lane-partial) of 2^((s - m) scale2); key 0, in every row's first
  // chunk, keeps m finite from there on; 8-key groups past the tile's keys
  // add 2^-inf = 0 and are left out
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int step = 0; step < nch; ++step) {
    landed(step);
    const int c0 = chunk0(step);
    if (!active || c0 >= kend) continue;
    float s[32];
    scores(s, step);
    if (!live) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) cm = fmaxf(cm, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      const float mn = fmaxf(m[r], group_max<4>(cm)), mns = mn * scale2;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (c0 + 8 * i < kend) {
          sum += ex2(fmaf(s[4 * i + 2 * r], scale2, -mns)) +
                 ex2(fmaf(s[4 * i + 2 * r + 1], scale2, -mns));
        }
      }
      l[r] = fmaf(l[r], ex2(fmaf(m[r], scale2, -mns)), sum);
      m[r] = mn;
    }
  }
  float ms[2] = {m[0] * scale2, m[1] * scale2}, inv_l[2] = {0.f, 0.f};
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / group_sum<4>(l[r]);
  }
  // sweep 2: P = 2^((s - m) scale2) / l in fp32, rounded to bf16 into the A
  // fragments of P.V (k-step j: keys c0 + 16j ..), then O += P . V over the
  // 16-key steps the tile's rows see
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  for (int step = nch; step < steps; ++step) {
    landed(step);
    const int c0 = chunk0(step);
    if (!active || c0 >= kend) continue;
    float s[32];
    scores(s, step);
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t& lo = a[i / 2][2 * (i % 2)];
      uint32_t& hi = a[i / 2][2 * (i % 2) + 1];
      if (live && c0 + 8 * i < kend) {
        lo = pack_bf16(ex2(fmaf(s[4 * i], scale2, -ms[0])) * inv_l[0],
                       ex2(fmaf(s[4 * i + 1], scale2, -ms[0])) * inv_l[0]);
        hi = pack_bf16(ex2(fmaf(s[4 * i + 2], scale2, -ms[1])) * inv_l[1],
                       ex2(fmaf(s[4 * i + 3], scale2, -ms[1])) * inv_l[1]);
      } else {
        lo = hi = 0u;
      }
    }
    const uint32_t vt = v_tile(step);
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_regs(a[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + 16 * j < kend) wgmma_rs<D>(o, a[j], wg_desc<D>(vt + j * 16 * 2 * D));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  if (!live) return;
  bf16* out_b = out + (size_t)b * seq * width + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < seq)
        *reinterpret_cast<uint32_t*>(out_b + (size_t)(row + 8 * r) * width + 8 * j + q2) =
            pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
}

// ------------------------------------------------------------ wgmma, tf32

// V's landed chunk (rows [key][d], D + 4 floats a row) into V^T's two
// planes, the B operand of P.V: rows d, the chunk's 64 keys along k in two
// sub-tiles of 32 (128-byte rows, swizzled, D rows apart), each 8-key group
// in the order (0, 2, 4, 6, 1, 3, 5, 7), which is the k order of P's A
// fragment taken from the scores' accumulators (keys 2q, 2q + 1 of the
// group as k = q, q + 4).  A thread writes one 16-byte piece of each plane
// (four keys of one d, read from four rows); a warp's lanes take 32
// consecutive d, so the reads are one row each and the writes fill the
// banks.
template <int D>
__device__ __forceinline__ void transpose_v(const float* vrows, float* vt, float* vt_lo, int tid,
                                            int nthreads) {
  constexpr int LD = D + 4;
  for (int idx = tid; idx < D * kWgKeys / 4; idx += nthreads) {
    const int d = idx % D, piece = idx / D;  // piece 2j + h: keys 8j + h + (0, 2, 4, 6)
    const float* src = vrows + (8 * (piece >> 1) + (piece & 1)) * LD + d;
    float4 h, l;
    split4(make_float4(src[0], src[2 * LD], src[4 * LD], src[6 * LD]), h, l);
    const uint32_t off = (piece / 8) * D * 128 + swizzle<128>(d * 128 + (piece % 8) * 16);
    *reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(vt) + off) = h;
    *reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(vt_lo) + off) = l;
  }
}

// fp32, T > kShortMaxSeq.  Block (batch row x head, kTfGroups 64-row query
// tiles), a warpgroup per tile, every product 3xTF32 on warpgroup MMA:
// hi.hi + hi.lo + lo.hi of x = hi + lo, hi rounded to TF32 and lo the rest.
// Shared memory, from a 1024-byte boundary: q's hi and lo planes (a tile
// each a warpgroup), two stages of K's chunk (its hi plane), K's lo plane,
// V^T's hi and lo planes, V's landing rows.  The two sweeps are one stream
// of 2 * nch steps over the block's 64-key chunks (causal: up to its last
// row's diagonal), each behind two barriers: the step's chunk has landed
// (K, and in sweep 2 V); the block splits it into its planes (q's too at
// step 0), fences them for the async proxy and meets again; then the next
// chunk is staged while this one computes.  Steps 0 .. nch - 1 take each
// row's online max m and sum l of 2^((s - m) scale2); steps nch .. 2 nch -
// 1 recompute the scores and add P = 2^((s - m) scale2) / l, in fp32, times
// V, each half of a chunk's P.V (32 keys, each waited for: registers)
// summed in a zeroed tile and then added to O.  Each product sums its two
// small terms first: the tensor cores' adders truncate, and the large sum
// then takes the fewest additions.
template <int D>
__global__ void __launch_bounds__(128 * kTfGroups, 1)
attention_fwd_tf32(const float* __restrict__ qkv, float* __restrict__ out, int seq, int width,
                   int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = tf_tile_bytes(D), VT = tf_vt_bytes(D), NO = D / 2, KS = D / 8;
  constexpr int kRowBytes = 4 * tf_sub(D);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid % 32;
  // the warp's index broadcast from lane 0 (attention_fwd_wgmma says why)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4, warp = warp_id % 4, groups = nthreads / 128;
  const int rows = kWgRows * groups;  // the block's query rows
  const int rb = rows * blockIdx.y, rt = rb + kWgRows * wg, r0 = rt + 16 * warp;
  const uint32_t raw = smem_u32(smem_raw), qh = (raw + 1023) & ~1023u;
  const uint32_t ql = qh + groups * TILE, kh = ql + groups * TILE, kl = kh + 2 * TILE;
  const uint32_t vt = kl + TILE, vt_lo = vt + VT, vrows = vt_lo + VT;
  auto at = [&](uint32_t addr) { return reinterpret_cast<float*>(smem_raw + (addr - raw)); };

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int nch = ((causal ? min(seq, rb + rows) : seq) + kWgKeys - 1) / kWgKeys;
  const int steps = 2 * nch;
  const bool active = rt < seq;                             // the warpgroup has rows
  const bool live = r0 < seq;                               // the warp has rows
  const int kend = causal ? min(seq, rt + kWgRows) : seq;  // the keys the tile's rows see
  const int row = r0 + lane / 4, q2 = 2 * (lane & 3);
  const int last[2] = {causal ? min(seq - 1, row) : seq - 1,
                       causal ? min(seq - 1, row + 8) : seq - 1};

  auto chunk0 = [&](int step) { return (step < nch ? step : step - nch) * kWgKeys; };
  auto stage = [&](int step) {  // sweep 1 stages K, sweep 2 K and V
    if (step >= steps) return;
    const int c0 = chunk0(step);
    stage_tf32<D, kWgRows>(kh + (step & 1) * TILE, base + width + c0 * stride, stride, seq - c0,
                           kWgKeys, tid, nthreads);
    if (step >= nch) {
      stage_rows<float, D>(at(vrows), D + 4, base + 2 * width + c0 * stride, stride, seq - c0,
                           kWgKeys, tid, nthreads);
    }
  };
  stage_tf32<D, kWgRows>(qh, base + rb * stride, stride, seq - rb, rows, tid, nthreads);
  stage(0);
  cp_async_commit();

  // descriptors: a k-step's offset from a tile's start, its sub-tile's and
  // its 32 bytes within the row
  auto k_off = [](int kk) { return tf_k_off<D, kWgRows>(kk); };
  auto v_off = [](int j) -> uint64_t {
    return (uint64_t)(((j / 4) * D * 128 + (j % 4) * 32) >> 4);
  };
  const uint64_t qh_desc = smem_desc<kRowBytes>(qh + wg * TILE);
  const uint64_t ql_desc = smem_desc<kRowBytes>(ql + wg * TILE);
  const uint64_t kl_desc = smem_desc<kRowBytes>(kl);
  const uint64_t vt_desc = smem_desc<128>(vt), vt_lo_desc = smem_desc<128>(vt_lo);
  // S = q . K^T for the chunk of `step`, waited for; -inf where a key lies
  // past T or the row's diagonal.  The scores stay unscaled: scale2 is
  // folded into each exponential's FFMA.
  auto scores = [&](float(&s)[32], int step) {
    const uint64_t kh_desc = smem_desc<kRowBytes>(kh + (step & 1) * TILE);
    wgmma_fence();
    wgmma_tf32_ss<64, 0>(s, ql_desc, kh_desc);
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) {
      wgmma_tf32_ss<64, 1>(s, ql_desc + k_off(kk), kh_desc + k_off(kk));
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_tf32_ss<64, 1>(s, qh_desc + k_off(kk), kl_desc + k_off(kk));
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_tf32_ss<64, 1>(s, qh_desc + k_off(kk), kh_desc + k_off(kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    const int c0 = chunk0(step);
    if (c0 + kWgKeys > seq || (causal && c0 + kWgKeys - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * i + q2 + (e & 1) > last[e >> 1]) s[4 * i + e] = -INFINITY;
    }
  };
  // the block's step: the chunk has landed; its planes (and q's at step
  // 0) split and fenced for wgmma's reads; the next chunk staged behind
  // the second barrier (K's other stage and V's rows are free by then)
  auto landed = [&](int step) {
    cp_async_wait<0>();
    __syncthreads();
    if (step == 0) split_planes(at(qh), at(qh), at(ql), groups * TILE, tid, nthreads);
    split_planes(at(kh + (step & 1) * TILE), at(kh + (step & 1) * TILE), at(kl), TILE, tid,
                 nthreads);
    if (step >= nch) transpose_v<D>(at(vrows), at(vt), at(vt_lo), tid, nthreads);
    fence_proxy_async();
    __syncthreads();
    stage(step + 1);
    cp_async_commit();
  };

  // sweep 1: online m (the raw scores' max, quad-uniform) and l
  // (lane-partial) of 2^((s - m) scale2), as attention_fwd_wgmma takes them
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int step = 0; step < nch; ++step) {
    landed(step);
    const int c0 = chunk0(step);
    if (!active || c0 >= kend) continue;
    float s[32];
    scores(s, step);
    if (!live) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) cm = fmaxf(cm, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      const float mn = fmaxf(m[r], group_max<4>(cm)), mns = mn * scale2;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (c0 + 8 * i < kend) {
          sum += ex2(fmaf(s[4 * i + 2 * r], scale2, -mns)) +
                 ex2(fmaf(s[4 * i + 2 * r + 1], scale2, -mns));
        }
      }
      l[r] = fmaf(l[r], ex2(fmaf(m[r], scale2, -mns)), sum);
      m[r] = mn;
    }
  }
  float ms[2] = {m[0] * scale2, m[1] * scale2}, inv_l[2] = {0.f, 0.f};
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / group_sum<4>(l[r]);
  }
  // sweep 2: P = 2^((s - m) scale2) / l in fp32, split into the hi and lo A
  // fragments of P.V (k-step j: keys c0 + 8j ..), then each half's P.V over
  // the k-steps the tile's rows see into a zeroed tile, added to O
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  for (int step = nch; step < steps; ++step) {
    landed(step);
    const int c0 = chunk0(step);
    if (!active || c0 >= kend) continue;
    float s[32];
    scores(s, step);
    // the chunk's P.V in two halves of 32 keys, each waited for before the
    // next half's fragments are formed (all 64 keys' hi and lo fragments at
    // once spill at D = 64, and forming one half's while the other is in
    // flight spills more), each in its own zeroed tile: one tile for the
    // chunk left 16 of its 24 k-steps adding into a full-size sum
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float oc[NO];
      if (half == 1 && c0 + 32 >= kend) break;
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * half + i;
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        if (live && c0 + 8 * j < kend) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(s[4 * j + e], scale2, -ms[e >> 1])) * inv_l[e >> 1];
          }
        }
        // the fragment's k = q, q + 4 are keys 2q, 2q + 1: (row g, row g + 8) each
        const float x[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ph[i][e] = tf32_round(x[e]);
          pl[i][e] = __float_as_uint(x[e] - __uint_as_float(ph[i][e]));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_regs(ph[i]);
        fence_regs(pl[i]);
      }
      wgmma_fence();
      wgmma_tf32_rs<D, 0>(oc, pl[0], vt_desc + v_off(4 * half));
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        const int j = 4 * half + i;
        if (c0 + 8 * j < kend) wgmma_tf32_rs<D, 1>(oc, pl[i], vt_desc + v_off(j));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * half + i;
        if (c0 + 8 * j < kend) wgmma_tf32_rs<D, 1>(oc, ph[i], vt_lo_desc + v_off(j));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * half + i;
        if (c0 + 8 * j < kend) wgmma_tf32_rs<D, 1>(oc, ph[i], vt_desc + v_off(j));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oc);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] += oc[i];
    }
  }
  if (!live) return;
  float* out_b = out + (size_t)b * seq * width + h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < seq)
        *reinterpret_cast<float2*>(out_b + (size_t)(row + 8 * r) * width + 8 * j + q2) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
}

template <int D>
cudaError_t launch_tf32(const void* qkv, void* out, int B, int seq, int width, int heads,
                        float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  const size_t smem = tf32_smem(D);
  if ((e = set_smem(attention_fwd_tf32<D>, smem)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(attention_fwd_tf32<D>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  attention_fwd_tf32<D>
      <<<dim3(B * heads, (tiles + kTfGroups - 1) / kTfGroups), 128 * kTfGroups, smem, stream>>>(
          static_cast<const float*>(qkv), static_cast<float*>(out), seq, width, heads, scale,
          causal);
  return cudaGetLastError();
}

// up to kShortMaxSeq: a block per (row, head), a warp per 16-row tile
template <int D, int KC>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int seq, int width, int heads,
                        float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  const size_t smem = bf16_smem(seq, D);
  if ((e = set_smem(attention_fwd_bf16<D, KC>, smem)) != cudaSuccess) return e;
  attention_fwd_bf16<D, KC><<<B * heads, 2 * round16(seq), smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale, causal);
  return cudaGetLastError();
}

template <int D, int KC>
cudaError_t launch_f32(const void* qkv, void* out, int B, int seq, int width, int heads,
                       float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  const size_t smem = f32_smem(seq, D);
  if ((e = set_smem(attention_fwd_f32<D, KC>, smem)) != cudaSuccess) return e;
  // several blocks an SM only with the largest carveout
  if ((e = cudaFuncSetAttribute(attention_fwd_f32<D, KC>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  attention_fwd_f32<D, KC><<<B * heads, 2 * KC, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), seq, width, heads, scale,
      causal);
  return cudaGetLastError();
}

// bf16 from kShortMaxSeq to kResidentMaxSeq (attention_fwd_onesweep): a
// block per (row x head, run of tiles), a head's tiles in as few runs as
// fill the card's kWgBlocks blocks an SM (one run a head once there are
// that many heads)
template <int D, int NCH>
cudaError_t launch_onesweep(const void* qkv, void* out, int B, int seq, int width, int heads,
                            float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const int runs = std::max(1, std::min(tiles, kWgBlocks * sms / std::max(1, B * heads)));
  const int run = (tiles + runs - 1) / runs;
  const size_t smem = onesweep_smem(NCH, D);
  auto kernel = attention_fwd_onesweep<D, NCH>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  // two blocks an SM only with the largest carveout
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  kernel<<<dim3(B * heads, (tiles + run - 1) / run), 128, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale, causal,
      run);
  return cudaGetLastError();
}

// bf16 above kResidentMaxSeq (attention_fwd_wgmma): a block per (row x
// head, group of 64-row tiles)
template <int D>
cudaError_t launch_streamed(const void* qkv, void* out, int B, int seq, int width, int heads,
                            float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  const int groups = wgmma_groups(seq, B * heads, sms);
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const size_t smem = wgmma_smem(groups, D);
  if ((e = set_smem(attention_fwd_wgmma<D>, smem)) != cudaSuccess) return e;
  // two blocks an SM only with the largest carveout
  if ((e = cudaFuncSetAttribute(attention_fwd_wgmma<D>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  attention_fwd_wgmma<D>
      <<<dim3(B * heads, (tiles + groups - 1) / groups), 128 * groups, smem, stream>>>(
          static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale,
          causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* qkv, void* out, int B, int seq, int width, int heads,
                         float scale, int causal, cudaStream_t stream) {
#define MNT_ARGS qkv, out, B, seq, width, heads, scale, causal, stream
  if (seq > kResidentMaxSeq) return launch_streamed<D>(MNT_ARGS);
  switch ((seq + kWgKeys - 1) / kWgKeys) {
    case 3: return launch_onesweep<D, 3>(MNT_ARGS);
    case 4: return launch_onesweep<D, 4>(MNT_ARGS);
    default: return launch_onesweep<D, 5>(MNT_ARGS);
  }
#undef MNT_ARGS
}

template <int D>
cudaError_t dispatch_kc(const void* qkv, void* out, int B, int seq, int width, int heads,
                        float scale, int causal, int dtype, cudaStream_t stream) {
  if (seq > kShortMaxSeq) {
    if (dtype == 0) return launch_tf32<D>(qkv, out, B, seq, width, heads, scale, causal, stream);
    return launch_wgmma<D>(qkv, out, B, seq, width, heads, scale, causal, stream);
  }
#define MNT_ARGS qkv, out, B, seq, width, heads, scale, causal, stream
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
#undef MNT_ARGS
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `dtype` (0 = float32, 1 =
// bfloat16) needs at most; the wrapper checks it against the card's limit
// before launching.  Above the resident length it no longer depends on seq.
size_t mnt_attention_fwd_smem(int seq, int head_dim, int dtype) {
  if (seq > kShortMaxSeq) {
    if (dtype == 0) return tf32_smem(head_dim);
    return seq > kResidentMaxSeq ? wgmma_smem(kWgMaxGroups, head_dim)
                                 : onesweep_smem((seq + kWgKeys - 1) / kWgKeys, head_dim);
  }
  return dtype == 0 ? f32_smem(seq, head_dim) : bf16_smem(seq, head_dim);
}

// The longest seq whose K and V stay resident in shared memory for `dtype`
// (128 float32, 320 bfloat16); longer ones stream (the wrapper counts those
// launches apart).
int mnt_attention_fwd_resident_max_seq(int dtype) { return resident_max_seq(dtype); }

// qkv: (B, seq, 3*width) contiguous, 16-byte aligned; out: (B, seq, width)
// contiguous, same type.  scale: D^-0.5 as the caller rounds it to float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int mnt_attention_fwd(const void* qkv, void* out, int B, int seq, int width, int heads,
                      float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || heads <= 0 || width % heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  switch (width / heads) {
    case 16: e = dispatch_kc<16>(qkv, out, B, seq, width, heads, scale, causal, dtype, s); break;
    case 32: e = dispatch_kc<32>(qkv, out, B, seq, width, heads, scale, causal, dtype, s); break;
    case 64: e = dispatch_kc<64>(qkv, out, B, seq, width, heads, scale, causal, dtype, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
