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
// fp32: operations.  An fp32-accurate product on the tensor cores is three
// TF32 products (3xTF32, below), so the least time is 3 x FLOPs at the TF32
// rate (494 TFLOP/s), which is under FLOPs at the FMA rate (67 TFLOP/s);
// PyTorch's own fp32 attention takes the same route.
//
// Design up to 128 keys (CLIP's text tower, ViT-B/32's vision tower), one
// block per (batch row, head), reading the fused layout in place (no
// head-split copies), one warp per 16-row query tile:
// - staging: q and k rows, then v rows in a second group that lands while
//   the scores run, go to shared memory with 16-byte cp.async copies; rows
//   past T are zero-filled; rows are padded (D + 8 bf16, D + 4 floats) so
//   that ldmatrix and float4 reads are free of bank conflicts;
// - the key capacity KC (16, 32, 64, 96 or 128, the smallest holding T) is a
//   template parameter: score tiles and unrolled loops are sized by it, so
//   short text sequences and the 50-token vision tower carry no empty slots
//   and keep few enough registers for several blocks per SM;
// - the scores are computed once and kept in registers, and exp(s - m) is
//   taken once (the kernels keep the loop over 128-key chunks, with its
//   rescaled row statistics, from when they also took longer rows: up to
//   128 keys it runs once, and the kernels compile to what they were);
// - bf16, on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
//   accumulators): each warp's S = Q.K^T for up to 128 keys stays in
//   registers (16 x 128 fp32 across the warp), the row max and sum are quad
//   shuffles, and P = exp(s - m) * (1/l) is rounded to bf16 straight into
//   the A fragments of P.V;
// - fp32, full-fp32 FFMA register tiles: lane (ry, kx) owns a 4-row x
//   KC/8-key tile of S and a 4-row x D/8 tile of O, each shared-memory
//   float4 feeding 4-16 FMAs; the rounded P of the warp's rows goes through
//   shared memory once;
// - causal rows skip whole 16-key tiles above the diagonal and mask inside
//   the diagonal tile (and the tile holding T); masked and padded keys give
//   P = 0 exactly.
//
// bf16 from 129 to kResidentMaxSeq (320) keys (ViT-L/14's vision tower: 257
// tokens, 273 with a 16-token VPT prompt, 261 with UPT's; attention_fwd_
// resident): K and V of the whole head stay in shared memory (92 KB at
// 320), and a warp's 16 x T scores no longer fit its registers:
// - a block per (batch row x head, group of query tiles), a warp per 16
//   rows, at most 9 warps; the (row, head)'s tiles split evenly over the
//   fewest blocks (T = 273: 18 tiles, two blocks of 9 warps), and over more
//   where the grid would give an SM fewer than two blocks, up to one wave
//   of two an SM (B = 8: blocks of 6 warps; a tensor-parallel rank's H/m
//   heads); two blocks share an SM (110 KB of shared memory each at 320);
// - K lands in 64-key commit groups and V in one more, so that sweep 1
//   starts on the first chunk while the rest of K and then V arrive (one
//   barrier a chunk); past that, no barrier: each warp runs alone;
// - two sweeps, the first in 64-key steps for each row's online max m and
//   sum l, the second in 32-key steps for the normalised, rounded P.V, with
//   the scores recomputed (the tensor cores recompute them for less than
//   holding 16 x T fp32 scores a warp would cost in registers); the warp's
//   q fragments are read once and held: 96 registers a thread, what 18
//   warps an SM leave (five a scheduler);
// - the softmax in base 2, D^-0.5 * log2(e) folded into the scores' scale
//   and every exponential one ex2: the streamed form's schedule, so the two
//   give the same bits.
//
// Above those (bf16 past 320 tokens: ViT-L/14 with a prompt above 63
// tokens, ViT-L/14@336's 577; fp32 past 128) K and V stream from device
// memory (attention_fwd_streamed); fp32 holding the head resident would
// take 174 KB at 320 and one block an SM:
// - a block per (batch row, head, 64-query tile), a warp per 16 rows; both
//   sweeps are one stream of steps over the block's key chunks (sweep 1
//   stages K alone, sweep 2 K and V) through a cp.async ring, the chunk of
//   step + stages - 1 landing while step computes, one barrier a step;
//   the block's shared memory does not depend on T (bf16: 2 stages of
//   64-key chunks, 46 KB, four blocks and 16 warps an SM; fp32: 3 stages
//   of 32-key chunks, 70 KB, three blocks and 12 warps an SM); a warp reads
//   its q fragments from shared memory at each step rather than holding
//   them, which keeps bf16 within the 128 registers four blocks allow;
// - the base-2 softmax and recomputed scores of the resident bf16 form;
// - bf16: the resident arithmetic (mma.sync m16n8k16, quad shuffles, P
//   packed straight into the A fragments of P.V);
// - fp32 as 3xTF32 on mma.sync m16n8k8 (attention_common.cuh): each operand
//   x = hi + lo (hi rounded to TF32 as cvt.rna.tf32.f32 rounds, lo the rest
//   cut to TF32), every product lo.hi + hi.lo + hi.hi summed in a zeroed
//   tile and then added to the fp32 accumulator, so the tensor cores'
//   truncating adders see short sums; P stays fp32 and is split like any
//   operand; its A fragments come from the scores' accumulators with the
//   keys of a k-step in the order (2q, 2q + 1) for k = (q, q + 4), and V is
//   read in that order.  Why three products: one TF32 product keeps 10
//   fraction bits, and this schedule over T = 337 keys at D = 64 then errs
//   by 3.4e-4 against the JAX package's forward, past the 1e-5 the kernel
//   is held to; hi.hi + hi.lo + lo.hi leaves out only lo.lo (2^-22 of a
//   product) and errs by 5.7e-7, about what two fp32 sums in different
//   orders differ by (tests/test_torch_port_streamed.py emulates both).

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

// Up to kShortMaxSeq keys a warp's scores stay in its registers (one block
// a (row, head), a warp per 16-row tile); up to kResidentMaxSeq bf16 K and V
// stay resident in shared memory; above those they stream (fp32 above
// kShortMaxSeq).
constexpr int kShortMaxSeq = 128;
constexpr int kResidentMaxSeq = 320;

int resident_max_seq(int dtype) { return dtype == 0 ? kShortMaxSeq : kResidentMaxSeq; }

size_t bf16_smem(int seq, int D) {
  return (size_t)3 * round16(seq) * (D + 8) * sizeof(bf16);
}
size_t f32_smem(int seq, int D) {
  const int tp = round16(seq);
  return (2 * (size_t)tp * (D + 4) + (size_t)tp * (D + 4 + key_capacity(tp) + 4)) * sizeof(float);
}

// bf16, kShortMaxSeq < T <= kResidentMaxSeq: keys a sweep-1 step (and a
// staging group of K), keys a sweep-2 step, the most warps a block, and
// blocks an SM (two: 110 KB of shared memory each at T = 320 with 9 warps,
// 96 registers a thread)
constexpr int kResKeys = 64;
constexpr int kResPvKeys = 32;
constexpr int kResMaxWarps = 9;
constexpr int kResBlocks = 2;

size_t resident_smem(int seq, int warps, int D) {
  return (16 * (size_t)warps + 2 * (size_t)round16(seq)) * (D + 8) * sizeof(bf16);
}

// Warps a block of the resident kernel: the (row, head)'s 16-row tiles split
// evenly over the fewest blocks of at most kResMaxWarps warps; where that
// grid would give an SM fewer than kResBlocks blocks, over as many more as
// one wave of kResBlocks an SM holds
int resident_warps(int seq, int rows_x_heads, int sms) {
  const int nt = round16(seq) / 16;
  int nb = (nt + kResMaxWarps - 1) / kResMaxWarps;
  if ((long long)rows_x_heads * nb < (long long)kResBlocks * sms) {
    nb = std::max(nb, std::min(nt, kResBlocks * sms / rows_x_heads));
  }
  return (nt + nb - 1) / nb;
}

// streamed (past resident_max_seq): a block of kStreamRows query rows, a warp
// per 16; chunks of kKeys keys in a ring of kStages (bf16: 64 keys, 2
// stages, 46 KB at D = 64, four blocks of 128 registers a thread, 16 warps
// an SM; fp32: 32 keys, 3 stages, 70 KB, three blocks, 12 warps an SM).
// Rows are padded to D + 8 bf16 or D + 4 floats (16-byte multiples, free
// of bank conflicts for ldmatrix and for the fp32 P.V's column reads of V).
constexpr int kStreamRows = 64;
constexpr int kStreamThreads = 2 * kStreamRows;
template <typename T>
struct Stream;
template <>
struct Stream<bf16> {
  static constexpr int kKeys = 64, kStages = 2, kBlocks = 4;
};
template <>
struct Stream<float> {
  static constexpr int kKeys = 32, kStages = 3, kBlocks = 3;
};
template <typename T>
__host__ __device__ constexpr int row_ld(int D) { return D + 16 / (int)sizeof(T); }
template <typename T>
size_t streamed_smem(int D) {
  return (kStreamRows + 2 * Stream<T>::kKeys * Stream<T>::kStages) * (size_t)row_ld<T>(D) *
         sizeof(T);
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

template <int D, int KC>
__global__ void __launch_bounds__(2 * KC, KC <= 64 ? 192 / KC : 1)
attention_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out, int seq, int width,
                  int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int LD = D + 4, LDP = KC + 4, NS = KC / 8;
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + tp * LD;
  float* qw = vs + tp * LD + warp * 16 * (LD + LDP);  // this warp's q rows, then its P
  float* pw = qw + 16 * LD;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int r0 = 16 * (nwarps * blockIdx.y + warp);
  const bool active = r0 < tp;
  if (active) stage_rows<float, D>(qw, LD, base + r0 * stride, stride, seq - r0, 16, lane, 32);
  stage_rows<float, D>(ks, LD, base + width, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  stage_rows<float, D>(vs, LD, base + 2 * width, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int ry = lane / 8, kx = lane % 8;
  const int kend = causal ? min(tp, r0 + 16) : tp;
  const int nch = KC < 128 ? 1 : (kend + KC - 1) / KC;  // below 128 keys, KC holds them all
  float s[4][NS];
  float m[4], inv_l[4];
  if (active) {
    float l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
    for (int c = 0; c < nch; ++c) {
      scores_f32<D, KC>(s, qw, ks, c * KC, kend, seq, r0, causal, scale, ry, kx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float cm = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) cm = fmaxf(cm, s[i][jj]);
        const float mn = fmaxf(m[i], group_max<8>(cm));
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          const float ex = expf(s[i][jj] - mn);
          sum += ex;
          if (nch == 1) s[i][jj] = ex;
        }
        l[i] = l[i] * expf(m[i] - mn) + group_sum<8>(sum);
        m[i] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) inv_l[i] = 1.f / l[i];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  float o[4][C::kPer] = {};
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    if (nch > 1) {
      scores_f32<D, KC>(s, qw, ks, c0, kend, seq, r0, causal, scale, ry, kx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) s[i][jj] = expf(s[i][jj] - m[i]);
    }
    // P of the warp's rows, once per chunk, for every lane of the row
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) pw[(4 * ry + i) * LDP + 8 * jj + kx] = s[i][jj] * inv_l[i];
    __syncwarp();
    const int n = min(KC, kend - c0);
#pragma unroll (NS <= 8 ? 4 : 1)
    for (int j = 0; j < n; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(p[i], pw + (4 * ry + i) * LDP + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = vs + (c0 + j + t) * LD;
#pragma unroll
        for (int u = 0; u < C::kRuns; ++u) {
          float v[C::kVec];
          load_vec<C::kVec>(v, vrow + C::col(u, kx));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < C::kVec; ++e)
              o[i][u * C::kVec + e] = fmaf(p[i][t], v[e], o[i][u * C::kVec + e]);
        }
      }
    }
    __syncwarp();
  }
  float* out_b = out + (size_t)b * seq * width + h * D;
  const int row0 = r0 + 4 * ry;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (row0 + i < seq)
#pragma unroll
      for (int u = 0; u < C::kRuns; ++u)
        store_vec<C::kVec>(out_b + (size_t)(row0 + i) * width + C::col(u, kx), o[i] + u * C::kVec);
}

// ------------------------------------------------------------ resident

// bf16, kShortMaxSeq < T <= kResidentMaxSeq.  Block (batch row x head,
// group of query tiles), a warp per 16 rows, K and V of the whole head in
// shared memory.  Group 0 stages the block's q rows and K's first chunk,
// group c K's chunk c, the last group V (all of them issued up front).
// Sweep 1 takes chunk c once its group has landed for every thread (one
// barrier a chunk) and keeps each row's online max m and sum l (base 2:
// scale2 = D^-0.5 * log2(e) is folded into the scores, P = 2^(s - m));
// sweep 2 recomputes the scores and adds the normalised P = 2^(s - m) / l,
// rounded to bf16 straight into the A fragments of P.V, times V.
template <int D>
__global__ void __launch_bounds__(32 * kResMaxWarps, kResBlocks)
attention_fwd_resident(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
                       int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8, KC = kResKeys;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nthreads = blockDim.x;
  const int rows = nthreads / 2;  // the block's query rows, 16 a warp
  const int rb = rows * blockIdx.y, r0 = rb + 16 * warp;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + rows * LD;
  bf16* vs = ks + tp * LD;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  // the keys the block's rows see (causal: up to its last row's diagonal)
  const int kb = causal ? min(tp, rb + rows) : tp;
  const int nch = (kb + KC - 1) / KC;  // at most 5
  stage_rows<bf16, D>(qs, LD, base + rb * stride, stride, seq - rb, min(rows, tp - rb), tid,
                      nthreads);
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    stage_rows<bf16, D>(ks + c0 * LD, LD, base + width + c0 * stride, stride, seq - c0,
                        min(KC, kb - c0), tid, nthreads);
    cp_async_commit();
  }
  stage_rows<bf16, D>(vs, LD, base + 2 * width, stride, seq, kb, tid, nthreads);
  cp_async_commit();

  const bool active = r0 < tp;
  const int kend = causal ? min(tp, r0 + 16) : tp;  // the keys this warp's rows see
  // the A fragments of the warp's q rows, held through both sweeps
  uint32_t qf[D / 16][4];
  cp_async_wait_upto(nch);  // group 0
  __syncthreads();
  if (active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, LD, r0 - rb, 16 * kk, lane);
  }
  // sweep 1: online m (quad-uniform) and l (lane-partial); key 0, in every
  // row's first chunk, keeps m finite from there on
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    if (c > 0) {
      cp_async_wait_upto(nch - c);  // groups 0 .. c have landed
      __syncthreads();              // ... for every thread
    }
    const int c0 = c * KC;
    if (!active || c0 >= kend) continue;
    float s[KC / 8][4];
    scores_bf16<D, KC>(s, qf, ks, c0, kend, seq, r0, causal, scale2, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) cm = fmaxf(cm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float mn = fmaxf(m[r], group_max<4>(cm));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) sum += ex2(s[n][2 * r] - mn) + ex2(s[n][2 * r + 1] - mn);
      l[r] = fmaf(l[r], ex2(m[r] - mn), sum);
      m[r] = mn;
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();
  if (!active) return;

  // sweep 2: P = 2^(s - m) / l rounded to bf16 into the A fragments of P.V
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / group_sum<4>(l[r]);
  float o[D / 8][4] = {};
  constexpr int KP = kResPvKeys;
  for (int c0 = 0; c0 < kend; c0 += KP) {
    float s[KP / 8][4];
    scores_bf16<D, KP>(s, qf, ks, c0, kend, seq, r0, causal, scale2, lane);
#pragma unroll
    for (int j = 0; j < KP / 16; ++j) {
      const int n0 = c0 + 16 * j;
      if (n0 >= kend) break;
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float(&x)[4] = s[2 * j + t];
        a[2 * t] = pack_bf16(ex2(x[0] - m[0]) * inv_l[0], ex2(x[1] - m[0]) * inv_l[0]);
        a[2 * t + 1] = pack_bf16(ex2(x[2] - m[1]) * inv_l[1], ex2(x[3] - m[1]) * inv_l[1]);
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

// ------------------------------------------------------------ streamed

// Past resident_max_seq (bf16 320, fp32 128).  Block (batch row x head, 64-query
// tile), a warp per 16 rows.  The two sweeps are one stream of 2 * nch
// steps over the block's chunks (causal: up to its last row's diagonal):
// steps 0 .. nch - 1 stage K alone and take each row's online max m and
// sum l (base 2: scale2 = D^-0.5 * log2(e) is folded into the scores, P =
// 2^(s - m)); steps nch .. 2 nch - 1 stage K and V, recompute the scores
// and add the normalised P = 2^(s - m) / l (rounded to bf16 for bf16) times
// V.  Chunk step + kStages - 1 is staged while step computes, behind one
// barrier a step.  bf16: every product on mma.sync m16n8k16, P packed
// straight into the A fragments of P.V.  fp32: every product as 3xTF32
// on m16n8k8; P.V takes P from the scores' accumulators with the chunk's
// keys in the order (n0 + 2q, n0 + 2q + 1) for the fragment's k = (q, q +
// 4), and V's column reads in that order.
template <typename T, int D>
__global__ void __launch_bounds__(kStreamThreads, Stream<T>::kBlocks)
attention_fwd_streamed(const T* __restrict__ qkv, T* __restrict__ out, int seq, int width,
                       int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KC = Stream<T>::kKeys, S = Stream<T>::kStages, LD = row_ld<T>(D);
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rb = kStreamRows * blockIdx.y, r0 = rb + 16 * warp;
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = qs + kStreamRows * LD;  // stage i: KC rows of K, then KC of V

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const T* base = qkv + (size_t)b * seq * stride + h * D;
  const bool active = r0 < tp;
  const int kend = causal ? min(tp, r0 + 16) : tp;  // the keys this warp's rows see
  const int nch = ((causal ? min(tp, rb + kStreamRows) : tp) + KC - 1) / KC;
  const int steps = 2 * nch;
  auto stage = [&](int step) {
    if (step >= steps) return;
    const int c0 = (step < nch ? step : step - nch) * KC;
    T* dst = ring + (step % S) * 2 * KC * LD;
    stage_rows<T, D>(dst, LD, base + width + c0 * stride, stride, seq - c0, KC, tid,
                     kStreamThreads);
    if (step >= nch) {
      stage_rows<T, D>(dst + KC * LD, LD, base + 2 * width + c0 * stride, stride, seq - c0, KC,
                       tid, kStreamThreads);
    }
  };
  // group 0: the block's q rows and step 0; then steps 1 .. S - 2
  stage_rows<T, D>(qs, LD, base + rb * stride, stride, seq - rb, kStreamRows, tid,
                   kStreamThreads);
  stage(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < S - 1; ++i) {
    stage(i);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float o[D / 8][4] = {};
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<S - 2>();  // this step's chunk has landed
    __syncthreads();         // ... for every thread; and step - 1's stage is free
    stage(step + S - 1);
    cp_async_commit();
    if (!active) continue;
    if (step == nch) {  // sweep 1 is done: reduce l over the row's quad
#pragma unroll
      for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / group_sum<4>(l[r]);
    }
    const int c0 = (step < nch ? step : step - nch) * KC;
    if (c0 >= kend) continue;
    const T* ks = ring + (step % S) * 2 * KC * LD;
    const T* vs = ks + KC * LD;
    float s[KC / 8][4];
    if constexpr (kBf16) {
      // the A fragments of the warp's q rows, read again each step rather
      // than held (bf16 fits the 128 registers of four blocks an SM so)
      uint32_t qf[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, LD, r0 - rb, 16 * kk, lane);
      scores_bf16<D, KC>(s, qf, ks, c0, kend, seq, r0, causal, scale2, lane, c0);
    } else {
      scores_tf32<D, KC>(s, qs + (r0 - rb) * LD, ks, c0, kend, seq, r0, causal, scale2, lane,
                         c0);
    }
    if (step < nch) {
      // online m and l: m quad-uniform, l lane-partial (key 0, in every
      // row's first chunk, keeps m finite from there on)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = -INFINITY;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) cm = fmaxf(cm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float mn = fmaxf(m[r], group_max<4>(cm));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < KC / 8; ++n) sum += ex2(s[n][2 * r] - mn) + ex2(s[n][2 * r + 1] - mn);
        l[r] = fmaf(l[r], ex2(m[r] - mn), sum);
        m[r] = mn;
      }
      continue;
    }
    // P = 2^(s - m) / l in fp32
#pragma unroll
    for (int n = 0; n < KC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = ex2(s[n][e] - m[e >> 1]) * inv_l[e >> 1];
    if constexpr (kBf16) {
      // rounded to bf16 straight into the A fragments of P.V
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        if (c0 + 16 * j >= kend) break;
        uint32_t a[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          a[2 * t] = pack_bf16(s[2 * j + t][0], s[2 * j + t][1]);
          a[2 * t + 1] = pack_bf16(s[2 * j + t][2], s[2 * j + t][3]);
        }
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bv[4];
          load_b_cols(bv, vs, LD, 16 * j, 16 * dd, lane);
          mma_bf16(o[2 * dd], a, bv[0], bv[1]);
          mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
        }
      }
    } else {
      // k-step kk: keys c0 + 8kk + (2q, 2q + 1) as the fragment's k = (q, q + 4)
      const int q = lane & 3, g = lane / 4;
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        if (c0 + 8 * kk >= kend) break;
        const uint32_t a[4] = {__float_as_uint(s[kk][0]), __float_as_uint(s[kk][2]),
                               __float_as_uint(s[kk][1]), __float_as_uint(s[kk][3])};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
        const float* v0 = reinterpret_cast<const float*>(vs) + (8 * kk + 2 * q) * LD + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(__float_as_uint(v0[8 * n]), bh0, bl0);
          split_tf32(__float_as_uint(v0[LD + 8 * n]), bh1, bl1);
          mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  if (!active) return;
  T* out_b = out + (size_t)b * seq * width + h * D;
  const int row0 = r0 + lane / 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r >= seq) continue;
      T* dst = out_b + (size_t)(row0 + 8 * r) * width + col;
      if constexpr (kBf16) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_streamed(const void* qkv, void* out, int B, int seq, int width, int heads,
                            float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  const size_t smem = streamed_smem<T>(D);
  if ((e = set_smem(attention_fwd_streamed<T, D>, smem)) != cudaSuccess) return e;
  // several blocks an SM only with the largest carveout
  if ((e = cudaFuncSetAttribute(attention_fwd_streamed<T, D>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  const dim3 grid(B * heads, (round16(seq) + kStreamRows - 1) / kStreamRows);
  attention_fwd_streamed<T, D><<<grid, kStreamThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, width, heads, scale, causal);
  return cudaGetLastError();
}

template <int D, int KC>
cudaError_t launch(const void* qkv, void* out, int B, int seq, int width, int heads,
                   float scale, int causal, int dtype, cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(B * heads), block(2 * round16(seq));
  if (dtype == 0) {
    const size_t smem = f32_smem(seq, D);
    if ((e = set_smem(attention_fwd_f32<D, KC>, smem)) != cudaSuccess) return e;
    attention_fwd_f32<D, KC><<<grid, block, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), seq, width, heads, scale,
        causal);
  } else {
    const size_t smem = bf16_smem(seq, D);
    if ((e = set_smem(attention_fwd_bf16<D, KC>, smem)) != cudaSuccess) return e;
    attention_fwd_bf16<D, KC><<<grid, block, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale,
        causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_resident(const void* qkv, void* out, int B, int seq, int width, int heads,
                            float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  const int nw = resident_warps(seq, B * heads, sms), tiles = round16(seq) / 16;
  const size_t smem = resident_smem(seq, nw, D);
  if ((e = set_smem(attention_fwd_resident<D>, smem)) != cudaSuccess) return e;
  // two blocks an SM only with the largest carveout
  if ((e = cudaFuncSetAttribute(attention_fwd_resident<D>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  attention_fwd_resident<D><<<dim3(B * heads, (tiles + nw - 1) / nw), 32 * nw, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_kc(const void* qkv, void* out, int B, int seq, int width, int heads,
                        float scale, int causal, int dtype, cudaStream_t stream) {
  if (seq > resident_max_seq(dtype)) {
    return dtype == 0
               ? launch_streamed<float, D>(qkv, out, B, seq, width, heads, scale, causal, stream)
               : launch_streamed<bf16, D>(qkv, out, B, seq, width, heads, scale, causal, stream);
  }
  if (seq > kShortMaxSeq) {
    return launch_resident<D>(qkv, out, B, seq, width, heads, scale, causal, stream);
  }
  switch (key_capacity(round16(seq))) {
    case 16: return launch<D, 16>(qkv, out, B, seq, width, heads, scale, causal, dtype, stream);
    case 32: return launch<D, 32>(qkv, out, B, seq, width, heads, scale, causal, dtype, stream);
    case 64: return launch<D, 64>(qkv, out, B, seq, width, heads, scale, causal, dtype, stream);
    case 96: return launch<D, 96>(qkv, out, B, seq, width, heads, scale, causal, dtype, stream);
    default: return launch<D, 128>(qkv, out, B, seq, width, heads, scale, causal, dtype, stream);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `dtype` (0 = float32, 1 =
// bfloat16) needs at most; the wrapper checks it against the card's limit
// before launching.  Above the resident length it no longer depends on seq.
size_t mnt_attention_fwd_smem(int seq, int head_dim, int dtype) {
  if (seq > resident_max_seq(dtype)) {
    return dtype == 0 ? streamed_smem<float>(head_dim) : streamed_smem<bf16>(head_dim);
  }
  if (seq > kShortMaxSeq) return resident_smem(seq, kResMaxWarps, head_dim);
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
