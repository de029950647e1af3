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
// What bounds it on an H100: memory.  CLIP's sequences are short (T = 50
// vision tokens, <= 77 text tokens, 257/273 for ViT-L/14) and D = 64, so the
// work is 4*B*H*T^2*D operations against B*T*4W elements read and written:
// about 25 operations per byte at the ViT-B/32 vision shape, far below the
// ~295 per byte where the bf16 tensor cores would become the limit.  What
// the design has to avoid is paying more than the bytes: scalar 2-byte
// staging, fp32 conversions and two shared-memory loads per FMA.
//
// Design, one block per (batch row, head), reading the fused layout in place
// (no head-split copies), one warp per 16-row query tile (up to 8 tiles;
// ViT-L/14's longer sequences split their tiles over several blocks, each
// staging the whole of K and V):
// - staging: q and k rows, then v rows in a second group that lands while
//   the scores run, go to shared memory with 16-byte cp.async copies; rows
//   past T are zero-filled; rows are padded (D + 8 bf16, D + 4 floats) so
//   that ldmatrix and float4 reads are free of bank conflicts;
// - the key capacity KC (16, 32, 64, 96 or 128, the smallest holding T) is a
//   template parameter: score tiles and unrolled loops are sized by it, so
//   short text sequences and the 50-token vision tower carry no empty slots
//   and keep few enough registers for several blocks per SM;
// - bf16, on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
//   accumulators): each warp's S = Q.K^T for up to 128 keys stays in
//   registers (16 x 128 fp32 across the warp), the row max and sum are quad
//   shuffles, and P = exp(s - m) * (1/l) is rounded to bf16 straight into
//   the A fragments of P.V;
// - fp32, full-fp32 FFMA (no TF32: it would break the 1e-5 agreement),
//   register-tiled: lane (ry, kx) owns a 4-row x KC/8-key tile of S and a
//   4-row x D/8 tile of O, each shared-memory float4 feeding 4-16 FMAs; the
//   rounded P of the warp's rows goes through shared memory once per chunk;
// - T above 128 keys (ViT-L/14): two sweeps over 128-key chunks, the first
//   for the row max and sum (rescaled from chunk to chunk), the second for
//   the normalised, rounded P.V; up to 128 keys the scores are computed once
//   and exp(s - m) is taken once;
// - causal rows skip whole 16-key tiles above the diagonal and mask inside
//   the diagonal tile (and the tile holding T); masked and padded keys give
//   P = 0 exactly;
// - T above kResidentMaxSeq (320; ViT-L/14 with a prompt above 63 tokens,
//   ViT-L/14@336's 577): the whole of K and V no longer fits a block (fp32
//   runs out first, at 333 keys), so both sweeps stream 128-key chunks
//   (K in sweep 1, K and V in sweep 2) from device memory through one
//   chunk buffer each, behind a block barrier: the block's shared memory no
//   longer depends on T (55 KB bf16, 118 KB fp32 at D = 64).  The chunks
//   are the resident form's chunks and the arithmetic is the same, so a
//   streamed call gives the bits the resident one would.  K is read twice
//   and there is no double buffering: a simple form, not yet tuned.

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

// Warps per block: one 16-row query tile each, all of a (row, head)'s tiles
// up to 128 keys; past that the tiles are split over several blocks
// (grid.y), each staging the whole of K and V.
// Up to here K and V are resident in shared memory; above, they stream.
constexpr int kResidentMaxSeq = 320;
constexpr int kStreamWarpsBf16 = 8;
constexpr int kStreamWarpsF32 = 4;

int bf16_warps(int seq) { return std::min(8, round16(seq) / 16); }
int f32_warps(int seq) { return round16(seq) <= 128 ? round16(seq) / 16 : 4; }

size_t bf16_smem(int seq, int D) {
  return (16 * (size_t)bf16_warps(seq) + 2 * (size_t)round16(seq)) * (D + 8) * sizeof(bf16);
}
size_t f32_smem(int seq, int D) {
  const int tp = round16(seq);
  return (2 * (size_t)tp * (D + 4) +
          (size_t)f32_warps(seq) * 16 * (D + 4 + key_capacity(tp) + 4)) * sizeof(float);
}

// streamed (T > kResidentMaxSeq): the block's query rows and one 128-key
// chunk of K and of V (bf16); one chunk of K and V and each warp's q rows
// and P (fp32)
size_t bf16_streamed_smem(int D) {
  return (16 * (size_t)kStreamWarpsBf16 + 2 * 128) * (D + 8) * sizeof(bf16);
}
size_t f32_streamed_smem(int D) {
  return (2 * 128 * (size_t)(D + 4) + (size_t)kStreamWarpsF32 * 16 * (D + 4 + 128 + 4)) *
         sizeof(float);
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

// ------------------------------------------------------------ streamed

// bf16, T > kResidentMaxSeq: 8 warps of 16 query rows; each sweep walks the
// block's 128-key chunks (causal: up to its last row's diagonal), staging
// the chunk after a barrier, so that every warp is done with the last one.
// Per warp the arithmetic is the resident kernel's at KC = 128.
template <int D>
__global__ void __launch_bounds__(32 * kStreamWarpsBf16, 1)
attention_fwd_bf16_streamed(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq,
                            int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KC = 128, LD = D + 8, NW = kStreamWarpsBf16, NT = 32 * NW;
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rb = 16 * NW * blockIdx.y;  // the block's first query row
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + 16 * NW * LD;
  bf16* vs = ks + KC * LD;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int r0 = rb + 16 * warp;
  const bool active = r0 < tp;
  const int kend = causal ? min(tp, r0 + 16) : tp;
  const int nch = ((causal ? min(tp, rb + 16 * NW) : tp) + KC - 1) / KC;  // the block's chunks
  stage_rows<bf16, D>(qs, LD, base + rb * stride, stride, seq - rb, min(16 * NW, tp - rb), tid,
                      NT);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float s[KC / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // sweep 1: row max and sum, rescaled from chunk to chunk
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    __syncthreads();  // every warp is done with the previous chunk
    stage_rows<bf16, D>(ks, LD, base + width + c0 * stride, stride, seq - c0, KC, tid, NT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active || c0 >= kend) continue;
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, LD, r0 - rb, 16 * kk, lane);
    }
    scores_bf16<D, KC>(s, qf, ks, c0, kend, seq, r0, causal, scale, lane, c0);
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
        for (int e = 2 * r; e < 2 * r + 2; ++e) sum += expf(s[n][e] - mn);
      l[r] = l[r] * expf(m[r] - mn) + group_sum<4>(sum);
      m[r] = mn;
    }
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};

  // sweep 2: P = exp(s - m) / l rounded to bf16 into the A fragments of P.V
  float o[D / 8][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    __syncthreads();
    stage_rows<bf16, D>(ks, LD, base + width + c0 * stride, stride, seq - c0, KC, tid, NT);
    stage_rows<bf16, D>(vs, LD, base + 2 * width + c0 * stride, stride, seq - c0, KC, tid, NT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active || c0 >= kend) continue;
    scores_bf16<D, KC>(s, qf, ks, c0, kend, seq, r0, causal, scale, lane, c0);
#pragma unroll
    for (int n = 0; n < KC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const int n0 = c0 + 16 * j;
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
        load_b_cols(bv, vs, LD, 16 * j, 16 * dd, lane);
        mma_bf16(o[2 * dd], a, bv[0], bv[1]);
        mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
      }
    }
  }
  if (!active) return;
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

// fp32, T > kResidentMaxSeq: 4 warps of 16 query rows, the resident fp32
// kernel's register tiles at KC = 128 over streamed chunks of K and V.
template <int D>
__global__ void __launch_bounds__(32 * kStreamWarpsF32, 1)
attention_fwd_f32_streamed(const float* __restrict__ qkv, float* __restrict__ out, int seq,
                           int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int KC = 128, LD = D + 4, LDP = KC + 4, NS = KC / 8, NW = kStreamWarpsF32;
  constexpr int NT = 32 * NW;
  const int tp = round16(seq);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + KC * LD;
  float* qw = vs + KC * LD + warp * 16 * (LD + LDP);  // this warp's q rows, then its P
  float* pw = qw + 16 * LD;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h * D;
  const int rb = 16 * NW * blockIdx.y, r0 = rb + 16 * warp;
  const bool active = r0 < tp;
  if (active) stage_rows<float, D>(qw, LD, base + r0 * stride, stride, seq - r0, 16, lane, 32);
  cp_async_commit();

  const int ry = lane / 8, kx = lane % 8;
  const int kend = causal ? min(tp, r0 + 16) : tp;
  const int nch = ((causal ? min(tp, rb + 16 * NW) : tp) + KC - 1) / KC;
  float s[4][NS];
  float m[4], l[4], inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    __syncthreads();
    stage_rows<float, D>(ks, LD, base + width + c0 * stride, stride, seq - c0, KC, tid, NT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active || c0 >= kend) continue;
    scores_f32<D, KC>(s, qw, ks, c0, kend, seq, r0, causal, scale, ry, kx, c0);
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
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) inv_l[i] = 1.f / l[i];

  float o[4][C::kPer] = {};
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * KC;
    __syncthreads();
    stage_rows<float, D>(ks, LD, base + width + c0 * stride, stride, seq - c0, KC, tid, NT);
    stage_rows<float, D>(vs, LD, base + 2 * width + c0 * stride, stride, seq - c0, KC, tid, NT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active || c0 >= kend) continue;
    scores_f32<D, KC>(s, qw, ks, c0, kend, seq, r0, causal, scale, ry, kx, c0);
    // P of the warp's rows, once per chunk, for every lane of the row
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        pw[(4 * ry + i) * LDP + 8 * jj + kx] = expf(s[i][jj] - m[i]) * inv_l[i];
    __syncwarp();
    const int n = min(KC, kend - c0);
#pragma unroll 1
    for (int j = 0; j < n; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(p[i], pw + (4 * ry + i) * LDP + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = vs + (j + t) * LD;
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
  if (!active) return;
  float* out_b = out + (size_t)b * seq * width + h * D;
  const int row0 = r0 + 4 * ry;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (row0 + i < seq)
#pragma unroll
      for (int u = 0; u < C::kRuns; ++u)
        store_vec<C::kVec>(out_b + (size_t)(row0 + i) * width + C::col(u, kx), o[i] + u * C::kVec);
}

template <int D>
cudaError_t launch_streamed(const void* qkv, void* out, int B, int seq, int width, int heads,
                            float scale, int causal, int dtype, cudaStream_t stream) {
  cudaError_t e;
  const int tiles = round16(seq) / 16;
  if (dtype == 0) {
    const size_t smem = f32_streamed_smem(D);
    const int nw = kStreamWarpsF32;
    if ((e = set_smem(attention_fwd_f32_streamed<D>, smem)) != cudaSuccess) return e;
    attention_fwd_f32_streamed<D><<<dim3(B * heads, (tiles + nw - 1) / nw), 32 * nw, smem,
                                    stream>>>(static_cast<const float*>(qkv),
                                              static_cast<float*>(out), seq, width, heads, scale,
                                              causal);
  } else {
    const size_t smem = bf16_streamed_smem(D);
    const int nw = kStreamWarpsBf16;
    if ((e = set_smem(attention_fwd_bf16_streamed<D>, smem)) != cudaSuccess) return e;
    attention_fwd_bf16_streamed<D><<<dim3(B * heads, (tiles + nw - 1) / nw), 32 * nw, smem,
                                     stream>>>(static_cast<const bf16*>(qkv),
                                               static_cast<bf16*>(out), seq, width, heads, scale,
                                               causal);
  }
  return cudaGetLastError();
}

template <int D, int KC>
cudaError_t launch(const void* qkv, void* out, int B, int seq, int width, int heads,
                   float scale, int causal, int dtype, cudaStream_t stream) {
  cudaError_t e;
  const int tiles = round16(seq) / 16;
  if (dtype == 0) {
    const size_t smem = f32_smem(seq, D);
    const int nw = f32_warps(seq);
    if ((e = set_smem(attention_fwd_f32<D, KC>, smem)) != cudaSuccess) return e;
    attention_fwd_f32<D, KC><<<dim3(B * heads, (tiles + nw - 1) / nw), 32 * nw, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), seq, width, heads, scale,
        causal);
  } else {
    const size_t smem = bf16_smem(seq, D);
    const int nw = bf16_warps(seq);
    if ((e = set_smem(attention_fwd_bf16<D, KC>, smem)) != cudaSuccess) return e;
    attention_fwd_bf16<D, KC><<<dim3(B * heads, (tiles + nw - 1) / nw), 32 * nw, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale,
        causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_kc(const void* qkv, void* out, int B, int seq, int width, int heads,
                        float scale, int causal, int dtype, cudaStream_t stream) {
  if (seq > kResidentMaxSeq) {
    return launch_streamed<D>(qkv, out, B, seq, width, heads, scale, causal, dtype, stream);
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

// Bytes of dynamic shared memory one block needs (the larger of the two
// types'); the wrapper checks it against the card's limit before launching.
// Above kResidentMaxSeq it no longer depends on seq.
size_t mnt_attention_fwd_smem(int seq, int head_dim) {
  if (seq > kResidentMaxSeq) {
    return std::max(bf16_streamed_smem(head_dim), f32_streamed_smem(head_dim));
  }
  return std::max(bf16_smem(seq, head_dim), f32_smem(seq, head_dim));
}

// The longest seq whose K and V stay resident in shared memory; longer ones
// stream (the wrapper counts those launches apart).
int mnt_attention_fwd_resident_max_seq() { return kResidentMaxSeq; }

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
