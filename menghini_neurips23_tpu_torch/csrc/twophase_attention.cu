// K4: the phase-grouped multi-head attention forward over CLIP's fused qkv.
//
// Replaces: benchmarks/exp_attn_kernels.py `_twophase_fwd_kernel` (reached
// through `twophase_attention`), a Pallas experiment that asks whether
// interleaving the softmax with the products stalls the matrix unit.  It
// groups the work by phase: every head's logits first, then every head's
// softmax, then every head's P.V.
//
// What it computes, per batch row b and head h (D = W / heads), unmasked,
// with K1's numerics (csrc/attention_fwd.cu):
//   s = (q . k^T) accumulated in fp32, times D^-0.5
//   p = softmax(s) in fp32 (exp(s - max) * (1 / sum)), rounded to the input type
//   out[b, :, h*D:(h+1)*D] = (p . v) accumulated in fp32, rounded to the input type
//
// What bounds it on an H100: memory, as K1 (4*B*H*T^2*D operations against
// B*T*4W elements moved: about 25 operations a byte at T = 66, D = 64, far
// below the ~295 where the bf16 tensor cores would be the limit).  This
// kernel is not built to approach that bound: it keeps the experiment's
// phase order inside a block, and the phase order costs what it costs.
//
// Design: one block per (batch row, group of G heads), in three phases
// separated by block barriers:
//   1. Q.K^T of all G heads into an fp32 logits scratch in shared memory,
//      one warp per (head, 16-row query tile), 16 keys at a time;
//   2. the softmax of all G * T rows in place, one warp per row (lanes
//      along the keys), P = 0 exactly at keys past T and on rows past T;
//   3. P.V of all G heads, one warp per (head, 16-row query tile), P read
//      from the scratch and rounded to the input type.
// q, k and v of the G heads are staged with 16-byte cp.async copies, rows
// past T zero-filled, q and k in one group and v in a second one that lands
// while phase 1 runs.  The rows of a head are padded to T_p = round16(T)
// rows and keys, so the products run on whole tiles.
// - bf16: every product on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 accumulators) through attention_common.cuh, as K1 does,
//   so that a comparison with K1 measures the phase order and not the math
//   units.  A logits row is T_p + 8 floats: 8 mod 32 or 24 mod 32 banks, so
//   the quad-ordered float2 accesses of a fragment (rows g, columns 2q) hit
//   32 distinct banks in each half-warp.
// - fp32: FFMA register tiles as in K1's fp32 path (lane (ry, kx) owns 4
//   rows x 4 keys of S, then 4 rows x D/8 columns of O); a logits row is
//   T_p + 4 floats, so P's float4 reads stay aligned.
// - No atomics: every value has one owner, so two launches give the same bits.
//
// The group G is the largest divisor of H whose staging (3 G T_p (D + pad)
// elements) and logits (G T_p (T_p + pad) floats) fit the 227 KB a block
// may take.  At the experiment's shape, (B, T, W, H) = (256, 66, 768, 12),
// T_p = 80 and D = 64: a head takes 62,720 bytes in bf16 and 92,160 in
// fp32, so G = 3 in bf16 (188,160 bytes; 4 heads would take 250,880) and
// G = 2 in fp32 (184,320 bytes).  All 12 heads never fit: their padded
// logits alone are 12 * 80 * 88 * 4 = 337,920 bytes.  The longest T a block
// takes at D = 64 (G = 1) is 176 in bf16 and 144 in fp32; past that the
// wrapper raises.

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

constexpr int kWarpsBf16 = 16;  // a block holds its SM alone: many warps hide latency
constexpr int kWarpsF32 = 8;    // FFMA tiles take more registers
constexpr size_t kMaxSmem = 227 * 1024;

// element pitch of a staged row, float pitch of a logits row
int stage_ld(int D, int dtype) { return D + (dtype == 1 ? 8 : 4); }
int logits_ld(int tp, int dtype) { return tp + (dtype == 1 ? 8 : 4); }

size_t head_smem(int seq, int D, int dtype) {
  const size_t tp = round16(seq);
  const size_t elem = dtype == 1 ? sizeof(bf16) : sizeof(float);
  return 3 * tp * stage_ld(D, dtype) * elem + tp * logits_ld(tp, dtype) * sizeof(float);
}

// the largest divisor of heads whose group fits a block; 0 if one head does not
int group_size(int seq, int D, int heads, int dtype) {
  for (int g = heads; g >= 1; --g)
    if (heads % g == 0 && g * head_smem(seq, D, dtype) <= kMaxSmem) return g;
  return 0;
}

// phase 2, shared by both types: one warp per logits row, in place
__device__ __forceinline__ void softmax_rows(float* lg, int lds, int rows, int tp, int seq,
                                             int warp, int nwarps, int lane) {
  for (int rr = warp; rr < rows; rr += nwarps) {
    float* row = lg + (size_t)rr * lds;
    if (rr % tp >= seq) {  // a padded query row: P = 0
      for (int c = lane; c < tp; c += 32) row[c] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) m = fmaxf(m, row[c]);
    m = group_max<32>(m);
    float sum = 0.f;
    for (int c = lane; c < seq; c += 32) {
      const float ex = expf(row[c] - m);
      row[c] = ex;
      sum += ex;
    }
    const float inv_l = 1.f / group_sum<32>(sum);
    for (int c = lane; c < tp; c += 32) row[c] = c < seq ? row[c] * inv_l : 0.f;
  }
}

// ------------------------------------------------------------------ bf16

template <int D>
__global__ void __launch_bounds__(32 * kWarpsBf16, 1)
twophase_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
              int heads, int group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8, NT = 32 * kWarpsBf16;
  const int tp = round16(seq), lds = tp + 8, tiles = tp / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head = (size_t)tp * LD;  // elements of one head's staged rows
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + group * head;
  bf16* vs = ks + group * head;
  float* lg = reinterpret_cast<float*>(vs + group * head);

  const int ngroups = heads / group;
  const int b = blockIdx.x / ngroups, h0 = (blockIdx.x % ngroups) * group;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h0 * D;
  for (int g = 0; g < group; ++g) {
    stage_rows<bf16, D>(qs + g * head, LD, base + g * D, stride, seq, tp, tid, NT);
    stage_rows<bf16, D>(ks + g * head, LD, base + width + g * D, stride, seq, tp, tid, NT);
  }
  cp_async_commit();
  for (int g = 0; g < group; ++g)
    stage_rows<bf16, D>(vs + g * head, LD, base + 2 * width + g * D, stride, seq, tp, tid, NT);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // phase 1: S = Q.K^T * scale of every head, -inf at keys past T
  for (int u = warp; u < group * tiles; u += kWarpsBf16) {
    const int g = u / tiles, r0 = 16 * (u % tiles);
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs + g * head, LD, r0, 16 * kk, lane);
    float* rows = lg + ((size_t)g * tp + r0 + lane / 4) * lds + 2 * (lane & 3);
    for (int c0 = 0; c0 < tp; c0 += 16) {
      float s[2][4];
      scores_bf16<D, 16>(s, qf, ks + g * head, c0, tp, seq, r0, false, scale, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(rows + 8 * r * lds + c0 + 8 * t) =
              make_float2(s[t][2 * r], s[t][2 * r + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // phase 2: the softmax of every row of every head
  softmax_rows(lg, lds, group * tp, tp, seq, warp, kWarpsBf16, lane);
  __syncthreads();

  // phase 3: O = P.V of every head, P rounded to bf16 into the A fragments
  for (int u = warp; u < group * tiles; u += kWarpsBf16) {
    const int g = u / tiles, r0 = 16 * (u % tiles);
    const float* rows = lg + ((size_t)g * tp + r0 + lane / 4) * lds + 2 * (lane & 3);
    float o[D / 8][4] = {};
    for (int n0 = 0; n0 < tp; n0 += 16) {
      uint32_t a[4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 p = *reinterpret_cast<const float2*>(rows + 8 * r * lds + n0 + 8 * t);
          a[2 * t + r] = pack_bf16(p.x, p.y);
        }
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bv[4];
        load_b_cols(bv, vs + g * head, LD, n0, 16 * dd, lane);
        mma_bf16(o[2 * dd], a, bv[0], bv[1]);
        mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
      }
    }
    bf16* out_b = out + (size_t)b * seq * width + (h0 + g) * D;
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
}

// ------------------------------------------------------------------ fp32

template <int D>
__global__ void __launch_bounds__(32 * kWarpsF32, 1)
twophase_f32(const float* __restrict__ qkv, float* __restrict__ out, int seq, int width,
             int heads, int group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using C = Cols<D>;
  constexpr int LD = D + 4, KC = 32, NS = KC / 8, NT = 32 * kWarpsF32;
  const int tp = round16(seq), lds = tp + 4, tiles = tp / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ry = lane / 8, kx = lane % 8;
  const size_t head = (size_t)tp * LD;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + group * head;
  float* vs = ks + group * head;
  float* lg = vs + group * head;

  const int ngroups = heads / group;
  const int b = blockIdx.x / ngroups, h0 = (blockIdx.x % ngroups) * group;
  const size_t stride = 3 * (size_t)width;
  const float* base = qkv + (size_t)b * seq * stride + h0 * D;
  for (int g = 0; g < group; ++g) {
    stage_rows<float, D>(qs + g * head, LD, base + g * D, stride, seq, tp, tid, NT);
    stage_rows<float, D>(ks + g * head, LD, base + width + g * D, stride, seq, tp, tid, NT);
  }
  cp_async_commit();
  for (int g = 0; g < group; ++g)
    stage_rows<float, D>(vs + g * head, LD, base + 2 * width + g * D, stride, seq, tp, tid, NT);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // phase 1: S = Q.K^T * scale, KC keys at a time, -inf at keys past T
  for (int u = warp; u < group * tiles; u += kWarpsF32) {
    const int g = u / tiles, r0 = 16 * (u % tiles);
    float* rows = lg + ((size_t)g * tp + r0 + 4 * ry) * lds + kx;
    for (int c0 = 0; c0 < tp; c0 += KC) {
      float s[4][NS];
      scores_f32<D, KC>(s, qs + g * head + r0 * LD, ks + g * head, c0, tp, seq, r0, false, scale,
                        ry, kx);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        if (c0 + 8 * jj < tp)
#pragma unroll
          for (int i = 0; i < 4; ++i) rows[i * lds + c0 + 8 * jj] = s[i][jj];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // phase 2: the softmax of every row of every head
  softmax_rows(lg, lds, group * tp, tp, seq, warp, kWarpsF32, lane);
  __syncthreads();

  // phase 3: O = P.V of every head (keys past T carry P = 0 and zero rows of V)
  for (int u = warp; u < group * tiles; u += kWarpsF32) {
    const int g = u / tiles, r0 = 16 * (u % tiles);
    const float* pw = lg + ((size_t)g * tp + r0 + 4 * ry) * lds;
    const float* vg = vs + g * head;
    float o[4][C::kPer] = {};
#pragma unroll 2
    for (int j = 0; j < tp; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(p[i], pw + i * lds + j);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = vg + (j + t) * LD;
#pragma unroll
        for (int u2 = 0; u2 < C::kRuns; ++u2) {
          float v[C::kVec];
          load_vec<C::kVec>(v, vrow + C::col(u2, kx));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < C::kVec; ++e)
              o[i][u2 * C::kVec + e] = fmaf(p[i][t], v[e], o[i][u2 * C::kVec + e]);
        }
      }
    }
    float* out_b = out + (size_t)b * seq * width + (h0 + g) * D;
    const int row0 = r0 + 4 * ry;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (row0 + i < seq)
#pragma unroll
        for (int u2 = 0; u2 < C::kRuns; ++u2)
          store_vec<C::kVec>(out_b + (size_t)(row0 + i) * width + C::col(u2, kx),
                             o[i] + u2 * C::kVec);
  }
}

template <int D>
cudaError_t launch(const void* qkv, void* out, int B, int seq, int width, int heads, float scale,
                   int dtype, cudaStream_t stream) {
  const int group = group_size(seq, D, heads, dtype);
  if (group == 0) return cudaErrorInvalidValue;
  const size_t smem = group * head_smem(seq, D, dtype);
  const dim3 grid(B * (heads / group));
  cudaError_t e;
  if (dtype == 0) {
    if ((e = set_smem(twophase_f32<D>, smem)) != cudaSuccess) return e;
    twophase_f32<D><<<grid, 32 * kWarpsF32, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), seq, width, heads, group, scale);
  } else {
    if ((e = set_smem(twophase_bf16<D>, smem)) != cudaSuccess) return e;
    twophase_bf16<D><<<grid, 32 * kWarpsBf16, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, group, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Heads per block (G) for this shape and type; 0 when one head's staging
// and logits exceed a block's shared memory (the wrapper raises).
int mnt_twophase_attention_groups(int seq, int head_dim, int heads, int dtype) {
  if (heads <= 0) return 0;
  return group_size(seq, head_dim, heads, dtype);
}

// Bytes of dynamic shared memory one block takes at that G (at G = 1 when
// no group fits, so that the wrapper can name what was asked for).
size_t mnt_twophase_attention_smem(int seq, int head_dim, int heads, int dtype) {
  const int g = heads > 0 ? group_size(seq, head_dim, heads, dtype) : 0;
  return (g > 0 ? g : 1) * head_smem(seq, head_dim, dtype);
}

// qkv: (B, seq, 3*width) contiguous, 16-byte aligned; out: (B, seq, width)
// contiguous, same type.  scale: D^-0.5 as the caller rounds it to float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int mnt_twophase_attention(const void* qkv, void* out, int B, int seq, int width, int heads,
                           float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || heads <= 0 || width % heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  switch (width / heads) {
    case 16: e = launch<16>(qkv, out, B, seq, width, heads, scale, dtype, s); break;
    case 32: e = launch<32>(qkv, out, B, seq, width, heads, scale, dtype, s); break;
    case 64: e = launch<64>(qkv, out, B, seq, width, heads, scale, dtype, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
