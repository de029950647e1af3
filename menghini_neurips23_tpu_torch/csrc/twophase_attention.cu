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
//   p = softmax(s) in fp32 (2^(s log2(e) - max) * (1 / sum)), rounded to the
//       input type
//   out[b, :, h*D:(h+1)*D] = (p . v) accumulated in fp32, rounded to the input type
//
// What bounds it on an H100: memory in bf16, as K1 (4*B*H*T^2*D operations
// against B*T*4W elements moved: about 25 operations a byte at T = 66, D =
// 64, far below the ~295 where the bf16 tensor cores would be the limit);
// in fp32 the bytes too (3xTF32 is three products at the TF32 rate: ~0.031
// ms of tensor time at (256, 66, 768, 12) against 0.062 ms of bytes).  The
// phase order keeps each block's work in three serial steps behind block
// barriers; the design hides them by keeping several blocks on an SM, so
// that one block's staging and products overlap another's softmax.
//
// Design: one block per (batch row, group of G heads), in three phases
// separated by block barriers:
//   1. Q.K^T of all G heads into an fp32 logits scratch in shared memory,
//      one warp per (head, 16-row query tile), 16 keys at a time, scaled by
//      D^-0.5 * log2(e) (K1's base-2 schedule), -inf at keys past T;
//   2. the softmax of all G * T rows in place, 8 lanes a row and 4 rows a
//      warp, each lane holding T_p / 8 of the row in registers, the max and
//      sum by shuffles within the 8 lanes and one ex2 an element; P = 0
//      exactly at keys past T and on rows past T;
//   3. P.V of all G heads, one warp per (head, 16-row query tile); each
//      warp stages its output tile in shared memory and writes whole
//      16-byte pieces of rows.
// Rows are padded to T_p = round16(T) rows and keys, so the products run on
// whole tiles.  A head's shared memory holds three regions:
//   L: the fp32 logits (T_p rows of T_p + 8 floats: 8 or 24 mod 32 banks, so
//      the quad-ordered float2 stores of an accumulator hit 32 banks in each
//      half-warp).  q is staged at L's end: each warp reads its q tile into
//      registers, a block barrier follows, and only then do logits land over
//      q (the logits of query tile t cover q tiles <= t only, so in rounds of
//      one tile a warp, each round behind one barrier, none is overwritten
//      before it is read);
//   K: k, and after phase 1 the output tiles of phase 3;
//   V: v, staged in a second cp.async group that lands while phase 1 runs.
// At (T, D) = (66, 64), T_p = 80: 28,160 + 2 * 11,520 = 51,200 bytes a head in
// bf16 (four blocks an SM), 28,160 + 2 * 21,760 = 71,680 in fp32 (three);
// without q under L they were 62,720 and 92,160.
// - bf16: every product on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 accumulators) through attention_common.cuh, as K1 does.
//   Phase 2 writes P as bf16 in place over its own fp32 row (the row's
//   lanes read it whole first), shifted by 16 bytes on rows 4-7 of every 8,
//   so that phase 3's ldmatrix of P (row pitch 32 or 96 mod 128 bytes) hits
//   8 distinct 16-byte bank groups.
// - fp32: both products as 3xTF32 on mma.sync m16n8k8 (split_tf32 and
//   mma_3xtf32 of attention_common.cuh, as K1's streamed fp32 kernel):
//   each operand x = hi + lo, every product lo.hi + hi.lo + hi.hi summed
//   in a zeroed tile, one k-step of 8 a tile, then added to the fp32
//   accumulator, so the tensor cores' truncating adders see three products.
//   The q fragments are held raw and split at each use; k's B fragments
//   come from ldmatrix on fp32 rows; P stays fp32 in place and its A
//   fragments are float2 reads with the keys of a k-step in the order (2q,
//   2q + 1) for k = (q, q + 4), V read in that order (K1's streamed order;
//   both reads are free of bank conflicts).
// - Occupancy: a block has at most 6 bf16 or 5 fp32 warps (one round of
//   units, more rounds past that: the experiment's T = 66 is 5 tiles);
//   __launch_bounds__ asks for four bf16 blocks an SM and three fp32 ones,
//   what shared memory allows at T = 66.  Each of an SM's four schedulers
//   holds a quarter of its registers, so that leaves 80 registers a thread
//   in bf16 (six warps a scheduler) and 128 in fp32 (four); fp32 spilled at
//   8 warps (80 registers) and at 6 (96).  G, unless
//   the caller names it, is the divisor of H that puts the most warps on the
//   card in the first wave (blocks resident an SM from the occupancy query,
//   at most the grid), the smaller G on a tie: at (256, 66, 768, 12) G = 1 in
//   both types (3,072 blocks; four bf16 or three fp32 blocks an SM).
// - No atomics: every value has one owner, so two launches give the same bits.
//
// The longest T one block takes at D = 64 (G = 1) is 192 in bf16 and 176 in
// fp32; past that the wrapper raises.

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mnt;

constexpr size_t kMaxSmem = 227 * 1024;
// float2 pairs of a logits row one of its 8 lanes holds in phase 2: T_p <= 16 * 14
// (227 KB already caps T_p at 224 for every D the kernel takes, 16 to 64)
constexpr int kMaxPairs = 14;

// the most warps a block has, and the blocks an SM __launch_bounds__ asks
// for: bf16 6 and four (80 registers a thread), fp32 5 and three (128)
template <typename T>
struct Occupancy {
  static constexpr int kMaxWarps = sizeof(T) == 2 ? 6 : 5;
  static constexpr int kBlocks = sizeof(T) == 2 ? 4 : 3;
};

// element pitch of a staged row (16-byte pieces at odd multiples of 16
// bytes mod 128, so ldmatrix is free of bank conflicts)
__host__ __device__ constexpr int stage_ld(int D, int elem) { return D + (elem == 2 ? 8 : 4); }

// bytes of the regions of one head: L (logits, with q at its end) and K or V
__host__ __device__ inline size_t region_l(int tp, int D, int elem) {
  const size_t lg = (size_t)tp * (tp + 8) * sizeof(float);
  const size_t st = (size_t)tp * stage_ld(D, elem) * elem;
  return lg > st ? lg : st;
}
__host__ __device__ inline size_t region_kv(int tp, int D, int elem) {
  return (size_t)tp * stage_ld(D, elem) * elem;
}

int elem_size(int dtype) { return dtype == 1 ? 2 : 4; }

size_t block_smem(int seq, int D, int group, int dtype) {
  const int tp = round16(seq), e = elem_size(dtype);
  return (size_t)group * (region_l(tp, D, e) + 2 * region_kv(tp, D, e));
}

bool fits(int seq, int D, int group, int dtype) {
  return seq >= 1 && round16(seq) <= 16 * kMaxPairs &&
         block_smem(seq, D, group, dtype) <= kMaxSmem;
}

// warps of a block: its G * T_p / 16 units in the fewest rounds of at most
// kMaxWarps, spread evenly over them
int block_warps(int seq, int group, int dtype) {
  const int most = dtype == 1 ? Occupancy<bf16>::kMaxWarps : Occupancy<float>::kMaxWarps;
  const int units = group * (round16(seq) / 16);
  const int rounds = (units + most - 1) / most;
  return (units + rounds - 1) / rounds;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * Occupancy<T>::kMaxWarps, Occupancy<T>::kBlocks)
twophase(const T* __restrict__ qkv, T* __restrict__ out, int seq, int width, int heads,
         int group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int LD = stage_ld(D, sizeof(T));
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tp = round16(seq), tiles = tp / 16, lds = tp + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nw = blockDim.x / 32;
  const size_t bytes_l = region_l(tp, D, sizeof(T)), bytes_kv = region_kv(tp, D, sizeof(T));
  const size_t head_bytes = bytes_l + 2 * bytes_kv;
  auto logits = [&](int g) { return reinterpret_cast<float*>(smem_raw + g * head_bytes); };
  auto q_of = [&](int g) {
    return reinterpret_cast<T*>(smem_raw + g * head_bytes + bytes_l - bytes_kv);
  };
  auto k_of = [&](int g) { return reinterpret_cast<T*>(smem_raw + g * head_bytes + bytes_l); };
  auto v_of = [&](int g) {
    return reinterpret_cast<T*>(smem_raw + g * head_bytes + bytes_l + bytes_kv);
  };

  const int ngroups = heads / group;
  const int b = blockIdx.x / ngroups, h0 = (blockIdx.x % ngroups) * group;
  const size_t stride = 3 * (size_t)width;
  const T* base = qkv + (size_t)b * seq * stride + (size_t)h0 * D;
  for (int g = 0; g < group; ++g) {
    stage_rows<T, D>(q_of(g), LD, base + g * D, stride, seq, tp, tid, blockDim.x);
    stage_rows<T, D>(k_of(g), LD, base + width + g * D, stride, seq, tp, tid, blockDim.x);
  }
  cp_async_commit();
  for (int g = 0; g < group; ++g)
    stage_rows<T, D>(v_of(g), LD, base + 2 * width + g * D, stride, seq, tp, tid, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // phase 1: S = Q.K^T * scale2 of every head, -inf at keys past T, in
  // rounds of one unit (head, 16-row tile) a warp
  const int units = group * tiles;
  for (int u0 = 0; u0 < units; u0 += nw) {
    const int u = u0 + warp, g = u / tiles, r0 = 16 * (u % tiles);
    const bool mine = u < units;
    float* rows = logits(g) + (size_t)(r0 + lane / 4) * lds + 2 * (lane & 3);
    auto store = [&](const float (&s)[2][4], int c0) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(rows + 8 * r * lds + c0 + 8 * t) =
              make_float2(s[t][2 * r], s[t][2 * r + 1]);
    };
    if constexpr (kBf16) {
      uint32_t qf[D / 16][4];
      if (mine) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], q_of(g), LD, r0, 16 * kk, lane);
      }
      __syncthreads();  // every q tile of this round is in registers
      if (!mine) continue;
      for (int c0 = 0; c0 < tp; c0 += 16) {
        float s[2][4];
        scores_bf16<D, 16>(s, qf, k_of(g), c0, tp, seq, r0, false, scale2, lane);
        store(s, c0);
      }
    } else {
      // matrices (rows 0-7, d 8kk..), (8-15, 8kk..), (0-7, 8kk + 4..), (8-15, 8kk + 4..)
      uint32_t qa[D / 8][4];
      if (mine) {
        const float* qw =
            q_of(g) + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) ldmatrix_x4(qa[kk], qw + 8 * kk);
      }
      __syncthreads();  // every q tile of this round is in registers
      if (!mine) continue;
      // matrices (keys c0.., d 8kk..), (c0.., 8kk + 4..), (c0 + 8.., 8kk..), (c0 + 8.., 8kk + 4..)
      const float* kw = k_of(g) + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
      for (int c0 = 0; c0 < tp; c0 += 16) {
        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          uint32_t ah[4], al[4], bk[4], bh[4], bl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(qa[kk][e], ah[e], al[e]);
          ldmatrix_x4(bk, kw + c0 * LD + 8 * kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(bk[e], bh[e], bl[e]);
          mma_3xtf32(s[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
        const bool edge = c0 + 16 > seq;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool valid = !edge || c0 + 8 * t + 2 * (lane & 3) + (e & 1) < seq;
            s[t][e] = valid ? s[t][e] * scale2 : -INFINITY;
          }
        store(s, c0);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // phase 2: the softmax of every row of every head, in place.  Lane group
  // gi = lane / 8 takes row 4w + (0, 2, 1, 3)[gi] of its warp's four: rows
  // two apart are 64 mod 128 bytes apart, so each half-warp's float2 reads
  // fill 32 banks; lane j of a group holds the row's pairs j, j + 8, ...
  {
    const int npairs = tp / 16, gi = lane >> 3, j = lane & 7;
    const int roff = ((gi & 1) << 1) | (gi >> 1);
    for (int rb = 4 * warp; rb < group * tp; rb += 4 * nw) {
      const int rr = rb + roff, r = rr % tp;
      float* row = logits(rr / tp) + (size_t)r * lds;
      float2 x[kMaxPairs];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        if (i < npairs) {
          x[i] = *reinterpret_cast<const float2*>(row + 2 * (j + 8 * i));
          m = fmaxf(m, fmaxf(x[i].x, x[i].y));
        }
      }
      m = group_max<8>(m);  // key 0 is finite: so is m
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        if (i < npairs) {
          x[i].x = ex2(x[i].x - m);
          x[i].y = ex2(x[i].y - m);
          sum += x[i].x + x[i].y;
        }
      }
      const float l = group_sum<8>(sum);
      const float inv_l = r < seq ? 1.f / l : 0.f;  // a padded query row: P = 0
      __syncwarp();  // the row's lanes have read it whole before P lands over it
      if constexpr (kBf16) {
        bf16* prow = reinterpret_cast<bf16*>(row) + 8 * ((r >> 2) & 1);
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i)
          if (i < npairs)
            *reinterpret_cast<uint32_t*>(prow + 2 * (j + 8 * i)) =
                pack_bf16(x[i].x * inv_l, x[i].y * inv_l);
      } else {
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i)
          if (i < npairs)
            *reinterpret_cast<float2*>(row + 2 * (j + 8 * i)) =
                make_float2(x[i].x * inv_l, x[i].y * inv_l);
      }
    }
  }
  __syncthreads();

  // phase 3: O = P.V of every head; each warp stages its tile in K's region
  // (free since phase 1) and writes it out in 16-byte pieces of rows
  constexpr int kPiece = 16 / sizeof(T), kPieces = D / kPiece;  // elements, pieces a row
  const int gq = lane / 4, q = lane & 3;
  for (int u = warp; u < units; u += nw) {
    const int g = u / tiles, r0 = 16 * (u % tiles);
    float o[D / 8][4] = {};
    if constexpr (kBf16) {
      // this lane's ldmatrix row of P (bf16, pitch 2 lds, shifted on rows 4-7 of 8)
      const int pr = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const bf16* prow = reinterpret_cast<const bf16*>(logits(g)) + (size_t)pr * 2 * lds +
                         8 * ((pr >> 2) & 1) + (lane >> 4) * 8;
      for (int n0 = 0; n0 < tp; n0 += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, prow + n0);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bv[4];
          load_b_cols(bv, v_of(g), LD, n0, 16 * dd, lane);
          mma_bf16(o[2 * dd], a, bv[0], bv[1]);
          mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
        }
      }
    } else {
      // k-step kk: keys 8kk + (2q, 2q + 1) as the fragment's k = (q, q + 4)
      const float* p0 = logits(g) + (size_t)(r0 + gq) * lds + 2 * q;
      const float* v0 = v_of(g) + 2 * q * LD + gq;
      for (int kk = 0; kk < tp / 8; ++kk) {
        const float2 top = *reinterpret_cast<const float2*>(p0 + 8 * kk);
        const float2 bot = *reinterpret_cast<const float2*>(p0 + 8 * lds + 8 * kk);
        const uint32_t a[4] = {__float_as_uint(top.x), __float_as_uint(bot.x),
                               __float_as_uint(top.y), __float_as_uint(bot.y)};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
        const float* vk = v0 + 8 * kk * LD;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(__float_as_uint(vk[8 * n]), bh0, bl0);
          split_tf32(__float_as_uint(vk[LD + 8 * n]), bh1, bl1);
          mma_3xtf32(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    T* os = k_of(g) + r0 * LD;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        T* dst = os + (gq + 8 * r) * LD + 8 * n + 2 * q;
        if constexpr (kBf16) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
        }
      }
    __syncwarp();
    T* out_b = out + ((size_t)b * seq + r0) * width + (size_t)(h0 + g) * D;
    for (int c = lane; c < 16 * kPieces; c += 32) {
      const int rr = c / kPieces, cc = (c % kPieces) * kPiece;
      if (r0 + rr < seq)
        *reinterpret_cast<uint4*>(out_b + (size_t)rr * width + cc) =
            *reinterpret_cast<const uint4*>(os + rr * LD + cc);
    }
  }
}

// the kernel of (dtype, D), or nullptr
template <int D>
const void* kernel_d(int dtype) {
  if (dtype == 0) return reinterpret_cast<const void*>(twophase<float, D>);
  if (dtype == 1) return reinterpret_cast<const void*>(twophase<bf16, D>);
  return nullptr;
}

const void* kernel_of(int D, int dtype) {
  switch (D) {
    case 16: return kernel_d<16>(dtype);
    case 32: return kernel_d<32>(dtype);
    case 64: return kernel_d<64>(dtype);
    default: return nullptr;
  }
}

// the whole of a block's shared memory, and every byte of the SM's for blocks
cudaError_t prepare(const void* kernel) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// blocks of G heads resident an SM (0 when the block does not fit)
cudaError_t blocks_per_sm(int seq, int D, int group, int dtype, int* n) {
  *n = 0;
  const void* kernel = kernel_of(D, dtype);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (group < 1 || !fits(seq, D, group, dtype)) return cudaSuccess;
  cudaError_t e = prepare(kernel);
  if (e != cudaSuccess) return e;
  const int threads = 32 * block_warps(seq, group, dtype);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads,
                                                       block_smem(seq, D, group, dtype));
}

// the default G: the divisor of heads that puts the most warps on the card
// in the first wave (0 when no group fits)
cudaError_t default_group(int B, int seq, int D, int heads, int dtype, int* group) {
  *group = 0;
  int dev, sms;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  long best = 0;
  for (int g = 1; g <= heads; ++g) {
    if (heads % g) continue;
    int n;
    if ((e = blocks_per_sm(seq, D, g, dtype, &n)) != cudaSuccess) return e;
    if (n == 0) continue;
    const long grid = (long)B * (heads / g);
    const long warps = std::min(grid, (long)sms * n) * block_warps(seq, g, dtype);
    if (warps > best) best = warps, *group = g;
  }
  return cudaSuccess;
}

template <typename T, int D>
void launch(const void* qkv, void* out, int B, int seq, int width, int heads, int group,
            float scale, cudaStream_t stream) {
  const int dtype = sizeof(T) == 2 ? 1 : 0;
  twophase<T, D><<<B * (heads / group), 32 * block_warps(seq, group, dtype),
                   block_smem(seq, D, group, dtype), stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, width, heads, group, scale);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of `group` heads takes (the wrapper
// raises past 227 KB; ops/twophase_attention.py keeps the same formula).
size_t mnt_twophase_attention_smem(int seq, int head_dim, int group, int dtype) {
  return block_smem(seq, head_dim, group, dtype);
}

// Blocks of `group` heads resident on one SM (the occupancy query, with the
// largest shared-memory carveout); 0 when group does not divide heads or its
// block does not fit; minus a cudaError_t on failure.
int mnt_twophase_attention_blocks_per_sm(int seq, int head_dim, int heads, int dtype,
                                         int group) {
  if (heads <= 0 || group <= 0 || heads % group) return 0;
  int n;
  const cudaError_t e = blocks_per_sm(seq, head_dim, group, dtype, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The heads a block takes when the caller leaves G to the kernel; 0 when
// one head does not fit a block; minus a cudaError_t on failure.
int mnt_twophase_attention_groups(int B, int seq, int head_dim, int heads, int dtype) {
  if (B <= 0 || heads <= 0) return 0;
  int g;
  const cudaError_t e = default_group(B, seq, head_dim, heads, dtype, &g);
  return e == cudaSuccess ? g : -static_cast<int>(e);
}

// qkv: (B, seq, 3*width) contiguous, 16-byte aligned; out: (B, seq, width)
// contiguous, same type.  scale: D^-0.5 as the caller rounds it to float32.
// dtype: 0 = float32, 1 = bfloat16.  group: heads a block (a divisor of
// heads whose block fits), 0 = the kernel's own choice.  Returns a
// cudaError_t (0 on success).
int mnt_twophase_attention(const void* qkv, void* out, int B, int seq, int width, int heads,
                           float scale, int dtype, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || heads <= 0 || width % heads || group < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = width / heads;
  const void* kernel = kernel_of(D, dtype);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (group == 0 && (e = default_group(B, seq, D, heads, dtype, &group)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  if (group == 0 || heads % group || !fits(seq, D, group, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((e = prepare(kernel)) != cudaSuccess) return static_cast<int>(e);
  switch (D * 2 + dtype) {
    case 32: launch<float, 16>(qkv, out, B, seq, width, heads, group, scale, s); break;
    case 33: launch<bf16, 16>(qkv, out, B, seq, width, heads, group, scale, s); break;
    case 64: launch<float, 32>(qkv, out, B, seq, width, heads, group, scale, s); break;
    case 65: launch<bf16, 32>(qkv, out, B, seq, width, heads, group, scale, s); break;
    case 128: launch<float, 64>(qkv, out, B, seq, width, heads, group, scale, s); break;
    default: launch<bf16, 64>(qkv, out, B, seq, width, heads, group, scale, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
