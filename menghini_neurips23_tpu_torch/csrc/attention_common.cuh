// Building blocks shared by the attention kernels K1 (attention_fwd.cu) and
// K2 (attention_bwd.cu): 16-byte cp.async staging, ldmatrix, the bf16
// m16n8k16 and the TF32 m16n8k8 tensor-core products with fp32
// accumulators (fp32 as 3xTF32), base-2 exponentials, warp reductions, and
// the scaled, masked scores both kernels start from.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l, g = l / 4,
// q = l % 4.  A (16 x 16, row-major) holds rows g and g + 8, columns 2q,
// 2q + 1 and 8 + 2q, 9 + 2q; B (16 x 8) holds rows 2q, 2q + 1, 8 + 2q,
// 9 + 2q of column g; the fp32 accumulator C (16 x 8) holds c0, c1 at row g,
// columns 2q, 2q + 1 and c2, c3 at row g + 8.  A row of C's values is thus
// spread over the 4 lanes of a quad, and the accumulators of two adjacent
// n8 tiles, rounded to bf16, are exactly an A fragment for the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace mnt {

// Rows of the (B, T, *) tensors are staged with 16-byte copies; rows past T
// are filled with zeros (src-size 0), so padded keys and values are finite.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of the committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// wait until at most n (0 .. 5) of the committed cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// Copy rows [0, rows_pad) of a strided tensor's (rows, kRowElems) slice
// into shared memory, `ld` elements apart; rows >= rows are zero-filled.
// kRowElems * sizeof(T) is a multiple of 16 bytes.  Call cp_async_commit
// after, and cp_async_wait before reading the rows.
template <typename T, int kRowElems>
__device__ __forceinline__ void stage_rows(T* smem, int ld, const T* gmem, size_t stride,
                                           int rows, int rows_pad, int tid, int nthreads) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = kRowElems / kPer;
  for (int idx = tid; idx < rows_pad * kChunks; idx += nthreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * kPer;
    const bool valid = r < rows;
    cp_async16(smem + r * ld + c, gmem + (valid ? r * stride + c : 0), valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b on the tensor cores: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo (+ what lo drops): hi is x rounded to TF32's 10 fraction bits
// (on the bit pattern, to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds: integer operations, not the slower cvt), x - hi is exact in fp32,
// and lo is that cut to TF32 (the bits the tensor core reads)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) & 0xffffe000u;
}

// x = hi + lo in two operations: hi is x cut to TF32 (toward zero) and lo =
// x - hi exactly, of which the tensor core reads the top bits (it cuts an
// fp32 operand to TF32, as split_tf32's mask does: empirical on the H100,
// see split_tf32_uncut in attention_bwd.cu).  hi drops up to one TF32 unit
// rather than half, so lo and the lo.lo that 3xTF32 leaves out are twice
// split_tf32's: a product errs by up to ~2^-20 of |a||b| rather than
// ~2^-21, for half the integer work (tests/test_torch_port_short_fp32.py
// emulates both).
__device__ __forceinline__ void split_tf32_trunc(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// c += a . b on the tensor cores: TF32 operands, fp32 accumulators.
// Fragments (PTX ISA, mma.m16n8k8 .tf32): lane l, g = l / 4, q = l % 4;
// A holds (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B holds (k = q,
// n = g), (k = q + 4, n = g); C as for m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b to fp32 accuracy as 3xTF32: lo.hi + hi.lo + hi.hi (what is
// dropped, lo.lo and the bits below lo, is ~2^-21 of the product), summed
// on the tensor cores in a zeroed tile and then added to c with one fp32
// add (rounded to nearest), so that no sum runs long inside the tensor
// cores' adders, which truncate
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// 2^x, one MUFU operation (ex2.approx.ftz: relative error below 2^-22,
// results below 2^-126 flushed to 0, 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment at rows r0..r0+15, columns k0..k0+15 of a row-major bf16 tile;
// with `trans`, of the transpose of a tile stored with those as its columns.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int k0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, c = k0 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + r * ld + c);
}

__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                             int ld, int r0, int k0, int lane) {
  // A[m][k] = tile[k0 + k][r0 + m]
  const int k = k0 + (lane & 7) + (lane >> 4) * 8, m = r0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(a, tile + k * ld + m);
}

// B fragments of two n8 tiles (n0..n0+7, n0+8..n0+15) for k0..k0+15, where
// B[k][n] = rows[n][k]: rows of keys read straight (Q.K^T, G.V^T).
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* rows, int ld,
                                            int n0, int k0, int lane) {
  const int n = n0 + (lane & 7) + (lane >> 4) * 8, k = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, rows + n * ld + k);
}

// ... where B[k][n] = rows[k][n]: a row-major (k, n) tile (P.V, dS.K, ...)
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* rows, int ld,
                                            int k0, int n0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, rows + k * ld + n);
}

// reductions over the lanes that share one row
template <int kWidth>
__device__ __forceinline__ float group_max(float v) {
  for (int o = 1; o < kWidth; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int kWidth>
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 1; o < kWidth; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int round16(int t) { return (t + 15) / 16 * 16; }

// ------------------------------------------------------------ scores

// Key capacity of one sweep, KC in {16, 32, 64, 96, 128}: the smallest that
// holds a (16-padded) sequence of tp keys, 128 past that.  Score tiles and
// unrolled loops are sized by it, so short sequences pay for no empty slots.
__host__ __device__ constexpr int key_capacity(int tp) {
  return tp <= 16 ? 16 : tp <= 32 ? 32 : tp <= 64 ? 64 : tp <= 96 ? 96 : 128;
}

// Scores of the warp's 16 rows (r0 ..) against keys [c0, c0 + KC) below
// kend, scaled, and masked where a tile crosses T or the diagonal; the rest
// of the chunk is -inf.  Lane l holds rows r0 + l/4 and r0 + l/4 + 8.  ks
// holds all the keys.
template <int D, int KC>
__device__ __forceinline__ void scores_bf16(float (&s)[KC / 8][4], const uint32_t (&qf)[D / 16][4],
                                            const __nv_bfloat16* ks, int c0, int kend, int seq,
                                            int r0, bool causal, float scale, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < KC / 16; ++j) {
    const int n0 = c0 + 16 * j;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * j + t][e] = n0 < kend ? 0.f : -INFINITY;
    if (n0 >= kend) continue;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      load_b_rows(b, ks, LD, n0, 16 * kk, lane);
      mma_bf16(s[2 * j], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * j + 1], qf[kk], b[2], b[3]);
    }
    const bool edge = n0 + 16 > seq || (causal && n0 + 15 > r0);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * t + 2 * (lane & 3) + (e & 1);
        const int row = r0 + lane / 4 + (e >> 1) * 8;
        const bool valid = !edge || (col < seq && (!causal || col <= row));
        s[2 * j + t][e] = valid ? s[2 * j + t][e] * scale : -INFINITY;
      }
  }
}

// The same for fp32 rows (D + 4 floats a row) as 3xTF32 on m16n8k8, the
// A fragments of the warp's 16 rows of q read from qw (its first row) at
// each k-step, two k-steps at a time, so that few of them are live at once;
// ldmatrix reads fp32 rows as well (an 8 x 8 matrix of b16 pairs is an
// 8 x 4 matrix of floats).  The accumulator layout is scores_bf16's.
template <int D, int KC>
__device__ __forceinline__ void scores_tf32(float (&s)[KC / 8][4], const float* qw,
                                            const float* ks, int c0, int kend, int seq, int r0,
                                            bool causal, float scale, int lane, int ks0 = 0) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int n = 0; n < KC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = c0 + 8 * n < kend ? 0.f : -INFINITY;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    // matrices (rows 0-7, d 8kk..), (8-15, 8kk..), (0-7, 8kk + 4..), (8-15, 8kk + 4..)
    uint32_t a[4], ah[4], al[4];
    ldmatrix_x4(a, qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * kk + (lane >> 4) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      const int n0 = c0 + 16 * j;
      if (n0 >= kend) continue;
      // matrices (keys n0.., d 8kk..), (n0.., 8kk + 4..), (n0 + 8.., 8kk..), (n0 + 8.., 8kk + 4..)
      uint32_t b[4], bh[4], bl[4];
      ldmatrix_x4(b, ks + (n0 - ks0 + (lane & 7) + (lane >> 4) * 8) * LD + 8 * kk +
                         ((lane >> 3) & 1) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(b[e], bh[e], bl[e]);
      mma_3xtf32(s[2 * j], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma_3xtf32(s[2 * j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < KC / 16; ++j) {
    const int n0 = c0 + 16 * j;
    if (n0 >= kend || !(n0 + 16 > seq || (causal && n0 + 15 > r0))) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * t + 2 * (lane & 3) + (e & 1);
        const int row = r0 + lane / 4 + (e >> 1) * 8;
        if (col >= seq || (causal && col > row)) s[2 * j + t][e] = -INFINITY;
      }
  }
#pragma unroll
  for (int n = 0; n < KC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= scale;  // -inf stays -inf
}

// c += A . B, 3xTF32, over two k-steps of 8: A straight from the
// accumulator tiles a0 and a1 of the warp's 16 rows against 16 columns (P,
// dS or their transposes), each tile's columns 2q, 2q + 1 taken as the
// fragment's k = q, q + 4, which is what the accumulator layout holds; B the
// 16 fp32 rows at b (D + 4 floats a row) in that order (rows 2q, 2q + 1,
// then 8 + 2q, 9 + 2q), columns 8n + g.  The six products of the two
// k-steps are summed in a zeroed tile and then added to c in fp32 (the
// tensor cores' adders truncate).  NC of the row's 8-column groups, from
// b's first column on (all D / 8 by default); operands split by split_tf32,
// or with kTrunc by split_tf32_trunc.  The column reads are free of bank
// conflicts (D + 4 = 4 mod 32 floats, or 20 at D = 16).
template <int D, int NC = D / 8, bool kTrunc = false>
__device__ __forceinline__ void acc2_times_rows_tf32(float (&c)[NC][4], const float (&a0)[4],
                                                     const float (&a1)[4], const float* b,
                                                     int lane) {
  auto split = [](uint32_t x, uint32_t& hi, uint32_t& lo) {
    if constexpr (kTrunc) {
      split_tf32_trunc(x, hi, lo);
    } else {
      split_tf32(x, hi, lo);
    }
  };
  constexpr int LD = D + 4;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float(&a)[4] = u ? a1 : a0;
    const uint32_t x[4] = {__float_as_uint(a[0]), __float_as_uint(a[2]), __float_as_uint(a[1]),
                           __float_as_uint(a[3])};
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], ah[u][e], al[u][e]);
  }
  const float* r = b + 2 * (lane & 3) * LD + lane / 4;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* rk = r + 8 * u * LD + 8 * n;
      uint32_t bh0, bl0, bh1, bl1;
      split(__float_as_uint(rk[0]), bh0, bl0);
      split(__float_as_uint(rk[LD]), bh1, bl1);
      mma_tf32(t, al[u], bh0, bh1);
      mma_tf32(t, ah[u], bl0, bl1);
      mma_tf32(t, ah[u], bh0, bh1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += t[e];
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mnt
