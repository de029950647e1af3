// Hopper warpgroup MMA (wgmma.mma_async, sm_90a) building blocks shared by
// K1's forms above 128 tokens (attention_fwd.cu: bf16, and fp32 as 3xTF32)
// and K2's pairs of launches (attention_bwd.cu: bf16 above 320 tokens, and
// fp32 above 128 as 3xTF32): shared addresses, the swizzled layouts and
// matrix descriptors wgmma reads, its fences, the bf16 and tf32 products
// (both operands from shared memory, or A from registers), and the fp32
// tiles split into TF32 hi and lo planes.
//
// A warpgroup is four consecutive warps; each wgmma instruction is issued
// by all 128 threads at once.  The fp32 accumulator of m64nNk8 (or k16)
// puts warp w's rows 16w .. 16w + 15 in mma.sync's m16n8 layout, tile after
// tile: lane l (g = l / 4, q = l % 4) holds d[4j], d[4j + 1] at row 16w + g,
// columns 8j + 2q, 8j + 2q + 1, and d[4j + 2], d[4j + 3] at row 16w + g + 8.
// A tf32 A operand from registers has mma.sync's m16n8k8 A layout a warp:
// a[0] (row g, k q), a[1] (g + 8, q), a[2] (g, q + 4), a[3] (g + 8, q + 4).
// So accumulator tile j's columns 2q, 2q + 1, taken as the fragment's k =
// q, q + 4, are one k-step's A fragment, provided B's rows (its k) hold
// each 8-column group in the order (0, 2, 4, 6, 1, 3, 5, 7).
//
// B comes from shared memory.  A product whose B is a matrix's columns (P.V
// in K1; dS.K, P^T.g and dS^T.q in K2) reads it in bf16 with the transpose
// bit, from the rows as they landed (wgmma_rs); 32-bit operands of wgmma
// are K-major only (no transpose bit), so in tf32 that matrix is written
// transposed through registers.
//
// Every branch around a wgmma must be uniform for the compiler (kernels
// broadcast the warp index from lane 0) and no register a wgmma writes may
// be touched while one is in flight: ptxas otherwise serialises every wgmma
// of the kernel, and says so only as `ptxas info (C75xx)`.
#pragma once

#include "attention_common.cuh"

namespace mnt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, 16-byte piece) in a tile of rows of kRowBytes (128,
// 64 or 32: one swizzle atom a row), with the hardware's swizzle for that
// width: bits 4.. of the offset XOR bits 7.. (3, 2 or 1 of them).  The tile
// starts on a multiple of 1024 bytes, so the offset's bits are the
// address's.
template <int kRowBytes>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (kRowBytes / 16 - 1)) << 4);
}

// Matrix descriptor of a tile (or of its part from `addr` on) in that
// layout: the start address, the byte offsets between 8-row groups (both
// fields, 8 rows x kRowBytes: a K-major operand reads one as the stride
// between groups of rows, a transposed one as the stride between groups
// of k; the other offset spans swizzle atoms across the row, and a row is
// one atom), and the swizzle mode (1: 128 bytes, 2: 64, 3: 32).
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kMode = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  constexpr uint64_t kGroup = (8 * kRowBytes) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kGroup << 16) | (kGroup << 32) | (kMode << 62);
}

// cp.async writes (and the threads' own stores) reach wgmma's (async proxy)
// reads of shared memory only through this fence, issued by the writing
// thread before the barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching registers a wgmma writes before its
// wait (or reads after its issue) by making them depend on this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------------------------ bf16 products

// A bf16 A from registers has mma.sync's m16n8k16 A layout a warp, so two
// adjacent n8 tiles of an accumulator, rounded to bf16, are one k-step's A
// fragment.

// the bf16 tiles: rows of D values, 2D bytes
template <int D>
__device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  return swizzle<2 * D>(off);
}
template <int D>
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return smem_desc<2 * D>(addr);
}

// Rows [0, rows) of a strided (rows, D) bf16 slice into the tile at `tile`
// (a shared address) in the swizzled layout; rows >= valid are zero-filled.
template <int D>
__device__ __forceinline__ void stage_swizzled(uint32_t tile, const __nv_bfloat16* gmem, size_t stride,
                                               int valid, int rows, int tid, int nthreads) {
  constexpr int kPieces = D / 8;  // 16-byte pieces a row
  for (int idx = tid; idx < rows * kPieces; idx += nthreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const bool ok = r < valid;
    const uint32_t dst = tile + swizzled<D>(r * 2 * D + c * 16);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem + (ok ? r * stride + c * 8 : 0)), "r"(ok ? 16 : 0));
  }
}


// d (+)= A . B^T: m64n64k16, A (64 x 16) and B (64 keys x 16) both from
// shared memory, K-major; kScaleD 0 overwrites d
template <int kScaleD>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(kScaleD));
}

// d += A . B: m64n(D)k16, A (64 x 16) from registers, B (16 keys x D) from
// shared memory with the transpose bit (rows [key][d]: MN-major)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// ------------------------------------------------------------ tf32 products

// d (+)= A . B^T: m64nNk8 (N = 32 or 64), tf32 (fp32 operands, of which the
// tensor cores read the TF32 bits), A (64 x 8) and B (N rows x 8) both from
// shared memory, K-major; kScaleD 0 overwrites d
template <int N, int kScaleD>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 32 || N == 64, "m64n32k8 or m64n64k8");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "n"(kScaleD));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "n"(kScaleD));
  }
}

// d (+)= A . B: m64nNk8 (N = 16, 32 or 64), tf32, A (64 x 8) from registers
// in mma.sync's m16n8k8 A layout a warp, B (8 x N) from shared memory
// stored as B^T (N rows of k, K-major)
template <int N, int kScaleD>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kScaleD));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kScaleD));
  } else {
    static_assert(N == 16, "m64n16k8, m64n32k8 or m64n64k8");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kScaleD));
  }
}

// ------------------------------------------------------ fp32 tiles, split

// x = hi + lo, 4 values: hi = x rounded to TF32 as split_tf32 rounds it (a
// value the tensor cores read whole) and lo = x - hi exactly (of which they
// read the top bits).  Cutting hi instead (split_tf32_trunc) saves two
// integer operations a value and doubled K1's error on the card.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
  hi = make_float4(__uint_as_float(tf32_round(x.x)), __uint_as_float(tf32_round(x.y)),
                   __uint_as_float(tf32_round(x.z)), __uint_as_float(tf32_round(x.w)));
  lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// A K-major fp32 tile of kRows rows of D floats, as wgmma reads it: cut
// along d into sub-tiles of tf_sub(D) floats (one 128- or 64-byte swizzle
// atom a row), each kRows rows apart.  Byte offset of (row r, 16-byte piece
// c), and the descriptor offset (16-byte units) of k-step kk: its
// sub-tile, then 32 bytes a k-step within the row.
__host__ __device__ constexpr int tf_sub(int D) { return D < 32 ? D : 32; }
template <int D, int kRows>
__device__ __forceinline__ uint32_t tf_offset(int r, int c) {
  constexpr int kRowBytes = 4 * tf_sub(D), kPieces = tf_sub(D) / 4;
  return (c / kPieces) * kRows * kRowBytes +
         swizzle<kRowBytes>(r * kRowBytes + (c % kPieces) * 16);
}
template <int D, int kRows>
__host__ __device__ constexpr uint64_t tf_k_off(int kk) {
  constexpr int kStepsSub = tf_sub(D) / 8;  // k-steps a sub-tile
  return (uint64_t)(((kk / kStepsSub) * kRows * 4 * tf_sub(D) + (kk % kStepsSub) * 32) >> 4);
}

// Rows [0, rows) of a strided (rows, D) fp32 slice into consecutive kRows-row
// tiles at `tile` (a shared address) in that layout; rows >= valid are
// zero-filled
template <int D, int kRows>
__device__ __forceinline__ void stage_tf32(uint32_t tile, const float* gmem, size_t stride,
                                           int valid, int rows, int tid, int nthreads) {
  constexpr int kPieces = D / 4;  // 16-byte pieces a row
  for (int idx = tid; idx < rows * kPieces; idx += nthreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const bool ok = r < valid;
    const uint32_t dst = tile + (r / kRows) * (kRows * 4 * D) + tf_offset<D, kRows>(r % kRows, c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem + (ok ? r * stride + c * 4 : 0)), "r"(ok ? 16 : 0));
  }
}

// A landed tile's two planes: each value x of src's `bytes` becomes its hi
// at the same offset in `hi` (src itself: in place) and its lo in `lo`,
// written last (lo = hi = src leaves the lo plane in place); an elementwise
// map, so the swizzle does not matter
__device__ __forceinline__ void split_planes(const float* src, float* hi, float* lo, int bytes,
                                             int tid, int nthreads) {
  for (int i = tid; i < bytes / 16; i += nthreads) {
    float4 h, l;
    split4(reinterpret_cast<const float4*>(src)[i], h, l);
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

}  // namespace mnt
