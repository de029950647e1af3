// bf16, kShortMaxSeq < T <= kResidentMaxSeq: one sweep with the scores held
// in registers, on a persistent grid.  An item is (batch row x head, group
// of 64-row query tiles), a warpgroup per tile (blockDim / 128 of them);
// each block takes a contiguous run of items (head by head) and, while it
// computes one, stages the next: its q tiles, and K and V when its head
// differs.  NCH = ceil(T / 64) key chunks is a template parameter, so that
// the NCH score accumulators (32 fp32 a thread each: 160 registers at NCH =
// 5) are indexed at compile time.  Shared memory, from a 1024-byte
// boundary: two q buffers (a tile a warpgroup each), then two K/V buffers
// (K's NCH chunks and V's), all in the swizzled layout.  An item's staging
// is NCH + 1 cp.async groups: its q (and K's chunk 0), K's chunk c, V
// (K's and V's groups empty when the head stays): the block meets once a
// chunk of K and issues that chunk's S = q . K^T (SS m64n64k16) at once,
// so that a new head's chunk 0 runs while the rest of K lands.  Then, once
// V has landed and every thread has left the item before, the next item is
// staged into the other buffers, and this one computes: after one wait,
// -inf past T and past a causal row's diagonal, each row's exact max m by
// fmax over the held scores (no exponential), one ex2 a score (D^-0.5
// log2(e) folded into its FFMA), the quad sum l and 1/l; then chunk by
// chunk P = 2^((s - m) scale2) * (1/l), normalised in fp32, rounded to bf16
// into the A fragments of its P.V (RS m64n(D)k16, V with the transpose bit)
// and issued, each chunk's fragments in registers of their own, formed
// while the chunk before is in flight; one wait before O is stored.  A
// causal tile computes every chunk's scores (its chunks past the diagonal
// are -inf, their P 0) but only the exponentials and P.V steps up to its
// keys; 8-key groups past the tile's keys are left out of the exponentials
// (their P is exactly 0) and warps whose rows all lie past T out of the
// softmax.  A warpgroup whose tile lies past T keeps to the block's
// barriers and computes nothing.
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
__global__ void __launch_bounds__(128 * kWgMaxGroups, 1)
attention_fwd_onesweep(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
                       int heads, float scale, int causal, int items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile_bytes(D), NO = D / 2;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid % 32;
  // the warp's index broadcast from lane 0 (attention_fwd_wgmma says why)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int groups = nthreads / 128, wg = warp_id / 4, warp = warp_id % 4;
  const int rows = kWgRows * groups;  // an item's query rows
  const int per_head = (seq + rows - 1) / rows;  // items a (row, head)
  const uint32_t qbuf = (smem_u32(smem_raw) + 1023) & ~1023u;  // two q buffers
  const uint32_t kvbuf = qbuf + 2 * groups * TILE;  // two K/V buffers
  const size_t stride = 3 * (size_t)width;
  const int q2 = 2 * (lane & 3);
  // the block's run of items
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  auto head_base = [&](int it) {
    const int bh = it / per_head, b = bh / heads, h = bh % heads;
    return qkv + (size_t)b * seq * stride + h * D;
  };
  // an item's NCH + 1 cp.async groups into q buffer qb and (with its head's
  // K and V) K/V buffer kb
  auto stage = [&](int it, int qb, int kb, bool kv) {
    const bf16* base = head_base(it);
    const int rb = rows * (it % per_head);
    const uint32_t ks = kvbuf + kb * 2 * NCH * TILE;
    stage_swizzled<D>(qbuf + qb * groups * TILE, base + rb * stride, stride, seq - rb, rows, tid,
                      nthreads);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (kv) {
        stage_swizzled<D>(ks + c * TILE, base + width + c * kWgKeys * stride, stride,
                          seq - c * kWgKeys, kWgKeys, tid, nthreads);
      }
      cp_async_commit();
    }
    if (kv) stage_swizzled<D>(ks + NCH * TILE, base + 2 * width, stride, seq, NCH * kWgKeys, tid,
                              nthreads);
    cp_async_commit();
  };

  int kb = 0;
  if (first < end) stage(first, 0, 0, true);
  for (int it = first; it < end; ++it) {
    const int qb = (it - first) & 1;
    const bool next_kv = it + 1 < end && (it + 1) / per_head != it / per_head;
    const int rb = rows * (it % per_head), rt = rb + kWgRows * wg, r0 = rt + 16 * warp;
    const bool active = rt < seq;                             // the warpgroup has rows
    const bool live = r0 < seq;                               // the warp has rows
    const int kend = causal ? min(seq, rt + kWgRows) : seq;  // the keys the tile's rows see
    // the last key each of the thread's two rows sees
    const int row = r0 + lane / 4;
    const int last[2] = {causal ? min(seq - 1, row) : seq - 1,
                         causal ? min(seq - 1, row + 8) : seq - 1};
    const uint32_t ks = kvbuf + kb * 2 * NCH * TILE;

    // S = q . K^T, chunk by chunk as K lands, all in flight at once; the
    // scores stay unscaled (scale2 is folded into each exponential's FFMA)
    const uint64_t q_desc = wg_desc<D>(qbuf + (qb * groups + wg) * TILE);
    float s[NCH][32];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      cp_async_wait_upto(NCH - c);  // q and K's chunks up to c
      fence_proxy_async();
      __syncthreads();
      if (active) {
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
    }
    cp_async_wait<0>();  // V, under the products
    fence_proxy_async();
    __syncthreads();  // ... and every thread has left the item before
    if (it + 1 < end) stage(it + 1, qb ^ 1, next_kv ? kb ^ 1 : kb, next_kv);
    if (next_kv) kb ^= 1;
    if (!active) continue;
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

    // P.V chunk by chunk (k-step j: keys c0 + 16j ..), up to the tile's keys
    const uint32_t vs = ks + NCH * TILE;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    uint32_t a[NCH][4][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int c0 = c * kWgKeys;
      if (c0 >= kend) break;
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
#if MNT_K1_PART == 2
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[(4 * j + e) % NO] += __uint_as_float(a[c][j][e] & 0x3fff3fffu);
#else
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(a[c][j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + 16 * j < kend) {
          wgmma_rs<D>(o, a[c][j], wg_desc<D>(vs + c * TILE + j * 16 * 2 * D));
        }
      }
      wgmma_commit();
#endif
    }
    wgmma_wait_all();
    fence_regs(o);
    if (!live) continue;
    const int bh = it / per_head;
    bf16* out_b = out + (size_t)(bh / heads) * seq * width + (bh % heads) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row + 8 * r < seq)
          *reinterpret_cast<uint32_t*>(out_b + (size_t)(row + 8 * r) * width + 8 * j + q2) =
              pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

