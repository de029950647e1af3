// Query side, step D: the next step's S and dP chains issued before this
// step's softmax, into a second pair of accumulators (the two pairs are
// sv[u], dv[u], u the step's parity, indexed at compile time by a loop of
// two steps unrolled), so that the tensor cores run the next chunk's
// products while this chunk's statistics, P and dS are formed.  A step's
// chunk is staged one step ahead of its products' issue (three stages:
// the chunk of step + 2 lands under step's work, while step's chunk feeds
// its dq and step + 1's feeds its S and dP).  Two blocks an SM: the second
// pair takes 64 registers more.
template <int D>
__global__ void __launch_bounds__(kTileThreads, 2)
attention_bwd_q_wgmma_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                           bf16* __restrict__ dqkv, float* __restrict__ stats, int seq,
                           int width, int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile(D), NO = D / 2;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // uniform for the compiler
  const int rt = kTile * blockIdx.y, r0 = rt + 16 * warp;
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u, gs = qs + TILE, ring = gs + TILE;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t stride = 3 * (size_t)width;
  const bf16* base = qkv + (size_t)b * seq * stride + h * D;
  const int kend = causal ? min(seq, rt + kTile) : seq;
  const int nch = (kend + kChunk - 1) / kChunk, steps = 2 * nch;
  const int row0 = r0 + lane / 4, q2 = 2 * (lane & 3);

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
  const uint64_t q_desc = wg_desc<D>(qs), g_desc = wg_desc<D>(gs);
  // S and dP of a step, issued as one group (not waited for)
  auto issue = [&](float(&s)[32], float(&dp)[32], int step) {
    const uint32_t kt = k_tile(step);
    const uint64_t k_desc = wg_desc<D>(kt), v_desc = wg_desc<D>(kt + TILE);
    wgmma_fence();
    wgmma_ss<0>(s, q_desc, k_desc);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(s, q_desc + 2 * kk, k_desc + 2 * kk);
    wgmma_ss<0>(dp, g_desc, v_desc);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(dp, g_desc + 2 * kk, v_desc + 2 * kk);
    wgmma_commit();
  };
  stage_swizzled<D>(qs, base + rt * stride, stride, seq - rt, kTile, tid, kTileThreads);
  stage_swizzled<D>(gs, grad + ((size_t)b * seq + rt) * width + h * D, width, seq - rt, kTile,
                    tid, kTileThreads);
  stage(0);
  cp_async_commit();
  stage(1);
  cp_async_commit();
  cp_async_wait<1>();  // q, g and step 0's chunk
  fence_proxy_async();
  __syncthreads();
  float sv[2][32], dv[2][32];
  issue(sv[0], dv[0], 0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rho[2] = {0.f, 0.f};
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
#pragma unroll 1
  for (int s2 = 0; s2 < steps; s2 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int step = s2 + u;
      if (step >= steps) break;
      float(&s)[32] = sv[u];
      float(&dp)[32] = dv[u];
      // step + 1's chunk has landed for every thread (staged a step ago),
      // and the stage of step - 1 (its products waited for) takes the chunk
      // of step + 2
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      stage(step + 2);
      cp_async_commit();
      if (step + 1 < steps) {
        issue(sv[u ^ 1], dv[u ^ 1], step + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      fence_regs(dp);
      if (step == nch) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float lsum = group_sum<4>(l[e2]), rsum = group_sum<4>(rho[e2]);
          const bool in = row0 + 8 * e2 < seq;
          rho[e2] = in ? rsum / lsum * scale : 0.f;
          m[e2] = in ? fmaf(m[e2], scale2, log2f(lsum)) : INFINITY;
        }
      }
      const int c0 = chunk0(step);
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
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float cm = -INFINITY;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            cm = fmaxf(cm, fmaxf(s[4 * i + 2 * e2], s[4 * i + 2 * e2 + 1]));
          }
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
      const uint32_t kt = k_tile(step);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + 16 * j < kend) wgmma_rs<D>(dq, a[j], wg_desc<D>(kt + j * 16 * 2 * D));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(sv[u ^ 1]);
      fence_regs(dv[u ^ 1]);
    }
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

