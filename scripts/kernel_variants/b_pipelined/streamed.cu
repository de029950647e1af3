// bf16, T > kResidentMaxSeq.  Block (batch row x head, group of 64-row query
// tiles), a warpgroup per tile (blockDim / 128 of them), every product on
// warpgroup MMA.  Shared memory, from a 1024-byte boundary: a q tile a
// warpgroup, then kWgStages (K, V) chunk pairs, all in the swizzled layout.
// The two sweeps are one stream of 2 * nch steps over the block's chunks
// (causal: up to its last row's diagonal): steps 0 .. nch - 1 take each
// row's online max m and sum l of P = 2^((s - m) scale2) (scale2 = D^-0.5 *
// log2(e)); steps nch .. 2 nch - 1 recompute the scores and add the
// normalised P / l, rounded to bf16 in the A fragments of P.V, times V.
// Each step issues the next step's S = q . K^T into the other of two
// accumulators before it waits for its own, and in sweep 2 leaves its P.V in
// flight under the next step's softmax: a step commits two wgmma groups
// (the next S, then this P.V; either may be empty), and waiting for all but
// the two newest retires this step's S and the P.V of the step before.  The
// block meets once a step, when the next step's chunk has landed, and then
// stages the chunk kWgAhead steps on into the stage of the step kWgStages -
// kWgAhead back, whose P.V every thread has retired.  A warpgroup skips the
// chunks its rows see none of (causal) and the rest of the block's steps
// when its tile lies past T, but keeps to the barriers and the groups.
template <int D>
__global__ void __launch_bounds__(128 * kWgMaxGroups, 1)
attention_fwd_wgmma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int seq, int width,
                    int heads, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = wg_tile_bytes(D), NO = D / 2;
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
  // the steps the warpgroup computes: its rows see the step's chunk
  auto seen = [&](int step) { return step < steps && active && chunk0(step) < kend; };
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
  for (int i = 0; i < kWgAhead; ++i) {
    stage(i);
    cp_async_commit();
  }
  // the block's barrier before a step's products: the step's chunk has
  // landed for every thread, and every thread has retired the P.V that read
  // the stage the chunk kWgAhead steps on goes to, staged behind it
  auto landed = [&](int step) {
    cp_async_wait<kWgAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    stage(step + kWgAhead);
    cp_async_commit();
  };
  // S = q . K^T for the chunk of `step`, both operands from shared memory,
  // issued (not waited for); the scores stay unscaled: scale2 is folded
  // into each exponential's FFMA
  const uint64_t q_desc = wg_desc<D>(qs + wg * TILE);
  auto issue_scores = [&](float(&s)[32], int step) {
    const uint64_t k_desc = wg_desc<D>(k_tile(step));
    wgmma_fence();
    wgmma_ss<0>(s, q_desc, k_desc);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<1>(s, q_desc + 2 * kk, k_desc + 2 * kk);
  };
  // -inf where a key lies past T or the row's diagonal
  auto mask = [&](float(&s)[32], int step) {
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
  // add 2^-inf = 0 and are left out.  Sweep 2: P = 2^((s - m) scale2) / l in
  // fp32, rounded to bf16 into the A fragments of P.V (k-step j: keys c0 +
  // 16j ..), then O += P . V over the 16-key steps the tile's rows see.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float ms[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float s[2][32];
  uint32_t a[2][4][4];
  // a step on accumulator and fragments P (the step's parity)
  auto step_on = [&](auto parity, int step) {
    constexpr int P = decltype(parity)::value;
    landed(step + 1);
    if (seen(step + 1)) issue_scores(s[P ^ 1], step + 1);
    wgmma_commit();
    wgmma_wait<2>();  // this step's S, and the P.V of the step before
    if (step == nch) {  // sweep 2 begins: the rows' statistics are whole
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ms[r] = m[r] * scale2;
        if (live) inv_l[r] = 1.f / group_sum<4>(l[r]);
      }
    }
    if (seen(step)) {
      fence_regs(s[P]);
      mask(s[P], step);
      const int c0 = chunk0(step);
      if (step < nch) {
        if (live) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float cm = -INFINITY;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              cm = fmaxf(cm, fmaxf(s[P][4 * i + 2 * r], s[P][4 * i + 2 * r + 1]));
            }
            const float mn = fmaxf(m[r], group_max<4>(cm)), mns = mn * scale2;
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (c0 + 8 * i < kend) {
                sum += ex2(fmaf(s[P][4 * i + 2 * r], scale2, -mns)) +
                       ex2(fmaf(s[P][4 * i + 2 * r + 1], scale2, -mns));
              }
            }
            l[r] = fmaf(l[r], ex2(fmaf(m[r], scale2, -mns)), sum);
            m[r] = mn;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t& lo = a[P][i / 2][2 * (i % 2)];
          uint32_t& hi = a[P][i / 2][2 * (i % 2) + 1];
          if (live && c0 + 8 * i < kend) {
            lo = pack_bf16(ex2(fmaf(s[P][4 * i], scale2, -ms[0])) * inv_l[0],
                           ex2(fmaf(s[P][4 * i + 1], scale2, -ms[0])) * inv_l[0]);
            hi = pack_bf16(ex2(fmaf(s[P][4 * i + 2], scale2, -ms[1])) * inv_l[1],
                           ex2(fmaf(s[P][4 * i + 3], scale2, -ms[1])) * inv_l[1]);
          } else {
            lo = hi = 0u;
          }
        }
        const uint32_t vt = v_tile(step);
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_regs(a[P][j]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c0 + 16 * j < kend) wgmma_rs<D>(o, a[P][j], wg_desc<D>(vt + j * 16 * 2 * D));
        }
      }
    }
    wgmma_commit();
  };
  // step 0's chunk, its S, and an empty P.V group before it
  landed(0);
  if (seen(0)) issue_scores(s[0], 0);
  wgmma_commit();
  wgmma_commit();
  for (int step = 0; step < steps; step += 2) {  // steps is even
    step_on(std::integral_constant<int, 0>(), step);
    step_on(std::integral_constant<int, 1>(), step + 1);
  }
  wgmma_wait_all();
  fence_regs(o);
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

