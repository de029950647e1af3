// bf16 from kShortMaxSeq to kResidentMaxSeq (attention_fwd_onesweep):
// warpgroups a block by wgmma_groups' rule for its one block an SM, items
// of that many 64-row tiles, and a persistent grid of as many blocks as
// the card holds at once (each a contiguous run of items)
template <int D, int NCH>
cudaError_t launch_onesweep(const void* qkv, void* out, int B, int seq, int width, int heads,
                            float scale, int causal, cudaStream_t stream) {
  cudaError_t e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  const int groups = wgmma_groups(seq, B * heads, sms);  // one block an SM
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const int items = B * heads * ((tiles + groups - 1) / groups);
  const size_t smem = wgmma_smem(seq, groups, D);
  auto kernel = attention_fwd_onesweep<D, NCH>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * groups, smem)) !=
      cudaSuccess) {
    return e;
  }
  const int grid = std::min(items, sms * std::max(per_sm, 1));
  kernel<<<grid, 128 * groups, smem, stream>>>(static_cast<const bf16*>(qkv),
                                               static_cast<bf16*>(out), seq, width, heads, scale,
                                               causal, items);
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
  const int groups = wgmma_groups(seq, B * heads, kWgBlocks * sms);
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const size_t smem = wgmma_smem(seq, groups, D);
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

