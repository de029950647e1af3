// the sms of the current device and the warpgroups a block (wgmma_groups)
cudaError_t wgmma_grid(int seq, int rows_x_heads, int& groups) {
  cudaError_t e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  groups = wgmma_groups(seq, rows_x_heads, sms);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch_wg(Kernel kernel, const void* qkv, void* out, int B, int seq, int width,
                      int heads, float scale, int causal, int D, cudaStream_t stream) {
  cudaError_t e;
  int groups;
  if ((e = wgmma_grid(seq, B * heads, groups)) != cudaSuccess) return e;
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const size_t smem = wgmma_smem(seq, groups, D);
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  // more than one block an SM only with the largest carveout
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess) {
    return e;
  }
  kernel<<<dim3(B * heads, (tiles + groups - 1) / groups), 128 * groups, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), seq, width, heads, scale, causal);
  return cudaGetLastError();
}

// bf16 above kShortMaxSeq: one sweep up to kResidentMaxSeq (NCH = 3, 4 or 5
// chunks of keys), streamed past it
template <int D>
cudaError_t launch_wgmma(const void* qkv, void* out, int B, int seq, int width, int heads,
                         float scale, int causal, cudaStream_t stream) {
#define MNT_ARGS qkv, out, B, seq, width, heads, scale, causal, D, stream
  if (seq > kResidentMaxSeq) return launch_wg(attention_fwd_wgmma<D>, MNT_ARGS);
  switch ((seq + kWgKeys - 1) / kWgKeys) {
    case 3: return launch_wg(attention_fwd_onesweep<D, 3>, MNT_ARGS);
    case 4: return launch_wg(attention_fwd_onesweep<D, 4>, MNT_ARGS);
    default: return launch_wg(attention_fwd_onesweep<D, 5>, MNT_ARGS);
  }
#undef MNT_ARGS
}

