size_t mnt_attention_fwd_smem(int seq, int head_dim, int dtype) {
  if (seq > kShortMaxSeq) {
    return dtype == 0 ? tf32_smem(head_dim) : wgmma_smem(seq, kWgMaxGroups, head_dim);
  }
  return dtype == 0 ? f32_smem(seq, head_dim) : bf16_smem(seq, head_dim);
}

