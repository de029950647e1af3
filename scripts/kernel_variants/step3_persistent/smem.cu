// a block's shared memory: 1 KB to align the tiles to the 128-byte
// swizzle's 1024-byte period; resident, two buffers of a q tile a
// warpgroup and K and V of every chunk; streamed, a q tile a warpgroup and
// K and V of kWgStages chunks
size_t wgmma_smem(int seq, int groups, int D) {
  if (seq <= kResidentMaxSeq) {
    return 1024 + 2 * (size_t)(groups + 2 * ((seq + kWgKeys - 1) / kWgKeys)) * wg_tile_bytes(D);
  }
  return 1024 + (size_t)(groups + 2 * kWgStages) * wg_tile_bytes(D);
}

