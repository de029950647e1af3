// a block's shared memory: 1 KB to align the tiles to the 128-byte
// swizzle's 1024-byte period, a q tile a warpgroup, and K and V of every
// chunk (resident) or of kWgStages chunks (streamed)
size_t wgmma_smem(int seq, int groups, int D) {
  const int chunks = seq <= kResidentMaxSeq ? (seq + kWgKeys - 1) / kWgKeys : kWgStages;
  return 1024 + (size_t)(groups + 2 * chunks) * wg_tile_bytes(D);
}

