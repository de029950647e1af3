// bf16 above kShortMaxSeq (attention_fwd_wgmma): query rows a warpgroup
// and keys a chunk (a step of either sweep), the most warpgroups a block,
// blocks an SM (the 128 registers a thread that two blocks of two
// warpgroups leave; 97 KB of shared memory each resident at T = 320 and D =
// 64, 49 KB streamed), and the streamed ring's stages of (K, V) chunk
// pairs
constexpr int kWgRows = 64;
constexpr int kWgKeys = 64;
constexpr int kWgMaxGroups = 2;
constexpr int kWgBlocks = 2;
constexpr int kWgStages = 2;

// bytes of a 64-row tile of q, K or V (rows of 2D bytes, swizzled)
__host__ __device__ constexpr int wg_tile_bytes(int D) { return kWgRows * 2 * D; }

