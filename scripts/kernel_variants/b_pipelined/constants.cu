// bf16 above kShortMaxSeq: query rows a warpgroup and keys a chunk (a step
// of either sweep), the most warpgroups a block (attention_fwd_wgmma),
// blocks an SM (attention_fwd_onesweep: 255 registers, 97 KB at T =
// 257-320 and D = 64; attention_fwd_wgmma takes one block of two
// warpgroups), and the streamed ring's stages of (K, V) chunk pairs and how
// many steps ahead a chunk is staged (a stage is reused kWgAhead + 4 steps
// on: the two steps' P.V and the next step's S that may be in flight)
constexpr int kWgRows = 64;
constexpr int kWgKeys = 64;
constexpr int kWgMaxGroups = 2;
constexpr int kWgBlocks = 2;
constexpr int kWgAhead = 2;
constexpr int kWgStages = kWgAhead + 4;

// bytes of a 64-row tile of q, K or V (rows of 2D bytes, swizzled)
__host__ __device__ constexpr int wg_tile_bytes(int D) { return kWgRows * 2 * D; }

