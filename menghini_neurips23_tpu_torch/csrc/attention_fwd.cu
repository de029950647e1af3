// K1: multi-head self-attention forward over CLIP's fused qkv projection.
//
// Replaces: menghini_neurips23_tpu/ops/attention.py `_fwd_kernel` (reached
// through `_fwd` and `fused_attention`), the Pallas kernel of the JAX package.
//
// What it computes, per batch row b and head h (D = W / heads):
//   q, k, v = qkv[b, :, h*D:(h+1)*D], qkv[b, :, W+h*D:...], qkv[b, :, 2W+h*D:...]
//   s = (q . k^T) accumulated in fp32, times D^-0.5, plus -inf above the
//       diagonal when causal
//   p = softmax(s) in fp32, rounded to the input type
//   out[b, :, h*D:(h+1)*D] = (p . v) accumulated in fp32, rounded to the input type
// The (B, H, T, T) scores never reach device memory.
//
// What bounds it on an H100: memory.  CLIP's sequences are short (T = 50
// vision tokens, <= 77 text tokens) and D = 64, so the work is
// 4*B*H*T^2*D operations against (B*T*3W + B*T*W) elements read and written:
// about 25 operations per byte at the ViT-B/32 vision shape, far below the
// ~295 per byte where the tensor cores would become the limit.
//
// Design (a plain first version; wgmma/TMA tiling is later work):
// - one block per (batch row, head); the block stages that head's K and V
//   (T x D each) in shared memory as fp32, reading the fused layout in place:
//   no head-split copies, no transposes;
// - K rows are padded to D+1 floats, so the 32 lanes of a warp, which read
//   32 different keys at the same column, hit 32 different banks;
// - one warp per query row: each lane scores keys j = lane, lane+32, ...,
//   the warp reduces the row max and sum with shuffles, normalises, rounds
//   p to the input type, then each lane accumulates output columns
//   d = lane, lane+32 over all keys;
// - the causal mask is a flag: row i simply stops at key i.
// Numerics follow the Pallas kernel: scale applied after the dot, fp32
// softmax (exp(s - max) / sum), P rounded to the input type before P.V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory: K (T x (D+1)), V (T x D), one q row and one score row per warp
__host__ __device__ constexpr size_t smem_floats(int T, int D) {
  return (size_t)T * (D + 1) + (size_t)T * D + (size_t)kWarps * D + (size_t)kWarps * T;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int seq,
                     int width, int heads, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int ldk = D + 1;
  float* ks = smem;
  float* vs = ks + (size_t)seq * ldk;
  float* qs = vs + (size_t)seq * D;
  float* ps = qs + kWarps * D;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const size_t row_stride = 3 * (size_t)width;
  const T* base = qkv + (size_t)b * seq * row_stride;

  for (int idx = threadIdx.x; idx < seq * D; idx += kThreads) {
    const int t = idx / D, d = idx % D;
    const T* row = base + t * row_stride;
    ks[t * ldk + d] = to_float(row[width + h * D + d]);
    vs[t * D + d] = to_float(row[2 * width + h * D + d]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q = qs + warp * D;
  float* p = ps + warp * seq;
  T* out_b = out + (size_t)b * seq * width + h * D;

  for (int i = warp; i < seq; i += kWarps) {
    const T* row = base + i * row_stride;
    for (int d = lane; d < D; d += 32) q[d] = to_float(row[h * D + d]);
    __syncwarp();
    const int n = causal ? i + 1 : seq;  // keys row i attends to

    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = ks + j * ldk;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], kj[d], s);
      s *= scale;
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < n; j += 32) p[j] = to_float(from_float<T>(p[j] / l));
    __syncwarp();

    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * D + d], acc);
      out_b[(size_t)i * width + d] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, void* out, int B, int seq, int width, int heads,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(seq, D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  attention_fwd_kernel<T, D><<<B * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, width, heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* qkv, void* out, int B, int seq, int width, int heads,
                       float scale, int causal, cudaStream_t stream) {
  switch (width / heads) {
    case 16: return launch<T, 16>(qkv, out, B, seq, width, heads, scale, causal, stream);
    case 32: return launch<T, 32>(qkv, out, B, seq, width, heads, scale, causal, stream);
    case 64: return launch<T, 64>(qkv, out, B, seq, width, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
size_t mnt_attention_fwd_smem(int seq, int head_dim) {
  return smem_floats(seq, head_dim) * sizeof(float);
}

// qkv: (B, seq, 3*width) contiguous; out: (B, seq, width) contiguous, same type.
// scale: D^-0.5 as the caller rounds it to float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int mnt_attention_fwd(const void* qkv, void* out, int B, int seq, int width, int heads,
                      float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch_d<float>(qkv, out, B, seq, width, heads, scale, causal, s);
  } else if (dtype == 1) {
    e = dispatch_d<__nv_bfloat16>(qkv, out, B, seq, width, heads, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
