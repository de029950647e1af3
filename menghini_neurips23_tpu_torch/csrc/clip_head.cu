// K3: the fused CLIP head, softmax(scale * normalize(img) . normalize(txt)^T).
//
// Replaces: menghini_neurips23_tpu/ops/clip_head.py `_head_kernel` (reached
// through `_fused_probs_pallas` and `fused_probs`), the Pallas kernel of the
// JAX package.  It turns image and class-prompt features into the zero-shot
// class probabilities that the FPL pseudolabels are picked from.
//
// What it computes, for image rows (B, E) and class rows (C, E) of one float
// type, with fp32 output (B, C):
//   x = img * rsqrt(sum(img^2)),  t = txt * rsqrt(sum(txt^2))   (fp32)
//   logits = (x . t^T) * scale
//   probs = exp(logits - max) / sum(exp(logits - max)) per row
//
// What bounds it on an H100: memory, and at the slice's sizes mostly launch
// latency.  B*E + C*E elements are read and B*C floats written, against
// 2*B*C*E operations: at B = 256, E = 512, C = 102 that is ~13 operations
// per byte, far below the ~295 where the tensor cores would be the limit.
//
// Design (a plain first version):
// - one block of 8 warps per tile of 8 image rows; warp w normalises image
//   row w into shared memory (fp32), multiplying by the rsqrt as the Pallas
//   kernel does;
// - the warps then share out the classes: a warp loads one class row into
//   registers (E <= 1024, 32 floats a lane), normalises it, and dots it with
//   each of the 8 staged image rows, leaving scale * dot in a (8, C) shared
//   logits tile;
// - warp w finishes row w with a row softmax in fp32 and writes it.
// C and E are runtime sizes; the last tile's missing rows are masked on load
// and store.  There is no class padding, so no -inf columns are needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps;  // image rows per block, one warp each
constexpr int kMaxE = 1024;
constexpr int kPerLane = kMaxE / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory: the normalised image tile (kRows x E) and its logits (kRows x C)
__host__ __device__ constexpr size_t smem_floats(int C, int E) {
  return (size_t)kRows * E + (size_t)kRows * C;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_head_kernel(const T* __restrict__ img, const T* __restrict__ txt,
                 float* __restrict__ out, int B, int C, int E, float scale) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* logits = xs + (size_t)kRows * E;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + warp;

  {  // normalise this warp's image row
    float* x = xs + (size_t)warp * E;
    if (row < B) {
      const T* src = img + (size_t)row * E;
      float ss = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float v = to_float(src[e]);
        x[e] = v;
        ss = fmaf(v, v, ss);
      }
      const float r = rsqrtf(warp_sum(ss));
      for (int e = lane; e < E; e += 32) x[e] *= r;
    } else {
      for (int e = lane; e < E; e += 32) x[e] = 0.f;
    }
  }
  __syncthreads();

  for (int c = warp; c < C; c += kWarps) {
    const T* src = txt + (size_t)c * E;
    float t[kPerLane];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = lane + 32 * k;
      const float v = e < E ? to_float(src[e]) : 0.f;
      t[k] = v;
      ss = fmaf(v, v, ss);
    }
    const float r = rsqrtf(warp_sum(ss));
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) t[k] *= r;
    for (int i = 0; i < kRows; ++i) {
      const float* x = xs + (size_t)i * E;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int e = lane + 32 * k;
        if (e < E) acc = fmaf(x[e], t[k], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) logits[(size_t)i * C + c] = acc * scale;
    }
  }
  __syncthreads();

  if (row < B) {  // row softmax
    float* lg = logits + (size_t)warp * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, lg[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float e = expf(lg[c] - m);
      lg[c] = e;
      l += e;
    }
    l = warp_sum(l);
    float* dst = out + (size_t)row * C;
    for (int c = lane; c < C; c += 32) dst[c] = lg[c] / l;
  }
}

template <typename T>
cudaError_t launch(const void* img, const void* txt, void* out, int B, int C, int E,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(C, E) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(clip_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + kRows - 1) / kRows;
  clip_head_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(txt), static_cast<float*>(out), B,
      C, E, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t mnt_clip_head_smem(int C, int E) { return smem_floats(C, E) * sizeof(float); }

// img: (B, E), txt: (C, E), both contiguous and of one type (0 = float32,
// 1 = bfloat16); out: (B, C) float32.  E <= 1024.  Returns a cudaError_t.
int mnt_clip_head(const void* img, const void* txt, void* out, int B, int C, int E,
                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > kMaxE) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(img, txt, out, B, C, E, scale, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(img, txt, out, B, C, E, scale, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
