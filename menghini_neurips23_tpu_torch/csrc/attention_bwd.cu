// K2: multi-head self-attention backward over CLIP's fused qkv projection.
//
// Replaces: menghini_neurips23_tpu/ops/attention.py `_bwd_kernel` (reached
// through `_bwd`, the custom VJP of `fused_attention`), the Pallas kernel of
// the JAX package.
//
// What it computes, per batch row b and head h (D = W / heads), given the
// forward's input qkv and the gradient g of its (B, T, W) output:
//   q, k, v, g_h = the head's column slices of qkv (h*D, W+h*D, 2W+h*D) and g
//   P     = softmax(q . k^T * D^-0.5 [+ causal mask]) in fp32, recomputed
//   dv    = P_lp^T . g_h            (P_lp: P rounded to the input type)
//   datt  = g_h . v^T               (fp32)
//   dS    = P * (datt - rowsum(datt * P)) * D^-0.5, rounded to the input type
//   dq    = dS . k,  dk = dS^T . q
//   dqkv[b, :, h*D...], [W+h*D...], [2W+h*D...] = dq, dk, dv (input type)
// Every product accumulates in fp32.  Nothing of size (B, H, T, T) reaches
// device memory, and no atomics are used: the result is deterministic.
//
// What bounds it on an H100: memory.  It reads qkv (3W) and g (W) and writes
// dqkv (3W) per token, about 7*W elements, against about 10*T*D operations
// per head and token: at the VPT vision shape (T = 66, D = 64) some 24
// operations per byte in bf16, far below the ~295 per byte where the tensor
// cores would become the limit.
//
// Design (a plain first version; wgmma/TMA tiling is later work):
// - one block per (batch row, head); the block stages that head's q, k, v
//   and g (T x D each) in shared memory as fp32, reading the fused layout in
//   place: no head-split copies, no transposes;
// - rows are padded to D+1 floats, so the 32 lanes of a warp, which read 32
//   different rows at one column, hit 32 different banks;
// - pass 1, one warp per query row i: recompute the row's logits and fp32
//   softmax P[i, :], then datt[i, j] = g_i . v_j, the row sum of datt * P by
//   warp shuffles, and dS[i, :]; P and dS (T x T fp32 each) stay in shared
//   memory, masked entries hold 0;
// - pass 2, each thread owns output elements (row, column d, neighbouring
//   threads on neighbouring d) and loops over T: dq = dS . k, dk = dS^T . q,
//   dv = P_lp^T . g; the causal mask is a loop bound.
// Shared memory: 4*T*(D+1) + 2*T*T floats, 128 KB at T = 77, D = 64; the
// wrapper raises above the card's 227 KB per block (ViT-L/14's T = 257).
// Numerics follow the Pallas kernel: scale after the dot, fp32 softmax
// (exp(s - max) / sum), dS from the fp32 P, P and dS*scale rounded to the
// input type where the Pallas kernel rounds them.

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

// x rounded to the input type and back, as the Pallas kernel's astype
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory: q, k, v, g (T x (D+1) each), P and dS (T x T each)
__host__ __device__ constexpr size_t smem_floats(int T, int D) {
  return 4 * (size_t)T * (D + 1) + 2 * (size_t)T * T;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ grad,
                     T* __restrict__ dqkv, int seq, int width, int heads, float scale,
                     int causal) {
  extern __shared__ float smem[];
  constexpr int ld = D + 1;
  const size_t tile = (size_t)seq * ld;
  float* qs = smem;
  float* ks = qs + tile;
  float* vs = ks + tile;
  float* gs = vs + tile;
  float* ps = gs + tile;                  // P, fp32, (seq x seq)
  float* ds = ps + (size_t)seq * seq;     // dS*scale rounded to T, (seq x seq)

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const size_t row_stride = 3 * (size_t)width;
  const T* base = qkv + (size_t)b * seq * row_stride;
  const T* gbase = grad + (size_t)b * seq * width + h * D;

  for (int idx = threadIdx.x; idx < seq * D; idx += kThreads) {
    const int t = idx / D, d = idx % D;
    const T* row = base + t * row_stride;
    qs[t * ld + d] = to_float(row[h * D + d]);
    ks[t * ld + d] = to_float(row[width + h * D + d]);
    vs[t * ld + d] = to_float(row[2 * width + h * D + d]);
    gs[t * ld + d] = to_float(gbase[(size_t)t * width + d]);
  }
  __syncthreads();

  // pass 1: P and dS, one warp per query row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < seq; i += kWarps) {
    const float* qi = qs + i * ld;
    const float* gi = gs + i * ld;
    float* p = ps + (size_t)i * seq;
    float* dsi = ds + (size_t)i * seq;
    const int n = causal ? i + 1 : seq;  // keys row i attends to

    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = ks + j * ld;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
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
    float r = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pj = p[j] / l;
      p[j] = pj;
      const float* vj = vs + j * ld;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(gi[d], vj[d], a);
      dsi[j] = a;  // datt, replaced by dS below
      r = fmaf(a, pj, r);
    }
    r = warp_sum(r);
    for (int j = lane; j < n; j += 32) {
      dsi[j] = round_to<T>(p[j] * (dsi[j] - r) * scale);
    }
    for (int j = n + lane; j < seq; j += 32) {
      p[j] = 0.f;
      dsi[j] = 0.f;
    }
  }
  __syncthreads();

  // pass 2: each thread owns (row, d) elements of dq, dk and dv
  T* out = dqkv + (size_t)b * seq * row_stride + h * D;
  for (int idx = threadIdx.x; idx < seq * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    // dq[i, d] = sum_j dS[i, j] k[j, d]
    const float* dsi = ds + (size_t)i * seq;
    const int n = causal ? i + 1 : seq;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(dsi[j], ks[j * ld + d], acc);
    out[(size_t)i * row_stride + d] = from_float<T>(acc);
  }
  for (int idx = threadIdx.x; idx < seq * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    // dk[j, d] = sum_i dS[i, j] q[i, d];  dv[j, d] = sum_i P_lp[i, j] g[i, d]
    const int start = causal ? j : 0;  // rows that attend to key j
    float acc_k = 0.f, acc_v = 0.f;
    for (int i = start; i < seq; ++i) {
      acc_k = fmaf(ds[(size_t)i * seq + j], qs[i * ld + d], acc_k);
      acc_v = fmaf(round_to<T>(ps[(size_t)i * seq + j]), gs[i * ld + d], acc_v);
    }
    out[(size_t)j * row_stride + width + d] = from_float<T>(acc_k);
    out[(size_t)j * row_stride + 2 * width + d] = from_float<T>(acc_v);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* grad, void* dqkv, int B, int seq, int width,
                   int heads, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(seq, D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  attention_bwd_kernel<T, D><<<B * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(grad), static_cast<T*>(dqkv), seq,
      width, heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* qkv, const void* grad, void* dqkv, int B, int seq,
                       int width, int heads, float scale, int causal, cudaStream_t stream) {
  switch (width / heads) {
    case 16: return launch<T, 16>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, stream);
    case 32: return launch<T, 32>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, stream);
    case 64: return launch<T, 64>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; the wrapper checks it
// against the card's limit before launching.
size_t mnt_attention_bwd_smem(int seq, int head_dim) {
  return smem_floats(seq, head_dim) * sizeof(float);
}

// qkv: (B, seq, 3*width) contiguous; grad: (B, seq, width) contiguous;
// dqkv: (B, seq, 3*width) contiguous; all of one type.
// scale: D^-0.5 as the caller rounds it to float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
int mnt_attention_bwd(const void* qkv, const void* grad, void* dqkv, int B, int seq,
                      int width, int heads, float scale, int causal, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch_d<float>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, s);
  } else if (dtype == 1) {
    e = dispatch_d<__nv_bfloat16>(qkv, grad, dqkv, B, seq, width, heads, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* mnt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
