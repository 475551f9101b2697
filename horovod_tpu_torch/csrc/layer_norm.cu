// LayerNorm forward for Hopper (sm_90a): kernel K8.
//
// Replaces _ln_fused_fwd_call of horovod_tpu/ops/pallas_kernels.py (:1489;
// kernel _ln_fwd_kernel :1436). For each row x of [n, d]:
//
//   mean = sum(x) / d                 (f32)
//   var  = sum((x - mean)^2) / d      (f32, the two-pass form)
//   rstd = 1 / sqrt(var + eps)
//   y    = (x - mean) * rstd * gamma + beta, in x's dtype
//
// and mean, rstd as [n] f32 for the backward (which stays plain PyTorch, as
// in the reference). gamma and beta are f32.
//
// Bound: memory. One read of x and one write of y (plus 8 bytes of
// statistics a row); a handful of operations an element. One warp owns a
// row and walks it three times (sum, squared deviations, output): only the
// first walk comes from device memory, the warp's row (2 KB at d = 1024 in
// bf16) is in L1 for the other two. 16-byte accesses when d is a multiple
// of 8 (bf16, f16) or 4 (f32), one element per lane otherwise, so any d is
// taken: there is no d % 128 gate on this side.
//
// Arithmetic: the sums run in a fixed order (each lane over its own chunks,
// then a butterfly over the warp), so equal inputs give equal bits. The
// output is rounded step by step (__fsub_rn, __fmul_rn, __fadd_rn: no FMA
// contraction), as the plain twin's separate operations round, so kernel and
// twin differ only through the order of the two sums. Division and sqrt are
// IEEE (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 32;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// kN elements of T in one 16-byte access (kVec), or one element.
template <typename T, bool kVec>
struct alignas(kVec ? 16 : sizeof(T)) Chunk {
  static constexpr int kN = kVec ? 16 / sizeof(T) : 1;
  T v[kN];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVec>
__device__ __forceinline__ void load(const T* p, int64_t i, float* x) {
  const Chunk<T, kVec> c = *reinterpret_cast<const Chunk<T, kVec>*>(p + i);
#pragma unroll
  for (int e = 0; e < Chunk<T, kVec>::kN; ++e) x[e] = to_f32(c.v[e]);
}

// Rows r = warp, warp + warps, ...; lane l takes the chunks l, l + 32, ...
// of a row (d a multiple of the chunk length).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int64_t n, int64_t d, float eps) {
  constexpr int V = Chunk<T, kVec>::kN;
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       r < n; r += step) {
    const T* xr = x + r * d;
    float s = 0.f;
    for (int64_t i = static_cast<int64_t>(lane) * V; i < d; i += 32 * V) {
      float v[V];
      load<T, kVec>(xr, i, v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e];
    }
    const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(d));
    float q = 0.f;
    for (int64_t i = static_cast<int64_t>(lane) * V; i < d; i += 32 * V) {
      float v[V];
      load<T, kVec>(xr, i, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = __fsub_rn(v[e], mean);
        q = __fadd_rn(q, __fmul_rn(c, c));
      }
    }
    const float var = __fdiv_rn(warp_sum(q), static_cast<float>(d));
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    T* yr = y + r * d;
    for (int64_t i = static_cast<int64_t>(lane) * V; i < d; i += 32 * V) {
      float v[V];
      load<T, kVec>(xr, i, v);
      Chunk<T, kVec> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xc = __fmul_rn(__fsub_rn(v[e], mean), rstd);
        out.v[e] = from_f32<T>(
            __fadd_rn(__fmul_rn(xc, gamma[i + e]), beta[i + e]));
      }
      *reinterpret_cast<Chunk<T, kVec>*>(yr + i) = out;
    }
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, void* mean, void* rstd, int64_t n, int64_t d,
                   float eps, cudaStream_t st) {
  constexpr int64_t V = 16 / sizeof(T);
  const bool vec = d % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15u) == 0;
  const int64_t want = (n + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (vec)
    ln_fwd_kernel<T, true><<<blocks, kThreads, 0, st>>>(xt, g, b, yt, mu, rs, n, d, eps);
  else
    ln_fwd_kernel<T, false><<<blocks, kThreads, 0, st>>>(xt, g, b, yt, mu, rs, n, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// LayerNorm forward over the rows of the contiguous [n, d] x. dtype:
// 0 = float32, 1 = bfloat16, 2 = float16 (x and y); gamma, beta: [d] f32;
// mean, rstd: [n] f32. Returns a cudaError_t.
int hvd_layer_norm_fwd(const void* x, int dtype, const void* gamma,
                       const void* beta, void* y, void* mean, void* rstd,
                       int64_t n, int64_t d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch<float>(x, gamma, beta, y, mean, rstd, n, d, eps, st);
    case kBF16: return launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, d, eps, st);
    case kF16: return launch<__half>(x, gamma, beta, y, mean, rstd, n, d, eps, st);
  }
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
