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
// statistics a row); a handful of operations an element.
//
// Design. One warp owns a row. Two paths, one source:
// * The register pass (ln_fwd_rows_kernel), for rows of 16-byte chunks
//   (d a multiple of 8 in bf16 / f16, of 4 in f32, x and y 16-byte
//   aligned) with at most 8 chunks a lane, i.e. d <= 2048 in bf16 / f16 and
//   d <= 1024 in f32 (GPT-2-medium's 1024 in bf16 is 4 chunks a lane).
//   Lane l holds chunks l, l + 32, ... of its row in registers: x is read
//   once, with 16-byte loads, both passes of the statistics run from
//   registers, and y leaves in 16-byte stores. The grid is the SMs times
//   the blocks an SM holds, and each warp walks rows warp, warp + warps,
//   ... with gamma and beta staged once a block in shared memory and, for
//   up to 4 chunks a lane, held in registers across all its rows (beyond,
//   read from shared memory row by row, which keeps the registers for x).
// * The general loop (ln_fwd_kernel, below) for every other width: 16-byte
//   accesses where d is a multiple of the chunk, one element a lane
//   otherwise, so any d is taken (no d % 128 gate).
//
// Arithmetic, the same in both: the sums run in a fixed order (each lane
// over its own chunks in order, then a butterfly over the warp), so equal
// inputs give equal bits. The output is rounded step by step (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), as the plain twin's separate
// operations round, so kernel and twin differ only through the order of
// the two sums. Division and sqrt are IEEE (no --use_fast_math).

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

// The general loop (widths no register variant takes): rows r = warp,
// warp + warps, ...; lane l takes the chunks l, l + 32, ... of a row (d a
// multiple of the chunk length) and walks the row three times (sum,
// squared deviations, output); only the first walk comes from device
// memory, the row is in L1 for the other two. gamma and beta are read as
// scalars.
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

// ------------------------------------------------------ the register pass
// 16 bytes of a row as f32 values.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
    v[i] = to_f32(e[i]);
}

// Rows r = global warp, + warps, ...; lane l holds the 16-byte chunks
// l + 32 j (j < kChunks) that lie in the row (d / V of them).
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads, 2)
ln_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int64_t n, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kResident = kChunks <= 4;  // gamma, beta in registers
  extern __shared__ float4 gb[];            // gamma [d], then beta [d]
  float* sg = reinterpret_cast<float*>(gb);
  float* sb = sg + d;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    sg[i] = gamma[i];
    sb[i] = beta[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int chunks = d / V;
  bool in[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) in[j] = lane + 32 * j < chunks;
  float g[kResident ? kChunks : 1][V], b[kResident ? kChunks : 1][V];
  if (kResident) {
#pragma unroll
    for (int j = 0; j < (kResident ? kChunks : 0); ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = (lane + 32 * j) * V + e;
        g[j][e] = in[j] ? sg[i] : 0.f;
        b[j][e] = in[j] ? sb[i] : 0.f;
      }
  }
  const float fd = static_cast<float>(d);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  for (int64_t r = first; r < n; r += step) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * d);
    uint4 raw[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      if (in[j]) raw[j] = __ldcs(xr + lane + 32 * j);  // read once
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!in[j]) continue;
      float v[V];
      unpack<T>(raw[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e];
    }
    const float mean = __fdiv_rn(warp_sum(s), fd);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!in[j]) continue;
      float v[V];
      unpack<T>(raw[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = __fsub_rn(v[e], mean);
        q = __fadd_rn(q, __fmul_rn(c, c));
      }
    }
    const float var = __fdiv_rn(warp_sum(q), fd);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    uint4* yr = reinterpret_cast<uint4*>(y + r * d);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (!in[j]) continue;
      float v[V];
      unpack<T>(raw[j], v);
      uint4 u;
      T* o = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = (lane + 32 * j) * V + e;
        const float gv = kResident ? g[kResident ? j : 0][e] : sg[i];
        const float bv = kResident ? b[kResident ? j : 0][e] : sb[i];
        const float xc = __fmul_rn(__fsub_rn(v[e], mean), rstd);
        o[e] = from_f32<T>(__fadd_rn(__fmul_rn(xc, gv), bv));
      }
      __stcs(yr + lane + 32 * j, u);  // written once
    }
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

template <typename T, int kChunks>
cudaError_t launch_rows(const T* x, const float* g, const float* b, T* y,
                        float* mu, float* rs, int64_t n, int64_t d, float eps,
                        cudaStream_t st) {
  constexpr int kMaxSmem = 2 * 32 * kChunks * (16 / sizeof(T)) * 4;
  static const int per_sm = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ln_fwd_rows_kernel<T, kChunks>, kThreads, kMaxSmem);
    return blocks > 0 ? blocks : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  const int blocks = static_cast<int>(want < most ? want : most);
  if (blocks <= 0) return cudaErrorInvalidDevice;
  ln_fwd_rows_kernel<T, kChunks><<<blocks, kThreads, 2 * d * 4, st>>>(
      x, g, b, y, mu, rs, n, static_cast<int>(d), eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, void* mean, void* rstd, int64_t n, int64_t d,
                   float eps, cudaStream_t st) {
  constexpr int64_t V = 16 / sizeof(T);
  const bool vec = d % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15u) == 0;
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaGetLastError();  // an earlier call's error is not this launch's
  if (vec) {
    switch ((d / V + 31) / 32) {  // chunks a lane
      case 1: return launch_rows<T, 1>(xt, g, b, yt, mu, rs, n, d, eps, st);
      case 2: return launch_rows<T, 2>(xt, g, b, yt, mu, rs, n, d, eps, st);
      case 3: return launch_rows<T, 3>(xt, g, b, yt, mu, rs, n, d, eps, st);
      case 4: return launch_rows<T, 4>(xt, g, b, yt, mu, rs, n, d, eps, st);
      case 5:
      case 6: return launch_rows<T, 6>(xt, g, b, yt, mu, rs, n, d, eps, st);
      case 7:
      case 8: return launch_rows<T, 8>(xt, g, b, yt, mu, rs, n, d, eps, st);
    }
  }
  const int64_t want = (n + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
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
