// Adasum pairwise combine for Hopper (sm_90a).
//
// Replaces adasum_combine_pairs of horovod_tpu/ops/pallas_kernels.py
// (_adasum_reduce_kernel + _adasum_apply_kernel). For each pair i < m of rows
// a[i], b[i] of length n:
//
//   dot = sum a*b,  na = sum a*a,  nb = sum b*b          (all in f32)
//   ac  = na == 0 ? 1 : 1 - dot / (2 na)                 (zero-norm guard)
//   bc  = nb == 0 ? 1 : 1 - dot / (2 nb)
//   out = ac*a + bc*b                                    (in the input dtype)
//
// Rows are addressed through two base pointers with a row stride each, so an
// interleaved [2m, n] tree level (rows 2i, 2i+1) is combined in place of a
// copy: a = buf, b = buf + n, lda = ldb = 2n. Output rows are contiguous.
//
// Bound: memory. Each element is read twice (reduce, then apply) and written
// once, with 6 flops per element in the reduce and 3 in the apply, far below
// the card's ridge point. The design aims at full-width accesses: 16-byte
// loads and stores per lane when the row bases and strides allow, and the
// same element-to-thread assignment with scalar accesses otherwise.
//
// Determinism: no float atomics. Launch 1 gives every pair `parts` blocks;
// each block reduces a fixed set of elements in a fixed order and writes its
// three partial sums to a scratch buffer. Launch 2 sums a pair's partials in
// a fixed order in its prologue (every block of the pair computes the same
// coefficients) and applies them. `parts` depends only on n and the dtype,
// and the summation order does not depend on whether the vector or scalar
// path loads the elements, so equal inputs give equal bits on every launch
// and on every rank.
//
// Arithmetic: bf16 and f16 are widened to f32 for all of it. The division is
// IEEE (build without --use_fast_math); NaN propagates through the sums and
// the coefficients as in jnp. The apply uses __fmul_rn / __fadd_rn, so it
// rounds exactly as the plain twin's separate multiply and add: the kernel
// and the twin differ only through the order of the reductions.
//
// Every launcher takes device pointers, sizes and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunksPerThread = 4;  // target work per thread per pass
constexpr int kMaxParts = 1024;      // blocks per pair, at most

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

// kN elements of T in one 16-byte access.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// x[0..V) = p[i..i+V), zeros past n. kVec: one 16-byte load for a whole
// chunk (row base 16-byte aligned, i a multiple of V).
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, int64_t i,
                                           int64_t n, float* x) {
  constexpr int V = Vec<T>::kN;
  if (kVec && i + V <= n) {
    const Vec<T> v = *reinterpret_cast<const Vec<T>*>(p + i);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f32(v.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = i + k < n ? to_f32(p[i + k]) : 0.f;
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, int64_t i,
                                            int64_t n, const float* y) {
  constexpr int V = Vec<T>::kN;
  if (kVec && i + V <= n) {
    Vec<T> v;
#pragma unroll
    for (int k = 0; k < V; ++k) v.v[k] = from_f32<T>(y[k]);
    *reinterpret_cast<Vec<T>*>(p + i) = v;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i + k < n) p[i + k] = from_f32<T>(y[k]);
  }
}

// Butterfly sum over the warp: fixed order, every lane gets the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: block (j, i) reduces chunks j, j + parts, ... of pair i, V elements
// per chunk per thread, and writes [dot, na, nb] to partials[i][j].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
adasum_reduce_kernel(const T* __restrict__ a, int64_t lda,
                     const T* __restrict__ b, int64_t ldb, int64_t n,
                     float* __restrict__ partials) {
  constexpr int V = Vec<T>::kN;
  const int64_t pair = blockIdx.y;
  const T* ar = a + pair * lda;
  const T* br = b + pair * ldb;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * V;
  float dot = 0.f, na = 0.f, nb = 0.f;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
       i < n; i += step) {
    float x[V], y[V];
    load_chunk<T, kVec>(ar, i, n, x);
    load_chunk<T, kVec>(br, i, n, y);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      dot = fmaf(x[k], y[k], dot);
      na = fmaf(x[k], x[k], na);
      nb = fmaf(y[k], y[k], nb);
    }
  }
  __shared__ float warp_part[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  dot = warp_sum(dot);
  na = warp_sum(na);
  nb = warp_sum(nb);
  if (lane == 0) {
    warp_part[0][warp] = dot;
    warp_part[1][warp] = na;
    warp_part[2][warp] = nb;
  }
  __syncthreads();
  if (warp == 0) {
    float s[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s[c] = warp_sum(lane < kWarps ? warp_part[c][lane] : 0.f);
    if (lane == 0) {
      float* out = partials + (pair * gridDim.x + blockIdx.x) * 3;
      out[0] = s[0];
      out[1] = s[1];
      out[2] = s[2];
    }
  }
}

// Pass 2: warp 0 sums pair i's partials (lane-strided, then the butterfly)
// into the two coefficients; then every thread applies them to its chunks,
// the same assignment as pass 1.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
adasum_apply_kernel(const T* __restrict__ a, int64_t lda,
                    const T* __restrict__ b, int64_t ldb, T* __restrict__ out,
                    int64_t n, const float* __restrict__ partials) {
  constexpr int V = Vec<T>::kN;
  const int64_t pair = blockIdx.y;
  const int parts = gridDim.x;
  __shared__ float coef[2];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* p = partials + pair * parts * 3;
    float dot = 0.f, na = 0.f, nb = 0.f;
    for (int j = lane; j < parts; j += 32) {
      dot += p[3 * j];
      na += p[3 * j + 1];
      nb += p[3 * j + 2];
    }
    dot = warp_sum(dot);
    na = warp_sum(na);
    nb = warp_sum(nb);
    if (lane == 0) {
      coef[0] = na == 0.f ? 1.f : 1.f - dot / (2.f * na);
      coef[1] = nb == 0.f ? 1.f : 1.f - dot / (2.f * nb);
    }
  }
  __syncthreads();
  const float ac = coef[0], bc = coef[1];
  const T* ar = a + pair * lda;
  const T* br = b + pair * ldb;
  T* orow = out + pair * n;
  const int64_t step = static_cast<int64_t>(parts) * kThreads * V;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
       i < n; i += step) {
    float x[V], y[V];
    load_chunk<T, kVec>(ar, i, n, x);
    load_chunk<T, kVec>(br, i, n, y);
#pragma unroll
    for (int k = 0; k < V; ++k)
      x[k] = __fadd_rn(__fmul_rn(ac, x[k]), __fmul_rn(bc, y[k]));
    store_chunk<T, kVec>(orow, i, n, x);
  }
}

// Blocks per pair: enough for kChunksPerThread 16-byte chunks per thread, at
// most kMaxParts. A function of n and the element size only (see
// Determinism).
inline int parts_for(int64_t n, int64_t elem_bytes) {
  const int64_t per_block = kThreads * (16 / elem_bytes) * kChunksPerThread;
  const int64_t p = (n + per_block - 1) / per_block;
  return static_cast<int>(p < 1 ? 1 : (p > kMaxParts ? kMaxParts : p));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t launch(const void* a, int64_t lda, const void* b, int64_t ldb,
                   void* out, int64_t m, int64_t n, void* scratch,
                   cudaStream_t st) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  float* part = static_cast<float*>(scratch);
  // every row base on a 16-byte boundary: the first ones, and the strides
  // (lda, ldb, and n for the output) in whole 16 bytes when m > 1
  constexpr int64_t V = Vec<T>::kN;
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out) &&
                   (m == 1 || (lda % V == 0 && ldb % V == 0 && n % V == 0));
  const dim3 grid(parts_for(n, sizeof(T)), static_cast<unsigned>(m));
  if (vec) {
    adasum_reduce_kernel<T, true><<<grid, kThreads, 0, st>>>(at, lda, bt, ldb, n, part);
    adasum_apply_kernel<T, true><<<grid, kThreads, 0, st>>>(at, lda, bt, ldb, ot, n, part);
  } else {
    adasum_reduce_kernel<T, false><<<grid, kThreads, 0, st>>>(at, lda, bt, ldb, n, part);
    adasum_apply_kernel<T, false><<<grid, kThreads, 0, st>>>(at, lda, bt, ldb, ot, n, part);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of scratch hvd_adasum_combine needs for m pairs of length n.
int64_t hvd_adasum_scratch_floats(int64_t m, int64_t n, int dtype) {
  return m * parts_for(n, dtype == kF32 ? 4 : 2) * 3;
}

// Pairs (a + i*lda, b + i*ldb), i < m, rows of n elements, into the
// contiguous [m, n] out. Strides in elements. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. scratch: hvd_adasum_scratch_floats f32 values.
// Returns a cudaError_t.
int hvd_adasum_combine(const void* a, int64_t lda, const void* b, int64_t ldb,
                       int dtype, void* out, int64_t m, int64_t n,
                       void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || m > 65535) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return launch<float>(a, lda, b, ldb, out, m, n, scratch, st);
    case kBF16: return launch<__nv_bfloat16>(a, lda, b, ldb, out, m, n, scratch, st);
    case kF16: return launch<__half>(a, lda, b, ldb, out, m, n, scratch, st);
  }
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
