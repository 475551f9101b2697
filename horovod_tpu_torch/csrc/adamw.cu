// Fused AdamW update for Hopper (sm_90a): kernel K9.
//
// Replaces _apply_leaf_fused of horovod_tpu/optim/fused.py (:86; kernel
// _adamw_kernel :56). For every element of every leaf, in f32:
//
//   mu'  = b1 mu + (1 - b1) g
//   nu'  = b2 nu + (1 - b2) g g
//   upd  = (mu' ibc1) / (sqrt(nu' ibc2) + eps) + wd p
//   p'   = p - lr upd
//
// with the step's scalars lr, ibc1 = 1/(1 - b1^t), ibc2 = 1/(1 - b2^t);
// p' is stored in the parameter's dtype, mu' in mu's dtype and nu' in f32.
// The update is in place: p, mu and nu are overwritten.
//
// One launch covers many leaves (multi-tensor): a table in device memory
// holds a row per leaf, [g, p, mu, nu, n, first block]; a block finds its
// leaf by a binary search over the first-block column and updates 2048
// consecutive elements of it. Any leaf length is taken (no padding, no
// lane alignment).
//
// Bound: memory. 4 + 4 + 2 + 4 bytes read and 4 + 2 + 4 written for each
// element of an f32 parameter with a bf16 mu: 24 bytes against about 12
// operations. Every access is coalesced (a warp reads 32 consecutive
// elements of each stream).
//
// Arithmetic: every operation rounds on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: no FMA contraction), in the order written above,
// as the plain twin's separate PyTorch operations round: kernel and twin
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 8;
constexpr int64_t kPerBlock = static_cast<int64_t>(kThreads) * kIters;
constexpr int kCols = 6;  // columns of a table row

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Scalars {
  float lr, ibc1, ibc2, b1, omb1, b2, omb2, eps, wd;
};

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const int64_t* __restrict__ table, int leaves, Scalars sc) {
  __shared__ int leaf;
  if (threadIdx.x == 0) {  // the last leaf whose first block is <= ours
    int lo = 0, hi = leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * kCols + 5] <= static_cast<int64_t>(blockIdx.x))
        lo = mid;
      else
        hi = mid - 1;
    }
    leaf = lo;
  }
  __syncthreads();
  const int64_t* row = table + static_cast<int64_t>(leaf) * kCols;
  const P* g = reinterpret_cast<const P*>(row[0]);
  P* p = reinterpret_cast<P*>(row[1]);
  M* mu = reinterpret_cast<M*>(row[2]);
  float* nu = reinterpret_cast<float*>(row[3]);
  const int64_t n = row[4];
  const int64_t start = (static_cast<int64_t>(blockIdx.x) - row[5]) * kPerBlock;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int64_t i = start + k * kThreads + threadIdx.x;
    if (i >= n) break;
    const float gf = to_f32(g[i]);
    const float pf = to_f32(p[i]);
    const float m = __fadd_rn(__fmul_rn(sc.b1, to_f32(mu[i])),
                              __fmul_rn(sc.omb1, gf));
    const float v = __fadd_rn(__fmul_rn(sc.b2, nu[i]),
                              __fmul_rn(__fmul_rn(sc.omb2, gf), gf));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, sc.ibc2)), sc.eps);
    const float upd = __fadd_rn(__fdiv_rn(__fmul_rn(m, sc.ibc1), den),
                                __fmul_rn(sc.wd, pf));
    p[i] = from_f32<P>(__fsub_rn(pf, __fmul_rn(sc.lr, upd)));
    mu[i] = from_f32<M>(m);
    nu[i] = v;
  }
}

template <typename P>
cudaError_t launch_p(int mu_dtype, const int64_t* table, int leaves,
                     int64_t blocks, Scalars sc, cudaStream_t st) {
  if (mu_dtype == kF32)
    adamw_kernel<P, float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(table, leaves, sc);
  else if (mu_dtype == kBF16)
    adamw_kernel<P, __nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(table, leaves, sc);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements a block updates (the first-block column counts in these).
int64_t hvd_adamw_block_elems() { return kPerBlock; }

// One AdamW step over `leaves` leaves. table: device int64 [leaves, 6], a
// row [g, p, mu, nu, n, first block] per leaf (pointers as integers, n > 0,
// first blocks ascending from 0); blocks: the total. p_dtype (p and g) and
// mu_dtype: 0 = float32, 1 = bfloat16; nu is float32. Returns a cudaError_t.
int hvd_adamw(const void* table, int leaves, int64_t blocks, int p_dtype,
              int mu_dtype, float lr, float ibc1, float ibc2, float b1,
              float omb1, float b2, float omb2, float eps, float wd,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (leaves <= 0 || blocks <= 0 || blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const Scalars sc{lr, ibc1, ibc2, b1, omb1, b2, omb2, eps, wd};
  const int64_t* t = static_cast<const int64_t*>(table);
  switch (p_dtype) {
    case kF32: return launch_p<float>(mu_dtype, t, leaves, blocks, sc, st);
    case kBF16: return launch_p<__nv_bfloat16>(mu_dtype, t, leaves, blocks, sc, st);
  }
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
