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
// One launch covers many leaves (multi-tensor): the launch's table, a
// column of g, p, mu, nu, element count and first block per leaf, rides in
// the kernel's parameters (__grid_constant__, the 32 KB parameter space of
// CUDA >= 12.1: up to kMaxLeaves leaves; nothing is copied to the device,
// so a CUDA graph captures the table with the launch). A block finds its
// leaf by a binary search over the first-block column and updates 2048
// consecutive elements of it. Any leaf length is taken (no padding, no lane
// alignment).
//
// The step's scalars lr, ibc1 and ibc2 come by value, or from a device f32
// [3] buffer read when the kernel runs: a replayed graph then takes the
// values its caller wrote there for that step (a schedule, the bias
// correction of the step count) instead of those frozen at capture.
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
constexpr int kMaxLeaves = 512;  // leaves in one launch's table

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
  const float* dev;  // [lr, ibc1, ibc2] on the device, or null
};

struct Table {
  const void* g[kMaxLeaves];
  void* p[kMaxLeaves];
  void* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t first[kMaxLeaves];  // first block of each leaf, ascending from 0
  int leaves;
};

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table t, const Scalars sc) {
  __shared__ int leaf;
  __shared__ float step[3];
  if (threadIdx.x == 0) {  // the last leaf whose first block is <= ours
    int lo = 0, hi = t.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (t.first[mid] <= static_cast<int64_t>(blockIdx.x))
        lo = mid;
      else
        hi = mid - 1;
    }
    leaf = lo;
    step[0] = sc.dev ? sc.dev[0] : sc.lr;
    step[1] = sc.dev ? sc.dev[1] : sc.ibc1;
    step[2] = sc.dev ? sc.dev[2] : sc.ibc2;
  }
  __syncthreads();
  const float lr = step[0], ibc1 = step[1], ibc2 = step[2];
  const P* g = static_cast<const P*>(t.g[leaf]);
  P* p = static_cast<P*>(t.p[leaf]);
  M* mu = static_cast<M*>(t.mu[leaf]);
  float* nu = t.nu[leaf];
  const int64_t n = t.n[leaf];
  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) - t.first[leaf]) * kPerBlock;
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
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, ibc2)), sc.eps);
    const float upd = __fadd_rn(__fdiv_rn(__fmul_rn(m, ibc1), den),
                                __fmul_rn(sc.wd, pf));
    p[i] = from_f32<P>(__fsub_rn(pf, __fmul_rn(lr, upd)));
    mu[i] = from_f32<M>(m);
    nu[i] = v;
  }
}

// The table of `leaves` host rows (g, p, mu, nu, n), n > 0; the total of
// blocks in *blocks.
bool fill(Table& t, const int64_t* rows, int leaves, int64_t* blocks) {
  int64_t first = 0;
  for (int i = 0; i < leaves; ++i) {
    const int64_t* r = rows + 5 * i;
    if (r[4] <= 0) return false;
    t.g[i] = reinterpret_cast<const void*>(r[0]);
    t.p[i] = reinterpret_cast<void*>(r[1]);
    t.mu[i] = reinterpret_cast<void*>(r[2]);
    t.nu[i] = reinterpret_cast<float*>(r[3]);
    t.n[i] = r[4];
    t.first[i] = first;
    first += (r[4] + kPerBlock - 1) / kPerBlock;
  }
  t.leaves = leaves;
  *blocks = first;
  return first > 0 && first <= 0x7fffffff;
}

cudaError_t launch(const int64_t* rows, int leaves, int p_dtype,
                   int mu_dtype, const Scalars& sc, cudaStream_t st) {
  Table t;
  int64_t blocks = 0;
  if (!fill(t, rows, leaves, &blocks)) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p_dtype == kF32 && mu_dtype == kF32)
    adamw_kernel<float, float><<<grid, kThreads, 0, st>>>(t, sc);
  else if (p_dtype == kF32 && mu_dtype == kBF16)
    adamw_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, st>>>(t, sc);
  else if (p_dtype == kBF16 && mu_dtype == kF32)
    adamw_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, st>>>(t, sc);
  else if (p_dtype == kBF16 && mu_dtype == kBF16)
    adamw_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<grid, kThreads, 0, st>>>(t, sc);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

static_assert(sizeof(Table) + sizeof(Scalars) <= 32764,
              "a table must fit the kernel's parameters");

}  // namespace

extern "C" {

// Leaves one launch's table holds.
int hvd_adamw_table_leaves() { return kMaxLeaves; }

// One AdamW step over `leaves` leaves (1..hvd_adamw_table_leaves()). rows:
// host int64 [leaves, 5], a row (g, p, mu, nu, n) per leaf (pointers as
// integers, n > 0). p_dtype (p and g) and mu_dtype: 0 = float32, 1 =
// bfloat16; nu is float32. dev_scalars: a device float32 [lr, ibc1, ibc2]
// read when the kernel runs, or null to take lr, ibc1 and ibc2 as given.
// Returns a cudaError_t.
int hvd_adamw(const int64_t* rows, int leaves, int p_dtype, int mu_dtype,
              const float* dev_scalars, float lr, float ibc1, float ibc2,
              float b1, float omb1, float b2, float omb2, float eps, float wd,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (leaves <= 0 || leaves > kMaxLeaves) return cudaErrorInvalidValue;
  const Scalars sc{lr, ibc1, ibc2, b1, omb1, b2, omb2, eps, wd, dev_scalars};
  return launch(rows, leaves, p_dtype, mu_dtype, sc, st);
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
