// Matrix product for Hopper (sm_90a): kernel K10.
//
// Replaces matmul_2d of horovod_tpu/ops/pallas_kernels.py (:1819; kernel
// _mm_kernel :1793): out [M, N] = x [M, K] @ w [K, N], all row-major, the
// sum accumulated in f32 and written once in the inputs' dtype. Its caller
// is the chunk product of the fused matmul + reduce-scatter ring
// (horovod_tpu_torch/ops/matmul.py). There is no backward: the TPU kernel
// has no VJP either.
//
// Shapes: K a multiple of 32 and N of 128 (the wrapper holds callers to the
// reference's tile rule, K and N multiples of 128 and M of 8); any M, rows
// past M masked. Operands contiguous and 16-byte aligned.
//
// Bound, at the ring's chunks on an H100: operations for the row-parallel
// MLP chunk [2048, 1024] @ [1024, 1024] (4.3 GFLOP against 10.5 MB), bytes
// for the LM-head chunk [2048, 256] @ [256, 32768] (its 134 MB bf16 output).
// The TPU's (bm, bk, bn) grid with a VMEM accumulator revisited along k is
// not carried over: here one block owns an output tile for the whole of K
// and keeps its sums in registers.
//
// Design, two paths:
// * bf16: tensor cores through WMMA (16 x 16 x 16 bf16 products, f32 sums).
//   A block of 8 warps owns a 128 x 128 output tile, 64 x 32 a warp (4 x 2
//   accumulator fragments in registers), and walks K in 32-deep slices
//   staged in shared memory by cp.async, two slices in flight (the next one
//   loads while this one multiplies). Rows past M load as zeros. The
//   epilogue passes each fragment through a per-warp 16 x 16 f32 scratch
//   tile to round it to bf16 once and drop rows past M.
// * f32: CUDA cores in full f32 FMA (no TF32: the reference contracts in
//   f32). A block of 256 threads owns a 64 x 64 tile, 4 x 4 outputs a
//   thread, K in 16-deep slices in shared memory.
//
// Arithmetic: every output is an f32 sum of products of the input values.
// In the f32 path one thread adds an output's products in k order; in the
// bf16 path the order within a 16-deep step is the tensor cores'. Either
// way equal inputs give equal bits: no atomics, no split of K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

// ------------------------------------------------------------- bf16, WMMA
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LA = BK + 8;  // padded row of the A slice (bf16 elements)
constexpr int LB = BN + 8;  // padded row of the B slice
constexpr int kStages = 2;

struct SmemBF16 {
  bf16 a[kStages][BM * LA];
  bf16 b[kStages][BK * LB];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of one K slice: A rows [row0, row0 + BM) x [k0, k0 + BK)
// and B rows [k0, k0 + BK) x [col0, col0 + BN), 16 bytes a copy.
__device__ __forceinline__ void load_slice(SmemBF16& sm, int stage,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w,
                                           int64_t M, int64_t K, int64_t N,
                                           int64_t row0, int64_t col0,
                                           int64_t k0, int tid) {
#pragma unroll
  for (int q0 = 0; q0 < BM * BK / 8 / kThreads; ++q0) {
    const int c = tid + q0 * kThreads;
    const int r = c >> 2, q = (c & 3) * 8;
    const int64_t gr = row0 + r;
    const bool in = gr < M;
    // a masked row still names a valid address (row 0)
    cp_async16(&sm.a[stage][r * LA + q], x + (in ? gr : 0) * K + k0 + q,
               in ? 16 : 0);
  }
#pragma unroll
  for (int q0 = 0; q0 < BK * BN / 8 / kThreads; ++q0) {
    const int c = tid + q0 * kThreads;
    const int r = c >> 4, q = (c & 15) * 8;
    cp_async16(&sm.b[stage][r * LB + q], w + (k0 + r) * N + col0 + q, 16);
  }
}

__global__ void __launch_bounds__(kThreads)
hvd_mm_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ out, int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(128) SmemBF16 sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int wr = warp >> 2;  // the warp's 64-row half of the tile
  const int wc = warp & 3;   // its 32-column quarter

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  const int64_t steps = K / BK;
  load_slice(sm, 0, x, w, M, K, N, row0, col0, 0, tid);
  cp_async_commit();
  for (int64_t s = 0; s < steps; ++s) {
    const int cur = static_cast<int>(s & 1);
    // the other stage was last read in step s - 1, which ended at a barrier
    if (s + 1 < steps)
      load_slice(sm, cur ^ 1, x, w, M, K, N, row0, col0, (s + 1) * BK, tid);
    cp_async_commit();  // an empty group on the last step keeps the count
    cp_async_wait<1>(); // every group but the newest: slice s has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a[4];
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wm::load_matrix_sync(a[i], &sm.a[cur][(wr * 64 + i * 16) * LA + kk],
                             LA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::load_matrix_sync(b[j], &sm.b[cur][kk * LB + wc * 32 + j * 16],
                             LB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wm::mma_sync(acc[i][j], a[i], b[j],
                                                 acc[i][j]);
    }
    __syncthreads();  // slice s is read before step s + 1 refills its stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the pipeline's shared memory is free; 1 KB of f32 a warp
  float* scratch = reinterpret_cast<float*>(&sm) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm::store_matrix_sync(scratch, acc[i][j], 16, wm::mem_row_major);
      __syncwarp();
      const int64_t gr = row0 + wr * 64 + i * 16 + r;
      if (gr < M) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16_rn(scratch[r * 16 + c + e]);
        *reinterpret_cast<uint4*>(out + gr * N + col0 + wc * 32 + j * 16 +
                                  c) = *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
}

// -------------------------------------------------------------- f32, FMA
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kThreads)
hvd_mm_fma(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, int64_t M, int64_t K, int64_t N) {
  __shared__ float sa[FK][FM + 4];  // the A slice transposed: sa[k][row]
  __shared__ float sb[FK][FN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * FM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * FN;
  // the thread's outputs: rows ty + 16 i, columns tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int q = 0; q < FM * FK / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e >> 4, kk = e & 15;
      const int64_t gr = row0 + r;
      sa[kk][r] = gr < M ? x[gr * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < FK * FN / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = e >> 6, cc = e & 63;
      sb[kk][cc] = w[(k0 + kk) * N + col0 + cc];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gr = row0 + ty + 16 * i;
    if (gr < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[gr * N + col0 + tx + 16 * j] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// out [m, n] = x [m, k] @ w [k, n], all contiguous row-major in one dtype
// (0 = float32, 1 = bfloat16), f32 sums. k a multiple of 32, n of 128; the
// pointers 16-byte aligned. Returns a cudaError_t.
int hvd_matmul(const void* x, const void* w, int dtype, int64_t m, int64_t k,
               int64_t n, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || k <= 0 || n <= 0 || k % BK || n % BN)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: {
      const dim3 grid(static_cast<unsigned>(n / FN),
                      static_cast<unsigned>((m + FM - 1) / FM));
      if (grid.y > 65535u) return cudaErrorInvalidValue;
      hvd_mm_fma<<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), m, k, n);
      return cudaGetLastError();
    }
    case kBF16: {
      const dim3 grid(static_cast<unsigned>(n / BN),
                      static_cast<unsigned>((m + BM - 1) / BM));
      if (grid.y > 65535u) return cudaErrorInvalidValue;
      hvd_mm_wmma<<<grid, kThreads, 0, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<bf16*>(out), m, k, n);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
