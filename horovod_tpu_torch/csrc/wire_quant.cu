// Wire-compression kernels for Hopper (sm_90a): per-block symmetric int8 /
// int4 quantization with one f32 scale per block row.
//
// Replaces the Pallas kernels of horovod_tpu/ops/pallas_kernels.py:
//   hvd_int8_quantize       <- int8_quantize_2d       (_int8_quant_kernel)
//   hvd_int8_dequantize     <- int8_dequantize_2d     (_int8_dequant_kernel)
//   hvd_int8_quantize_pack  <- int8_quantize_pack_2d  (_int8_quant_pack_kernel)
//   hvd_int4_quantize_pack  <- int4_quantize_pack_2d  (_int4_quant_pack_kernel)
//
// One row of the [rows, B] view is one quantization block. Each row is owned
// by one warp: the absmax is a warp-shuffle reduction, then the same warp
// quantizes the row (the second read hits L1/L2, the row is B*4 bytes). A
// grid-stride loop walks the rows, so any row count and any B >= 2 work;
// there is no tiling gate like the TPU's _pick_block.
//
// Bound: memory. The quantizers read 4 (or 2) bytes and write ~1 (or ~0.5)
// byte per element and do a handful of flops per element, far below the
// card's ridge point. The design therefore aims at full-width accesses:
// 16-byte loads per lane when B and the pointers allow it, 4-byte stores of
// four quantized values, and a scalar path for ragged B.
//
// Bits that must match the reference (and the plain-PyTorch twins in
// horovod_tpu_torch/ops/cuda_kernels.py):
//   * scale = absmax * f32(1/qmax) -- a multiply by the f32 constant, not a
//     division by qmax;
//   * the quotient is the IEEE division x / safe (build without
//     --use_fast_math), safe = scale > 0 ? scale : 1;
//   * round half to even (rintf), clip in float, then convert;
//   * absmax propagates NaN like jnp.max (fmaxf would drop it);
//   * packed scale bytes are the little-endian bit pattern of the f32 scale;
//   * int4 nibbles are half-split: byte j = (q[j] & 0xF) | (q[j + B/2] << 4).
//
// Every launcher takes device pointers, sizes and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps = 8 rows in flight
constexpr int kMaxBlocks = 8192;            // grid-stride beyond this
constexpr float kInv127 = 0x1.020408p-7f;   // f32(1/127)
constexpr float kInv7 = 0x1.24924ap-3f;     // f32(1/7)

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

// V elements of T in one 16-byte load.
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

struct alignas(4) Quad {
  int8_t b[4];
};

// Max of two non-negative values that keeps a NaN from either side.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ int8_t quant(float x, float safe, float qmax) {
  const float c = fminf(fmaxf(rintf(x / safe), -qmax), qmax);
  return static_cast<int8_t>(static_cast<int>(c));
}

__device__ __forceinline__ int8_t nibbles(int8_t lo, int8_t hi) {
  const unsigned b = (static_cast<unsigned>(lo) & 0xFu) |
                     (static_cast<unsigned>(hi) << 4);
  return static_cast<int8_t>(b & 0xFFu);
}

// absmax of one row, reduced over the warp; every lane gets the result.
template <typename T, bool kVec>
__device__ float row_absmax(const T* xr, int n, int lane) {
  float m = 0.f;
  if (kVec) {
    constexpr int V = Vec<T>::kN;
    for (int i = lane * V; i < n; i += 32 * V) {
      const Vec<T> v = *reinterpret_cast<const Vec<T>*>(xr + i);
#pragma unroll
      for (int k = 0; k < V; ++k) m = nan_max(fabsf(to_f32(v.v[k])), m);
    }
  } else {
    for (int i = lane; i < n; i += 32) m = nan_max(fabsf(to_f32(xr[i])), m);
  }
  return warp_max(m);
}

// q[0..n) = quant(x[0..n)); q may be a packed row (4-byte aligned when kVec).
template <typename T, bool kVec>
__device__ void quant_row(const T* xr, int8_t* qr, int n, int lane,
                          float safe, float qmax) {
  if (kVec) {
    constexpr int V = Vec<T>::kN;
    for (int i = lane * V; i < n; i += 32 * V) {
      const Vec<T> v = *reinterpret_cast<const Vec<T>*>(xr + i);
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        Quad o;
#pragma unroll
        for (int j = 0; j < 4; ++j) o.b[j] = quant(to_f32(v.v[k + j]), safe, qmax);
        *reinterpret_cast<Quad*>(qr + i + k) = o;
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) qr[i] = quant(to_f32(xr[i]), safe, qmax);
  }
}

// The 4 little-endian bytes of the f32 scale, one byte per lane 0..3.
__device__ __forceinline__ void store_scale_bytes(int8_t* dst, float scale,
                                                  int lane) {
  if (lane < 4)
    dst[lane] = static_cast<int8_t>((__float_as_uint(scale) >> (8 * lane)) & 0xFFu);
}

__device__ __forceinline__ int64_t first_warp() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}
__device__ __forceinline__ int64_t warp_stride() {
  return (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
}

// #1: [rows, B] float -> [rows, B] int8 + [rows] f32 scales.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, int64_t rows, int B) {
  const int lane = threadIdx.x & 31;
  for (int64_t r = first_warp(); r < rows; r += warp_stride()) {
    const T* xr = x + r * B;
    const float scale = row_absmax<T, kVec>(xr, B, lane) * kInv127;
    const float safe = scale > 0.f ? scale : 1.f;
    quant_row<T, kVec>(xr, q + r * B, B, lane, safe, 127.f);
    if (lane == 0) s[r] = scale;
  }
}

// #2: [rows, B] int8, [rows] f32 -> [rows, B] f32, y = f32(q) * s.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                    float* __restrict__ y, int64_t rows, int B) {
  const int lane = threadIdx.x & 31;
  for (int64_t r = first_warp(); r < rows; r += warp_stride()) {
    const int8_t* qr = q + r * B;
    float* yr = y + r * B;
    const float sc = s[r];
    if (kVec) {
      for (int i = lane * 4; i < B; i += 32 * 4) {
        const Quad v = *reinterpret_cast<const Quad*>(qr + i);
        float4 o;
        o.x = static_cast<float>(v.b[0]) * sc;
        o.y = static_cast<float>(v.b[1]) * sc;
        o.z = static_cast<float>(v.b[2]) * sc;
        o.w = static_cast<float>(v.b[3]) * sc;
        *reinterpret_cast<float4*>(yr + i) = o;
      }
    } else {
      for (int i = lane; i < B; i += 32) yr[i] = static_cast<float>(qr[i]) * sc;
    }
  }
}

// #3: [rows, B] float -> [rows, B + 4] int8 rows [q_0..q_{B-1} | scale bytes].
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_quant_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ p,
                       int64_t rows, int B) {
  const int lane = threadIdx.x & 31;
  for (int64_t r = first_warp(); r < rows; r += warp_stride()) {
    const T* xr = x + r * B;
    int8_t* pr = p + r * (B + 4);
    const float scale = row_absmax<T, kVec>(xr, B, lane) * kInv127;
    const float safe = scale > 0.f ? scale : 1.f;
    quant_row<T, kVec>(xr, pr, B, lane, safe, 127.f);
    store_scale_bytes(pr + B, scale, lane);
  }
}

// #4: [rows, B] float, B even -> [rows, B/2 + 4] int8 rows of half-split
// nibbles, then the scale bytes.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
int4_quant_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ p,
                       int64_t rows, int B) {
  const int lane = threadIdx.x & 31;
  const int half = B / 2;
  for (int64_t r = first_warp(); r < rows; r += warp_stride()) {
    const T* xr = x + r * B;
    int8_t* pr = p + r * (half + 4);
    const float scale = row_absmax<T, kVec>(xr, B, lane) * kInv7;
    const float safe = scale > 0.f ? scale : 1.f;
    if (kVec) {
      constexpr int V = Vec<T>::kN;
      for (int j = lane * V; j < half; j += 32 * V) {
        const Vec<T> lo = *reinterpret_cast<const Vec<T>*>(xr + j);
        const Vec<T> hi = *reinterpret_cast<const Vec<T>*>(xr + half + j);
#pragma unroll
        for (int k = 0; k < V; k += 4) {
          Quad o;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            o.b[t] = nibbles(quant(to_f32(lo.v[k + t]), safe, 7.f),
                             quant(to_f32(hi.v[k + t]), safe, 7.f));
          *reinterpret_cast<Quad*>(pr + j + k) = o;
        }
      }
    } else {
      for (int j = lane; j < half; j += 32)
        pr[j] = nibbles(quant(to_f32(xr[j]), safe, 7.f),
                        quant(to_f32(xr[half + j]), safe, 7.f));
    }
    store_scale_bytes(pr + half, scale, lane);
  }
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

inline int grid_for(int64_t rows) {
  const int64_t warps_per_block = kThreads / 32;
  const int64_t g = (rows + warps_per_block - 1) / warps_per_block;
  return static_cast<int>(g < kMaxBlocks ? g : kMaxBlocks);
}

template <typename T>
cudaError_t launch_int8_quant(const void* x, void* q, void* s, int64_t rows,
                              int B, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* ft = static_cast<float*>(s);
  const bool vec = B % Vec<T>::kN == 0 && aligned(x, 16) && aligned(q, 4);
  if (vec)
    int8_quant_kernel<T, true><<<grid_for(rows), kThreads, 0, st>>>(xt, qt, ft, rows, B);
  else
    int8_quant_kernel<T, false><<<grid_for(rows), kThreads, 0, st>>>(xt, qt, ft, rows, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int8_pack(const void* x, void* p, int64_t rows, int B,
                             cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* pt = static_cast<int8_t*>(p);
  // rows of B + 4 bytes stay 4-byte aligned when B % 4 == 0 (V >= 4 here)
  const bool vec = B % Vec<T>::kN == 0 && aligned(x, 16) && aligned(p, 4);
  if (vec)
    int8_quant_pack_kernel<T, true><<<grid_for(rows), kThreads, 0, st>>>(xt, pt, rows, B);
  else
    int8_quant_pack_kernel<T, false><<<grid_for(rows), kThreads, 0, st>>>(xt, pt, rows, B);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int4_pack(const void* x, void* p, int64_t rows, int B,
                             cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* pt = static_cast<int8_t*>(p);
  // both half-rows must start on a 16-byte boundary: B/2 % V == 0
  const bool vec = (B / 2) % Vec<T>::kN == 0 && aligned(x, 16) && aligned(p, 4);
  if (vec)
    int4_quant_pack_kernel<T, true><<<grid_for(rows), kThreads, 0, st>>>(xt, pt, rows, B);
  else
    int4_quant_pack_kernel<T, false><<<grid_for(rows), kThreads, 0, st>>>(xt, pt, rows, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
int hvd_int8_quantize(const void* x, int dtype, void* q, void* s,
                      int64_t rows, int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_int8_quant<float>(x, q, s, rows, block, st);
    case kBF16: return launch_int8_quant<__nv_bfloat16>(x, q, s, rows, block, st);
    case kF16: return launch_int8_quant<__half>(x, q, s, rows, block, st);
  }
  return cudaErrorInvalidValue;
}

int hvd_int8_dequantize(const void* q, const void* s, void* y, int64_t rows,
                        int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* ft = static_cast<const float*>(s);
  float* yt = static_cast<float*>(y);
  const bool vec = block % 4 == 0 && aligned(q, 4) && aligned(y, 16);
  if (vec)
    int8_dequant_kernel<true><<<grid_for(rows), kThreads, 0, st>>>(qt, ft, yt, rows, block);
  else
    int8_dequant_kernel<false><<<grid_for(rows), kThreads, 0, st>>>(qt, ft, yt, rows, block);
  return cudaGetLastError();
}

int hvd_int8_quantize_pack(const void* x, int dtype, void* p, int64_t rows,
                           int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_int8_pack<float>(x, p, rows, block, st);
    case kBF16: return launch_int8_pack<__nv_bfloat16>(x, p, rows, block, st);
    case kF16: return launch_int8_pack<__half>(x, p, rows, block, st);
  }
  return cudaErrorInvalidValue;
}

int hvd_int4_quantize_pack(const void* x, int dtype, void* p, int64_t rows,
                           int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_int4_pack<float>(x, p, rows, block, st);
    case kBF16: return launch_int4_pack<__nv_bfloat16>(x, p, rows, block, st);
    case kF16: return launch_int4_pack<__half>(x, p, rows, block, st);
  }
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
