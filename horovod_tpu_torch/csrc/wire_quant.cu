// Wire-compression kernels for Hopper (sm_90a): per-block symmetric int8 /
// int4 quantization with one f32 scale per block row.
//
// Replaces the Pallas kernels of horovod_tpu/ops/pallas_kernels.py:
//   hvd_int8_quantize       <- int8_quantize_2d (:1578, _int8_quant_kernel)
//   hvd_int8_quantize_many  <- the same, once per gradient leaf, as error
//                              feedback calls it (one launch for many)
//   hvd_int8_dequantize     <- int8_dequantize_2d     (_int8_dequant_kernel)
//   hvd_int8_quantize_pack  <- int8_quantize_pack_2d (:1637,
//                              _int8_quant_pack_kernel)
//   hvd_int4_quantize_pack  <- int4_quantize_pack_2d  (_int4_quant_pack_kernel)
//
// One row of the [rows, B] view is one quantization block.
//
// Bound: memory. The quantizers read 4 (or 2) bytes and write ~1 (or ~0.5)
// byte per element and do a handful of flops per element, far below the
// card's ridge point, so the aim is to move each byte once at the card's
// rate.
//
// #2 and #4 (and the general loops below) are a warp a row: the row read
// once for the absmax and again (from L1) to quantize, 4-byte stores, one
// row in flight a warp, a grid of rows / 8 blocks.
//
// The int8 quantizers (#1, #3) at B = 128, 256 or 512 and 16-byte aligned
// data share a register path (int8_quant_tiles_kernel): a row belongs
// to B / 16 lanes of a warp, each holding 16 consecutive elements in
// registers (four 16-byte loads in f32, two in bf16 / f16), so every
// element is read once; a warp loads two row slots (4 rows of 256 f32,
// 4 KB) before its first reduction; the absmax is a shuffle over the row's
// lanes, and each lane quantizes its 16 values from registers into 16
// bytes. A block quantizes a tile of 8 warps' rows into shared memory --
// #1's q rows and a column of f32 scales, or #3's packed rows of B + 4
// bytes with the scale bytes, which are only 4-byte aligned -- and one
// thread stores the tile with bulk copies (cp.async.bulk, the TMA's 1-D
// form) as whole 16-byte units (a tile of 4k rows starts 16-byte aligned:
// 4 (B + 4) = 4B + 16) while the block fills its other buffer. The grid is
// persistent (the SMs times the blocks that fit on each), so no ragged wave
// of short blocks is left; it is taken when the tiles fill it. A block's
// last tile is stored row by row, so the kernel does not end waiting on a
// bulk copy. Fewer rows, other widths and other alignments take a general
// loop: a warp a row.
//
// A zero numerator takes the IEEE division's slow path, so the int8
// quantizers divide a zero as a one and zero its byte after (quant_nz), and
// rows past the data are not quantized at all.
//
// #1 takes a table of leaves (pointer, element count, first output row),
// passed by value in the kernel's parameters (__grid_constant__, at most
// 4 KB: no host-to-device copy), so one launch quantizes up to kMaxLeaves
// gradient leaves of one dtype as they lie in memory; elements past a
// leaf's end read as 0 (the zero padding of a whole last block). The flat
// [rows, B] call, and #3's, is a table of one leaf.
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

#include <type_traits>

namespace {

constexpr int kThreads = 256;               // 8 warps
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

// quant() of an int8 quantizer's value: a zero (the padding past a leaf's
// end, a zero gradient) is divided as a 1 and its result set to 0 after,
// because a zero numerator takes the IEEE division's slow path.
__device__ __forceinline__ int8_t quant_nz(float x, float safe, float qmax) {
  const int8_t q = quant(x == 0.f ? 1.f : x, safe, qmax);
  return x == 0.f ? 0 : q;
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
        for (int j = 0; j < 4; ++j) o.b[j] = quant_nz(to_f32(v.v[k + j]), safe, qmax);
        *reinterpret_cast<Quad*>(qr + i + k) = o;
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) qr[i] = quant_nz(to_f32(xr[i]), safe, qmax);
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

// ------------------------------------------------ #1 and #3: register path
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;       // consecutive elements a lane holds of a row
constexpr int kMaxLeaves = 168;  // leaves in one launch's table of #1

// A lane's kChunk elements of a row as raw 32-bit words: one f32 a word,
// or two bf16 / f16, the first in the low half.
template <typename T>
struct Chunk {
  static constexpr int kWords = kChunk * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ float at(int j) const;
};
template <>
__device__ __forceinline__ float Chunk<float>::at(int j) const {
  return __uint_as_float(w[j]);
}
template <>
__device__ __forceinline__ float Chunk<__nv_bfloat16>::at(int j) const {
  return __uint_as_float(((w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu) << 16);
}
template <>
__device__ __forceinline__ float Chunk<__half>::at(int j) const {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(w[j >> 1] >> (16 * (j & 1)))));
}

template <typename T>
__device__ __forceinline__ void zero_chunk(Chunk<T>& c) {
#pragma unroll
  for (int k = 0; k < Chunk<T>::kWords; ++k) c.w[k] = 0;
}

// The chunk at p, of which `avail` elements lie in the leaf: 16-byte loads
// when all do (p is then 16-byte aligned), else element by element with
// zeros past the leaf's end.
template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p,
                                           int64_t avail) {
  if (avail >= kChunk) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < Chunk<T>::kWords / 4; ++k) {
      const uint4 u = __ldg(v + k);
      c.w[4 * k] = u.x;
      c.w[4 * k + 1] = u.y;
      c.w[4 * k + 2] = u.z;
      c.w[4 * k + 3] = u.w;
    }
  } else {
    using U = typename std::conditional<sizeof(T) == 4, uint32_t,
                                        uint16_t>::type;
    constexpr int kPer = 4 / sizeof(T);  // elements a word
    const U* e = reinterpret_cast<const U*>(p);
    zero_chunk(c);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < avail)
        c.w[j / kPer] |= static_cast<uint32_t>(e[j]) << (32 / kPer * (j % kPer));
  }
}

template <typename T>
__device__ __forceinline__ float chunk_absmax(const Chunk<T>& c) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) m = nan_max(fabsf(c.at(j)), m);
  return m;
}

// Max over the kLanes lanes that share a row (aligned groups of the warp).
template <int kLanes>
__device__ __forceinline__ float lanes_max(float m) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The chunk's 16 int8 values as four little-endian words.
template <typename T>
__device__ __forceinline__ void quant_chunk(const Chunk<T>& c, float safe,
                                            uint32_t (&o)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(
                  quant_nz(c.at(4 * k + b), safe, 127.f))) << (8 * b);
    o[k] = word;
  }
}

// The leaves of one launch, passed by value in the kernel's parameters:
// kCap of them at most (1 for a flat call, whose launch then carries 64
// bytes of table, not 4 KB). Leaf i's elements x[i][0, n[i]) fill output
// rows first[i] .. first[i] + ceil(n[i] / block) - 1, zeros past n[i];
// first increases with i. The launch covers output rows [lo, hi); a row of
// that range that no leaf of the table owns (a leaf of another dtype, in
// another launch) is left alone.
template <int kCap>
struct QuantTable {
  const void* x[kCap];
  int64_t n[kCap];
  int64_t first[kCap];
  int8_t* q;  // output rows: [rows, block] int8 (#1) or packed (#3)
  float* s;   // [rows] f32 scales (#1)
  int64_t lo, hi;
  int leaves, block;
};
static_assert(sizeof(QuantTable<kMaxLeaves>) <= 4096,
              "a table must fit the 4 KB of a kernel's parameters");

// The last leaf whose first row is at most r (lo <= r < hi): a binary
// search of the table.
template <int kCap>
__device__ __forceinline__ int leaf_before(const QuantTable<kCap>& t,
                                           int64_t r) {
  if (kCap == 1) return 0;
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= r)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The leaf that owns row r (lo <= r < hi), or -1, searching forward from
// leaf i <= the answer (a table of one leaf owns every row).
template <int kCap>
__device__ __forceinline__ int leaf_from(const QuantTable<kCap>& t, int i,
                                         int64_t r) {
  if (kCap == 1) return 0;
  while (i + 1 < t.leaves && t.first[i + 1] <= r) ++i;
  return (r - t.first[i]) * t.block < t.n[i] ? i : -1;
}

template <int kCap>
__device__ __forceinline__ int leaf_of(const QuantTable<kCap>& t, int64_t r) {
  return leaf_from(t, leaf_before(t, r), r);
}

// #1, general loop: a warp a row, any block >= 2. kVec: block is a multiple
// of the 16-byte vector and every leaf and q are aligned for it. A leaf's
// short last row is read element by element and quantized as if zero-padded.
template <typename T, bool kVec, int kCap>
__global__ void __launch_bounds__(kThreads)
int8_quant_rows_general_kernel(const __grid_constant__ QuantTable<kCap> t) {
  const int lane = threadIdx.x & 31;
  const int B = t.block;
  for (int64_t r = t.lo + first_warp(); r < t.hi; r += warp_stride()) {
    const int i = leaf_of(t, r);
    if (i < 0) continue;
    const int64_t off = (r - t.first[i]) * B;
    const T* xr = static_cast<const T*>(t.x[i]) + off;
    int8_t* qr = t.q + r * B;
    float scale;
    if (t.n[i] - off >= B) {
      scale = row_absmax<T, kVec>(xr, B, lane) * kInv127;
      quant_row<T, kVec>(xr, qr, B, lane, scale > 0.f ? scale : 1.f, 127.f);
    } else {
      const int m = static_cast<int>(t.n[i] - off);
      scale = row_absmax<T, false>(xr, m, lane) * kInv127;
      quant_row<T, false>(xr, qr, m, lane, scale > 0.f ? scale : 1.f, 127.f);
      for (int j = m + lane; j < B; j += 32) qr[j] = 0;
    }
    if (lane == 0) t.s[r] = scale;
  }
}

// Bulk copies from shared memory (the TMA's 1-D form), issued by one thread.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// All but the newest N of this thread's bulk copies have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// This thread's shared-memory writes become visible to the bulk copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// #1 and #3, register path, B = 16 kLanes: block b takes tiles of kTile
// output rows from lo, b, b + blocks, ...; warp w of a tile quantizes its
// kGroup rows, two slots of 32 / kLanes rows loaded before either is
// reduced, into a copy of the tile in shared memory -- q rows and a column
// of f32 scales (#1), or packed rows of B + 4 bytes (kPack, #3) -- which
// one thread stores with bulk copies while the block fills the other of two
// buffers. A block's last tile, a ragged tile, or one that holds a row no
// leaf of the table owns (another launch's) is stored row by row instead:
// each lane copies the 16 bytes it wrote, and the row's first lane the
// scale.
template <typename T, int kLanes, int kCap, bool kPack>
__global__ void __launch_bounds__(kThreads)
int8_quant_tiles_kernel(const __grid_constant__ QuantTable<kCap> t) {
  constexpr int kPass = 32 / kLanes;  // rows of one slot
  constexpr int kGroup = 2 * kPass;   // rows of a warp
  constexpr int B = kLanes * kChunk;
  constexpr int kRow = kPack ? B + 4 : B;  // bytes of an output row
  constexpr int kTile = kWarps * kGroup;   // rows of a tile
  constexpr int kTileBytes = kTile * kRow;
  static_assert(kTile % 4 == 0 && kTileBytes % 16 == 0,
                "tiles of 4k rows start 16-byte aligned");
  __shared__ __align__(128) uint8_t tile[2][kTileBytes];
  __shared__ __align__(16) float column[2][kPack ? 4 : kTile];  // #1's scales
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / kLanes, part = lane % kLanes;
  const int64_t tiles = (t.hi - t.lo + kTile - 1) / kTile;
  // #1's scale column of a tile starts 16-byte aligned where lo's does
  const bool s16 = !kPack && (reinterpret_cast<uintptr_t>(t.s + t.lo) & 15) == 0;
  int buf = 0;
  for (int64_t tl = blockIdx.x; tl < tiles; tl += gridDim.x, buf ^= 1) {
    if (threadIdx.x == 0) bulk_wait_read<1>();  // buf's last store read it
    __syncthreads();
    const int64_t r0 = t.lo + tl * kTile;
    // one search a warp and tile; the warp's rows then step forward
    const int64_t first_row = r0 + warp * kGroup;
    const int base = first_row < t.hi ? leaf_before(t, first_row) : 0;
    Chunk<T> c[2];
    int64_t row[2];
    int leaf[2], local[2];
    bool foreign = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      local[k] = warp * kGroup + k * kPass + sub;
      row[k] = r0 + local[k];
      leaf[k] = row[k] < t.hi ? leaf_from(t, base, row[k]) : -1;
      foreign = foreign || (row[k] < t.hi && leaf[k] < 0);
      if (leaf[k] >= 0) {
        const int64_t off = (row[k] - t.first[leaf[k]]) * B + part * kChunk;
        // a one-leaf table holds whole rows only
        load_chunk(c[k], static_cast<const T*>(t.x[leaf[k]]) + off,
                   kCap == 1 ? kChunk : t.n[leaf[k]] - off);
      } else {
        zero_chunk(c[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float scale = lanes_max<kLanes>(chunk_absmax(c[k])) * kInv127;
      if (leaf[k] < 0) continue;
      uint32_t o[4];
      quant_chunk(c[k], scale > 0.f ? scale : 1.f, o);
      uint8_t* d = tile[buf] + local[k] * kRow;
      if (kPack) {  // packed rows are only 4-byte aligned
        uint32_t* w = reinterpret_cast<uint32_t*>(d + part * kChunk);
        w[0] = o[0];
        w[1] = o[1];
        w[2] = o[2];
        w[3] = o[3];
        if (part == 0) *reinterpret_cast<float*>(d + B) = scale;
      } else {
        *reinterpret_cast<uint4*>(d + part * kChunk) =
            make_uint4(o[0], o[1], o[2], o[3]);
        if (part == 0) column[buf][local[k]] = scale;
      }
    }
    fence_proxy_async();
    // a bulk store pays off while the block goes on to fill its other
    // buffer; a block's last tile leaves row by row, so the kernel does not
    // end waiting on a bulk copy just issued
    const bool bulk = !__syncthreads_or(foreign) && r0 + kTile <= t.hi &&
                      tl + gridDim.x < tiles;
    if (bulk) {
      if (threadIdx.x == 0) {
        bulk_store(t.q + r0 * kRow, tile[buf], kTileBytes);
        if (s16) bulk_store(t.s + r0, column[buf], kTile * 4);
        bulk_commit();
      }
      if (!kPack && !s16 && threadIdx.x < kTile)
        t.s[r0 + threadIdx.x] = column[buf][threadIdx.x];
      continue;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // each lane copies what it wrote
      if (leaf[k] < 0) continue;
      const uint8_t* d = tile[buf] + local[k] * kRow;
      int8_t* g = t.q + row[k] * kRow;
      if (kPack) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(d + part * kChunk);
        uint32_t* v = reinterpret_cast<uint32_t*>(g + part * kChunk);
        v[0] = w[0];
        v[1] = w[1];
        v[2] = w[2];
        v[3] = w[3];
        if (part == 0)
          *reinterpret_cast<uint32_t*>(g + B) =
              *reinterpret_cast<const uint32_t*>(d + B);
      } else {
        *reinterpret_cast<uint4*>(g + part * kChunk) =
            *reinterpret_cast<const uint4*>(d + part * kChunk);
        if (part == 0) t.s[row[k]] = column[buf][local[k]];
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

inline bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

inline int grid_for(int64_t rows) {
  const int64_t warps_per_block = kThreads / 32;
  const int64_t g = (rows + warps_per_block - 1) / warps_per_block;
  return static_cast<int>(g < kMaxBlocks ? g : kMaxBlocks);
}

// Blocks of `kernel` that fit on one SM.
template <typename K>
int blocks_per_sm(K kernel) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return blocks > 0 ? blocks : 1;
}

// Launches the tile kernel on a persistent grid (the SMs times the blocks
// that fit on each) when its tiles fill that grid, and returns whether it
// did. Below that, a general loop's warp a row puts four times as many
// warps to work and finishes first.
template <typename T, int kLanes, int kCap, bool kPack>
bool launch_tiles(const QuantTable<kCap>& t, cudaStream_t st) {
  static const int per_sm =
      blocks_per_sm(int8_quant_tiles_kernel<T, kLanes, kCap, kPack>);
  constexpr int64_t kTile = kWarps * 64 / kLanes;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = sms * per_sm;
  if ((t.hi - t.lo + kTile - 1) / kTile < blocks) return false;
  int8_quant_tiles_kernel<T, kLanes, kCap, kPack><<<blocks, kThreads, 0, st>>>(t);
  return true;
}

// The tile kernel for the register path's widths (B = 128, 256, 512).
template <typename T, int kCap, bool kPack>
bool launch_register_path(const QuantTable<kCap>& t, cudaStream_t st) {
  switch (t.block) {
    case 128: return launch_tiles<T, 8, kCap, kPack>(t, st);
    case 256: return launch_tiles<T, 16, kCap, kPack>(t, st);
    case 512: return launch_tiles<T, 32, kCap, kPack>(t, st);
  }
  return false;
}

template <typename T, int kCap>
cudaError_t launch_int8_quant(const QuantTable<kCap>& t, cudaStream_t st) {
  bool x16 = true;  // every leaf starts on a 16-byte boundary
  for (int i = 0; i < t.leaves; ++i) x16 = x16 && aligned(t.x[i], 16);
  if (x16 && aligned(t.q, 16) && launch_register_path<T, kCap, false>(t, st))
    return cudaGetLastError();
  const int grid = grid_for(t.hi - t.lo);
  if (x16 && aligned(t.q, 4) && t.block % Vec<T>::kN == 0)
    int8_quant_rows_general_kernel<T, true, kCap><<<grid, kThreads, 0, st>>>(t);
  else
    int8_quant_rows_general_kernel<T, false, kCap><<<grid, kThreads, 0, st>>>(t);
  return cudaGetLastError();
}

template <int kCap>
cudaError_t quantize_table(const QuantTable<kCap>& t, int dtype,
                           cudaStream_t st) {
  cudaGetLastError();  // an earlier call's error is not this launch's
  if (t.hi <= t.lo) return cudaSuccess;
  switch (dtype) {
    case kF32: return launch_int8_quant<float, kCap>(t, st);
    case kBF16: return launch_int8_quant<__nv_bfloat16, kCap>(t, st);
    case kF16: return launch_int8_quant<__half, kCap>(t, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_int8_pack(const void* x, void* p, int64_t rows, int B,
                             cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* pt = static_cast<int8_t*>(p);
  cudaGetLastError();  // an earlier call's error is not this launch's
  if (aligned(x, 16) && aligned(p, 16)) {
    QuantTable<1> t;
    t.x[0] = x;
    t.n[0] = rows * B;
    t.first[0] = 0;
    t.q = pt;
    t.s = nullptr;
    t.lo = 0;
    t.hi = rows;
    t.leaves = 1;
    t.block = B;
    if (launch_register_path<T, 1, true>(t, st)) return cudaGetLastError();
  }
  // the general loop: rows of B + 4 bytes stay 4-byte aligned when B % 4 ==
  // 0 (V >= 4 here)
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
  QuantTable<1> t;
  t.x[0] = x;
  t.n[0] = rows * block;
  t.first[0] = 0;
  t.q = static_cast<int8_t*>(q);
  t.s = static_cast<float*>(s);
  t.lo = 0;
  t.hi = rows;
  t.leaves = 1;
  t.block = block;
  return quantize_table(t, dtype, static_cast<cudaStream_t>(stream));
}

// Leaves a table of hvd_int8_quantize_many holds.
int hvd_int8_table_leaves() { return kMaxLeaves; }

// table: `leaves` host rows of (pointer, elements, first output row), each
// leaf non-empty, in increasing row order, of one dtype.
int hvd_int8_quantize_many(const int64_t* table, int leaves, int dtype,
                           void* q, void* s, int block, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || block < 2)
    return cudaErrorInvalidValue;
  QuantTable<kMaxLeaves> t;
  int64_t end = table[2];
  for (int i = 0; i < leaves; ++i) {
    t.x[i] = reinterpret_cast<const void*>(table[3 * i]);
    t.n[i] = table[3 * i + 1];
    t.first[i] = table[3 * i + 2];
    if (t.n[i] <= 0 || t.first[i] < end) return cudaErrorInvalidValue;
    end = t.first[i] + (t.n[i] + block - 1) / block;
  }
  t.q = static_cast<int8_t*>(q);
  t.s = static_cast<float*>(s);
  t.lo = t.first[0];
  t.hi = end;
  t.leaves = leaves;
  t.block = block;
  return quantize_table(t, dtype, static_cast<cudaStream_t>(stream));
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
