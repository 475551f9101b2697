// Adasum pairwise combine for Hopper (sm_90a): kernel K4.
//
// Replaces adasum_combine_pairs of horovod_tpu/ops/pallas_kernels.py:1366
// (_adasum_reduce_kernel + _adasum_apply_kernel). For each pair i < m of rows
// a[i], b[i] of length n:
//
//   dot = sum a*b,  na = sum a*a,  nb = sum b*b          (all in f32)
//   ac  = na == 0 ? 1 : 1 - dot / (2 na)                 (zero-norm guard)
//   bc  = nb == 0 ? 1 : 1 - dot / (2 nb)
//   out = ac*a + bc*b                                    (in the input dtype)
//
// One launch takes a table of pair sets ("entries") of one dtype: each entry
// holds an a base and a b base with a row stride each (an interleaved
// [2m, n] tree level goes in as a = buf, b = buf + n, lda = ldb = 2n, with no
// copy), a contiguous [m, n] output, m and n. The table travels in the
// kernel's parameters (__grid_constant__, no host-to-device copy). An entry
// keeps all of a, b, their strides and out (56 bytes), so the table uses
// the 32 KB parameter space of CUDA >= 12.1 (kMaxEntries entries, a
// ResNet-50 step's 161 leaves in one launch) rather than a compact entry
// that only a gathered level could fill: the single-pair call, whose a and
// b may be any two row sets, is a one-entry table of the same kernel.
//
// Bound: memory. Each input element is read once and each output written
// once, 3 n elements a pair against 9 flops an element, far below the
// card's ridge point.
//
// Design: one persistent grid (the SMs times the blocks that fit on each,
// two of 98 KB of shared memory) walks the table's work units in
// increasing order, unit u = blockIdx.x, + gridDim.x, ... A pair of n
// elements is `parts` units, parts = min(tiles, kMaxParts), a tile being
// 48 KB of each operand; unit j owns tiles j, j + parts, ... (one tile
// unless n exceeds kMaxParts tiles: ResNet-50's largest leaf, 2359296 f32
// elements, is exactly kMaxParts tiles). For each unit a block
//   1. brings its tile of a and of b into shared memory with bulk copies
//      (cp.async.bulk, the TMA's 1-D form) in four stages, each completing
//      on its own mbarrier, so that the reduction starts on the first
//      12 KB while the rest lands (rows that are not 16-byte aligned, and
//      a ragged tail of under 16 bytes, are loaded element by element);
//   2. reduces [dot, na, nb] over the tile;
//   3. for parts > 1, writes them to the pair's slot j, arrives on the
//      pair's counter with release semantics, waits on it with acquire
//      semantics until every part has arrived, and sums the pair's slots in
//      one fixed tree;
//   4. applies the coefficients to the tile still in shared memory and
//      stores the output (evict-first: it is not read again here): the
//      second pass reads nothing from HBM. (A unit of several tiles keeps
//      only its last and reads the earlier ones again for the apply, from
//      L2 or HBM.)
// Small leaves are one unit and never wait. The wait is what this design
// pays for keeping the tiles on chip: its blocks load nothing meanwhile,
// and a pair as large as ResNet-50's largest leaf fills three quarters of
// the card's shared memory, so no other pair's loads can fill the gap.
// Applying from L2 instead, after the block's next loads are issued, was
// slower on the H100 even with the tiles loaded under an evict-last
// policy: part of them had left L2.
//
// The wait cannot deadlock, for two reasons together. (a) Every block is
// resident: whenever a pair has more than one part the launch is
// cooperative (cudaLaunchAttributeCooperative), which runs the whole grid
// at once or refuses it, and the grid is at most the blocks that fit.
// (b) Every block takes its units in increasing order, and a pair's parts
// are consecutive units, at most kMaxParts <= gridDim.x of them, so no
// block holds two parts of one pair. Then the block whose current unit is
// the smallest never waits on a part that a block has yet to reach: such a
// part would lie after that block's current unit and before its own
// pair's end, so the other block's current unit would belong to the same
// pair, and the block would hold two of its parts.
//
// Determinism: no float atomics, and the summation order of a leaf is a
// function of n and the dtype only. Tile size and parts depend on n and
// the element size; inside a tile, 16-byte vector v goes to thread
// v mod 256 in increasing v (the same shared-memory places whether a bulk
// copy or element loads filled them; zeros past n); each thread sums with
// fmaf, then a warp butterfly, the warps in a fixed order, and the parts
// in one fixed tree over the slot index. So a leaf gives the same bits
// launched alone or at any place of any table, in every launch, on every
// rank.
//
// Counters are zero between launches: a block arrives a second time after
// it has read the pair's sums, and the block whose second arrival is the
// last one resets the counter, so no memset launch is needed. A wait that
// never ends (a lost arrival) traps after seconds instead of hanging the
// card.
//
// Arithmetic: bf16 and f16 are widened to f32 for all of it. The division is
// IEEE (build without --use_fast_math); NaN propagates through the sums and
// the coefficients as in jnp. The apply uses __fmul_rn / __fadd_rn, so it
// rounds exactly as the plain twin's separate multiply and add: the kernel
// and the twin differ only through the order of the reductions.
//
// Both launchers take device pointers, sizes, a zeroed scratch of pair
// slots (hvd_adasum_pair_bytes() a pair, kept zero by the kernel) and a
// stream, launch on that stream without synchronising, and return a
// cudaError_t; hvd_failure() names the step that failed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 48 * 1024;  // of each operand, a unit's tile
constexpr int kStages = 4;             // bulk copies (and mbarriers) a tile
constexpr int kStageBytes = kTileBytes / kStages;
constexpr int kStageVecs = kStageBytes / 16;
constexpr int kMaxParts = 192;    // units a pair, at most
constexpr int kMaxEntries = 512;  // pair sets of one launch's table
static_assert(kStageVecs % kThreads == 0, "a stage is whole rounds");

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

// A pair's counter and its parts' [dot, na, nb].
struct PairSlot {
  int count;
  int pad[3];
  float part[kMaxParts][3];
};

// Entry i: pairs (a[i] + p lda[i], b[i] + p ldb[i]) -> out[i] + p n[i],
// p < its m, as units first_unit[i] .. first_unit[i + 1] - 1 and pair
// slots first_pair[i] ...
template <int kCap>
struct Table {
  const void* a[kCap];
  const void* b[kCap];
  void* out[kCap];
  int64_t lda[kCap];
  int64_t ldb[kCap];
  int64_t n[kCap];
  int first_unit[kCap + 1];
  int first_pair[kCap];
  int entries;
  PairSlot* slots;
};
static_assert(sizeof(Table<kMaxEntries>) <= 32764,
              "a table must fit the 32 KB of a kernel's parameters");

struct Smem {
  alignas(128) unsigned char a[kTileBytes];
  alignas(128) unsigned char b[kTileBytes];
  uint64_t bar[kStages];
  float warp_part[3][kWarps];
  float sums[3];
};

// Units of a pair of rows of n elements of `elem` bytes. The host's and the
// kernel's count.
__host__ __device__ __forceinline__ int parts_for(int64_t n, int elem) {
  const int64_t tile = kTileBytes / elem;
  const int64_t tiles = (n + tile - 1) / tile;
  return static_cast<int>(tiles < kMaxParts ? tiles : kMaxParts);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Butterfly sum over the warp: fixed order, every lane gets the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[c] <- the sum of every thread's v[c], in one fixed tree; every thread
// gets it.
__device__ __forceinline__ void block_sum3(Smem& s, float (&v)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = warp_sum(v[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) s.warp_part[c][warp] = v[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = warp_sum(lane < kWarps ? s.warp_part[c][lane] : 0.f);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) s.sums[c] = v[c];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = s.sums[c];
}

__device__ __forceinline__ void arrive_release(int* count) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(count)
               : "memory");
}

__device__ __forceinline__ int load_acquire(const int* count) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(count)
               : "memory");
  return v;
}

// Fills the shared tile with a[0, len) and b[0, len), zeros up to a whole
// vector: 16-byte aligned rows by bulk copies, in stages (returns the mask
// of the stages issued), the rest element by element. Every thread's reads
// of the previous tile are done before the copies start.
template <typename T>
__device__ __forceinline__ uint32_t stage_tile(Smem& s, const T* a,
                                               const T* b, int len,
                                               bool bulk) {
  constexpr int V = Vec<T>::kN;
  fence_proxy_async();  // this thread's element writes before the copies
  __syncthreads();
  const int bulk_bytes = bulk ? (len * static_cast<int>(sizeof(T))) & ~15 : 0;
  uint32_t issued = 0;
#pragma unroll
  for (int st = 0; st < kStages; ++st)
    if (st * kStageBytes < bulk_bytes) issued |= 1u << st;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (!(issued >> st & 1)) continue;
      const int lo = st * kStageBytes;
      const int bytes = min(kStageBytes, bulk_bytes - lo);
      mbar_expect_tx(&s.bar[st], 2 * bytes);
      bulk_load(s.a + lo, reinterpret_cast<const unsigned char*>(a) + lo,
                bytes, &s.bar[st]);
      bulk_load(s.b + lo, reinterpret_cast<const unsigned char*>(b) + lo,
                bytes, &s.bar[st]);
    }
  }
  const int first = bulk_bytes / static_cast<int>(sizeof(T));
  const int end = (len + V - 1) / V * V;
  if (first < end) {
    T* sa = reinterpret_cast<T*>(s.a);
    T* sb = reinterpret_cast<T*>(s.b);
    const T zero = from_f32<T>(0.f);
    for (int i = first + threadIdx.x; i < end; i += kThreads) {
      sa[i] = i < len ? a[i] : zero;
      sb[i] = i < len ? b[i] : zero;
    }
    __syncthreads();
  }
  return issued;
}

// f(v) for each of this thread's vectors v < nvec of the shared tile, in
// increasing v, after waiting for the stages in `wait` to land (parity:
// bit st is the parity of stage st's phase to wait for).
template <typename F>
__device__ __forceinline__ void walk(Smem& s, int nvec, uint32_t wait,
                                     uint32_t parity, F&& f) {
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int v0 = st * kStageVecs;
    if (v0 >= nvec) break;
    if (wait >> st & 1) mbar_wait(&s.bar[st], parity >> st & 1);
#pragma unroll
    for (int k = 0; k < kStageVecs / kThreads; ++k) {
      const int v = v0 + k * kThreads + static_cast<int>(threadIdx.x);
      if (v < nvec) f(v);
    }
  }
}

template <typename T, int kCap>
__global__ void __launch_bounds__(kThreads, 2)
adasum_combine_kernel(const __grid_constant__ Table<kCap> t) {
  constexpr int V = Vec<T>::kN;
  constexpr int64_t kTileElems = kTileBytes / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const Vec<T>* va = reinterpret_cast<const Vec<T>*>(s.a);
  const Vec<T>* vb = reinterpret_cast<const Vec<T>*>(s.b);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&s.bar[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  uint32_t parity = 0;
  int e = 0;
  const int units = t.first_unit[t.entries];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    while (u >= t.first_unit[e + 1]) ++e;
    const int64_t n = t.n[e];
    const int parts = parts_for(n, sizeof(T));
    const int64_t tiles = (n + kTileElems - 1) / kTileElems;
    const int local = u - t.first_unit[e];
    const int pair = local / parts, part = local - pair * parts;
    const T* ar = static_cast<const T*>(t.a[e]) + pair * t.lda[e];
    const T* br = static_cast<const T*>(t.b[e]) + pair * t.ldb[e];
    T* orow = static_cast<T*>(t.out[e]) + pair * n;
    const bool bulk = aligned16(ar) && aligned16(br);
    const bool vstore = aligned16(orow);

    // 1-2: reduce every tile of the unit; the last stays in shared memory
    float acc[3] = {0.f, 0.f, 0.f};
    int64_t tile = part;
    int len = 0;
    for (;; tile += parts) {
      const int64_t base = tile * kTileElems;
      len = static_cast<int>(n - base < kTileElems ? n - base : kTileElems);
      const uint32_t issued = stage_tile(s, ar + base, br + base, len, bulk);
      walk(s, (len + V - 1) / V, issued, parity, [&](int v) {
        const Vec<T> x = va[v], y = vb[v];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = to_f32(x.v[k]), yf = to_f32(y.v[k]);
          acc[0] = fmaf(xf, yf, acc[0]);
          acc[1] = fmaf(xf, xf, acc[1]);
          acc[2] = fmaf(yf, yf, acc[2]);
        }
      });
      parity ^= issued;
      if (tile + parts >= tiles) break;
    }
    block_sum3(s, acc);

    // 3: the pair's sums over its parts
    PairSlot* slot = t.slots + t.first_pair[e] + pair;
    int departed = 0;  // thread 0: the arrivals before its second one
    if (parts > 1) {
      if (threadIdx.x == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) slot->part[part][c] = acc[c];
        arrive_release(&slot->count);
        for (uint32_t polls = 0; load_acquire(&slot->count) < parts;
             ++polls) {
          __nanosleep(32);
          if (polls == (1u << 24)) __trap();
        }
      }
      __syncthreads();
      const int j = threadIdx.x;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = j < parts ? __ldcg(&slot->part[j][c]) : 0.f;
      block_sum3(s, acc);
      // read after the apply, so that the atomic's round trip overlaps it
      if (threadIdx.x == 0) departed = atomicAdd(&slot->count, 1);
    }
    const float ac = acc[1] == 0.f ? 1.f : 1.f - acc[0] / (2.f * acc[1]);
    const float bc = acc[2] == 0.f ? 1.f : 1.f - acc[0] / (2.f * acc[2]);

    // 4: apply, the last tile from shared memory, earlier ones reloaded
    int64_t base = tile * kTileElems;
    auto apply = [&](int v) {
      const Vec<T> x = va[v], y = vb[v];
      Vec<T> r;
#pragma unroll
      for (int k = 0; k < V; ++k)
        r.v[k] = from_f32<T>(__fadd_rn(__fmul_rn(ac, to_f32(x.v[k])),
                                       __fmul_rn(bc, to_f32(y.v[k]))));
      T* o = orow + base + static_cast<int64_t>(v) * V;
      if (vstore && (v + 1) * V <= len) {
        float4 f;
        memcpy(&f, &r, sizeof(f));
        __stcs(reinterpret_cast<float4*>(o), f);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (v * V + k < len) o[k] = r.v[k];
      }
    };
    walk(s, (len + V - 1) / V, 0u, parity, apply);
    for (int64_t k = part; k < tile; k += parts) {
      base = k * kTileElems;
      len = static_cast<int>(kTileElems);  // only the last tile is ragged
      const uint32_t issued = stage_tile(s, ar + base, br + base, len, bulk);
      walk(s, (len + V - 1) / V, issued, parity, apply);
      parity ^= issued;
    }
    if (parts > 1 && threadIdx.x == 0 && departed == 2 * parts - 1)
      atomicExch(&slot->count, 0);  // every block of the pair is past it
  }
}

// Blocks of the kernel that fit on one SM (once per process, which uses
// one card), after its opt-in to the shared memory it takes.
template <typename T, int kCap>
int blocks_per_sm() {
  static const int blocks = [] {
    if (allow_smem(adasum_combine_kernel<T, kCap>,
                   static_cast<int>(sizeof(Smem))) != cudaSuccess)
      return 0;
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, adasum_combine_kernel<T, kCap>, kThreads,
        static_cast<int>(sizeof(Smem)));
    return b;
  }();
  return blocks;
}

// Appends pair set (a, lda, b, ldb, out, m, n) to t; *pairs counts the
// table's pairs, *max_parts its largest parts. False if the set is empty
// or the units would overflow an int.
template <int kCap>
bool add_entry(Table<kCap>& t, const void* a, int64_t lda, const void* b,
               int64_t ldb, void* out, int64_t m, int64_t n, int elem,
               int64_t* pairs, int* max_parts) {
  const int i = t.entries;
  if (i >= kCap || m <= 0 || n <= 0) return false;
  const int parts = parts_for(n, elem);
  const int64_t units = t.first_unit[i] + m * parts;
  if (units > INT32_MAX || *pairs + m > INT32_MAX) return false;
  t.a[i] = a;
  t.b[i] = b;
  t.out[i] = out;
  t.lda[i] = lda;
  t.ldb[i] = ldb;
  t.n[i] = n;
  t.first_pair[i] = static_cast<int>(*pairs);
  t.first_unit[i + 1] = static_cast<int>(units);
  t.entries = i + 1;
  *pairs += m;
  if (parts > *max_parts) *max_parts = parts;
  return true;
}

template <typename T, int kCap>
int launch_table(const Table<kCap>& t, int64_t pairs, int max_parts,
                 int64_t scratch_bytes, cudaStream_t st) {
  if (pairs * static_cast<int64_t>(sizeof(PairSlot)) > scratch_bytes)
    return failed("checking the scratch", cudaErrorInvalidValue);
  const int64_t most = static_cast<int64_t>(sm_count()) *
                       blocks_per_sm<T, kCap>();
  if (most <= 0)
    return failed("sizing the grid", cudaErrorInvalidConfiguration);
  const int units = t.first_unit[t.entries];
  const int grid = static_cast<int>(units < most ? units : most);
  if (max_parts > grid)  // see the header: the wait needs every part's block
    return failed("fitting a pair's parts in the grid",
                  cudaErrorInvalidConfiguration);
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = st;
  cfg.attrs = coop;
  cfg.numAttrs = max_parts > 1 ? 1 : 0;  // no block waits otherwise
  cudaGetLastError();  // an earlier call's error is not this launch's
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, adasum_combine_kernel<T, kCap>, t);
  return e == cudaSuccess ? 0 : failed("launching the kernel", e);
}

int elem_bytes(int dtype) { return dtype == kF32 ? 4 : 2; }

template <int kCap>
int combine(Table<kCap>& t, int dtype, int64_t pairs, int max_parts,
            void* scratch, int64_t scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  t.slots = static_cast<PairSlot*>(scratch);
  switch (dtype) {
    case kF32:
      return launch_table<float, kCap>(t, pairs, max_parts, scratch_bytes,
                                       st);
    case kBF16:
      return launch_table<__nv_bfloat16, kCap>(t, pairs, max_parts,
                                               scratch_bytes, st);
    case kF16:
      return launch_table<__half, kCap>(t, pairs, max_parts, scratch_bytes,
                                        st);
  }
  return failed("checking the dtype", cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Pairs (a + i*lda, b + i*ldb), i < m, rows of n elements, into the
// contiguous [m, n] out. Strides in elements. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. scratch: scratch_bytes of zeroed pair slots,
// at least m * hvd_adasum_pair_bytes(). Returns a cudaError_t.
int hvd_adasum_combine(const void* a, int64_t lda, const void* b, int64_t ldb,
                       int dtype, void* out, int64_t m, int64_t n,
                       void* scratch, int64_t scratch_bytes, void* stream) {
  Table<1> t;
  t.entries = 0;
  t.first_unit[0] = 0;
  int64_t pairs = 0;
  int max_parts = 0;
  if (!add_entry(t, a, lda, b, ldb, out, m, n, elem_bytes(dtype), &pairs,
                 &max_parts))
    return failed("checking the sizes", cudaErrorInvalidValue);
  return combine(t, dtype, pairs, max_parts, scratch, scratch_bytes, stream);
}

// Pair sets a launch's table holds.
int hvd_adasum_table_entries() { return kMaxEntries; }

// Bytes of scratch a pair takes (its counter and its parts' sums).
int64_t hvd_adasum_pair_bytes() { return sizeof(PairSlot); }

// table: `entries` host rows of (a, lda, b, ldb, out, m, n), as
// hvd_adasum_combine takes them, all of one dtype; combined in one launch.
// scratch: at least (the sum of m) * hvd_adasum_pair_bytes() bytes.
int hvd_adasum_combine_many(const int64_t* table, int entries, int dtype,
                            void* scratch, int64_t scratch_bytes,
                            void* stream) {
  if (entries < 1 || entries > kMaxEntries)
    return failed("checking the table", cudaErrorInvalidValue);
  Table<kMaxEntries> t;
  t.entries = 0;
  t.first_unit[0] = 0;
  int64_t pairs = 0;
  int max_parts = 0;
  for (int i = 0; i < entries; ++i) {
    const int64_t* r = table + 7 * i;
    if (!add_entry(t, reinterpret_cast<const void*>(r[0]), r[1],
                   reinterpret_cast<const void*>(r[2]), r[3],
                   reinterpret_cast<void*>(r[4]), r[5], r[6],
                   elem_bytes(dtype), &pairs, &max_parts))
      return failed("checking the table", cudaErrorInvalidValue);
  }
  return combine(t, dtype, pairs, max_parts, scratch, scratch_bytes, stream);
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* hvd_failure() { return g_failed; }

}  // extern "C"
