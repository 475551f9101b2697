// Hopper (sm_90a) building blocks shared by the wgmma / TMA kernels of
// flash_attention_sm90.cu (K5, K7) and matmul.cu (K10), and by the
// persistent grids of layer_norm.cu (K8).
//
// Device side: mbarriers, TMA loads and stores (cp.async.bulk.tensor),
// wgmma operand descriptors for 128B-swizzled tiles, the wgmma fence /
// commit / wait, register ties, and the 1024-byte alignment of dynamic
// shared memory. Host side: cuTensorMapEncodeTiled found through the
// runtime (so no library links -lcuda), a per-thread cache of encoded
// tensor maps, binding the primary context to a thread, the number of
// SMs, the opt-in to more than 48 KB of dynamic shared memory, and the
// name of the step a launcher failed at.
//
// Everything here lives in an anonymous namespace: each library that
// includes it gets its own copy (its own map cache and failure name).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The mbarrier inits visible to the async proxy (TMA) and to every thread
// after the following __syncthreads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A phase that
// never completes (a lost copy) traps after ~2^30 polls, seconds, instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}

// TMA load of the 2-D box at (c0 innermost, c1) into dst; its bytes count
// toward bar's transaction.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// TMA load of the 4-D box at (c0 innermost, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store of the 2-D box at (c0 innermost, c1) from src, in this
// thread's current bulk group; the map clips what lies out of bounds.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// All but the newest N of this thread's committed bulk stores have read
// their shared memory.
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// This thread's committed bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (a TMA store that reads them next).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma operand descriptor of a tile of 128-byte rows, 128B swizzle, on a
// 1024-byte boundary. sbo: bytes between 8-row groups (1024 for rows laid
// one after another); lbo: for an MN-major operand wider than 64 bf16, the
// bytes between its 64-wide column blocks (unused otherwise).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile,
                                               uint32_t lbo = 16,
                                               uint32_t sbo = 1024) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
constexpr uint64_t kStepK = 32 >> 4;     // K-major: 16 columns a step
constexpr uint64_t kStepMN = 2048 >> 4;  // MN-major: 16 rows a step

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warpgroup are
// still running (N = 0: every one is done).
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to this point, so that the compiler neither reads an
// accumulator before the wgmma that writes it has been waited for nor
// reuses an A operand's registers while a wgmma may still read them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Aligns the dynamic shared memory to 1024 bytes (the 128B swizzle's
// period, which the descriptors and TMA's swizzle assume).
template <typename S>
__device__ __forceinline__ S& smem_as() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(smem_raw + pad);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor maps this thread has encoded, by what they encode (a map holds
// only an address and a geometry, so an equal key is an equal map): a
// training step hands the same tensors to the kernels step after step, so
// a launch mostly encodes nothing. Direct-mapped; a zero key (a null
// pointer) never matches a real tensor.
struct CachedMap {
  uint64_t key[8];
  CUtensorMap map;
};
constexpr int kCachedMaps = 64;
thread_local CachedMap g_maps[kCachedMaps];

template <typename Encode>
bool cached_map(CUtensorMap* map, const uint64_t (&key)[8], Encode encode) {
  uint64_t h = 0;
  for (uint64_t k : key) h = (h ^ k) * 0x100000001b3ull;
  CachedMap& slot = g_maps[(h >> 32) % kCachedMaps];
  bool same = true;
  for (int i = 0; i < 8; ++i) same = same && slot.key[i] == key[i];
  if (same) {
    *map = slot.map;
    return true;
  }
  if (!encode(map)) return false;
  slot.map = *map;
  for (int i = 0; i < 8; ++i) slot.key[i] = key[i];
  return true;
}

// What the last failed launcher call of this thread was doing.
thread_local const char* g_failed = "";

int failed(const char* what, cudaError_t e) {
  g_failed = what;
  return static_cast<int>(e);
}

// cuTensorMapEncodeTiled is a libcuda call and needs a current context. A
// thread that has made no runtime call yet has none: PyTorch's autograd
// thread, whose first work in a backward can be a launcher, is one. A
// runtime call binds the device's primary context, once per thread.
bool context_bound() {
  thread_local const bool bound = cudaFree(nullptr) == cudaSuccess;
  return bound;
}

// SMs of the current device, once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  return counts[dev];
}

// Shared memory of a kernel: its struct plus room to align it to 1024.
template <typename S>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(S)) + 1024;
}

// The kernel's opt-in to dynamic shared memory above 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
