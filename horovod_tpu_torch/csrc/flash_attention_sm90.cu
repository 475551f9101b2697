// Flash attention forward K5 and backward K7 for Hopper (sm_90a) on wgmma
// and TMA: the route of bf16 operands with D = 64 (the LM's heads) and bf16
// gradients. The other routes (f32, D = 32 or 128, f32 gradients, the ring
// step K6) stay in flash_attention.cu.
//
// Replaces, in horovod_tpu/ops/pallas_kernels.py:
//   K5  _flash_fwd_once_call (:339): online-softmax attention with a
//       normalized output in bf16 and the f32 row LSE in natural log units;
//   K7  _flash_bwd_fused (:923): dq, dk, dv in bf16 from q, k, v, dO, the
//       LSE and D = rowsum(dO * O).
//
// Operands are [B, T, H, 64] bf16 tensors read through their strides (the
// q, k, v views of a fused qkv projection in place; every stride a multiple
// of 16 bytes). Outputs are contiguous: out, dq, dk, dv [B, T, H, 64]; lse
// and D [B, H, Tq] f32. q_off and k_off are the global positions of row 0
// of q and of k for the causal mask.
//
// Arithmetic, the contract of flash_attention.cu: base-2 logits
// s = (scale log2 e) q.k in f32; running max m and sum l in f32; p (and the
// backward's dS) rounded to bf16 before it multiplies v (q, k); every
// product sums in f32; out = o / l_safe, lse = (m == -inf ? 0 : m ln 2) +
// log(l_safe), l_safe = l == 0 ? 1 : l, so a fully masked row gives out 0
// and lse 0. logf and the division are the IEEE / libdevice ones; 2^x is
// one MUFU.EX2 (ex2.approx.ftz), whose flush of results below 2^-126 to 0
// no bf16 p or dS can show.
//
// Bound: at the main-path shape (B*H = 128, T = 1024, causal) the forward
// moves 68 MB (20 us at 3.35 TB/s) for 17.2 GFLOP (17 us at the bf16
// tensor-core peak), the backward 118 MB (35 us) for 43 GFLOP (43 us).
//
// Design. A block is two consumer warpgroups, each owning 64 rows, and one
// producer warp (warp 8): 288 threads. The producer's lane 0 issues TMA
// loads (cp.async.bulk.tensor) of the streamed 64-row tiles into a ring of
// kStages stages; a stage's `full` mbarrier counts the bytes in, its
// `empty` mbarrier one arrival from each of the 8 consumer warps once
// their wgmma have read it. Every product is one wgmma.m64n64k16 chain
// (4 steps over 64): operands in shared memory come through 128B-swizzled
// TMA boxes of 64 rows x 128 bytes, which is exactly the swizzle's span, so
// a K-major operand (rows along M or N, D contiguous) advances 32 bytes a
// step and an MN-major one (the transposed-B bit: V, K, Q or dO as [rows,
// D] where D is the product's N) 2048 bytes (16 rows) a step.
// * K5: S = Q K^T from shared memory into registers; the softmax runs on
//   the accumulator layout (a thread holds 2 rows x 16 columns, a row's
//   max and sum reduce over the 4 lanes of a quad); p is packed to bf16 in
//   the register layout of wgmma's A operand, which is the accumulator's,
//   and O += P V takes it from registers. Nothing of S touches shared
//   memory.
// * K7, design (a): two kernels, deterministic by construction (each output
//   row is summed by one warpgroup in a fixed tile order; no atomics).
//   dq over q tiles: S = Q K^T and dP = dO V^T, dS = p (dP - D) scale in
//   registers, dQ += dS K with dS as the register A operand. It runs first,
//   so it can also make D = rowsum(dO * O) from its q tiles and write it
//   for the dk+dv kernel (the autograd function's route; the ring passes a
//   D of its own). dk+dv over k tiles computes the transposed scores
//   S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out in the
//   accumulator layout and feed dV += P^T dO and dK += dS^T Q from
//   registers too: seven products, none staged through shared memory.
// Causal tiles past the diagonal are skipped, and only tiles that cross it
// (or the ragged end) are masked: the element loops are compiled twice,
// with and without the mask, because a mask tested element by element in
// every tile cost the forward a third of its time. Forward / dq blocks
// start with the longest rows. TMA's out-of-bounds fill gives zeros past
// T; those rows and columns are masked or not stored. The forward takes
// 96 registers or fewer, so two blocks (four consumer warpgroups) share an
// SM and one block's softmax overlaps another's products; each warpgroup
// itself waits for each product (a software pipeline inside the
// warpgroup, FlashAttention-3's, made ptxas serialize the wgmma chain
// instead).
//
// Each launcher sets its kernel's shared-memory limit once per process,
// encodes the tensor maps on the host with libcuda's
// cuTensorMapEncodeTiled (found with cudaGetDriverEntryPoint, so the
// library needs no -lcuda; a map already encoded in this thread is
// reused), passes them as __grid_constant__ parameters, launches on the
// given stream without synchronising and returns a cudaError_t, with
// hvd_flash_sm90_failure() naming the step that failed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                 // head dim: a 128-byte row
constexpr int kBN = 64;                // rows of every tile
constexpr int kWG = 2;                 // consumer warpgroups a block
constexpr int kBM = kWG * kBN;         // own rows a block
constexpr int kStages = 3;             // streamed tiles in flight
constexpr int kConsumerWarps = 4 * kWG;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kTile = kBN * kD * 2;    // bytes of a bf16 tile
constexpr int kVec = kBN * 4;          // bytes of a tile's f32 lse or D
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// A [64 rows, 64] bf16 box at (d 0, head h, row t, batch b).
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// 64 f32 values of row bh of a [B * H, Tq] statistic, from element t.
__device__ __forceinline__ void tma_vec(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int t, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(t),
      "r"(bh)
      : "memory");
}

// wgmma operand descriptor of a 64-row tile of 128-byte rows, 128B
// swizzle, on a 1024-byte boundary: 8-row groups 1024 bytes apart (the
// stride byte offset; the leading one is unused for this swizzle at N or
// K = 64).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}
constexpr uint64_t kStepK = 32 >> 4;     // K-major: 16 columns a step
constexpr uint64_t kStepMN = 2048 >> 4;  // MN-major: 16 rows a step

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {  // every committed group done
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

#define HVD_ACC32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HVD_ACC32_ARGS(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both from shared memory,
// K-major; kAccumulate = 0 overwrites d.
template <int kAccumulate>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_ACC32
      ", %32, %33, %34, 1, 1, 0, 0;\n"
      : HVD_ACC32_ARGS(d)
      : "l"(a), "l"(b), "n"(kAccumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers (wgmma's A
// fragment: a thread's rows lane/4 and lane/4 + 8 of its warp's 16, columns
// 2 (lane % 4) + {0, 1} and + 8), B from shared memory as [16 rows, 64]
// (MN-major, the transposed-B bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_ACC32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : HVD_ACC32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// S[64 x 64] = A . B^T over D = 64: four K-major steps.
__device__ __forceinline__ void mma_scores(float (&s)[32], uint64_t a,
                                           uint64_t b) {
  mma_ss<0>(s, a, b);
#pragma unroll
  for (int j = 1; j < kD / 16; ++j)
    mma_ss<1>(s, a + j * kStepK, b + j * kStepK);
}

// acc[64 x 64] += P[64 x 64] . W[64 x 64]: P in registers, W a tile of 64
// rows in shared memory.
__device__ __forceinline__ void mma_pv(float (&acc)[32],
                                       const uint32_t (&p)[4][4],
                                       uint64_t w) {
#pragma unroll
  for (int j = 0; j < kBN / 16; ++j) mma_rs(acc, p[j], w + j * kStepMN);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator x[64 x 64] (index 4 i + e: row lane/4 + 8 (e / 2) of the
// warp's 16, column 8 i + 2 (lane % 4) + e % 2) as bf16 A fragments of the
// next product, whose K runs over x's columns: step j covers columns
// 16 j .. 16 j + 15, i.e. x's chunks 2 j and 2 j + 1.
__device__ __forceinline__ void to_a_frags(const float (&x)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// Number of kBN-row k tiles that rows up to q_last can see.
__device__ __forceinline__ int causal_hi(int64_t q_last, int k_off, int nk) {
  const int64_t num = q_last - k_off;
  if (num < 0) return 0;
  const int64_t hi = num / kBN + 1;
  return hi < nk ? static_cast<int>(hi) : nk;
}

// The first kBN-row q tile whose last row sees key `key` (a global
// position; q_off the global position of q row 0).
__device__ __forceinline__ int causal_lo(int64_t key, int q_off) {
  const int64_t num = key - q_off - (kBN - 1);
  return num > 0 ? static_cast<int>((num + kBN - 1) / kBN) : 0;
}

// Writes a [64, 64] f32 accumulator as bf16 rows row0 + r (r < 64, row <
// t) of the contiguous [B, t, H, 64] tensor out.
__device__ __forceinline__ void store_acc(bf16* out, const float (&x)[32],
                                          int b, int h, int H, int t,
                                          int row0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ra = row0 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    if (r >= t) continue;
    bf16* row = out + ((static_cast<int64_t>(b) * t + r) * H + h) * kD + col;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) = __floats2bfloat162_rn(
          x[4 * i + 2 * half], x[4 * i + 2 * half + 1]);
  }
}

// Aligns the dynamic shared memory to 1024 bytes (the 128B swizzle's
// period, which the descriptors assume).
template <typename S>
__device__ __forceinline__ S& smem_as() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(smem_raw + pad);
}

// 2^x in one MUFU.EX2 (ex2.approx.ftz): results below 2^-126 flush to 0,
// which p, rounded to bf16 before any product, cannot tell from theirs.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether accumulator element i (a thread's rows ra and ra + 8, columns
// k0 + 8 (i / 4) + cq + i % 2) is hidden: its key lies past tk, or above
// the diagonal.
__device__ __forceinline__ bool hidden(int i, int k0, int ra, int cq, int tk,
                                       int q_off, int k_off, int causal) {
  const int kc = k0 + 8 * (i >> 2) + cq + (i & 1);
  const int qr = ra + 8 * ((i >> 1) & 1);
  return kc >= tk || (causal && q_off + qr < k_off + kc);
}

// One tile of the online softmax on the score accumulator x (a thread's
// rows ra and ra + 8): x becomes the base-2 logits scale_log2 x, -inf where
// kEdge hides an element, then p = exp2(logit - m_new); the running max m
// and this thread's part of the running sum l are updated; alpha =
// exp2(m_old - m_new) is the factor of the output rows; p goes, rounded to
// bf16, into the A fragments of P V.
template <bool kEdge>
__device__ __forceinline__ void online_softmax(
    float (&x)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&p)[4][4], int k0, int ra, int cq, int tk,
    int q_off, int k_off, int causal, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float v = scale_log2 * x[i];
    if (kEdge && hidden(i, k0, ra, cq, tk, q_off, k_off, causal))
      v = -INFINITY;
    x[i] = v;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_ftz(m[r] - m_safe[r]);  // m = -inf -> 0
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = exp2_ftz(x[i] - m_safe[(i >> 1) & 1]);  // exp2(-inf) == 0
    sum[(i >> 1) & 1] += x[i];
  }
  l[0] = l[0] * alpha[0] + sum[0];  // this thread's 16 columns
  l[1] = l[1] * alpha[1] + sum[1];
  to_a_frags(x, p);
}

// ------------------------------------------------------------ K5 forward
struct FwdSmem {
  bf16 q[kWG][kBN * kD];
  bf16 k[kStages][kBN * kD];
  bf16 v[kStages][kBN * kD];
  uint64_t full[kStages], empty[kStages], qbar;
};

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      bf16* __restrict__ out, float* __restrict__ lse, int H,
                      int tq, int tk, int q_off, int k_off, int causal,
                      float scale_log2) {
  FwdSmem& s = smem_as<FwdSmem>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // causal: the q tiles with the most k tiles go first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBM;
  const int nk = (tk + kBN - 1) / kBN;
  const int hi = causal ? causal_hi(static_cast<int64_t>(q_off) + q0 + kBM - 1,
                                    k_off, nk)
                        : nk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    mbar_init(&s.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(&s.qbar, kWG * kTile);
      for (int g = 0; g < kWG; ++g)
        tma_rows(s.q[g], &mq, &s.qbar, h, q0 + g * kBN, b);
      for (int kt = 0; kt < hi; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(&s.empty[st], (kt / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kTile);
        tma_rows(s.k[st], &mk, &s.full[st], h, kt * kBN, b);
        tma_rows(s.v[st], &mv, &s.full[st], h, kt * kBN, b);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int r0 = q0 + wg * kBN;  // the warpgroup's first row
  const int ra = r0 + (warp & 3) * 16 + (lane >> 2);  // rows ra and ra + 8
  const int cq = 2 * (lane & 3);
  const int hi_wg = causal ? causal_hi(static_cast<int64_t>(q_off) + r0 +
                                           kBN - 1, k_off, nk)
                           : nk;
  float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  mbar_wait(&s.qbar, 0);
  const uint64_t q_desc = desc_sw128(s.q[wg]);
  // whether tile kt crosses the diagonal or the ragged end (for this
  // warpgroup's rows)
  auto edge = [&](int kt) {
    return kt * kBN + kBN > tk ||
           (causal && static_cast<int64_t>(k_off) + kt * kBN + kBN - 1 >
                          static_cast<int64_t>(q_off) + r0);
  };
  for (int kt = 0; kt < hi; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&s.full[st], (kt / kStages) & 1);
    if (kt < hi_wg) {
      float x[32], alpha[2];
      wg_fence();
      mma_scores(x, q_desc, desc_sw128(s.k[st]));
      wg_commit();
      wg_wait();
      fence_regs(x);
      uint32_t p[4][4];
      if (edge(kt))
        online_softmax<true>(x, m, l, alpha, p, kt * kBN, ra, cq, tk, q_off,
                             k_off, causal, scale_log2);
      else
        online_softmax<false>(x, m, l, alpha, p, kt * kBN, ra, cq, tk, q_off,
                              k_off, causal, scale_log2);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      wg_fence();
      mma_pv(o, p, desc_sw128(s.v[st]));
      wg_commit();
      wg_wait();
      fence_regs(o);
      fence_regs(p);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l_safe[r] = l[r] == 0.f ? 1.f : l[r];
    const int qr = ra + 8 * r;
    if ((lane & 3) == 0 && qr < tq)
      lse[static_cast<int64_t>(bh) * tq + qr] =
          (m[r] == -INFINITY ? 0.f : m[r] * kLn2) + logf(l_safe[r]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = o[i] / l_safe[(i >> 1) & 1];
  store_acc(out, o, b, h, H, tq, r0);
}

// dS = p (dP - D) scale over the dq kernel's score tile x (a thread's rows
// ra and ra + 8, keys k0 + 8 (i / 4) + cq + i % 2), in place of x; p =
// exp2(scale_log2 x - lse2) of the row, 0 where kEdge hides the element
// (a key past tk or above the diagonal, a row past tq).
template <bool kEdge>
__device__ __forceinline__ void ds_rows(float (&x)[32], const float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&ddr)[2], int k0, int ra,
                                        int cq, int tq, int tk, int q_off,
                                        int k_off, int causal, float scale,
                                        float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float v = scale_log2 * x[i];
    if (kEdge && (ra + 8 * r >= tq ||
                  hidden(i, k0, ra, cq, tk, q_off, k_off, causal)))
      v = -INFINITY;
    x[i] = exp2_ftz(v - lse2[r]) * (dp[i] - ddr[r]) * scale;
  }
}

// P^T and dS^T over the dk+dv kernel's transposed tile x (a thread's keys
// ka and ka + 8, q rows i0 + 8 (i / 4) + cq + i % 2 of the streamed tile,
// whose lse and D are lse[c] and dd[c]): x becomes p, dp becomes dS.
template <bool kEdge>
__device__ __forceinline__ void p_ds_cols(float (&x)[32], float (&dp)[32],
                                          const float* lse, const float* dd,
                                          int i0, int ka, int cq, int tq,
                                          int tk, int q_off, int k_off,
                                          int causal, float scale,
                                          float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i >> 2) + cq + (i & 1);  // the q row in the tile
    float v = scale_log2 * x[i];
    if (kEdge) {
      const int qc = i0 + c, kr = ka + 8 * ((i >> 1) & 1);
      if (qc >= tq || kr >= tk || (causal && q_off + qc < k_off + kr))
        v = -INFINITY;
    }
    const float p = exp2_ftz(v - lse[c] * kLog2e);
    x[i] = p;
    dp[i] = p * (dp[i] - dd[c]) * scale;
  }
}

// ---------------------------------------------------- K7 backward: dq
struct DqSmem {
  bf16 q[kWG][kBN * kD];
  bf16 dout[kWG][kBN * kD];
  bf16 o[kWG][kBN * kD];  // the forward's output, when D is made here
  bf16 k[kStages][kBN * kD];
  bf16 v[kStages][kBN * kD];
  float lse[kWG][kBN];
  float dd[kWG][kBN];
  uint64_t full[kStages], empty[kStages], qbar;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const __grid_constant__ CUtensorMap mlse,
                         const __grid_constant__ CUtensorMap mdd,
                         const __grid_constant__ CUtensorMap mo,
                         float* __restrict__ dd_out, int ld,
                         bf16* __restrict__ dq, int H, int tq, int tk,
                         int q_off, int k_off, int causal, float scale,
                         float scale_log2) {
  DqSmem& s = smem_as<DqSmem>();
  const bool make_d = dd_out != nullptr;  // D from O here, else read
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBM;
  const int nk = (tk + kBN - 1) / kBN;
  const int hi = causal ? causal_hi(static_cast<int64_t>(q_off) + q0 + kBM - 1,
                                    k_off, nk)
                        : nk;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    mbar_init(&s.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      mbar_expect_tx(&s.qbar, kWG * (make_d ? 3 * kTile + kVec
                                           : 2 * kTile + 2 * kVec));
      for (int g = 0; g < kWG; ++g) {
        const int t0 = q0 + g * kBN;
        tma_rows(s.q[g], &mq, &s.qbar, h, t0, b);
        tma_rows(s.dout[g], &mdo, &s.qbar, h, t0, b);
        tma_vec(s.lse[g], &mlse, &s.qbar, t0, bh);
        if (make_d)
          tma_rows(s.o[g], &mo, &s.qbar, h, t0, b);
        else
          tma_vec(s.dd[g], &mdd, &s.qbar, t0, bh);
      }
      for (int kt = 0; kt < hi; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(&s.empty[st], (kt / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kTile);
        tma_rows(s.k[st], &mk, &s.full[st], h, kt * kBN, b);
        tma_rows(s.v[st], &mv, &s.full[st], h, kt * kBN, b);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int r0 = q0 + wg * kBN;
  const int lr = (warp & 3) * 16 + (lane >> 2);  // local rows lr, lr + 8
  const int ra = r0 + lr;
  const int cq = 2 * (lane & 3);
  const int hi_wg = causal ? causal_hi(static_cast<int64_t>(q_off) + r0 +
                                           kBN - 1, k_off, nk)
                           : nk;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(&s.qbar, 0);
  if (make_d) {
    // D = rowsum(dO * O) in f32: two threads a row, 32 columns each, read
    // through the 128B swizzle (16-byte chunk c of row r at chunk c ^ r % 8)
    const int r = (threadIdx.x & 127) >> 1, half = threadIdx.x & 1;
    const unsigned char* orow =
        reinterpret_cast<const unsigned char*>(s.o[wg]) + r * 128;
    const unsigned char* drow =
        reinterpret_cast<const unsigned char*>(s.dout[wg]) + r * 128;
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = ((4 * half + j) ^ (r & 7)) * 16;
      const uint4 a = *reinterpret_cast<const uint4*>(orow + at);
      const uint4 c = *reinterpret_cast<const uint4*>(drow + at);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(c2[e]);
        d += x.x * y.x + x.y * y.y;
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      s.dd[wg][r] = d;
      if (r0 + r < tq) dd_out[static_cast<int64_t>(bh) * ld + r0 + r] = d;
    }
    // the warpgroup's 128 threads (named barrier 1 + wg)
    if (wg == 0)
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
  // rows past tq read lse and D as 0; every column of theirs is masked
  // (p = 0) and their dq is not stored
  const float lse2[2] = {s.lse[wg][lr] * kLog2e, s.lse[wg][lr + 8] * kLog2e};
  const float ddr[2] = {s.dd[wg][lr], s.dd[wg][lr + 8]};
  const uint64_t q_desc = desc_sw128(s.q[wg]),
                 do_desc = desc_sw128(s.dout[wg]);
  for (int kt = 0; kt < hi; ++kt) {
    const int st = kt % kStages;
    mbar_wait(&s.full[st], (kt / kStages) & 1);
    if (kt < hi_wg) {
      float x[32], dp[32];
      wg_fence();
      mma_scores(x, q_desc, desc_sw128(s.k[st]));
      mma_scores(dp, do_desc, desc_sw128(s.v[st]));
      wg_commit();
      wg_wait();
      fence_regs(x);
      fence_regs(dp);
      const int k0 = kt * kBN;
      const bool edge = k0 + kBN > tk || r0 + kBN > tq ||
                        (causal && static_cast<int64_t>(k_off) + k0 + kBN - 1 >
                                       static_cast<int64_t>(q_off) + r0);
      if (edge)
        ds_rows<true>(x, dp, lse2, ddr, k0, ra, cq, tq, tk, q_off, k_off,
                      causal, scale, scale_log2);
      else
        ds_rows<false>(x, dp, lse2, ddr, k0, ra, cq, tq, tk, q_off, k_off,
                       causal, scale, scale_log2);
      uint32_t ds[4][4];
      to_a_frags(x, ds);
      wg_fence();
      mma_pv(acc, ds, desc_sw128(s.k[st]));
      wg_commit();
      wg_wait();
      fence_regs(acc);
      fence_regs(ds);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }
  store_acc(dq, acc, b, h, H, tq, r0);
}

// ------------------------------------------------ K7 backward: dk and dv
struct DkvSmem {
  bf16 k[kWG][kBN * kD];
  bf16 v[kWG][kBN * kD];
  bf16 q[kStages][kBN * kD];
  bf16 dout[kStages][kBN * kD];
  float lse[kStages][kBN];
  float dd[kStages][kBN];
  uint64_t full[kStages], empty[kStages], kvbar;
};

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const __grid_constant__ CUtensorMap mlse,
                          const __grid_constant__ CUtensorMap mdd,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int tq, int tk, int q_off, int k_off, int causal,
                          float scale, float scale_log2) {
  DkvSmem& s = smem_as<DkvSmem>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBM;  // causal: the first keys see the most
  const int nq = (tq + kBN - 1) / kBN;
  const int lo = causal ? causal_lo(static_cast<int64_t>(k_off) + k0, q_off)
                        : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    mbar_init(&s.kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      mbar_expect_tx(&s.kvbar, kWG * 2 * kTile);
      for (int g = 0; g < kWG; ++g) {
        tma_rows(s.k[g], &mk, &s.kvbar, h, k0 + g * kBN, b);
        tma_rows(s.v[g], &mv, &s.kvbar, h, k0 + g * kBN, b);
      }
      for (int qt = lo; qt < nq; ++qt) {
        const int n = qt - lo, st = n % kStages, i0 = qt * kBN;
        if (n >= kStages) mbar_wait(&s.empty[st], (n / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kTile + 2 * kVec);
        tma_rows(s.q[st], &mq, &s.full[st], h, i0, b);
        tma_rows(s.dout[st], &mdo, &s.full[st], h, i0, b);
        tma_vec(s.lse[st], &mlse, &s.full[st], i0, bh);
        tma_vec(s.dd[st], &mdd, &s.full[st], i0, bh);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int kw = k0 + wg * kBN;  // the warpgroup's first key
  const int ka = kw + (warp & 3) * 16 + (lane >> 2);  // keys ka and ka + 8
  const int cq = 2 * (lane & 3);
  const int lo_wg = causal ? causal_lo(static_cast<int64_t>(k_off) + kw, q_off)
                           : 0;
  float ak[32], av[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    ak[i] = 0.f;
    av[i] = 0.f;
  }
  mbar_wait(&s.kvbar, 0);
  const uint64_t k_desc = desc_sw128(s.k[wg]),
                 v_desc = desc_sw128(s.v[wg]);
  for (int qt = lo; qt < nq; ++qt) {
    const int n = qt - lo, st = n % kStages, i0 = qt * kBN;
    mbar_wait(&s.full[st], (n / kStages) & 1);
    if (qt >= lo_wg) {
      float x[32], dp[32];
      wg_fence();
      mma_scores(x, k_desc, desc_sw128(s.q[st]));      // S^T
      mma_scores(dp, v_desc, desc_sw128(s.dout[st]));  // dP^T
      wg_commit();
      wg_wait();
      fence_regs(x);
      fence_regs(dp);
      const bool edge = i0 + kBN > tq || kw + kBN > tk ||
                        (causal && static_cast<int64_t>(q_off) + i0 <
                                       static_cast<int64_t>(k_off) + kw +
                                           kBN - 1);
      if (edge)
        p_ds_cols<true>(x, dp, s.lse[st], s.dd[st], i0, ka, cq, tq, tk,
                        q_off, k_off, causal, scale, scale_log2);
      else
        p_ds_cols<false>(x, dp, s.lse[st], s.dd[st], i0, ka, cq, tq, tk,
                         q_off, k_off, causal, scale, scale_log2);
      uint32_t pa[4][4], dsa[4][4];
      to_a_frags(x, pa);
      to_a_frags(dp, dsa);
      wg_fence();
      mma_pv(av, pa, desc_sw128(s.dout[st]));  // dV += P^T dO
      mma_pv(ak, dsa, desc_sw128(s.q[st]));    // dK += dS^T Q
      wg_commit();
      wg_wait();
      fence_regs(av);
      fence_regs(ak);
      fence_regs(pa);
      fence_regs(dsa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[st]);
  }
  store_acc(dk, ak, b, h, H, tk, kw);
  store_acc(dv, av, b, h, H, tk, kw);
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

// A [B, T, H, 64] bf16 operand at p with element strides (sb, st, sh), read
// as boxes of 64 rows of one head, 128B-swizzled; rows past T read as 0.
bool rows_map(CUtensorMap* map, const void* p, int64_t sb, int64_t st,
              int64_t sh, int B, int H, int T) {
  const uint64_t key[8] = {reinterpret_cast<uint64_t>(p),
                           static_cast<uint64_t>(sb),
                           static_cast<uint64_t>(st),
                           static_cast<uint64_t>(sh),
                           static_cast<uint64_t>(B),
                           static_cast<uint64_t>(H),
                           static_cast<uint64_t>(T), 0};
  return cached_map(map, key, [&](CUtensorMap* m) {
    const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                   static_cast<cuuint64_t>(st) * 2,
                                   static_cast<cuuint64_t>(sb) * 2};
    const cuuint32_t box[4] = {kD, 1, kBN, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(p), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// A [rows, t] f32 statistic whose rows lie ld floats apart (ld a multiple
// of 4: TMA takes 16-byte strides), read 64 values of a row at a time;
// values past t read as 0.
bool vec_map(CUtensorMap* map, const void* p, int rows, int t, int ld) {
  const uint64_t key[8] = {reinterpret_cast<uint64_t>(p),
                           static_cast<uint64_t>(rows),
                           static_cast<uint64_t>(t),
                           static_cast<uint64_t>(ld), 0, 0, 0, 1};
  return cached_map(map, key, [&](CUtensorMap* m) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(t),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
    const cuuint32_t box[2] = {kBN, 1};
    const cuuint32_t step[2] = {1, 1};
    return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                          const_cast<void*>(p), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_NONE,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// What the last failed launcher call of this thread was doing.
thread_local const char* g_failed = "";

// cuTensorMapEncodeTiled is a libcuda call and needs a current context. A
// thread that has made no runtime call yet has none: PyTorch's autograd
// thread, whose first work in a backward can be this launcher, is one. A
// runtime call binds the device's primary context, once per thread.
bool context_bound() {
  thread_local const bool bound = cudaFree(nullptr) == cudaSuccess;
  return bound;
}

int failed(const char* what, cudaError_t e) {
  g_failed = what;
  return static_cast<int>(e);
}

// Shared memory of a kernel: its struct plus room to align it to 1024.
template <typename S>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(S)) + 1024;
}

// The kernel's opt-in to dynamic shared memory above 48 KB, once per
// process.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// K5 on the Hopper route (bf16, D = 64). q, k, v: device pointers with
// element strides (sb, st, sh) each; out: contiguous [B, tq, H, 64] bf16;
// lse: contiguous [B, H, tq] f32. Returns a cudaError_t.
int hvd_flash_fwd_sm90(const void* q, int64_t q_sb, int64_t q_st,
                       int64_t q_sh, const void* k, int64_t k_sb, int64_t k_st,
                       int64_t k_sh, const void* v, int64_t v_sb, int64_t v_st,
                       int64_t v_sh, int B, int H, int tq, int tk, int q_off,
                       int k_off, int causal, float scale_log2, void* out,
                       void* lse, void* stream) {
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0)
    return failed("checking the sizes", cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return failed("finding cuTensorMapEncodeTiled", cudaErrorNotSupported);
  if (!context_bound())
    return failed("binding a context", cudaErrorInitializationError);
  static const cudaError_t attr =
      allow_smem(flash_fwd_sm90_kernel, smem_bytes<FwdSmem>());
  if (attr != cudaSuccess) return failed("raising the smem limit", attr);
  CUtensorMap mq, mk, mv;
  if (!rows_map(&mq, q, q_sb, q_st, q_sh, B, H, tq) ||
      !rows_map(&mk, k, k_sb, k_st, k_sh, B, H, tk) ||
      !rows_map(&mv, v, v_sb, v_st, v_sh, B, H, tk))
    return failed("encoding a tensor map", cudaErrorInvalidValue);
  cudaGetLastError();  // an earlier call's error is not this launch's
  const dim3 grid(B * H, (tq + kBM - 1) / kBM);
  flash_fwd_sm90_kernel<<<grid, kThreads, smem_bytes<FwdSmem>(),
                          static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), H, tq,
      tk, q_off, k_off, causal, scale_log2);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : failed("launching the kernel", e);
}

// K7 on the Hopper route (bf16 operands and gradients, D = 64): the dq
// kernel, then the dk+dv kernel. q, k, v, dout as for hvd_flash_fwd_sm90;
// lse, dd: [B, H, tq] f32 whose (b, h) rows lie ld floats apart (ld >= tq,
// a multiple of 4). make_d = 1: the dq kernel computes D = rowsum(dO * O)
// from out (the forward's output, strided like the operands) and writes it
// into dd for the dk+dv kernel; make_d = 0: dd is given and out unused.
// dq, dk, dv: contiguous [B, t, H, 64] bf16. Returns a cudaError_t.
int hvd_flash_bwd_sm90(const void* q, int64_t q_sb, int64_t q_st,
                       int64_t q_sh, const void* k, int64_t k_sb, int64_t k_st,
                       int64_t k_sh, const void* v, int64_t v_sb, int64_t v_st,
                       int64_t v_sh, const void* dout, int64_t o_sb,
                       int64_t o_st, int64_t o_sh, const void* out,
                       int64_t out_sb, int64_t out_st, int64_t out_sh, int B,
                       int H, int tq, int tk, int q_off, int k_off, int causal,
                       float scale, float scale_log2, const void* lse,
                       void* dd, int ld, int make_d, void* dq, void* dk,
                       void* dv, void* stream) {
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0 || ld % 4 || ld < tq)
    return failed("checking the sizes", cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return failed("finding cuTensorMapEncodeTiled", cudaErrorNotSupported);
  if (!context_bound())
    return failed("binding a context", cudaErrorInitializationError);
  static const cudaError_t attr_dq =
      allow_smem(flash_bwd_dq_sm90_kernel, smem_bytes<DqSmem>());
  static const cudaError_t attr_dkv =
      allow_smem(flash_bwd_dkv_sm90_kernel, smem_bytes<DkvSmem>());
  if (attr_dq != cudaSuccess) return failed("raising the smem limit", attr_dq);
  if (attr_dkv != cudaSuccess)
    return failed("raising the smem limit", attr_dkv);
  CUtensorMap mq, mk, mv, mdo, mlse, mdd, mo;
  if (!rows_map(&mq, q, q_sb, q_st, q_sh, B, H, tq) ||
      !rows_map(&mk, k, k_sb, k_st, k_sh, B, H, tk) ||
      !rows_map(&mv, v, v_sb, v_st, v_sh, B, H, tk) ||
      !rows_map(&mdo, dout, o_sb, o_st, o_sh, B, H, tq) ||
      !vec_map(&mlse, lse, B * H, tq, ld) ||
      !vec_map(&mdd, dd, B * H, tq, ld) ||
      !(make_d ? rows_map(&mo, out, out_sb, out_st, out_sh, B, H, tq)
               : rows_map(&mo, q, q_sb, q_st, q_sh, B, H, tq)))
    return failed("encoding a tensor map", cudaErrorInvalidValue);
  cudaGetLastError();  // an earlier call's error is not this launch's
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gq(B * H, (tq + kBM - 1) / kBM);
  flash_bwd_dq_sm90_kernel<<<gq, kThreads, smem_bytes<DqSmem>(), st>>>(
      mq, mk, mv, mdo, mlse, mdd, mo,
      make_d ? static_cast<float*>(dd) : nullptr, ld,
      static_cast<bf16*>(dq), H, tq, tk, q_off, k_off, causal, scale,
      scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return failed("launching the dq kernel", e);
  const dim3 gk(B * H, (tk + kBM - 1) / kBM);
  flash_bwd_dkv_sm90_kernel<<<gk, kThreads, smem_bytes<DkvSmem>(), st>>>(
      mq, mk, mv, mdo, mlse, mdd, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, tq, tk, q_off, k_off, causal, scale,
      scale_log2);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : failed("launching the dk+dv kernel", e);
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What the last failed launcher call of this thread was doing.
const char* hvd_flash_sm90_failure() { return g_failed; }

}  // extern "C"
