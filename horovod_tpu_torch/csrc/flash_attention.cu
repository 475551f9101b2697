// Flash attention for Hopper (sm_90a): forward K5, ring step K6 and
// backward K7.
//
// Replaces, in horovod_tpu/ops/pallas_kernels.py:
//   K5  _flash_fwd_once_call (:339; kernel _flash_fwd_once_kernel :301 over
//       the shared loop _flash_accum :222): online-softmax attention with a
//       normalized output in the input dtype and the f32 row LSE in natural
//       log units;
//   K6  _flash_step_call (:497; kernel _flash_step_kernel :262) and
//       _flash_step_call_streaming (:457; kernel _flash_step_stream_kernel
//       :381): one hop of ring attention, K5's loop started from a carried
//       (m, l, o) and ended without normalizing. The TPU splits resident and
//       streamed k/v for its VMEM budget; here k/v tiles stream at any
//       length, so one kernel covers both;
//   K7  _flash_bwd_fused (:923; kernel :826): dq, dk, dv from q, k, v, dO,
//       the LSE and D = rowsum(dO * O), in the input dtype or in f32. With
//       f32 outputs it also computes what the two-pass _flash_bwd_resident
//       (:986) and the streaming branch of _flash_bwd_hm (:1084) compute,
//       the latter at the ring's hop offsets; the TPU split them for its
//       VMEM budget.
//
// K6's carry: m and l [B, H, Tq] f32, m in natural log units, and the
// unnormalized o [B, Tq, H, D] f32, read at the start and written in place
// (each element by the thread that read it, after the block's first
// barrier). m enters base 2 once, m_in log2 e, and leaves once, m ln 2,
// except that a row whose maximum the hop did not raise gets m_in back bit
// for bit; a block whose rows see no key of the hop (causal, k_off past
// its last row) returns before touching anything, so a fully masked hop
// leaves the whole carry as it was.
//
// Operands are [B, T, H, D] tensors read through their strides (elements;
// the D values of a row are contiguous, every row on a 16-byte boundary), so
// the q, k and v views of a fused qkv projection are read in place. Outputs
// are contiguous: out, dq, dk, dv [B, T, H, D]; lse and D [B, H, T] f32.
// q_off and k_off are the global positions of row 0 of q and of k for the
// causal mask (0 here; the ring of sequence parallelism passes its offsets).
//
// Arithmetic, as in the reference: the logits s = (scale * log2 e) * q.k are
// f32 sums of products of the input values; the softmax runs in base 2, its
// running max m and sum l in f32; p (and the backward's dS) is rounded to the
// input dtype before it multiplies v (q, k), as the MXU takes its operands;
// every product accumulates in f32. Epilogue (:331-336): out = o / l_safe,
// lse = (m == -inf ? 0 : m ln 2) + log(l_safe), l_safe = l == 0 ? 1 : l, so a
// fully masked row gives out 0 and lse 0. Division, exp2f and logf are the
// IEEE / libdevice ones (no --use_fast_math).
//
// The LM's own route, bf16 at D = 64 with bf16 gradients (K5 and K7), runs
// on wgmma and TMA in flash_attention_sm90.cu; this file keeps the rest.
// Design, two paths with the same contract:
// * bf16 with D of 32, and at D = 64 the ring step K6 and the backward with
//   f32 gradients, run on the tensor cores through WMMA (16 x 16 x 16 bf16 products with f32 sums): a block of 4
//   warps owns 64 rows, 16 a warp, and walks the 64-row tiles of the other
//   side, staged in shared memory as bf16. A warp's product tiles land in
//   f32 scratch in shared memory; 2 lanes a row take the softmax (or dS) of
//   their half row there and write p (or dS) back as bf16 for the next
//   product. The forward rescales its output rows in registers once a tile
//   (o = o alpha + p v); dq, dk and dv stay in WMMA fragments.
// * f32, and bf16 with D = 128, run on the CUDA cores in f32: a block of
//   128 threads (a 16 x 8 grid) owns RM * 16 rows; a thread computes an
//   RM x 8 patch of each 64-column score tile (columns tx + 8j) and the
//   matching RM x D/8 patch of its output rows (columns 4 tx + 32 g + e,
//   so that the 8 threads of a quarter warp read 128 contiguous bytes);
//   the 8 threads of a row reduce its max and sum with shuffles.
// Both stop the causal loop at the last tile a row can see (:317-321), and
// causal forward / dq blocks start with the longest rows.
//
// Bound: at the main-path shape (B*H = 128, T = 1024, D = 64, bf16, causal)
// the forward moves 68 MB (20 us at 3.35 TB/s) for 17.2 GFLOP (17 us at
// the bf16 tensor-core peak), the backward 118 MB (35 us) for 43 GFLOP
// (43 us): both near the card's ridge point, so either bound is a few tens
// of microseconds. K6 at the ring hop of a 16384-token sequence over 4
// ranks (q, k, v [1, 4096, 16, 64] bf16) moves 59.8 MB (17.8 us), its f32
// carry in and out the most of it, for 68.7 GFLOP on a fully visible hop
// (69.5 us): bound by operations. The WMMA kernels stage every product
// through shared memory, so shared-memory traffic, not the tensor cores,
// sets their pace.
//
// Determinism: the backward runs two kernels, dq over q tiles and dk+dv over
// k tiles, each summing its tiles in a fixed order: no float atomics, so two
// launches on the same inputs give the same bytes.
//
// Every launcher launches on the given stream without synchronising and
// returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTx = 8;                  // threads across a tile's columns
constexpr int kTy = kThreads / kTx;     // threads across its rows
constexpr int kBN = 64;                 // rows of a streamed tile
constexpr int kLS = kBN + 4;            // shared row stride of a score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum DType { kF32 = 0, kBF16 = 1 };

template <int D>
struct Cfg {
  static constexpr int RM = D >= 128 ? 2 : 4;  // own rows per thread
  static constexpr int BM = kTy * RM;           // own rows per block
  static constexpr int G = D / (4 * kTx);       // float4 output groups/thread
  static constexpr int LD = D + 4;              // shared row stride, floats
};

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

// v rounded to T's precision (an MXU operand of the reference), as f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T>
struct alignas(16) Vec16 {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// A [B, T, H, D] operand: element (b, t, h, d) at p[b sb + t st + h sh + d].
template <typename T>
struct Rows {
  const T* p;
  int64_t sb, st, sh;
  __device__ __forceinline__ const T* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

// dst[r][0, D) = src[(r0 + r) st + 0, D) in f32 for r < n, zeros for
// n <= r < rows (so padded rows never carry NaN or Inf into a product).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t st, int r0, int n,
                                          int rows) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kChunks = D / V;
  constexpr int LD = Cfg<D>::LD;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * V;
    float x[V];
    if (r < n) {
      const Vec16<T> raw = *reinterpret_cast<const Vec16<T>*>(
          src + static_cast<int64_t>(r0 + r) * st + col);
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = to_f32(raw.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
    float* d = dst + r * LD + col;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// acc[i][j] = sum_d a[i LD + d] * b[8 j LD + d]: rows i < RM of the block's
// own tile (a = its row ty RM) against rows tx + 8 j of a streamed tile
// (b = its row tx). d ascends, so the order of the sum is fixed.
template <int D, int RM>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&acc)[RM][8]) {
  constexpr int LD = Cfg<D>::LD;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[RM], bv[8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + j * 8 * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4 g + e] += sum_{j < kBN} p[i kLS + j] * w[j LD + 32 g + e]: the
// thread's rows of a score tile in shared memory (p = its row ty RM) times
// a streamed tile (w = its column 4 tx).
template <int D, int RM>
__device__ __forceinline__ void pv_tile(const float* p, const float* w,
                                        float (&acc)[RM][4 * Cfg<D>::G]) {
  constexpr int LD = Cfg<D>::LD, G = Cfg<D>::G;
#pragma unroll 2
  for (int j = 0; j < kBN; j += 4) {
    float pa[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p + i * kLS + j);
      pa[i][0] = t.x;
      pa[i][1] = t.y;
      pa[i][2] = t.z;
      pa[i][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 wv[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        wv[g] = *reinterpret_cast<const float4*>(w + (j + jj) * LD + 32 * g);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][4 * g + 0] = fmaf(pa[i][jj], wv[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pa[i][jj], wv[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pa[i][jj], wv[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pa[i][jj], wv[g].w, acc[i][4 * g + 3]);
        }
    }
  }
}

// Max and sum over the 8 threads of a row (lanes that differ in bits 0-2).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < kTx; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < kTx; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stores a thread's RM x 4G patch of rows r0 + ty RM + i (< t) into the
// contiguous [B, t, H, D] tensor out.
template <typename O, int D, int RM>
__device__ __forceinline__ void store_rows(O* out, const float (&acc)[RM][4 * Cfg<D>::G],
                                           int b, int h, int H, int t, int r0) {
  constexpr int G = Cfg<D>::G;
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty * RM + i;
    if (r >= t) continue;
    O* row = out + ((static_cast<int64_t>(b) * t + r) * H + h) * D + 4 * tx;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Vec4<O> v;
#pragma unroll
      for (int e = 0; e < 4; ++e) v.v[e] = from_f32<O>(acc[i][4 * g + e]);
      *reinterpret_cast<Vec4<O>*>(row + 32 * g) = v;
    }
  }
}

// K6's carry, written in place (see the top of the file); null for K5.
struct Carry {
  float* m;
  float* l;
  float* o;
};

// Number of kBN-row k tiles a q tile whose last row is q_last can see.
__device__ __forceinline__ int causal_hi(int64_t q_last, int k_off, int nk) {
  const int64_t num = q_last - k_off;
  if (num < 0) return 0;
  const int64_t hi = num / kBN + 1;
  return hi < nk ? static_cast<int>(hi) : nk;
}

// --------------------------------------------- K5 forward and K6 ring step
// kStep = false: K5 (out, lse; carry unused). kStep = true: K6 (the carry;
// out and lse unused).
template <typename T, int D, bool kStep>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Rows<T> q, Rows<T> k, Rows<T> v, T* __restrict__ out,
                 float* __restrict__ lse, Carry carry, int H, int tq, int tk,
                 int q_off, int k_off, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int RM = C::RM, BM = C::BM, G = C::G, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BM][LD]
  float* sK = sQ + BM * LD;      // [kBN][LD]
  float* sV = sK + kBN * LD;     // [kBN][LD]
  float* sP = sV + kBN * LD;     // [BM][kLS]
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // causal: the q tiles with the most k tiles go first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int nk = (tk + kBN - 1) / kBN;
  const int hi = causal ? causal_hi(static_cast<int64_t>(q_off) + q0 + BM - 1,
                                    k_off, nk)
                        : nk;
  if (kStep && hi == 0) return;  // no key of the hop: the carry stays
  load_tile<T, D>(sQ, q.head(b, h), q.st, q0, min(BM, tq - q0), BM);

  float m[RM], l[RM], o[RM][4 * G], m_in[RM], m0[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m0[i] = -INFINITY;
    m_in[i] = 0.f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) o[i][c] = 0.f;
    const int qr = q0 + ty * RM + i;
    if (kStep && qr < tq) {
      const int64_t at = static_cast<int64_t>(bh) * tq + qr;
      m_in[i] = carry.m[at];
      m0[i] = m_in[i] * kLog2e;
      l[i] = carry.l[at];
      const float* row = carry.o +
                         ((static_cast<int64_t>(b) * tq + qr) * H + h) * D +
                         4 * tx;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(row + 32 * g);
        o[i][4 * g] = t.x;
        o[i][4 * g + 1] = t.y;
        o[i][4 * g + 2] = t.z;
        o[i][4 * g + 3] = t.w;
      }
    }
    m[i] = m0[i];
  }
  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    load_tile<T, D>(sK, k.head(b, h), k.st, k0, min(kBN, tk - k0), kBN);
    load_tile<T, D>(sV, v.head(b, h), v.st, k0, min(kBN, tk - k0), kBN);
    __syncthreads();
    float s[RM][8];
    dot_tile<D, RM>(sQ + ty * RM * LD, sK + tx * LD, s);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + ty * RM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = k0 + tx + 8 * j;
        float x = scale_log2 * s[i][j];
        if (qr >= tq || kc >= tk || (causal && q_off + qr < k_off + kc))
          x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_safe);  // m = -inf -> 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_safe);  // exp2(-inf) == 0
        sum += p;
        sP[(ty * RM + i) * kLS + tx + 8 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) o[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<D, RM>(sP + ty * RM * kLS, sV + 4 * tx, o);
  }
  if constexpr (kStep) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + ty * RM + i;
      if (tx == 0 && qr < tq) {
        const int64_t at = static_cast<int64_t>(bh) * tq + qr;
        carry.m[at] = m[i] == m0[i] ? m_in[i] : m[i] * kLn2;
        carry.l[at] = l[i];
      }
    }
    store_rows<float, D, RM>(carry.o, o, b, h, H, tq, q0);
    return;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) o[i][c] = o[i][c] / l_safe;
    const int qr = q0 + ty * RM + i;
    if (tx == 0 && qr < tq)
      lse[static_cast<int64_t>(bh) * tq + qr] =
          (m[i] == -INFINITY ? 0.f : m[i] * kLn2) + logf(l_safe);
  }
  store_rows<T, D, RM>(out, o, b, h, H, tq, q0);
}

// ------------------------------------------------------- K7 backward: dq
// One block per (bh, q tile); walks the k tiles its rows can see:
// dS = p (dP - D) scale with p = exp2(s - lse log2 e), dq += dS k.
template <typename T, typename O, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Rows<T> q, Rows<T> k, Rows<T> v, Rows<T> dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    O* __restrict__ dq, int H, int tq, int tk, int q_off,
                    int k_off, int causal, float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int RM = C::RM, BM = C::BM, G = C::G, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BM][LD]
  float* sO = sQ + BM * LD;      // [BM][LD]   dO
  float* sK = sO + BM * LD;      // [kBN][LD]
  float* sV = sK + kBN * LD;     // [kBN][LD]
  float* sS = sV + kBN * LD;     // [BM][kLS]  dS
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int nq = min(BM, tq - q0);
  load_tile<T, D>(sQ, q.head(b, h), q.st, q0, nq, BM);
  load_tile<T, D>(sO, dout.head(b, h), dout.st, q0, nq, BM);
  float lse2[RM], ddr[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qr = q0 + ty * RM + i;
    const int64_t at = static_cast<int64_t>(bh) * tq + qr;
    lse2[i] = qr < tq ? lse[at] * kLog2e : 0.f;
    ddr[i] = qr < tq ? dd[at] : 0.f;
  }
  const int nk = (tk + kBN - 1) / kBN;
  const int hi = causal ? causal_hi(static_cast<int64_t>(q_off) + q0 + BM - 1,
                                    k_off, nk)
                        : nk;
  float acc[RM][4 * G];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    load_tile<T, D>(sK, k.head(b, h), k.st, k0, min(kBN, tk - k0), kBN);
    load_tile<T, D>(sV, v.head(b, h), v.st, k0, min(kBN, tk - k0), kBN);
    __syncthreads();
    float s[RM][8], dp[RM][8];
    dot_tile<D, RM>(sQ + ty * RM * LD, sK + tx * LD, s);
    dot_tile<D, RM>(sO + ty * RM * LD, sV + tx * LD, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qr = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = k0 + tx + 8 * j;
        float x = scale_log2 * s[i][j];
        if (qr >= tq || kc >= tk || (causal && q_off + qr < k_off + kc))
          x = -INFINITY;
        const float p = exp2f(x - lse2[i]);
        const float ds = p * (dp[i][j] - ddr[i]) * scale;
        sS[(ty * RM + i) * kLS + tx + 8 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    pv_tile<D, RM>(sS + ty * RM * kLS, sK + 4 * tx, acc);
  }
  store_rows<O, D, RM>(dq, acc, b, h, H, tq, q0);
}

// ---------------------------------------------------- K7 backward: dk, dv
// One block per (bh, k tile); walks the q tiles that can see it:
// dv += p^T dO, dk += dS^T q, from the transposed tiles s^T = k q^T and
// dP^T = v dO^T.
template <typename T, typename O, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Rows<T> q, Rows<T> k, Rows<T> v, Rows<T> dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, O* __restrict__ dk,
                     O* __restrict__ dv, int H, int tq, int tk, int q_off,
                     int k_off, int causal, float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int RM = C::RM, BM = C::BM, G = C::G, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;              // [BM][LD]
  float* sV = sK + BM * LD;      // [BM][LD]
  float* sQ = sV + BM * LD;      // [kBN][LD]
  float* sO = sQ + kBN * LD;     // [kBN][LD]  dO
  float* sP = sO + kBN * LD;     // [BM][kLS]  p^T, in T's precision
  float* sS = sP + BM * kLS;     // [BM][kLS]  dS^T
  float* sL = sS + BM * kLS;     // [kBN]      lse log2 e
  float* sD = sL + kBN;          // [kBN]      D
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BM;
  const int nkr = min(BM, tk - k0);
  load_tile<T, D>(sK, k.head(b, h), k.st, k0, nkr, BM);
  load_tile<T, D>(sV, v.head(b, h), v.st, k0, nkr, BM);
  const int nqt = (tq + kBN - 1) / kBN;
  int lo = 0;
  if (causal) {  // the first q tile whose last row sees key k0
    const int64_t num = static_cast<int64_t>(k_off) + k0 - q_off - (kBN - 1);
    if (num > 0) lo = static_cast<int>((num + kBN - 1) / kBN);
  }
  float ak[RM][4 * G], av[RM][4 * G];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) ak[i][c] = av[i][c] = 0.f;
  for (int qt = lo; qt < nqt; ++qt) {
    const int i0 = qt * kBN;
    __syncthreads();
    load_tile<T, D>(sQ, q.head(b, h), q.st, i0, min(kBN, tq - i0), kBN);
    load_tile<T, D>(sO, dout.head(b, h), dout.st, i0, min(kBN, tq - i0),
                    kBN);
    for (int c = threadIdx.x; c < kBN; c += kThreads) {
      const int r = i0 + c;
      const int64_t at = static_cast<int64_t>(bh) * tq + r;
      sL[c] = r < tq ? lse[at] * kLog2e : 0.f;
      sD[c] = r < tq ? dd[at] : 0.f;
    }
    __syncthreads();
    float s[RM][8], dp[RM][8];
    dot_tile<D, RM>(sK + ty * RM * LD, sQ + tx * LD, s);
    dot_tile<D, RM>(sV + ty * RM * LD, sO + tx * LD, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kr = k0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j, qc = i0 + c;
        float x = scale_log2 * s[i][j];
        if (qc >= tq || kr >= tk || (causal && q_off + qc < k_off + kr))
          x = -INFINITY;
        const float p = exp2f(x - sL[c]);
        const float ds = p * (dp[i][j] - sD[c]) * scale;
        sP[(ty * RM + i) * kLS + c] = round_to<T>(p);
        sS[(ty * RM + i) * kLS + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
    pv_tile<D, RM>(sP + ty * RM * kLS, sO + 4 * tx, av);
    pv_tile<D, RM>(sS + ty * RM * kLS, sQ + 4 * tx, ak);
  }
  store_rows<O, D, RM>(dk, ak, b, h, H, tk, k0);
  store_rows<O, D, RM>(dv, av, b, h, H, tk, k0);
}

// ------------------------------------------- tensor-core path (bf16, D <= 64)
// The same three kernels for bf16 operands with D of 32 or 64, on the tensor
// cores through WMMA (16 x 16 x 16 bf16 products, f32 sums). A block of 4
// warps owns 64 rows, 16 a warp; the tiles stay bf16 in shared memory. A
// warp's products land in f32 scratch in shared memory, where its 32 lanes
// (2 per row: row lane % 16, half lane / 16) take the softmax or dS of their
// half row and write p or dS back as bf16 for the next product; the output
// of the forward is rescaled per tile in registers (o = o alpha + p v), dq,
// dk and dv accumulate in WMMA fragments across tiles. Same arithmetic
// contract as the CUDA-core kernels above; the sums inside a product run in
// the tensor cores' order, which is fixed.

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

template <int D>
struct TC {
  static constexpr int BM = 64;        // own rows per block, 16 per warp
  static constexpr int LB = D + 8;     // bf16 row stride of an operand tile
  static constexpr int LS = kBN + 4;   // f32 stride of a warp's score tile
  static constexpr int LP = kBN + 8;   // bf16 stride of a warp's p / dS
  static constexpr int LO = D + 4;     // f32 stride of a warp's output tile
  static constexpr int KD = D / 16;    // 16-wide chunks of D
  static constexpr int HALF = D / 2;   // output columns per lane
  static constexpr int TILE = 64 * LB * 2;        // bytes of an operand tile
  static constexpr int SCORE = 4 * 16 * LS * 4;   // bytes of 4 score tiles
  static constexpr int PTILE = 4 * 16 * LP * 2;   // bytes of 4 p / dS tiles
  static constexpr int OUT = 4 * 16 * LO * 4;     // bytes of 4 output tiles
};

// dst[r][0, D) = src[(r0 + r) st + 0, D) for r < n, zeros up to `rows`.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int64_t st, int r0, int n,
                                          int rows) {
  constexpr int kChunks = D / 8, LB = TC<D>::LB;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(r0 + r) * st + col);
    *reinterpret_cast<uint4*>(dst + r * LB + col) = v;
  }
}

// out[16][kBN] (f32, stride LS) = A . B^T: A the warp's 16 rows (fragments
// a), B the kBN rows of the bf16 tile b.
template <int D>
__device__ __forceinline__ void score_tc(const FragA (&a)[TC<D>::KD],
                                         const bf16* b, float* out) {
  constexpr int LB = TC<D>::LB, KD = TC<D>::KD;
#pragma unroll
  for (int n = 0; n < kBN / 16; ++n) {
    FragC c;
    wm::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      FragBc bt;
      wm::load_matrix_sync(bt, b + n * 16 * LB + kk * 16, LB);
      wm::mma_sync(c, a[kk], bt, c);
    }
    wm::store_matrix_sync(out + n * 16, c, TC<D>::LS, wm::mem_row_major);
  }
}

// acc[dn] += P . W: P the warp's [16][kBN] bf16 tile (stride LP), W the kBN
// x D bf16 tile w.
template <int D>
__device__ __forceinline__ void pv_tc(const bf16* p, const bf16* w,
                                      FragC (&acc)[TC<D>::KD]) {
  constexpr int LB = TC<D>::LB, KD = TC<D>::KD;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    FragA a;
    wm::load_matrix_sync(a, p + kk * 16, TC<D>::LP);
#pragma unroll
    for (int dn = 0; dn < KD; ++dn) {
      FragBr bm;
      wm::load_matrix_sync(bm, w + kk * 16 * LB + dn * 16, LB);
      wm::mma_sync(acc[dn], a, bm, acc[dn]);
    }
  }
}

// The lane's 32 values of row (lane % 16), half (lane / 16), of a warp's
// f32 score tile.
__device__ __forceinline__ void read_half_row(const float* t, int ld,
                                              float (&x)[32]) {
  const int r = threadIdx.x & 15, h = (threadIdx.x >> 4) & 1;
  const float* row = t + r * ld + h * 32;
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + j);
    x[j] = v.x;
    x[j + 1] = v.y;
    x[j + 2] = v.z;
    x[j + 3] = v.w;
  }
}

__device__ __forceinline__ void write_half_row(bf16* t, const float (&x)[32]) {
  const int r = threadIdx.x & 15, h = (threadIdx.x >> 4) & 1;
  bf16* row = t + r * (kBN + 8) + h * 32;
#pragma unroll
  for (int j = 0; j < 32; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(row + j) =
        __floats2bfloat162_rn(x[j], x[j + 1]);
}

// Writes a warp's [16][D] f32 fragments through its scratch tile: the lane
// stores its half row (row0 + lane % 16 < t) to the contiguous [B, t, H, D]
// tensor out.
template <typename O, int D>
__device__ __forceinline__ void store_frags(FragC (&acc)[TC<D>::KD],
                                            float* scratch, O* out, int b,
                                            int h, int H, int t, int row0) {
  constexpr int LO = TC<D>::LO, HALF = TC<D>::HALF;
#pragma unroll
  for (int dn = 0; dn < TC<D>::KD; ++dn)
    wm::store_matrix_sync(scratch + dn * 16, acc[dn], LO, wm::mem_row_major);
  __syncwarp();
  const int r = threadIdx.x & 15, half = (threadIdx.x >> 4) & 1;
  if (row0 + r >= t) return;
  const float* src = scratch + r * LO + half * HALF;
  O* row = out + ((static_cast<int64_t>(b) * t + row0 + r) * H + h) * D +
           half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + c);
    Vec4<O> w;
    w.v[0] = from_f32<O>(v.x);
    w.v[1] = from_f32<O>(v.y);
    w.v[2] = from_f32<O>(v.z);
    w.v[3] = from_f32<O>(v.w);
    *reinterpret_cast<Vec4<O>*>(row + c) = w;
  }
}

template <int D, bool kStep>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(Rows<bf16> q, Rows<bf16> k, Rows<bf16> v,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    Carry carry, int H, int tq, int tk, int q_off, int k_off,
                    int causal, float scale_log2) {
  using C = TC<D>;
  constexpr int KD = C::KD, HALF = C::HALF;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sK = reinterpret_cast<bf16*>(smem_tc + C::TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem_tc + 2 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem_tc + 3 * C::TILE);
  float* sO = reinterpret_cast<float*>(smem_tc + 3 * C::TILE + C::SCORE);
  bf16* sP = reinterpret_cast<bf16*>(smem_tc + 3 * C::TILE + C::SCORE +
                                     C::OUT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, half = lane >> 4;
  float* sSw = sS + warp * 16 * C::LS;
  float* sOw = sO + warp * 16 * C::LO;
  bf16* sPw = sP + warp * 16 * C::LP;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * C::BM;
  const int nk = (tk + kBN - 1) / kBN;
  const int hi = causal ? causal_hi(static_cast<int64_t>(q_off) + q0 +
                                        C::BM - 1, k_off, nk)
                        : nk;
  if (kStep && hi == 0) return;  // no key of the hop: the carry stays
  copy_tile<D>(sQ, q.head(b, h), q.st, q0, min(C::BM, tq - q0), C::BM);
  __syncthreads();
  FragA qa[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    wm::load_matrix_sync(qa[kk], sQ + warp * 16 * C::LB + kk * 16, C::LB);
  const int qr = q0 + warp * 16 + r;
  const int64_t at = static_cast<int64_t>(bh) * tq + qr;
  float* crow = kStep ? carry.o +
                            ((static_cast<int64_t>(b) * tq + qr) * H + h) * D +
                            half * HALF
                      : nullptr;
  float m0 = -INFINITY, m_in = 0.f, l = 0.f, o[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) o[c] = 0.f;
  if (kStep && qr < tq) {
    m_in = carry.m[at];
    m0 = m_in * kLog2e;
    l = carry.l[at];
#pragma unroll
    for (int c = 0; c < HALF; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(crow + c);
      o[c] = t.x;
      o[c + 1] = t.y;
      o[c + 2] = t.z;
      o[c + 3] = t.w;
    }
  }
  float m = m0;
  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    copy_tile<D>(sK, k.head(b, h), k.st, k0, min(kBN, tk - k0), kBN);
    copy_tile<D>(sV, v.head(b, h), v.st, k0, min(kBN, tk - k0), kBN);
    __syncthreads();
    score_tc<D>(qa, sK, sSw);
    __syncwarp();
    float x[32];
    read_half_row(sSw, C::LS, x);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kc = k0 + half * 32 + j;
      float s = scale_log2 * x[j];
      if (qr >= tq || kc >= tk || (causal && q_off + qr < k_off + kc))
        s = -INFINITY;
      x[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16)));
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      x[j] = exp2f(x[j] - m_safe);
      sum += x[j];
    }
    write_half_row(sPw, x);
    l = l * alpha + sum + __shfl_xor_sync(0xffffffffu, sum, 16);
    m = m_new;
    __syncwarp();
    FragC acc[KD];
#pragma unroll
    for (int dn = 0; dn < KD; ++dn) wm::fill_fragment(acc[dn], 0.f);
    pv_tc<D>(sPw, sV, acc);
#pragma unroll
    for (int dn = 0; dn < KD; ++dn)
      wm::store_matrix_sync(sOw + dn * 16, acc[dn], C::LO, wm::mem_row_major);
    __syncwarp();
    const float* pv = sOw + r * C::LO + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(pv + c);
      o[c] = o[c] * alpha + t.x;
      o[c + 1] = o[c + 1] * alpha + t.y;
      o[c + 2] = o[c + 2] * alpha + t.z;
      o[c + 3] = o[c + 3] * alpha + t.w;
    }
    __syncwarp();
  }
  if constexpr (kStep) {
    if (qr < tq) {
#pragma unroll
      for (int c = 0; c < HALF; c += 4)
        *reinterpret_cast<float4*>(crow + c) =
            make_float4(o[c], o[c + 1], o[c + 2], o[c + 3]);
      if (half == 0) {
        carry.m[at] = m == m0 ? m_in : m * kLn2;
        carry.l[at] = l;
      }
    }
    return;
  }
  const float l_safe = l == 0.f ? 1.f : l;
  if (qr < tq) {
    bf16* row = out + ((static_cast<int64_t>(b) * tq + qr) * H + h) * D +
                half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(o[c] / l_safe, o[c + 1] / l_safe);
    if (half == 0)
      lse[static_cast<int64_t>(bh) * tq + qr] =
          (m == -INFINITY ? 0.f : m * kLn2) + logf(l_safe);
  }
}

template <typename O, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(Rows<bf16> q, Rows<bf16> k, Rows<bf16> v,
                       Rows<bf16> dout, const float* __restrict__ lse,
                       const float* __restrict__ dd, O* __restrict__ dq,
                       int H, int tq, int tk, int q_off, int k_off,
                       int causal, float scale, float scale_log2) {
  using C = TC<D>;
  constexpr int KD = C::KD;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sO = reinterpret_cast<bf16*>(smem_tc + C::TILE);
  bf16* sK = reinterpret_cast<bf16*>(smem_tc + 2 * C::TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem_tc + 3 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem_tc + 4 * C::TILE);
  float* sP = reinterpret_cast<float*>(smem_tc + 4 * C::TILE + C::SCORE);
  bf16* sD = reinterpret_cast<bf16*>(smem_tc + 4 * C::TILE + 2 * C::SCORE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, half = lane >> 4;
  float* sSw = sS + warp * 16 * C::LS;   // scores, then dq at the end
  float* sPw = sP + warp * 16 * C::LS;   // dP
  bf16* sDw = sD + warp * 16 * C::LP;    // dS
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * C::BM;
  const int nq = min(C::BM, tq - q0);
  copy_tile<D>(sQ, q.head(b, h), q.st, q0, nq, C::BM);
  copy_tile<D>(sO, dout.head(b, h), dout.st, q0, nq, C::BM);
  __syncthreads();
  FragA qa[KD], oa[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    wm::load_matrix_sync(qa[kk], sQ + warp * 16 * C::LB + kk * 16, C::LB);
    wm::load_matrix_sync(oa[kk], sO + warp * 16 * C::LB + kk * 16, C::LB);
  }
  const int qr = q0 + warp * 16 + r;
  const int64_t at = static_cast<int64_t>(bh) * tq + qr;
  const float lse2 = qr < tq ? lse[at] * kLog2e : 0.f;
  const float ddr = qr < tq ? dd[at] : 0.f;
  const int nk = (tk + kBN - 1) / kBN;
  const int hi = causal ? causal_hi(static_cast<int64_t>(q_off) + q0 +
                                        C::BM - 1, k_off, nk)
                        : nk;
  FragC acc[KD];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn) wm::fill_fragment(acc[dn], 0.f);
  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    copy_tile<D>(sK, k.head(b, h), k.st, k0, min(kBN, tk - k0), kBN);
    copy_tile<D>(sV, v.head(b, h), v.st, k0, min(kBN, tk - k0), kBN);
    __syncthreads();
    score_tc<D>(qa, sK, sSw);
    score_tc<D>(oa, sV, sPw);
    __syncwarp();
    float x[32], dp[32];
    read_half_row(sSw, C::LS, x);
    read_half_row(sPw, C::LS, dp);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kc = k0 + half * 32 + j;
      float s = scale_log2 * x[j];
      if (qr >= tq || kc >= tk || (causal && q_off + qr < k_off + kc))
        s = -INFINITY;
      const float p = exp2f(s - lse2);
      x[j] = p * (dp[j] - ddr) * scale;
    }
    write_half_row(sDw, x);
    __syncwarp();
    pv_tc<D>(sDw, sK, acc);
  }
  store_frags<O, D>(acc, sSw, dq, b, h, H, tq, q0 + warp * 16);
}

template <typename O, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(Rows<bf16> q, Rows<bf16> k, Rows<bf16> v,
                        Rows<bf16> dout, const float* __restrict__ lse,
                        const float* __restrict__ dd, O* __restrict__ dk,
                        O* __restrict__ dv, int H, int tq, int tk, int q_off,
                        int k_off, int causal, float scale,
                        float scale_log2) {
  using C = TC<D>;
  constexpr int KD = C::KD;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = reinterpret_cast<bf16*>(smem_tc + C::TILE);
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc + 2 * C::TILE);
  bf16* sO = reinterpret_cast<bf16*>(smem_tc + 3 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem_tc + 4 * C::TILE);
  float* sPd = reinterpret_cast<float*>(smem_tc + 4 * C::TILE + C::SCORE);
  bf16* sP = reinterpret_cast<bf16*>(smem_tc + 4 * C::TILE + 2 * C::SCORE);
  bf16* sD = reinterpret_cast<bf16*>(smem_tc + 4 * C::TILE + 2 * C::SCORE +
                                     C::PTILE);
  float* sL = reinterpret_cast<float*>(smem_tc + 4 * C::TILE +
                                       2 * C::SCORE + 2 * C::PTILE);
  float* sDD = sL + kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, half = lane >> 4;
  float* sSw = sS + warp * 16 * C::LS;    // s^T, then dk / dv at the end
  float* sPdw = sPd + warp * 16 * C::LS;  // dP^T
  bf16* sPw = sP + warp * 16 * C::LP;     // p^T
  bf16* sDw = sD + warp * 16 * C::LP;     // dS^T
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * C::BM;
  const int nkr = min(C::BM, tk - k0);
  copy_tile<D>(sK, k.head(b, h), k.st, k0, nkr, C::BM);
  copy_tile<D>(sV, v.head(b, h), v.st, k0, nkr, C::BM);
  __syncthreads();
  FragA ka[KD], va[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    wm::load_matrix_sync(ka[kk], sK + warp * 16 * C::LB + kk * 16, C::LB);
    wm::load_matrix_sync(va[kk], sV + warp * 16 * C::LB + kk * 16, C::LB);
  }
  const int kr = k0 + warp * 16 + r;
  const int nqt = (tq + kBN - 1) / kBN;
  int lo = 0;
  if (causal) {  // the first q tile whose last row sees key k0
    const int64_t num = static_cast<int64_t>(k_off) + k0 - q_off - (kBN - 1);
    if (num > 0) lo = static_cast<int>((num + kBN - 1) / kBN);
  }
  FragC ak[KD], av[KD];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn) {
    wm::fill_fragment(ak[dn], 0.f);
    wm::fill_fragment(av[dn], 0.f);
  }
  for (int qt = lo; qt < nqt; ++qt) {
    const int i0 = qt * kBN;
    __syncthreads();
    copy_tile<D>(sQ, q.head(b, h), q.st, i0, min(kBN, tq - i0), kBN);
    copy_tile<D>(sO, dout.head(b, h), dout.st, i0, min(kBN, tq - i0), kBN);
    for (int c = threadIdx.x; c < kBN; c += kThreads) {
      const int row = i0 + c;
      const int64_t at = static_cast<int64_t>(bh) * tq + row;
      sL[c] = row < tq ? lse[at] * kLog2e : 0.f;
      sDD[c] = row < tq ? dd[at] : 0.f;
    }
    __syncthreads();
    score_tc<D>(ka, sQ, sSw);
    score_tc<D>(va, sO, sPdw);
    __syncwarp();
    float x[32], dp[32];
    read_half_row(sSw, C::LS, x);
    read_half_row(sPdw, C::LS, dp);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j, qc = i0 + c;
      float s = scale_log2 * x[j];
      if (qc >= tq || kr >= tk || (causal && q_off + qc < k_off + kr))
        s = -INFINITY;
      const float p = exp2f(s - sL[c]);
      x[j] = p;
      dp[j] = p * (dp[j] - sDD[c]) * scale;
    }
    write_half_row(sPw, x);
    write_half_row(sDw, dp);
    __syncwarp();
    pv_tc<D>(sPw, sO, av);
    pv_tc<D>(sDw, sQ, ak);
  }
  store_frags<O, D>(ak, sSw, dk, b, h, H, tk, k0 + warp * 16);
  __syncwarp();
  store_frags<O, D>(av, sSw, dv, b, h, H, tk, k0 + warp * 16);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in, once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
Rows<T> rows_of(const void* p, int64_t sb, int64_t st, int64_t sh) {
  return Rows<T>{static_cast<const T*>(p), sb, st, sh};
}

template <int D, bool kStep>
cudaError_t fwd_tc(const int64_t* ptrs, const int64_t* strides, int B, int H,
                   int tq, int tk, int q_off, int k_off, int causal,
                   float scale_log2, void* out, void* lse, Carry carry,
                   cudaStream_t st) {
  using C = TC<D>;
  const size_t smem = 3 * C::TILE + C::SCORE + C::OUT + C::PTILE;
  cudaError_t e = allow_smem(flash_fwd_tc_kernel<D, kStep>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (tq + C::BM - 1) / C::BM);
  flash_fwd_tc_kernel<D, kStep><<<grid, kThreads, smem, st>>>(
      rows_of<bf16>(reinterpret_cast<const void*>(ptrs[0]), strides[0], strides[1], strides[2]),
      rows_of<bf16>(reinterpret_cast<const void*>(ptrs[1]), strides[3], strides[4], strides[5]),
      rows_of<bf16>(reinterpret_cast<const void*>(ptrs[2]), strides[6], strides[7], strides[8]),
      static_cast<bf16*>(out), static_cast<float*>(lse), carry, H, tq, tk,
      q_off, k_off, causal, scale_log2);
  return cudaGetLastError();
}

template <typename O, int D>
cudaError_t bwd_tc(const int64_t* ptrs, const int64_t* strides,
                   const void* lse, const void* dd, int B, int H, int tq,
                   int tk, int q_off, int k_off, int causal, float scale,
                   float scale_log2, void* dq, void* dk, void* dv,
                   cudaStream_t st) {
  using C = TC<D>;
  const Rows<bf16> q = rows_of<bf16>(reinterpret_cast<const void*>(ptrs[0]), strides[0], strides[1], strides[2]);
  const Rows<bf16> k = rows_of<bf16>(reinterpret_cast<const void*>(ptrs[1]), strides[3], strides[4], strides[5]);
  const Rows<bf16> v = rows_of<bf16>(reinterpret_cast<const void*>(ptrs[2]), strides[6], strides[7], strides[8]);
  const Rows<bf16> o = rows_of<bf16>(reinterpret_cast<const void*>(ptrs[3]), strides[9], strides[10], strides[11]);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  const size_t smem_dq = 4 * C::TILE + 2 * C::SCORE + C::PTILE;
  const size_t smem_dkv = 4 * C::TILE + 2 * C::SCORE + 2 * C::PTILE +
                          2 * kBN * sizeof(float);
  cudaError_t e = allow_smem(flash_bwd_dq_tc_kernel<O, D>, smem_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_tc_kernel<O, D>, smem_dkv);
  if (e != cudaSuccess) return e;
  const dim3 gq(B * H, (tq + C::BM - 1) / C::BM);
  flash_bwd_dq_tc_kernel<O, D><<<gq, kThreads, smem_dq, st>>>(
      q, k, v, o, l, d, static_cast<O*>(dq), H, tq, tk, q_off, k_off,
      causal, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gk(B * H, (tk + C::BM - 1) / C::BM);
  flash_bwd_dkv_tc_kernel<O, D><<<gk, kThreads, smem_dkv, st>>>(
      q, k, v, o, l, d, static_cast<O*>(dk), static_cast<O*>(dv), H, tq, tk,
      q_off, k_off, causal, scale, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D, bool kStep>
cudaError_t fwd(const int64_t* ptrs, const int64_t* strides, int B, int H,
                int tq, int tk, int q_off, int k_off, int causal,
                float scale_log2, void* out, void* lse, Carry carry,
                cudaStream_t st) {
  using C = Cfg<D>;
  const size_t smem = sizeof(float) *
                      ((C::BM + 2 * kBN) * C::LD + C::BM * kLS);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D, kStep>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (tq + C::BM - 1) / C::BM);
  flash_fwd_kernel<T, D, kStep><<<grid, kThreads, smem, st>>>(
      rows_of<T>(reinterpret_cast<const void*>(ptrs[0]), strides[0], strides[1], strides[2]),
      rows_of<T>(reinterpret_cast<const void*>(ptrs[1]), strides[3], strides[4], strides[5]),
      rows_of<T>(reinterpret_cast<const void*>(ptrs[2]), strides[6], strides[7], strides[8]),
      static_cast<T*>(out), static_cast<float*>(lse), carry, H, tq, tk,
      q_off, k_off, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T, typename O, int D>
cudaError_t bwd(const int64_t* ptrs, const int64_t* strides, const void* lse,
                const void* dd, int B, int H, int tq, int tk, int q_off,
                int k_off, int causal, float scale, float scale_log2,
                void* dq, void* dk, void* dv, cudaStream_t st) {
  using C = Cfg<D>;
  const Rows<T> q = rows_of<T>(reinterpret_cast<const void*>(ptrs[0]), strides[0], strides[1], strides[2]);
  const Rows<T> k = rows_of<T>(reinterpret_cast<const void*>(ptrs[1]), strides[3], strides[4], strides[5]);
  const Rows<T> v = rows_of<T>(reinterpret_cast<const void*>(ptrs[2]), strides[6], strides[7], strides[8]);
  const Rows<T> o = rows_of<T>(reinterpret_cast<const void*>(ptrs[3]), strides[9], strides[10], strides[11]);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  const size_t smem_dq = sizeof(float) *
                         ((2 * C::BM + 2 * kBN) * C::LD + C::BM * kLS);
  const size_t smem_dkv = sizeof(float) *
                          ((2 * C::BM + 2 * kBN) * C::LD + 2 * C::BM * kLS +
                           2 * kBN);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, O, D>, smem_dq);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dkv_kernel<T, O, D>, smem_dkv);
  if (e != cudaSuccess) return e;
  const dim3 gq(B * H, (tq + C::BM - 1) / C::BM);
  flash_bwd_dq_kernel<T, O, D><<<gq, kThreads, smem_dq, st>>>(
      q, k, v, o, l, d, static_cast<O*>(dq), H, tq, tk, q_off, k_off, causal,
      scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 gk(B * H, (tk + C::BM - 1) / C::BM);
  flash_bwd_dkv_kernel<T, O, D><<<gk, kThreads, smem_dkv, st>>>(
      q, k, v, o, l, d, static_cast<O*>(dk), static_cast<O*>(dv), H, tq, tk,
      q_off, k_off, causal, scale, scale_log2);
  return cudaGetLastError();
}

// bf16 with D of 32 or 64 takes the tensor-core kernels, everything else the
// CUDA-core ones; the forward and the bf16-gradient backward of bf16 at
// D = 64 are flash_attention_sm90.cu's (wgmma and TMA) and refused here.
template <typename T, bool kStep>
cudaError_t fwd_d(int d, const int64_t* ptrs, const int64_t* strides, int B,
                  int H, int tq, int tk, int q_off, int k_off, int causal,
                  float scale_log2, void* out, void* lse, Carry carry,
                  cudaStream_t st) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  switch (d) {
    case 32:
      if constexpr (tc) return fwd_tc<32, kStep>(ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, carry, st);
      else return fwd<T, 32, kStep>(ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, carry, st);
    case 64:  // K5 for bf16 runs in flash_attention_sm90.cu
      if constexpr (tc && kStep) return fwd_tc<64, kStep>(ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, carry, st);
      else if constexpr (tc) return cudaErrorNotSupported;
      else return fwd<T, 64, kStep>(ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, carry, st);
    case 128: return fwd<T, 128, kStep>(ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, carry, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename O>
cudaError_t bwd_d(int d, const int64_t* ptrs, const int64_t* strides,
                  const void* lse, const void* dd, int B, int H, int tq,
                  int tk, int q_off, int k_off, int causal, float scale,
                  float scale_log2, void* dq, void* dk, void* dv,
                  cudaStream_t st) {
  constexpr bool tc = std::is_same<T, bf16>::value;
  switch (d) {
    case 32:
      if constexpr (tc) return bwd_tc<O, 32>(ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
      else return bwd<T, O, 32>(ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
    case 64:  // bf16 gradients run in flash_attention_sm90.cu
      if constexpr (tc && std::is_same<O, float>::value) return bwd_tc<O, 64>(ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
      else if constexpr (tc) return cudaErrorNotSupported;
      else return bwd<T, O, 64>(ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
    case 128: return bwd<T, O, 128>(ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Attention forward. ptrs: q, k, v (device pointers as integers); strides:
// (sb, st, sh) of q, then of k, then of v, in elements. dtype: 0 = float32,
// 1 = bfloat16. d: 32, 64 or 128. out: contiguous [B, tq, H, d] in the
// input dtype; lse: contiguous [B, H, tq] f32. Returns a cudaError_t.
int hvd_flash_fwd(const int64_t* ptrs, const int64_t* strides, int dtype,
                  int B, int H, int tq, int tk, int d, int q_off, int k_off,
                  int causal, float scale_log2, void* out, void* lse,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  const Carry none{nullptr, nullptr, nullptr};
  switch (dtype) {
    case kF32: return fwd_d<float, false>(d, ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, none, st);
    case kBF16: return fwd_d<__nv_bfloat16, false>(d, ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, out, lse, none, st);
  }
  return cudaErrorInvalidValue;
}

// One ring hop (K6). ptrs, strides, dtype, d as for hvd_flash_fwd; q_off
// and k_off are the hop's global positions of q row 0 and k row 0. m, l:
// contiguous [B, H, tq] f32 (m in natural log units); o: contiguous
// [B, tq, H, d] f32, unnormalized. All three are updated in place. Returns
// a cudaError_t.
int hvd_flash_step(const int64_t* ptrs, const int64_t* strides, int dtype,
                   int B, int H, int tq, int tk, int d, int q_off, int k_off,
                   int causal, float scale_log2, void* m, void* l, void* o,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  const Carry carry{static_cast<float*>(m), static_cast<float*>(l),
                    static_cast<float*>(o)};
  switch (dtype) {
    case kF32: return fwd_d<float, true>(d, ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, nullptr, nullptr, carry, st);
    case kBF16: return fwd_d<__nv_bfloat16, true>(d, ptrs, strides, B, H, tq, tk, q_off, k_off, causal, scale_log2, nullptr, nullptr, carry, st);
  }
  return cudaErrorInvalidValue;
}

// Attention backward (two kernels: dq, then dk and dv). ptrs: q, k, v, dO;
// strides: (sb, st, sh) of each, in that order. lse, dd: contiguous
// [B, H, tq] f32. out_f32: 1 writes dq, dk, dv in f32, 0 in the input
// dtype; all three contiguous [B, t, H, d]. Returns a cudaError_t.
int hvd_flash_bwd(const int64_t* ptrs, const int64_t* strides, int dtype,
                  int out_f32, int B, int H, int tq, int tk, int d, int q_off,
                  int k_off, int causal, float scale, float scale_log2,
                  const void* lse, const void* dd, void* dq, void* dk,
                  void* dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return bwd_d<float, float>(d, ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
  if (dtype == kBF16 && out_f32)
    return bwd_d<__nv_bfloat16, float>(d, ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
  if (dtype == kBF16)
    return bwd_d<__nv_bfloat16, __nv_bfloat16>(d, ptrs, strides, lse, dd, B, H, tq, tk, q_off, k_off, causal, scale, scale_log2, dq, dk, dv, st);
  return cudaErrorInvalidValue;
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
