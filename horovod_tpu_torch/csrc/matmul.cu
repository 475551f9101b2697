// Matrix product for Hopper (sm_90a): kernel K10.
//
// Replaces matmul_2d of horovod_tpu/ops/pallas_kernels.py (:1819; kernel
// _mm_kernel :1793): out [M, N] = x [M, K] @ w [K, N], all row-major, the
// sum accumulated in f32 and written once in the inputs' dtype. Its caller
// is the chunk product of the fused matmul + reduce-scatter ring
// (horovod_tpu_torch/ops/matmul.py). There is no backward: the TPU kernel
// has no VJP either.
//
// Shapes: K a multiple of 64 and N of 128 (the wrapper holds callers to the
// reference's tile rule, K and N multiples of 128 and M of 8); any M, rows
// past M read as zeros and not written. Operands contiguous and 16-byte
// aligned.
//
// Bound, at the ring's chunks on an H100: operations for the row-parallel
// MLP chunk [2048, 1024] @ [1024, 1024] (4.3 GFLOP against 10.5 MB), bytes
// for the LM-head chunk [2048, 256] @ [256, 32768] (its 134 MB bf16 output
// against 34.4 GFLOP). The TPU's (bm, bk, bn) grid with a VMEM accumulator
// revisited along k is not carried over: here one warpgroup owns 64 rows of
// an output tile for the whole of K and keeps their sums in registers.
//
// Design, two paths:
// * bf16: persistent wgmma + TMA kernels. The grid is at most one block an
//   SM, and a block walks a static schedule of output tiles. A block is
//   three warpgroups. Warpgroup 2 is the producer: setmaxnreg gives its
//   registers away, and one thread issues the TMA loads of 64-deep k slabs
//   into rings of stages guarded by full / empty mbarriers; a ring runs
//   across tile boundaries, so the next tile's slabs load while the
//   consumers are in this tile's epilogue. A (x, K-major) comes in
//   128B-swizzled boxes of 64 k x 128 or 64 rows, B (w, N contiguous:
//   MN-major, the transposed-B bit) in boxes of 64 k x 64 n. Warpgroups 0
//   and 1 are the consumers: each owns 64 rows x BN columns of a tile and
//   runs wgmma.m64nBNk16 chains (4 a slab) into f32 accumulators in
//   registers (setmaxnreg raises them to 232 a thread), one slab's chain
//   still running while the next one's is issued. The epilogue rounds each
//   sum once to bf16 and writes it, one 64 x 64 box at a time, into one of
//   the warpgroup's two store boxes in the 128B swizzle (conflict-free);
//   one thread stores the box by TMA (cp.async.bulk.tensor ...
//   bulk_group), which clips rows past M, and waits for a store to have
//   read its box (wait_group.read) only before the box is rewritten, so
//   the last boxes' stores drain while the next tile's wgmma chains run.
//   Two schedules, by shape:
//   - resident B (hvd_mm_wgmma_resident, BN = 256), where K <= 256 and
//     there are at least 3/4 as many 256-wide columns as SMs (the LM-head
//     chunk: 128): a block takes a whole column, loads its B (K x 256,
//     128 KB) once, and each consumer warpgroup works alone through its
//     own 64-row tiles of the column with its own ring of 4 A slabs. A
//     kernel that streamed A and B for 128 x 256 tiles read 192 KB from L2
//     for each 64 KB tile it wrote, ~393 MB at the LM-head chunk, and took
//     0.080 ms there on an H100 (700 W); resident B reads 32 KB of A for
//     each 32 KB tile and took 0.063 (kernel_ab.py, PERF.md).
//   - streaming (hvd_mm_wgmma, BN = 128) otherwise: both consumer
//     warpgroups work on each 128 x 128 tile and share its B slabs, A and
//     B stream through one ring of 6, and block b takes tiles b, b + grid,
//     ..., M fastest, so the blocks at work at once share their B columns
//     in L2 (the MLP chunk's 128 tiles fill 128 of the 132 SMs).
//   Shared memory: 224 KB (+ 1 KB of alignment) of the 227 KB a block may
//   take in each (MmSmem, MmResidentSmem below): one block an SM.
// * f32: CUDA cores in full f32 FMA (no TF32: the reference contracts in
//   f32). A block of 256 threads owns a 64 x 64 tile, 4 x 4 outputs a
//   thread, K in 16-deep slices in shared memory. Not redesigned.
//
// Arithmetic: every output is an f32 sum of products of the input values.
// In the f32 path one thread adds an output's products in k order; in the
// bf16 path the order within a 16-deep step is the tensor cores'. Either
// way equal inputs give equal bits: no atomics, no split of K.
//
// hvd_matmul encodes the tensor maps on the host (sm90.cuh: through the
// runtime's driver entry point, reused per thread), launches on the given
// stream without synchronising and returns a cudaError_t, with
// hvd_failure() naming the step that failed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum DType { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------- bf16, wgmma + TMA
constexpr int kBM = 128;           // rows of an output tile
constexpr int kBK = 64;            // k of a slab: one 128-byte swizzle row
constexpr int kBox = 64;           // columns of a B box and a store box
constexpr int kWgRows = 64;        // rows of a consumer warpgroup
constexpr int kMmThreads = 384;    // consumers 0, 1; producer warpgroup 2
constexpr int kConsumerWarps = 8;
constexpr int kBoxBytes = kBox * 64 * 2;  // a 64 x 64 bf16 box: 8 KB
constexpr int kResidentSlabs = 4;  // K <= 256 keeps B resident
constexpr int kResidentStages = 4; // a resident warpgroup's A ring

// Shared memory of the streaming kernel: a ring of kStreamStages x (A slab
// 16 KB + B slab 16 KB), and two 8 KB store boxes a consumer warpgroup.
constexpr int kStreamN = 128;
constexpr int kStreamStages = 6;
struct MmSmem {
  bf16 a[kStreamStages][kBM * kBK];
  bf16 b[kStreamStages][kStreamN / kBox][kBK * kBox];
  bf16 c[2][2][kWgRows * kBox];
  uint64_t full[kStreamStages], empty[kStreamStages];
};

// Resident B (hvd_mm_wgmma_resident): B for all of K (4 slabs x 4 boxes,
// 128 KB), a ring of 4 A slabs of 64 rows (8 KB) for each consumer
// warpgroup, and two store boxes each.
struct MmResidentSmem {
  bf16 b[kResidentSlabs][256 / kBox][kBK * kBox];
  bf16 a[2][kResidentStages][kWgRows * kBK];
  bf16 c[2][2][kWgRows * kBox];
  uint64_t full[2][kResidentStages], empty[2][kResidentStages];
  uint64_t bfull, bempty;
};

__device__ __forceinline__ void mma_k16(float (&d)[64], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void mma_k16(float (&d)[128], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 128 threads of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// The epilogue of one warpgroup's 64 x BN accumulator (rows row0 ..),
// one 64 x 64 box at a time through the warpgroup's two store boxes: a box
// is rewritten once the store before the last has read it. Sum 4 i + 2 h
// + e of the thread sits at row r + 8 h, column 8 i + 2 (lane % 4) + e:
// 16-byte chunk i % 8 of box i / 8's row, swizzled by the row's low three
// bits (TMA's 128B pattern).
template <int BN>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           bf16 (&boxes)[2][kWgRows * kBox],
                                           const CUtensorMap* mo, int n0,
                                           int row0, int wg) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  const int r = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / kBox; ++j) {
    unsigned char* const box = reinterpret_cast<unsigned char*>(boxes[j & 1]);
    if (leader) bulk_wait_read<1>();
    wg_sync(wg);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h, i = 8 * j + c;
        *reinterpret_cast<uint32_t*>(box + row * 128 +
                                     ((c ^ (row & 7)) << 4) +
                                     4 * (lane & 3)) =
            pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    wg_sync(wg);
    if (leader) {
      tma_store_2d(mo, box, n0 + j * kBox, row0);
      bulk_commit();
    }
  }
}

// Streaming: output tiles of 128 x 128, numbered M fastest; block b takes
// tiles b, b + grid, ...; both consumer warpgroups work on each tile and
// share its B slabs.
__global__ void __launch_bounds__(kMmThreads, 1)
hvd_mm_wgmma(const __grid_constant__ CUtensorMap mx,
             const __grid_constant__ CUtensorMap mw,
             const __grid_constant__ CUtensorMap mo, int M, int K, int N) {
  constexpr int BN = kStreamN, kStages = kStreamStages;
  MmSmem& s = smem_as<MmSmem>();
  const int wg = threadIdx.x >> 7;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int tiles = m_tiles * (N / BN);
  const int slabs = K / kBK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;  // slabs issued by this block, over every tile
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t % m_tiles * kBM, n0 = t / m_tiles * BN;
        for (int kb = 0; kb < slabs; ++kb, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&s.empty[st], (it / kStages - 1) & 1);
          mbar_expect_tx(&s.full[st], (kBM + BN) * kBK * 2);
          tma_load_2d(s.a[st], &mx, &s.full[st], kb * kBK, m0);
#pragma unroll
          for (int j = 0; j < BN / kBox; ++j)
            tma_load_2d(s.b[st][j], &mw, &s.full[st], n0 + j * kBox,
                        kb * kBK);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  float acc[BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t % m_tiles * kBM, n0 = t / m_tiles * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // one slab's products stay in flight while the next slab's are
    // issued; a slab's stage is released once its group is done
    for (int kb = 0; kb < slabs; ++kb, ++it) {
      const int st = it % kStages;
      mbar_wait(&s.full[st], (it / kStages) & 1);
      const uint64_t da = desc_sw128(s.a[st] + wg * kWgRows * kBK);
      const uint64_t db = desc_sw128(s.b[st][0], kBoxBytes);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k)
        mma_k16(acc, da + k * kStepK, db + k * kStepMN);
      wg_commit();
      if (kb > 0) {
        wg_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.empty[(it - 1) % kStages]);
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[(it - 1) % kStages]);
    if (m0 + wg * kWgRows < M)  // else its rows all lie past M
      store_rows<BN>(acc, s.c[wg], &mo, n0, m0 + wg * kWgRows, wg);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
}

// Resident B (BN = 256, K <= 256): block b takes the 256-wide columns b,
// b + grid, ...; for each it loads B (K x 256) once, and each consumer
// warpgroup works alone through its own 64-row tiles of the column
// (warpgroup w: tiles w, w + 2, ...) with its own ring of A slabs, so one
// warpgroup's epilogue runs while the other's wgmma chain has the tensor
// cores.
__global__ void __launch_bounds__(kMmThreads, 1)
hvd_mm_wgmma_resident(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw,
                      const __grid_constant__ CUtensorMap mo, int M, int K,
                      int N) {
  constexpr int BN = 256;
  MmResidentSmem& s = smem_as<MmResidentSmem>();
  const int wg = threadIdx.x >> 7;
  const int columns = N / BN;
  const int rows = (M + kWgRows - 1) / kWgRows;  // 64-row tiles a column
  const int slabs = K / kBK;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int i = 0; i < kResidentStages; ++i) {
        mbar_init(&s.full[w][i], 1);
        mbar_init(&s.empty[w][i], 4);  // the warpgroup's warps
      }
    mbar_init(&s.bfull, 1);
    mbar_init(&s.bempty, kConsumerWarps);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it0 = 0, it1 = 0;  // slabs issued to each warpgroup's ring
      int done = 0;          // columns whose B this block has loaded
      for (int col = blockIdx.x; col < columns; col += gridDim.x, ++done) {
        const int n0 = col * BN;
        if (done > 0) mbar_wait(&s.bempty, (done - 1) & 1);
        mbar_expect_tx(&s.bfull, K * BN * 2);
        for (int kb = 0; kb < slabs; ++kb)
#pragma unroll
          for (int j = 0; j < BN / kBox; ++j)
            tma_load_2d(s.b[kb][j], &mw, &s.bfull, n0 + j * kBox, kb * kBK);
        for (int h = 0; h < rows; ++h) {
          const int w = h & 1;
          for (int kb = 0; kb < slabs; ++kb) {
            const int it = w ? it1++ : it0++;
            const int st = it % kResidentStages;
            if (it >= kResidentStages)
              mbar_wait(&s.empty[w][st], (it / kResidentStages - 1) & 1);
            mbar_expect_tx(&s.full[w][st], kWgRows * kBK * 2);
            tma_load_2d(s.a[w][st], &mx, &s.full[w][st], kb * kBK,
                        h * kWgRows);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  float acc[BN / 2];
  int it = 0, done = 0;
  for (int col = blockIdx.x; col < columns; col += gridDim.x, ++done) {
    const int n0 = col * BN;
    mbar_wait(&s.bfull, done & 1);
    for (int h = wg; h < rows; h += 2) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < slabs; ++kb, ++it) {
        const int st = it % kResidentStages;
        mbar_wait(&s.full[wg][st], (it / kResidentStages) & 1);
        const uint64_t da = desc_sw128(s.a[wg][st]);
        const uint64_t db = desc_sw128(s.b[kb][0], kBoxBytes);
        wg_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
          mma_k16(acc, da + k * kStepK, db + k * kStepMN);
        wg_commit();
        if (kb > 0) {
          wg_wait<1>();
          __syncwarp();
          if (lane == 0)
            mbar_arrive(&s.empty[wg][(it - 1) % kResidentStages]);
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[wg][(it - 1) % kResidentStages]);
      store_rows<BN>(acc, s.c[wg], &mo, n0, h * kWgRows, wg);
    }
    __syncwarp();  // this column's B is read
    if (lane == 0) mbar_arrive(&s.bempty);
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
}

// -------------------------------------------------------------- f32, FMA
constexpr int kFmaThreads = 256;
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kFmaThreads)
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
    for (int q = 0; q < FM * FK / kFmaThreads; ++q) {
      const int e = tid + q * kFmaThreads;
      const int r = e >> 4, kk = e & 15;
      const int64_t gr = row0 + r;
      sa[kk][r] = gr < M ? x[gr * K + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < FK * FN / kFmaThreads; ++q) {
      const int e = tid + q * kFmaThreads;
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

// ------------------------------------------------------------------ host
// A row-major [rows, cols] bf16 matrix read or written in 128B-swizzled
// boxes of box_rows x 64 columns; rows past `rows` read as 0 and are not
// written.
bool matrix_map(CUtensorMap* map, const void* p, int64_t rows, int64_t cols,
                int box_rows) {
  const uint64_t key[8] = {reinterpret_cast<uint64_t>(p),
                           static_cast<uint64_t>(rows),
                           static_cast<uint64_t>(cols),
                           static_cast<uint64_t>(box_rows), 0, 0, 0, 2};
  return cached_map(map, key, [&](CUtensorMap* m) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t step[2] = {1, 1};
    return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          const_cast<void*>(p), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// Raises the kernel's shared-memory limit (once per process and kernel:
// `limit` is the caller's static), then launches it on `blocks` blocks.
template <typename Kernel>
int launch_wgmma(Kernel kernel, int smem, const cudaError_t& limit,
                 const CUtensorMap& mx, const CUtensorMap& mw,
                 const CUtensorMap& mo, int m, int k, int n, int blocks,
                 cudaStream_t st) {
  if (limit != cudaSuccess) return failed("raising the smem limit", limit);
  cudaGetLastError();  // an earlier call's error is not this launch's
  kernel<<<blocks, kMmThreads, smem, st>>>(mx, mw, mo, m, k, n);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : failed("launching the bf16 kernel", e);
}

int matmul_bf16(const void* x, const void* w, int64_t m, int64_t k,
                int64_t n, void* out, cudaStream_t st) {
  if (m > INT32_MAX || k > INT32_MAX || n > INT32_MAX)
    return failed("checking the sizes", cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return failed("finding cuTensorMapEncodeTiled", cudaErrorNotSupported);
  if (!context_bound())
    return failed("binding a context", cudaErrorInitializationError);
  const int sms = sm_count();
  if (sms <= 0) return failed("counting the SMs", cudaErrorInvalidDevice);
  const int mi = static_cast<int>(m), ki = static_cast<int>(k),
            ni = static_cast<int>(n);
  const int m_tiles = (mi + kBM - 1) / kBM;
  const int columns = ni % 256 == 0 ? ni / 256 : 0;
  // the schedule by shape (see the header)
  const bool resident = ki <= kResidentSlabs * kBK && 4 * columns >= 3 * sms;
  CUtensorMap mx, mw, mo;
  if (!matrix_map(&mx, x, m, k, resident ? kWgRows : kBM) ||
      !matrix_map(&mw, w, k, n, kBK) || !matrix_map(&mo, out, m, n, kWgRows))
    return failed("encoding a tensor map", cudaErrorInvalidValue);
  if (resident) {
    constexpr int kSmem = smem_bytes<MmResidentSmem>();
    static const cudaError_t limit = allow_smem(hvd_mm_wgmma_resident, kSmem);
    return launch_wgmma(hvd_mm_wgmma_resident, kSmem, limit, mx, mw, mo, mi,
                        ki, ni, columns < sms ? columns : sms, st);
  }
  const int tiles = m_tiles * (ni / kStreamN);
  constexpr int kSmem = smem_bytes<MmSmem>();
  static const cudaError_t limit = allow_smem(hvd_mm_wgmma, kSmem);
  return launch_wgmma(hvd_mm_wgmma, kSmem, limit, mx, mw, mo, mi, ki, ni,
                      tiles < sms ? tiles : sms, st);
}

}  // namespace

extern "C" {

// out [m, n] = x [m, k] @ w [k, n], all contiguous row-major in one dtype
// (0 = float32, 1 = bfloat16), f32 sums. k a multiple of 64, n of 128; the
// pointers 16-byte aligned. Returns a cudaError_t.
int hvd_matmul(const void* x, const void* w, int dtype, int64_t m, int64_t k,
               int64_t n, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || k <= 0 || n <= 0 || k % kBK || n % 128)
    return failed("checking the sizes", cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: {
      const dim3 grid(static_cast<unsigned>(n / FN),
                      static_cast<unsigned>((m + FM - 1) / FM));
      if (grid.y > 65535u)
        return failed("checking the sizes", cudaErrorInvalidValue);
      cudaGetLastError();
      hvd_mm_fma<<<grid, kFmaThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), m, k, n);
      const cudaError_t e = cudaGetLastError();
      return e == cudaSuccess ? 0 : failed("launching the f32 kernel", e);
    }
    case kBF16:
      return matmul_bf16(x, w, m, k, n, out, st);
  }
  return failed("checking the dtype", cudaErrorInvalidValue);
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What the last failed hvd_matmul call of this thread was doing.
const char* hvd_failure() { return g_failed; }

}  // extern "C"
