// The bf16/f16 tensor-core engine of kernel B6 (dense S * A on half inputs,
// f32 sums), and so of B7's product half.
//
// Replaces, with dense_sketch.cuh, the TPU kernel
// repro/kernels/sketch_matmul/kernel.py:27 (matmul_kernel) on half inputs,
// which accumulates an f32 output block in VMEM over a sequential m grid
// on the MXU.  out (d, n) f32 = S (d, m) * A (m, n), S already rounded to
// A's dtype by the wrapper.  The work is 2*d*m*n operations (5.2e11 at d =
// 4000, m = 2^16, n = 1000) against (d*m + m*n) * 2 + d*n * 4 bytes (0.69
// GB), so it is bound by operations: 0.53 ms on the H100's 989 TFLOP/s of
// dense bf16 tensor cores, against 7.8 ms on its 67 TFLOP/s FP32 FMA pipes
// (the route this engine replaced).  The products of bf16 or f16 inputs
// are exact in f32, so the f32 sums keep the 2*gamma_m*|S||A| bound of the
// f32 FMA route.  The design:
//
// - Products: Hopper's warpgroup MMA, wgmma.mma_async m64n256k16 with f32
//   accumulators, which alone reaches the tensor cores' full rate, both
//   operands read from shared memory through descriptors.  The engine
//   computes the transposed tile, out^T = A^T * S^T: the wgmma's A operand
//   is A^T (64 columns of A a warpgroup, 16 rows of the reduction) from A's
//   tile as it lies in memory, columns contiguous ("MN-major", transposed
//   by the instruction), and its B operand is S^T from S's tile, each row
//   of S along the reduction ("K-major").  A block owns a 256 x 128 output
//   tile (kHalfBD rows of S, kHalfBN columns of A) with two multiplying
//   warpgroups, each 64 columns by 256 rows: 128 f32 accumulators a
//   thread.  One block an SM: at d = 4000, n = 1000 the grid is 16 x 8 =
//   128 tiles on 132 SMs.  Each warpgroup waits for a stage's wgmmas
//   before it releases the slot and issues the next stage's (keeping one
//   stage in flight gained nothing: the copies bound the engine).
// - Operands arrive by TMA into a ring of kHalfStages stages of kHalfBK = 64
//   rows of the reduction (48 KiB a stage), in the 128-byte swizzle the
//   descriptors name: S's tile (256 x 64, 128 bytes a row), A's as two
//   64 x 64 boxes.  TMA writes zeros for every element outside the matrix
//   (ragged d, m, n), so the engine has no edge code; it needs 16-byte row
//   pitches, which the wrapper provides by copying an operand whose rows
//   are not (the pad is never read).  L2 promotion is 128 bytes, a row's
//   span of a stage: with 256 bytes the engine ran slower.
// - Blocks that share a row tile of S (the same blockIdx.y, consecutive
//   blockIdx.x) form a thread-block cluster of kHalfCluster, and each loads
//   1/kHalfCluster of the S tile with one multicast TMA into every block of
//   the cluster: a block reads 32 KiB a stage from L2, not 48 (without the
//   cluster, and with clusters of 4, the engine ran slower).
// - The block is warp-specialized: one thread of a producer warp issues a
//   stage's three TMA loads; the two warpgroups only multiply.  Each slot
//   has two mbarriers in every block: `full` completes when the stage's
//   bytes have landed (the producer's expect_tx, the TMA's complete_tx
//   from every block of the cluster); `empty` when every multiplying warp
//   of every block of the cluster is done with the slot (its wgmmas
//   waited for), so no block's multicast overwrites a slot a peer still
//   reads.  These handshakes carry no data of their own (TMA's complete_tx
//   and wgmma.wait_group order the bytes), so they arrive and wait at the
//   default CTA scope: with a cluster-scope release on each arrival the
//   ring ran at half the speed.
//   A grid whose n-tiles are not a multiple of the cluster is padded with
//   blocks that load and multiply but do not store.
//   scripts/half_engine_variants.py times each of these choices against
//   the engine (PERF.md).
// - The reduction may be split into P slabs (blockIdx.z), by the wrapper's
//   plan (kernels/common.py:sketch_split, a function of the shape and the
//   SM count alone).  With P > 1 each (tile, slab) block writes its f32
//   partial tile to the caller's scratch and a second kernel adds the P
//   partials in slab order.  No atomics: the result is bitwise the same
//   from run to run, and B7's B is bitwise B6's output.
// - Index arithmetic is 64-bit.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"
#include "dense_mma.cuh"  // the mbarrier and cluster helpers

namespace {

constexpr int kHalfBD = 256;    // rows of S (of out) in a block tile: the wgmma's N
constexpr int kHalfBN = 128;    // columns of A (of out) in a block tile: 64 a warpgroup
constexpr int kHalfBK = 64;     // rows of the reduction in one ring stage
constexpr int kHalfStages = 4;  // stages of the ring
constexpr int kHalfGroups = kHalfBN / 64;          // multiplying warpgroups
constexpr int kHalfMma = 128 * kHalfGroups;        // multiplying threads
constexpr int kHalfThreads = kHalfMma + 32;        // + the producer warp
constexpr int kHalfCluster = 2;                    // blocks sharing an S tile
constexpr int kHalfSRow = kHalfBK * 2;             // bytes of a row of S's tile: one swizzle span
constexpr int kHalfSBytes = kHalfBD * kHalfSRow;   // S's tile
constexpr int kHalfARow = 128;                     // bytes of a row of a box of A's tile (64 columns)
constexpr int kHalfABox = kHalfBK * kHalfARow;     // one 64-column box of A's tile
constexpr int kHalfStage = kHalfSBytes + kHalfGroups * kHalfABox;  // bytes of a stage
// the ring, then the full and the empty mbarrier of each slot; + alignment slack
constexpr size_t kHalfSmem = (size_t)kHalfStage * kHalfStages + 16 * kHalfStages + 1024;
static_assert(kHalfSRow == 128, "S's rows in the 128-byte swizzle");
static_assert(kHalfSBytes % 1024 == 0 && kHalfStage % 1024 == 0, "1024-byte aligned swizzled tiles");
static_assert(kHalfBD % (8 * kHalfCluster) == 0, "whole swizzle atoms in each block's share of S");
static_assert(kHalfBK % 16 == 0, "whole wgmmas a stage");

__device__ __forceinline__ uint32_t hmma_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA: box (x, y) of the tensor map into this block's shared `dst`
// (multicast: into the same offset of every block of `mask`), its bytes
// counted on the mbarrier `bar` at that offset.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map, int x,
                                                   int y, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(x), "r"(y)
      : "memory");
}
// This thread's arrival on this block's mbarrier `bar`, expecting `bytes`
// more of TMA traffic in the phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The descriptor of a tile for one wgmma, at shared address `addr`: rows of
// 128 bytes in the 128-byte swizzle, 1024 bytes between groups of 8 rows
// (the stride byte offset); the leading byte offset is unused with this
// swizzle and these extents.  S's tile is read K-major (addr: row 0 at the
// wgmma's first reduction element, 32 bytes a step), a box of A's tile
// MN-major (addr: the step's first reduction row, 2048 bytes a step).
__device__ __forceinline__ uint64_t hmma_desc(uint32_t addr, uint32_t group_bytes, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(group_bytes >> 4) << 32 | layout << 62;
}
__device__ __forceinline__ uint64_t desc_s(uint32_t addr) { return hmma_desc(addr, 1024, 1); }
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return hmma_desc(addr, 1024, 1); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// d (64 x 256, the warpgroup's accumulators) += A (64 x 16) * B (16 x 256),
// both from shared memory through descriptors: A "MN-major" (its 64 rows
// contiguous, transposed by the instruction), B K-major; accumulate = 0
// overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_m64n256k16<__nv_bfloat16>(float (&d)[128], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_m64n256k16<__half>(float (&d)[128], uint64_t desc_a,
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Issue the products of one ring stage (shared address st) into the
// warpgroup's accumulators, as one wgmma group; `first`: the accumulators
// start from these products.  A^T's operand is the warpgroup's 64-column
// box of A's tile: 64 bytes of its 128-byte rows along the reduction a
// wgmma (16 rows, two swizzle atoms 1024 bytes apart).
template <typename T>
__device__ __forceinline__ void hmma_stage(float (&acc)[128], uint32_t st, int group, bool first) {
  const uint32_t a_box = st + kHalfSBytes + group * kHalfABox;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHalfBK / 16; ++kk)
    wgmma_m64n256k16<T>(acc, desc_a(a_box + kk * 16 * kHalfARow), desc_s(st + kk * 32),
                        first && kk == 0 ? 0 : 1);
  wgmma_commit();
}

// out = S (d, m) * A (m, n): tile (blockIdx.y rows of S, blockIdx.x columns
// of A), reduction slab blockIdx.z of `slab` rows (a whole number of
// stages but in the last slab); with gridDim.z > 1 the tile's partial goes
// to part (row-major kHalfBD x kHalfBN, no bounds).  Blocks with
// blockIdx.x * kHalfBN >= n are the grid's padding.  Threads below
// kHalfMma multiply; thread kHalfMma issues the loads.
//  full[s]:  1 arrival (the producer's expect_tx) + the stage's bytes;
//  empty[s]: C * kHalfMma / 32 arrivals (each multiplying warp of each
//            block of the cluster).
template <typename T>
__global__ void __launch_bounds__(kHalfThreads, 1)
hmma_sketch_kernel(const __grid_constant__ CUtensorMap tmap_s,
                   const __grid_constant__ CUtensorMap tmap_a, float* __restrict__ out,
                   float* __restrict__ part, int64_t d, int64_t m, int64_t n, int64_t slab) {
  extern __shared__ __align__(16) unsigned char hmma_smem_raw[];
  const uint32_t ring = (hmma_smem(hmma_smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kHalfStage * kHalfStages, empty = full + 8 * kHalfStages;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t rank = cluster_rank(), blocks = cluster_blocks();
  const int64_t r0 = (int64_t)blockIdx.y * kHalfBD, c0 = (int64_t)blockIdx.x * kHalfBN;
  const int64_t k_begin = (int64_t)blockIdx.z * slab;
  const int64_t k_end = k_begin + slab < m ? k_begin + slab : m;
  const int64_t steps = k_end > k_begin ? cdiv(k_end - k_begin, kHalfBK) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kHalfStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, blocks * (kHalfMma / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are set before a peer's TMA signals them

  float acc[128];
  if (threadIdx.x == kHalfMma) {  // produce
    const int share = kHalfBD / (int)blocks;  // rows of the S tile this block loads for all
    const uint16_t mask = (uint16_t)((1u << blocks) - 1);
    for (int64_t g = 0; g < steps; ++g) {
      const int st = (int)(g % kHalfStages);
      // every multiplying warp of the cluster is done with stage g - kHalfStages
      if (g >= kHalfStages) mbar_wait<false>(empty + 8 * st, (uint32_t)(g / kHalfStages - 1) & 1);
      const uint32_t slot = ring + st * kHalfStage, bar = full + 8 * st;
      const int k0 = (int)(k_begin + g * kHalfBK);
      mbar_expect(bar, kHalfStage);
      const uint32_t mine = slot + rank * share * kHalfSRow;
      if (blocks > 1)
        tma_load_multicast(mine, &tmap_s, k0, (int)(r0 + rank * share), bar, mask);
      else
        tma_load(mine, &tmap_s, k0, (int)r0, bar);
#pragma unroll
      for (int h = 0; h < kHalfGroups; ++h)
        tma_load(slot + kHalfSBytes + h * kHalfABox, &tmap_a, (int)(c0 + 64 * h), k0, bar);
    }
  } else if (threadIdx.x < kHalfMma) {  // multiply
    const int group = warp / 4;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int64_t kt = 0; kt < steps; ++kt) {
      const int st = (int)(kt % kHalfStages);
      mbar_wait<false>(full + 8 * st, (uint32_t)(kt / kHalfStages) & 1);
      hmma_stage<T>(acc, ring + st * kHalfStage, group, kt == 0);
      wgmma_wait<0>();
      if (kt + kHalfStages < steps) {  // the slot is reused: tell every block this warp is done
        __syncwarp();
        if (lane < (int)blocks) mbar_arrive_cluster<false>(cluster_map(empty + 8 * st, lane));
      }
    }
  }
  // No block leaves while a peer may still load into it or arrive on its
  // barriers.
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
  if (threadIdx.x >= kHalfMma || c0 >= n) return;

  // accumulator 4j + q of this lane: out^T row (A's column) 64 group +
  // 16 (warp % 4) + lane / 4 + 8 (q / 2), column (S's row) 8 j + 2 (lane % 4) + q % 2
  const int ncol = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  const int drow = 2 * (lane % 4);
  const bool split = gridDim.z > 1;
  const int64_t tiles_x = cdiv(n, kHalfBN);
  float* tile = split ? part + (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * tiles_x +
                                blockIdx.x) * (kHalfBD * kHalfBN)
                      : nullptr;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 8 * j + drow + q % 2, c = ncol + 8 * (q / 2);
      if (split) {
        tile[r * kHalfBN + c] = acc[4 * j + q];
      } else if (r0 + r < d && c0 + c < n) {
        out[(r0 + r) * n + c0 + c] = acc[4 * j + q];
      }
    }
}

// The split's second kernel: tile blockIdx.x of `tiles` is the sum of its
// `parts` f32 partials, added in slab order.
__global__ void __launch_bounds__(256)
hmma_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t d, int64_t n,
                int64_t tiles_x, int64_t parts) {
  const int64_t tiles = gridDim.x;
  const int64_t r0 = (int64_t)(blockIdx.x / tiles_x) * kHalfBD;
  const int64_t c0 = (int64_t)(blockIdx.x % tiles_x) * kHalfBN;
  constexpr int64_t kTile = (int64_t)kHalfBD * kHalfBN;
  for (int e = threadIdx.x; e < kHalfBD * kHalfBN; e += blockDim.x) {
    const int64_t i = r0 + e / kHalfBN, j = c0 + e % kHalfBN;
    if (i >= d || j >= n) continue;
    float acc = part[(int64_t)blockIdx.x * kTile + e];
    for (int64_t p = 1; p < parts; ++p) acc += part[(p * tiles + blockIdx.x) * kTile + e];
    out[i * n + j] = acc;
  }
}

// The wrapper's split: `parts` slabs of `slab` rows covering [0, m).
inline bool hmma_valid_split(int64_t m, int64_t slab, int64_t parts, const void* scratch) {
  if (slab < kHalfBK || slab % kHalfBK != 0 || parts < 1 || parts > 65535) return false;
  if (parts > 1 && scratch == nullptr) return false;
  return m == 0 ? parts == 1 : cdiv(m, slab) == parts;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major (rows, cols) matrix with a row pitch of
// `pitch` elements, read in swizzled (box_rows, box_cols) boxes, zeros
// outside.
template <typename T>
cudaError_t half_tensor_map(CUtensorMap* map, const T* base, int64_t rows, int64_t cols,
                            int64_t pitch, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 2, const_cast<T*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// out (d, n) f32 = S (d, m) * A (m, n), S and A in T (bf16 or f16), n >= 2,
// their rows `lds` and `lda` elements apart (multiples of 8, the bases
// 16-byte aligned: TMA's rule); the sum over m in `parts` slabs of `slab`
// rows, the f32 partials in `scratch` when parts > 1.
template <typename T>
cudaError_t launch_hmma_sketch(const T* S, const T* A, float* out, float* scratch, int64_t d,
                               int64_t m, int64_t n, int64_t lds, int64_t lda, int64_t slab,
                               int64_t parts, cudaStream_t stream) {
  if (!hmma_valid_split(m, slab, parts, scratch)) return cudaErrorInvalidValue;
  if (lds < m || lda < n || lds % 8 || lda % 8 || reinterpret_cast<uintptr_t>(S) % 16 ||
      reinterpret_cast<uintptr_t>(A) % 16 || m > 2147483647 || d > 2147483647 ||
      n > 2147483647)
    return cudaErrorInvalidValue;
  const int64_t gy = cdiv(d, kHalfBD), tiles_x = cdiv(n, kHalfBN);
  const int cluster = tiles_x > 1 ? kHalfCluster : 1;
  const int64_t gx = cdiv(tiles_x, cluster) * cluster;
  if (gy > 65535 || gx * gy > 2147483647) return cudaErrorInvalidConfiguration;
  CUtensorMap tmap_s, tmap_a;
  cudaError_t err = half_tensor_map<T>(&tmap_s, S, d, m, lds, kHalfBK, kHalfBD / cluster,
                                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = half_tensor_map<T>(&tmap_a, A, m, n, lda, 64, kHalfBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = hmma_sketch_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kHalfSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)gx, (unsigned)gy, (unsigned)parts);
  config.blockDim = dim3(kHalfThreads);
  config.dynamicSmemBytes = kHalfSmem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, tmap_s, tmap_a, out, scratch, d, m, n, slab);
  if (err != cudaSuccess) return err;
  if (parts > 1)
    hmma_sum_kernel<<<(unsigned)(tiles_x * gy), 256, 0, stream>>>(scratch, out, d, n, tiles_x, parts);
  return cudaGetLastError();
}

}  // namespace
