// The f32 tensor-core engines of kernels B6 (dense S * A) and B2 (the
// panel Gram B^T B), and so of B7's two halves, in split TF32 ("3xTF32").
//
// Replaces, on f32 inputs, the TPU kernels
// repro/kernels/sketch_matmul/kernel.py:27 (matmul_kernel; with
// dense_sketch.cuh), repro/kernels/tsqr/kernel.py:101 (matmul_gram_kernel;
// with matmul_gram.cu) and repro/kernels/tsqr/kernel.py:51
// (panel_gram_kernel; with gram.cuh), which accumulate an f32 output block
// in VMEM over a sequential grid on the MXU.  On the H100 the FP32 FMA
// pipes give 67 TFLOP/s and the TF32 tensor cores 495, but one TF32
// product keeps 11 significant bits of each factor.  So each factor is
// split into two TF32 values, x = big + small, and a*b is formed as
// a_big*b_small + a_small*b_big + a_big*b_big with f32 accumulators, the
// small terms first (CUTLASS's OpMultiplyAddFastF32); a_small*b_small is
// dropped.  Two splits (rna: round to nearest, ties away, to TF32's 10
// stored mantissa bits; x - big is exact in both):
// - rounded (A; the Gram's three-part split starts from it): big =
//   rna(x), small = rna(x - big); x = big + small within 2^-22 * |x|.  A
//   finite x whose rounding overflows takes big = x truncated.  A
//   non-finite x splits to (0, x), so its inf or NaN meets only the other
//   factor's big part, which has that factor's sign: an inf or NaN in A
//   gives what the plain version gives (with (x, 0) it would meet the
//   other's small part too, of its own sign, and inf - inf would give NaN).
// - truncated (S): big = x itself, which the tensor cores read as TF32 by
//   dropping its 13 low bits, and small = rna(x - x truncated); x = big +
//   small within 2^-21 * |x|, and only the small part is written.  An inf
//   or NaN in S gives NaN (its big part meets A's small part and zeros):
//   S is a sketch, always finite.
// Per product of B6 the route is off by at most about 5 * 2^-22 * |s||a|
// (2^-21 from S's small part, 2^-21 from the dropped small*small, 2^-22
// from A's small part; below f32's normal range, 2^-137 * |a| more).
// Where the tensor cores sum in f32 they truncate, so each warpgroup adds
// the products of one 32-row stage in a stage accumulator and then into
// its running sums with the FMA pipes' rounded f32 adds: the route keeps
// the 2*gamma_m*|S||A| bound of the plain version wherever m >= 10
// (5 * 2^-22 <= 2 * gamma_m); shorter sums hold it on typical data
// (chip_smoke.py drives m = 9 and 20 among its edges).  A selection (one
// +-1 a row of S) is reproduced within 2^-22 * |A| and a selection of S's
// columns (one +-1 a column of A) within 2^-21 * |S|, where one TF32
// product is off by up to 2^-11.
//
// B6 (f32, n >= 2): out (d, n) f32 = S (d, m) * A (m, n).  The work is three
// TF32 products of 2*d*m*n operations (3.1e12 at d = 4000, m = 2^16, n =
// 1000: 3.18 ms at 495 TFLOP/s) against (d*m + m*n + d*n) * 4 bytes (1.3
// GB, 0.40 ms), so it is bound by operations.  Two kernels:
// - tf32_split_t_kernel writes A^T's two parts (n x m each, rows on a
//   multiple of 4 elements) into the caller's scratch: TF32 wgmma reads its
//   shared-memory operands K-major only, and A's rows are not (its columns
//   are contiguous).  A is the smaller operand (m*n against S's d*m), so
//   the copy costs 3 * m*n * 4 bytes of traffic (0.8 GB at n = 1000).
// - tf32_sketch_kernel: the half engine's design (half_mma.cuh).  A
//   block owns a 128 x 128 tile of out (kTfBD rows of S, kTfBN columns of
//   A), two warpgroups of 64 rows each (wgmma.mma_async m64n128k8 TF32,
//   both operands from shared memory through descriptors, S's rows and
//   A^T's rows K-major in the 128-byte swizzle), one producer thread
//   loading a ring of kTfStages stages of kTfBK = 32 rows by TMA (zeros
//   outside the matrix), clusters of 2 blocks along n that multicast S's
//   tile, full/empty mbarriers at CTA scope, the reduction split into slabs
//   by the wrapper's plan (kernels/common.py:sketch_split) and the
//   partials added in slab order by hmma_sum_kernel: deterministic, no
//   atomics.  Three warps of a fourth warpgroup write S's small part for
//   each stage beside S's tile once it has landed (the same swizzled
//   layout, element by element), fence it for the tensor cores and arrive
//   on the stage's `ready` mbarrier, on which the multiplying warps wait.
//   A stage is S's tile, its small part and A^T's two parts, 16 KiB each;
//   three stages.  At d = 4000, n = 1000 the grid is 32 x 8 tiles, two
//   waves on 132 SMs.
//
// B2 (f32; also the Gram of the f32 B of B3, B5 and B7 on any input): G
// (n, n) = B^T B for B (s, n), its upper 64 x 64 tiles only, each value
// written at (i, j) and (j, i) and a diagonal tile keeping its entries
// with i <= j, so G is exactly symmetric.  Its sums may be as short as one
// row (d = 1), where 2*gamma_s*|B|^T|B| leaves one ulp: the two-part
// split's 2^-21 cannot keep that, so the Gram splits each value exactly
// into three TF32 parts and forms six products (tf32_gram_kernel).  The
// work is six TF32 products of s*n*(n+1) operations (0.049 ms at s = 4000,
// n = 1000) against (s*n + n*n) * 4 bytes (0.02 GB), bound by operations;
// it is small, so it runs mma.sync m16n8k8 TF32 with fragments loaded by
// hand: a block a tile, four warps of 32 x 32, stages of 16 rows of both
// column panels read into registers during the stage before and split once
// into shared memory (rows padded to 72 words, so a fragment load hits 32
// banks), and the sum over s cut into slabs by the wrapper's plan
// (kernels/common.py:gram_split), whose f32 partials dmma_sum_sym_kernel
// adds in slab order and mirrors.
//
// Index arithmetic is 64-bit.
#pragma once

#include "dense_mma.cuh"
#include "half_mma.cuh"

namespace {

constexpr int kTfBD = 128;    // rows of S (of out) in a block tile: 64 a warpgroup, the wgmma's M
constexpr int kTfBN = 128;    // columns of A (of out) in a block tile: the wgmma's N
constexpr int kTfBK = 32;     // rows of the reduction in one ring stage: one 128-byte row
constexpr int kTfStages = 3;  // stages of the ring
constexpr int kTfAcc = kTfBN / 2;              // accumulators a thread (64 x kTfBN a warpgroup)
constexpr int kTfGroups = kTfBD / 64;          // multiplying warpgroups
constexpr int kTfMma = 128 * kTfGroups;        // multiplying threads
constexpr int kTfSplitters = 96;               // threads writing S's small part: three warps
constexpr int kTfThreads = kTfMma + 32 + kTfSplitters;  // + the producer warp
constexpr int kTfCluster = 2;                  // blocks sharing an S tile
constexpr int kTfRow = kTfBK * 4;              // bytes of a row of every tile
constexpr int kTfTile = 128 * kTfRow;          // one tile: S's (kTfBD rows), A^T's (kTfBN rows)
// a stage: S's tile, S's small part, A^T's big part, A^T's small part
constexpr int kTfStage = 4 * kTfTile;
constexpr int kTfLoaded = 3 * kTfTile;         // bytes of a stage that TMA brings
constexpr int kTfAlign = 64;                   // elements: the scratch's sections start on 256 bytes
// the ring, then the full, ready and empty mbarrier of each slot; + alignment slack
constexpr size_t kTfSmem = (size_t)kTfStage * kTfStages + 24 * kTfStages + 1024;
static_assert(kTfRow == 128, "rows in the 128-byte swizzle");
static_assert(kTfBD == 128 && kTfBN == 128, "every tile of a stage is 128 rows");
static_assert(kTfTile % 1024 == 0 && kTfStage % 1024 == 0, "1024-byte aligned swizzled tiles");
static_assert(kTfBD % (8 * kTfCluster) == 0, "whole swizzle atoms in each block's share of S");
static_assert(kTfSmem <= 232448, "one block an SM");

// rna_tf32 on an f32 word: round to nearest, ties away from zero, at 10
// stored mantissa bits; the 13 low bits come out 0.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, rounded (see the header).
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  const uint32_t bits = __float_as_uint(x);
  if ((bits & 0x7F800000u) == 0x7F800000u) {  // inf, or NaN kept NaN in 10 mantissa bits
    big = 0u;
    small = (bits | ((bits & 0x007FFFFFu) ? 0x00400000u : 0u)) & 0xFFFFE000u;
    return;
  }
  uint32_t b = tf32_rna(bits);
  if ((b & 0x7F800000u) == 0x7F800000u) b = bits & 0xFFFFE000u;  // rounded past the largest f32
  big = b;
  small = tf32_rna(__float_as_uint(x - __uint_as_float(b)));
}

// The small part of x's truncated split (its big part is x itself); 0 for
// an inf or NaN.
__device__ __forceinline__ float tf32_small_of_truncated(float x) {
  const uint32_t bits = __float_as_uint(x);
  if ((bits & 0x7F800000u) == 0x7F800000u) return 0.0f;
  return __uint_as_float(tf32_rna(__float_as_uint(x - __uint_as_float(bits & 0xFFFFE000u))));
}

// The row pitch (elements) of A^T's parts in the scratch: a multiple of 4,
// for TMA's 16-byte rule.
__host__ __device__ __forceinline__ int64_t tf32_pitch(int64_t m) { return cdiv(m, 4) * 4; }

// A (m, n), rows `lda` apart -> A^T's parts big and small (n, m), rows
// `pitch` apart: a 32 x 32 tile a block (blockIdx.x rows of A, blockIdx.y
// columns), split as it is read and written transposed through shared
// memory.
__global__ void __launch_bounds__(256)
tf32_split_t_kernel(const float* __restrict__ A, float* __restrict__ big, float* __restrict__ small,
                    int64_t m, int64_t n, int64_t lda, int64_t pitch) {
  __shared__ uint32_t tb[32][33], ts[32][33];
  const int64_t k0 = (int64_t)blockIdx.x * 32, c0 = (int64_t)blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int64_t k = k0 + i, c = c0 + tx;
    tf32_split(k < m && c < n ? A[k * lda + c] : 0.0f, tb[i][tx], ts[i][tx]);
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int64_t c = c0 + i, k = k0 + tx;
    if (c < n && k < m) {
      big[c * pitch + k] = __uint_as_float(tb[tx][i]);
      small[c * pitch + k] = __uint_as_float(ts[tx][i]);
    }
  }
}

// d (64 x 128) += A (64 x 8) * B (8 x 128), TF32, both from shared memory
// through descriptors, K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kTfAcc], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  static_assert(kTfAcc == 64, "m64n128k8");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void mbar_arrive_local(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The producer thread: stage g of the block's slab into ring slot
// g % kTfStages, once every multiplying warp of the cluster is done with
// stage g - kTfStages; S's tile shared with the cluster by multicast.
__device__ __forceinline__ void tf32_produce(const CUtensorMap& tmap_s, const CUtensorMap& tmap_ab,
                                             const CUtensorMap& tmap_as, uint32_t ring,
                                             uint32_t full, uint32_t empty, uint32_t rank,
                                             uint32_t blocks, int64_t r0, int64_t c0,
                                             int64_t k_begin, int64_t steps) {
  const int share = kTfBD / (int)blocks;  // rows of the S tile this block loads for all
  const uint16_t mask = (uint16_t)((1u << blocks) - 1);
  for (int64_t g = 0; g < steps; ++g) {
    const int st = (int)(g % kTfStages);
    if (g >= kTfStages) mbar_wait<false>(empty + 8 * st, (uint32_t)(g / kTfStages - 1) & 1);
    const uint32_t slot = ring + st * kTfStage, bar = full + 8 * st;
    const int k0 = (int)(k_begin + g * kTfBK);
    mbar_expect(bar, kTfLoaded);
    const uint32_t mine = slot + rank * share * kTfRow;
    if (blocks > 1)
      tma_load_multicast(mine, &tmap_s, k0, (int)(r0 + rank * share), bar, mask);
    else
      tma_load(mine, &tmap_s, k0, (int)r0, bar);
    tma_load(slot + 2 * kTfTile, &tmap_ab, k0, (int)c0, bar);
    tma_load(slot + 3 * kTfTile, &tmap_as, k0, (int)c0, bar);
  }
}

// The splitting threads (t of kTfSplitters): S's small part of each stage,
// beside its tile, once the stage has landed.
__device__ __forceinline__ void tf32_split_stages(unsigned char* ring_ptr, uint32_t full,
                                                  uint32_t ready, int64_t steps, int t) {
  for (int64_t g = 0; g < steps; ++g) {
    const int st = (int)(g % kTfStages);
    mbar_wait<false>(full + 8 * st, (uint32_t)(g / kTfStages) & 1);
    const float4* src = reinterpret_cast<const float4*>(ring_ptr + st * kTfStage);
    float4* dst = reinterpret_cast<float4*>(ring_ptr + st * kTfStage + kTfTile);
    for (int e = t; e < kTfTile / 16; e += kTfSplitters) {
      const float4 v = src[e];
      dst[e] = make_float4(tf32_small_of_truncated(v.x), tf32_small_of_truncated(v.y),
                           tf32_small_of_truncated(v.z), tf32_small_of_truncated(v.w));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_local(ready + 8 * st);
  }
}

// out = S (d, m) * A (m, n) in 3xTF32, A^T's parts from tf32_split_t_kernel:
// tile (blockIdx.y rows of S, blockIdx.x columns of A), reduction slab
// blockIdx.z of `slab` rows (a whole number of stages but in the last
// slab); with gridDim.z > 1 the tile's partial goes to part (row-major
// kTfBD x kTfBN, no bounds).  Blocks with blockIdx.x * kTfBN >= n are the
// grid's padding.  Threads below kTfMma (two warpgroups) multiply; thread
// kTfMma issues the loads; the last kTfSplitters threads split S.
//  full[s]:  1 arrival (the producer's expect_tx) + the stage's TMA bytes;
//  ready[s]: kTfSplitters arrivals (S's small part written and fenced);
//  empty[s]: C * kTfMma / 32 arrivals (each multiplying warp of each
//            block of the cluster).
__global__ void __launch_bounds__(kTfThreads, 1)
tf32_sketch_kernel(const __grid_constant__ CUtensorMap tmap_s,
                   const __grid_constant__ CUtensorMap tmap_ab,
                   const __grid_constant__ CUtensorMap tmap_as, float* __restrict__ out,
                   float* __restrict__ part, int64_t d, int64_t m, int64_t n, int64_t slab) {
  extern __shared__ __align__(16) unsigned char tf_smem_raw[];
  const uint32_t raw = hmma_smem(tf_smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* const ring_ptr = tf_smem_raw + (ring - raw);
  const uint32_t full = ring + kTfStage * kTfStages, ready = full + 8 * kTfStages,
                 empty = ready + 8 * kTfStages;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t rank = cluster_rank(), blocks = cluster_blocks();
  const int64_t r0 = (int64_t)blockIdx.y * kTfBD, c0 = (int64_t)blockIdx.x * kTfBN;
  const int64_t k_begin = (int64_t)blockIdx.z * slab;
  const int64_t k_end = k_begin + slab < m ? k_begin + slab : m;
  const int64_t steps = k_end > k_begin ? cdiv(k_end - k_begin, kTfBK) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTfStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(ready + 8 * st, kTfSplitters);
      mbar_init(empty + 8 * st, blocks * (kTfMma / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are set before a peer's TMA signals them

  if (threadIdx.x >= kTfMma) {  // the producer warp, then the splitting warps
    const int t = threadIdx.x - kTfMma;
    if (t == 0)
      tf32_produce(tmap_s, tmap_ab, tmap_as, ring, full, empty, rank, blocks, r0, c0, k_begin,
                   steps);
    else if (t >= 32)
      tf32_split_stages(ring_ptr, full, ready, steps, t - 32);
    __syncwarp();
    // No block leaves while a peer may still load into it or arrive on its
    // barriers.
    cluster_sync();
    return;
  }
  const int group = warp / 4;
  float acc[kTfAcc], stage_acc[kTfAcc];
#pragma unroll
  for (int i = 0; i < kTfAcc; ++i) acc[i] = stage_acc[i] = 0.0f;
  for (int64_t kt = 0; kt < steps; ++kt) {
    const int st = (int)(kt % kTfStages);
    const uint32_t parity = (uint32_t)(kt / kTfStages) & 1;
    mbar_wait<false>(full + 8 * st, parity);
    mbar_wait<false>(ready + 8 * st, parity);
    const uint32_t s_big = ring + st * kTfStage + group * 64 * kTfRow;  // this warpgroup's rows
    const uint32_t s_small = s_big + kTfTile;
    const uint32_t a_big = ring + st * kTfStage + 2 * kTfTile, a_small = a_big + kTfTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTfBK / 8; ++kk) {
      const uint32_t k = kk * 32;  // 8 elements of a 128-byte row
      wgmma_tf32(stage_acc, desc_s(s_big + k), desc_s(a_small + k), kk > 0);
      wgmma_tf32(stage_acc, desc_s(s_small + k), desc_s(a_big + k), 1);
      wgmma_tf32(stage_acc, desc_s(s_big + k), desc_s(a_big + k), 1);
    }
    wgmma_commit();
    // Waiting for the stage's products here ran faster than leaving them in
    // flight and summing two or more stages on the tensor cores before a
    // promotion: a stage in flight holds its slot, and the ring then keeps
    // one stage fewer in hand.
    wgmma_wait<0>();
    if (kt + kTfStages < steps) {  // the slot is reused: tell every block this warp is done
      __syncwarp();
      if (lane < (int)blocks) mbar_arrive_cluster<false>(cluster_map(empty + 8 * st, lane));
    }
#pragma unroll
    for (int i = 0; i < kTfAcc; ++i) acc[i] += stage_acc[i];
  }
  cluster_sync();
  if (c0 >= n) return;

  // accumulator 4j + q of this lane: S's row 64 group + 16 (warp % 4) +
  // lane / 4 + 8 (q / 2) of the tile, A's column 8 j + 2 (lane % 4) + q % 2
  const int row = 64 * group + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const bool split = gridDim.z > 1;
  const int64_t tiles_x = cdiv(n, kTfBN);
  float* tile = split ? part + (((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * tiles_x +
                                blockIdx.x) * (kTfBD * kTfBN)
                      : nullptr;
#pragma unroll
  for (int j = 0; j < kTfAcc / 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row + 8 * (q / 2), c = 8 * j + col + q % 2;
      if (split) {
        tile[r * kTfBN + c] = acc[4 * j + q];
      } else if (r0 + r < d && c0 + c < n) {
        out[(r0 + r) * n + c0 + c] = acc[4 * j + q];
      }
    }
}

// f32 elements of the f32 engine's scratch: the partial tiles (parts > 1)
// and A^T's two parts, each section on a multiple of kTfAlign
// (kernels/common.py:sketch_split sizes the buffer the same way).
inline int64_t tf32_partials(int64_t d, int64_t n, int64_t parts) {
  return parts > 1 ? cdiv(parts * cdiv(d, kTfBD) * cdiv(n, kTfBN) * kTfBD * kTfBN, kTfAlign) * kTfAlign
                   : 0;
}

// out (d, n) f32 = S (d, m) * A (m, n) in 3xTF32, n >= 2, S's and A's rows
// `lds` and `lda` elements apart (S's a multiple of 4 and its base 16-byte
// aligned: TMA's rule); the sum over m in `parts` slabs of `slab` rows.
// `scratch` holds the f32 partials when parts > 1, then A^T's two parts.
inline cudaError_t launch_tf32_sketch(const float* S, const float* A, float* out, float* scratch,
                                      int64_t d, int64_t m, int64_t n, int64_t lds, int64_t lda,
                                      int64_t slab, int64_t parts, cudaStream_t stream) {
  if (!hmma_valid_split(m, slab, parts, scratch, kTfBK)) return cudaErrorInvalidValue;
  if (lds < m || lda < n || lds % 4 || reinterpret_cast<uintptr_t>(S) % 16 || m > 2147483647 ||
      d > 2147483647 || n > 2147483647)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaMemsetAsync(out, 0, (size_t)(d * n) * sizeof(float), stream);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int64_t gy = cdiv(d, kTfBD), tiles_x = cdiv(n, kTfBN);
  const int cluster = tiles_x > 1 ? kTfCluster : 1;
  const int64_t gx = cdiv(tiles_x, cluster) * cluster;
  if (gy > 65535 || gx * gy > 2147483647 || cdiv(n, 32) > 65535)
    return cudaErrorInvalidConfiguration;
  const int64_t pitch = tf32_pitch(m);
  float* const a_big = scratch + tf32_partials(d, n, parts);
  float* const a_small = a_big + cdiv(n * pitch, kTfAlign) * kTfAlign;
  tf32_split_t_kernel<<<dim3((unsigned)cdiv(m, 32), (unsigned)cdiv(n, 32)), 256, 0, stream>>>(
      A, a_big, a_small, m, n, lda, pitch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tmap_s, tmap_ab, tmap_as;
  err = tma_tensor_map<float>(&tmap_s, S, d, m, lds, kTfBK, kTfBD / cluster,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = tma_tensor_map<float>(&tmap_ab, a_big, n, m, pitch, kTfBK, kTfBN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = tma_tensor_map<float>(&tmap_as, a_small, n, m, pitch, kTfBK, kTfBN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tf32_sketch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTfSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)gx, (unsigned)gy, (unsigned)parts);
  config.blockDim = dim3(kTfThreads);
  config.dynamicSmemBytes = kTfSmem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, tf32_sketch_kernel, tmap_s, tmap_ab, tmap_as, out, scratch, d,
                           m, n, slab);
  if (err != cudaSuccess) return err;
  if (parts > 1)
    hmma_sum_kernel<kTfBD, kTfBN>
        <<<(unsigned)(tiles_x * gy), 256, 0, stream>>>(scratch, out, d, n, tiles_x, parts);
  return cudaGetLastError();
}

// ---- B2 in f32: the split-TF32 Gram ----------------------------------------

constexpr int kTfGramTile = 64;     // G's tiles, as B2's f64 engine
constexpr int kTfGramK = 16;        // rows of B in one stage
constexpr int kTfGramPitch = 72;    // words a staged row: fragment loads on 32 banks
constexpr int kTfGramThreads = 128;  // four warps of 32 x 32
constexpr int kTfGramLoads = 2 * kTfGramK * kTfGramTile / kTfGramThreads;  // elements a thread a stage
static_assert(kTfGramThreads == 2 * kTfGramTile, "a thread a column, two threads a row pair");

// x = x0 + x1 + x2, three TF32 values: x0 and x1 the rounded split's
// parts, x2 = x - x0 - x1 (exact: at most 3 significant bits are left in
// f32's normal range).  An inf or NaN gives (0, x, 0).
__device__ __forceinline__ void tf32_split3(float x, uint32_t& x0, uint32_t& x1, uint32_t& x2) {
  tf32_split(x, x0, x1);
  const float rest = (x - __uint_as_float(x0)) - __uint_as_float(x1);
  x2 = (__float_as_uint(x) & 0x7F800000u) == 0x7F800000u ? 0u : tf32_rna(__float_as_uint(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// G = B^T B for B (s, n) f32: upper tile blockIdx.x, slab blockIdx.z of
// `slab` rows; with gridDim.z > 1 the tile's partial goes to part
// (row-major 64 x 64).  Each stage's rows of the two column panels are
// read into registers while the tensor cores run the stage before, then
// split once into shared memory (three parts); the warps load their
// fragments of every part from there.  Each product b_i * b_j is
// x0*y0 + (x2*y0 + x0*y2 + x1*y1 + x1*y0 + x0*y1), the dropped terms below
// 2^-32 * |b_i||b_j|: x0*y0 is exact and sums on its own, the rest sums
// beside it, and the two are added by the FMA pipes, rounded, once the
// slab is done.  So a one-row B (s = 1) gives each G entry within half an
// ulp, as the plain version does, and the f32 sums keep 2*gamma_s*|B|^T|B|.
__global__ void __launch_bounds__(kTfGramThreads, 3)
tf32_gram_kernel(const float* __restrict__ B, float* __restrict__ G, float* __restrict__ part,
                 int64_t s, int64_t n, int64_t slab) {
  // [part][panel i, panel j][row][column]
  __shared__ __align__(16) uint32_t P[3][2][kTfGramK][kTfGramPitch];
  int64_t ti, tj;
  upper_tile(blockIdx.x, cdiv(n, kTfGramTile), ti, tj);
  const int64_t ci0 = ti * kTfGramTile, cj0 = tj * kTfGramTile;
  const int64_t k_begin = (int64_t)blockIdx.z * slab;
  const int64_t k_end = k_begin + slab < s ? k_begin + slab : s;
  const int64_t steps = k_end > k_begin ? cdiv(k_end - k_begin, kTfGramK) : 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wi = 32 * (warp / 2), wj = 32 * (warp % 2);

  // a thread's elements of a stage: column c of both panels, rows r0 + 2 i
  constexpr int kRows = kTfGramLoads / 2;
  const int c = threadIdx.x % kTfGramTile, rr = threadIdx.x / kTfGramTile;
  const bool in_i = ci0 + c < n, in_j = cj0 + c < n;
  float next[kTfGramLoads];
  auto fetch = [&](int64_t k0) {
    const float* row_i = B + (k0 + rr) * n + ci0 + c;
    const float* row_j = row_i + (cj0 - ci0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool in = k0 + rr + 2 * i < k_end;
      next[i] = in && in_i ? row_i[2 * i * n] : 0.0f;
      next[kRows + i] = in && in_j ? row_j[2 * i * n] : 0.0f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rr + 2 * i;
      tf32_split3(next[i], P[0][0][r][c], P[1][0][r][c], P[2][0][r][c]);
      tf32_split3(next[kRows + i], P[0][1][r][c], P[1][1][r][c], P[2][1][r][c]);
    }
  };

  float acc[2][4][4], cor[2][4][4];  // x0*y0, and the rest
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = cor[mt][nt][q] = 0.0f;

  if (steps > 0) {
    fetch(k_begin);
    stash();
  }
  for (int64_t kt = 0; kt < steps; ++kt) {
    __syncthreads();  // stage kt is in shared memory
    if (kt + 1 < steps) fetch(k_begin + (kt + 1) * kTfGramK);
#pragma unroll
    for (int kk = 0; kk < kTfGramK; kk += 8) {
      uint32_t a[3][2][4], b[3][4][2];  // [part]
#pragma unroll
      for (int h = 0; h < 3; ++h) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[h][mt][q] = P[h][0][kk + t + 4 * (q / 2)][wi + 16 * mt + g + 8 * (q % 2)];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 2; ++q) b[h][nt][q] = P[h][1][kk + t + 4 * q][wj + 8 * nt + g];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // the smaller terms first
          mma_tf32(cor[mt][nt], a[2][mt], b[0][nt][0], b[0][nt][1]);
          mma_tf32(cor[mt][nt], a[0][mt], b[2][nt][0], b[2][nt][1]);
          mma_tf32(cor[mt][nt], a[1][mt], b[1][nt][0], b[1][nt][1]);
          mma_tf32(cor[mt][nt], a[1][mt], b[0][nt][0], b[0][nt][1]);
          mma_tf32(cor[mt][nt], a[0][mt], b[1][nt][0], b[1][nt][1]);
          mma_tf32(acc[mt][nt], a[0][mt], b[0][nt][0], b[0][nt][1]);
        }
    }
    __syncthreads();  // every warp is done with stage kt
    if (kt + 1 < steps) stash();
  }

  // accumulator (mt, nt, q): row wi + 16 mt + g + 8 (q / 2), column
  // wj + 8 nt + 2 t + q % 2 of the tile
  const int64_t tile = (int64_t)blockIdx.z * gridDim.x + blockIdx.x;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wi + 16 * mt + g + 8 * (q / 2), c = wj + 8 * nt + 2 * t + q % 2;
        const float v = acc[mt][nt][q] + cor[mt][nt][q];
        if (gridDim.z > 1)
          part[tile * (kTfGramTile * kTfGramTile) + r * kTfGramTile + c] = v;
        else
          store_sym(G, n, ci0 + r, cj0 + c, ti == tj, v);
      }
}

// G (n, n) f32 = B^T B for B (s, n) f32 contiguous, its sum over s in
// `parts` slabs of `slab` rows (f32 partials in `scratch` when parts > 1).
inline cudaError_t launch_tf32_gram(const float* B, float* G, float* scratch, int64_t s,
                                    int64_t n, int64_t slab, int64_t parts, cudaStream_t stream) {
  if (n < 1) return cudaGetLastError();
  if (!hmma_valid_split(s, slab, parts, scratch, kTfGramK)) return cudaErrorInvalidValue;
  const int64_t T = cdiv(n, kTfGramTile);
  const int64_t tiles = T * (T + 1) / 2;
  if (tiles > 2147483647) return cudaErrorInvalidConfiguration;
  tf32_gram_kernel<<<dim3((unsigned)tiles, 1, (unsigned)parts), kTfGramThreads, 0, stream>>>(
      B, G, scratch, s, n, slab);
  if (parts > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dmma_sum_sym_kernel<kTfGramTile, float><<<(unsigned)tiles, 256, 0, stream>>>(scratch, G, n,
                                                                                 parts);
  }
  return cudaGetLastError();
}

}  // namespace
