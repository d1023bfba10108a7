// The f64 tensor-core tile engine of kernels B6 (dense S * A), B4 (S * A
// with S generated in the kernel) and B2 (panel Gram B^T B), and so of the
// f64 halves of B3, B5 and B7.
//
// Replaces, with dense_sketch.cuh and gram.cuh, the TPU kernels
// repro/kernels/sketch_matmul/kernel.py:27 (matmul_kernel), :40
// (fused_gaussian_kernel) and repro/kernels/tsqr/kernel.py:51
// (panel_gram_kernel), which accumulate an output block in VMEM over a
// sequential grid on the MXU (the Gaussian one generating its S tile in
// VMEM first).  B4's generating producer is described at its kernel,
// dmma_gen_sketch_kernel, below.
//
// Both products are C = sum over k of X[k, rows]^T * Y[k, cols] with the
// reduction index k running along the long axis: S (d, m) * A (m, n) has X
// = S^T (S row-major, its tile read along k), and B^T B has X = Y = B.  In
// f64 they are bound by operations (2*d*m*n = 5.2e11 at d = 4000, m = 2^16,
// n = 1000 against 2.3e9 bytes), and the H100 reaches its 67 TFLOP/s f64
// peak only through the tensor cores (DMMA), which Hopper exposes for f64
// through mma.sync alone (wgmma has no f64 form).  The design:
//
// - Products: mma.sync.m16n8k8.row.col.f64, one of the f64 shapes PTX 7.8
//   added for sm_90 (m16n8k4, k8 and k16 measured alike on the H100; k8
//   leaves registers for 16 warps a block).  Fragment layouts as in
//   CUTLASS's SM90_16x8x8_F64 traits: a[i] = X(row g + 8*(i%2), k t +
//   4*(i/2)), b[i] = Y(k t + 4*i, col g), c[q] = C(row g + 8*(q/2), col 2*t
//   + q%2), with g = lane/4, t = lane%4.  Each warp owns a 32 x 32 warp
//   tile: eight 16 x 8 accumulator tiles in registers.
// - A ring of STAGES stages in dynamic shared memory, each holding
//   kMmaStep rows of the reduction of both operands, filled by cp.async:
//   stage k + STAGES - 1 loads while stage k multiplies, with one barrier
//   per stage.  No TMA: TMA needs 16-byte global strides, and n may be odd.
//   A pair of adjacent elements is one 16-byte copy where it is 16-byte
//   aligned in memory and inside the matrix, else 8-byte copies; elements
//   outside the matrix (ragged edges of d, m, n) are zeros written into
//   shared memory, never read.  Each thread copies the same pairs of every
//   stage, so their bounds and alignment are worked out once: checked per
//   element, the copies of a stage cost more instructions than its
//   products.
// - Shared rows are padded by kMmaPad f64, so the fragment loads of each
//   half-warp fall on 16 distinct bank pairs in both layouts (k along a
//   row for S, rows along a row for A and B).
// - The reduction may be split into P slabs (blockIdx.z): a plan from the
//   Python wrapper (kernels/common.py:split_plan, a function of the shapes
//   and the SM count alone) picks P so that tiles * P fill the SMs.  With
//   P > 1 each (tile, slab) block writes its partial tile to the caller's
//   scratch and a second kernel adds the P partials in slab order.  No
//   atomics: the result is bitwise the same from run to run.
// - Index arithmetic is 64-bit.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMmaStep = 16;  // rows of the reduction in one ring stage
constexpr int kMmaPad = 4;    // f64 of padding at the end of a shared row
constexpr int kMmaK = 8;      // depth of one m16n8k8 product

// Block shape: a BM x BN output tile for WARPS_M x WARPS_N warps, a ring of
// STAGES stages, MIN_BLOCKS resident blocks an SM (for __launch_bounds__).
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MIN_BLOCKS_>
struct MmaShape {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles of a warp
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile of whole m16n8 tiles");
  static_assert(kMmaStep % kMmaK == 0, "whole products per stage");
};

// Shared-memory layout of one stage: X as [BM][kMmaStep] (X_MK, k along a
// row: S) or [kMmaStep][BM] (rows along a row: B), then Y as
// [kMmaStep][BN]; every row padded by kMmaPad.
template <class Shape, bool X_MK>
struct MmaSmem {
  static constexpr int kXLd = X_MK ? kMmaStep + kMmaPad : Shape::BM + kMmaPad;
  static constexpr int kXElems = X_MK ? Shape::BM * kXLd : kMmaStep * kXLd;
  static constexpr int kYLd = Shape::BN + kMmaPad;
  static constexpr int kStage = kXElems + kMmaStep * kYLd;
  static constexpr size_t kBytes = sizeof(double) * kStage * Shape::STAGES;
};

// One m16n8k8 f64 product on the tensor cores: c += a * b.
__device__ __forceinline__ void dmma_16x8x8(double (&c)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two adjacent elements src[0..1] into dst[0..1], of which the first
// `valid` (0, 1 or 2) lie inside the matrix; the others become 0.  `vec`:
// both inside and src 16-byte aligned, so one 16-byte copy.
__device__ __forceinline__ void copy_pair(double* dst, const double* src, int valid, bool vec) {
  if (vec) {
    cp_async_16(dst, src);
  } else if (valid == 2) {
    cp_async_8(dst, src);
    cp_async_8(dst + 1, src + 1);
  } else if (valid == 1) {
    cp_async_8(dst, src);
    dst[1] = 0.0;
  } else {
    *reinterpret_cast<double2*>(dst) = make_double2(0.0, 0.0);
  }
}

__device__ __forceinline__ int clamp_pair(int64_t left) {
  return left < 0 ? 0 : (left > 2 ? 2 : (int)left);
}

__device__ __forceinline__ bool aligned16(const double* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// An 8-byte cp.async of `bytes` (8 or 0) bytes; the rest of the 8 is zeros.
__device__ __forceinline__ void cp_async_8z(double* dst, const double* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
// A thread's share of one operand's stage: kMmaStep rows of the reduction
// [k0, k0 + kMmaStep) x COLS columns [c0, c0 + COLS) of a row-major g
// (leading dimension ld, rows along k) into s ([kMmaStep][COLS + kMmaPad]),
// for thread `tid` of THREADS.  A thread always copies the same column
// pair, kRowsPerIt rows apart, so the pair's columns inside the matrix and
// its 16-byte alignment (the rows it visits differ by an even count, and
// stages by kMmaStep rows) are worked out once; a full stage then costs one
// copy per pair.  Rows >= k_end and columns >= c_end read as zeros: stored
// (a cp.async wait and a __syncthreads cover them), or with ASYNC_ZEROS
// cp.asyncs of 0 bytes, so that an mbarrier tracking the copies covers
// every write of the stage.
template <int COLS, int THREADS, bool ASYNC_ZEROS = false>
struct KRowsCopy {
  static constexpr int kPairsPerRow = COLS / 2;
  static constexpr int kRowsPerIt = THREADS / kPairsPerRow;
  static_assert(THREADS % kPairsPerRow == 0 && kMmaStep % kRowsPerIt == 0 && kRowsPerIt % 2 == 0,
                "whole rows per pass, an even count");
  const double* g;    // the matrix: the source of a copy of 0 bytes
  const double* src;  // this thread's pair in row k = 0
  int64_t ld;
  int row, shared, valid;
  bool vec;

  __device__ __forceinline__ KRowsCopy(const double* g_, int64_t ld_, int64_t c0, int64_t c_end,
                                       int tid)
      : g(g_), ld(ld_) {
    row = tid / kPairsPerRow;
    const int c = 2 * (tid % kPairsPerRow);
    src = g + row * ld + c0 + c;
    shared = row * (COLS + kMmaPad) + c;
    valid = clamp_pair(c_end - (c0 + c));
    vec = valid == 2 && aligned16(src);
  }

  __device__ __forceinline__ void operator()(double* s, int64_t k0, int64_t k_end) const {
    const double* p = src + k0 * ld;
    const bool full = k0 + kMmaStep <= k_end;
#pragma unroll
    for (int it = 0; it < kMmaStep / kRowsPerIt; ++it) {
      const bool inside = full || k0 + row + it * kRowsPerIt < k_end;
      const int v = inside ? valid : 0;
      double* dst = s + shared + it * kRowsPerIt * (COLS + kMmaPad);
      const double* q = p + it * kRowsPerIt * ld;
      if (!ASYNC_ZEROS) {
        copy_pair(dst, q, v, v == 2 && vec);
      } else if (v == 2 && vec) {
        cp_async_16(dst, q);
      } else {
        cp_async_8z(dst, v >= 1 ? q : g, v >= 1 ? 8 : 0);
        cp_async_8z(dst + 1, v == 2 ? q + 1 : g, v == 2 ? 8 : 0);
      }
    }
  }
};

// The same for the transposed operand: ROWS rows [r0, r0 + ROWS) x
// kMmaStep columns [k0, k0 + kMmaStep) of a row-major g (columns along k)
// into s ([ROWS][kMmaStep + kMmaPad]).  Rows >= r_end and columns >= k_end
// read as zeros, stored.
template <int ROWS, int THREADS>
struct RowsKCopy {
  static constexpr int kPairsPerRow = kMmaStep / 2;
  static constexpr int kRowsPerIt = THREADS / kPairsPerRow;
  static_assert(THREADS % kPairsPerRow == 0 && ROWS % kRowsPerIt == 0 && kRowsPerIt % 2 == 0,
                "whole rows per pass, an even count");
  const double* src;  // this thread's pair in column k = 0
  int64_t ld;
  int col, shared, rows_left;
  bool vec;

  __device__ __forceinline__ RowsKCopy(const double* g, int64_t ld_, int64_t r0, int64_t r_end,
                                       int tid)
      : ld(ld_) {
    const int r = tid / kPairsPerRow;
    col = 2 * (tid % kPairsPerRow);
    src = g + (r0 + r) * ld + col;
    shared = r * (kMmaStep + kMmaPad) + col;
    const int64_t left = r_end - (r0 + r);
    rows_left = left < 0 ? 0 : (left > ROWS ? ROWS : (int)left);
    vec = aligned16(src);
  }

  __device__ __forceinline__ void operator()(double* s, int64_t k0, int64_t k_end) const {
    const double* p = src + k0;
    const int valid = k0 + kMmaStep <= k_end ? 2 : clamp_pair(k_end - (k0 + col));
#pragma unroll
    for (int it = 0; it < ROWS / kRowsPerIt; ++it) {
      const bool inside = it * kRowsPerIt < rows_left;
      copy_pair(s + shared + it * kRowsPerIt * (kMmaStep + kMmaPad), p + it * kRowsPerIt * ld,
                inside ? valid : 0, inside && valid == 2 && vec);
    }
  }
};

template <class Shape>
__device__ __forceinline__ void mma_zero(double (&acc)[Shape::MT][Shape::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < Shape::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Shape::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0;
}

// The products of one ring stage xs (X half, then the Y half at
// xs + kXElems) into the warp's accumulators.
template <class Shape, bool X_MK>
__device__ __forceinline__ void mma_stage(double (&acc)[Shape::MT][Shape::NT][4],
                                          const double* xs) {
  using Sm = MmaSmem<Shape, X_MK>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int xr = (warp / Shape::WARPS_N) * Shape::WM + g;  // this lane's first X row
  const int yc = (warp % Shape::WARPS_N) * Shape::WN + g;  // and first Y column
  const double* ys = xs + Sm::kXElems;
#pragma unroll
  for (int kk = 0; kk < kMmaStep; kk += kMmaK) {
    double b[Shape::NT][2];
#pragma unroll
    for (int nt = 0; nt < Shape::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) b[nt][i] = ys[(kk + t + 4 * i) * Sm::kYLd + yc + 8 * nt];
#pragma unroll
    for (int mt = 0; mt < Shape::MT; ++mt) {
      double a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = xr + 16 * mt + 8 * (i % 2), k = kk + t + 4 * (i / 2);
        a[i] = X_MK ? xs[r * Sm::kXLd + k] : xs[k * Sm::kXLd + r];
      }
#pragma unroll
      for (int nt = 0; nt < Shape::NT; ++nt) dmma_16x8x8(acc[mt][nt], a, b[nt]);
    }
  }
}

// The block's tile: acc = sum over k in [k_begin, k_end) of X(k, x0 + r) *
// Y(k, y0 + c).  X is S (X_MK: row r of S, ld = m, rows < x_end) or a
// (K, rows) row-major matrix (column r, columns < x_end); Y is (K, cols)
// row-major, columns < y_end.
template <class Shape, bool X_MK>
__device__ __forceinline__ void mma_block(double (&acc)[Shape::MT][Shape::NT][4], double* smem,
                                          const double* X, int64_t ldx, int64_t x0,
                                          int64_t x_end, const double* Y, int64_t ldy,
                                          int64_t y0, int64_t y_end, int64_t k_begin,
                                          int64_t k_end) {
  using Sm = MmaSmem<Shape, X_MK>;
  constexpr int kT = Shape::kThreads;
  mma_zero<Shape>(acc);

  using XCopy = std::conditional_t<X_MK, RowsKCopy<Shape::BM, kT>, KRowsCopy<Shape::BM, kT>>;
  const XCopy xcopy(X, ldx, x0, x_end, threadIdx.x);
  const KRowsCopy<Shape::BN, kT> ycopy(Y, ldy, y0, y_end, threadIdx.x);
  auto load_stage = [&](int64_t slot, int64_t k0) {
    double* xs = smem + slot * Sm::kStage;
    xcopy(xs, k0, k_end);
    ycopy(xs + Sm::kXElems, k0, k_end);
  };

  const int64_t steps = k_end > k_begin ? cdiv(k_end - k_begin, kMmaStep) : 0;
#pragma unroll
  for (int st = 0; st < Shape::STAGES - 1; ++st) {
    if (st < steps) load_stage(st, k_begin + (int64_t)st * kMmaStep);
    cp_async_commit();
  }
  for (int64_t kt = 0; kt < steps; ++kt) {
    cp_async_wait<Shape::STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int64_t next = kt + Shape::STAGES - 1;
    if (next < steps) load_stage(next % Shape::STAGES, k_begin + next * kMmaStep);
    cp_async_commit();
    mma_stage<Shape, X_MK>(acc, smem + (kt % Shape::STAGES) * Sm::kStage);
  }
  cp_async_wait<0>();
}

// Where accumulator (mt, nt, q) of this lane sits in the block tile.
template <class Shape>
__device__ __forceinline__ int acc_row(int mt, int q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / Shape::WARPS_N) * Shape::WM + 16 * mt + lane / 4 + 8 * (q / 2);
}
template <class Shape>
__device__ __forceinline__ int acc_col(int nt, int q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % Shape::WARPS_N) * Shape::WN + 8 * nt + 2 * (lane % 4) + q % 2;
}

// The block's partial tile, row-major BM x BN, into part (no bounds: the
// sum kernel drops what lies outside the output).
template <class Shape>
__device__ __forceinline__ void store_partial(const double (&acc)[Shape::MT][Shape::NT][4],
                                              double* part) {
#pragma unroll
  for (int mt = 0; mt < Shape::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Shape::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = acc_row<Shape>(mt, 2 * h), c = acc_col<Shape>(nt, 0);
        *reinterpret_cast<double2*>(part + r * Shape::BN + c) =
            make_double2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// out (rows, cols) row-major, tile at (r0, c0).
template <class Shape>
__device__ __forceinline__ void store_rect(const double (&acc)[Shape::MT][Shape::NT][4],
                                           double* out, int64_t rows, int64_t cols,
                                           int64_t r0, int64_t c0) {
#pragma unroll
  for (int mt = 0; mt < Shape::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Shape::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t i = r0 + acc_row<Shape>(mt, q), j = c0 + acc_col<Shape>(nt, q);
        if (i < rows && j < cols) out[i * cols + j] = acc[mt][nt][q];
      }
}

// G (n, n) from the upper tile (ti, tj): each value is written at (i, j)
// and (j, i); a diagonal tile keeps only its entries with i <= j, so G is
// exactly symmetric whatever the tensor cores round.
__device__ __forceinline__ void store_sym(double* G, int64_t n, int64_t i, int64_t j,
                                          bool diagonal, double v) {
  if (i < n && j < n && (!diagonal || i <= j)) {
    G[i * n + j] = v;
    G[j * n + i] = v;
  }
}

// Upper tile u of a T x T tile grid, row by row: (ti, tj) with ti <= tj.
__device__ __forceinline__ void upper_tile(int64_t u, int64_t T, int64_t& ti, int64_t& tj) {
  ti = 0;
  while (u >= T - ti) {
    u -= T - ti;
    ++ti;
  }
  tj = ti + u;
}

// out = S (d, m) * A (m, n): tile (blockIdx.y, blockIdx.x), reduction slab
// blockIdx.z of `slab` rows.
template <class Shape>
__global__ void __launch_bounds__(Shape::kThreads, Shape::MIN_BLOCKS)
dmma_sketch_kernel(const double* __restrict__ S, const double* __restrict__ A,
                   double* __restrict__ out, double* __restrict__ part, int64_t d, int64_t m,
                   int64_t n, int64_t slab) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int64_t r0 = (int64_t)blockIdx.y * Shape::BM, c0 = (int64_t)blockIdx.x * Shape::BN;
  const int64_t k_begin = (int64_t)blockIdx.z * slab;
  const int64_t k_end = k_begin + slab < m ? k_begin + slab : m;
  double acc[Shape::MT][Shape::NT][4];
  mma_block<Shape, true>(acc, reinterpret_cast<double*>(mma_smem), S, m, r0, d, A, n, c0, n,
                         k_begin, k_end);
  if (gridDim.z == 1) {
    store_rect<Shape>(acc, out, d, n, r0, c0);
  } else {
    const int64_t tile =
        ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    store_partial<Shape>(acc, part + tile * Shape::BM * Shape::BN);
  }
}

// G = B^T B for B (s, n): upper tile blockIdx.x, slab blockIdx.z.
template <class Shape>
__global__ void __launch_bounds__(Shape::kThreads, Shape::MIN_BLOCKS)
dmma_gram_kernel(const double* __restrict__ B, double* __restrict__ G,
                 double* __restrict__ part, int64_t s, int64_t n, int64_t slab) {
  static_assert(Shape::BM == Shape::BN, "square Gram tiles");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  int64_t ti, tj;
  upper_tile(blockIdx.x, cdiv(n, Shape::BM), ti, tj);
  const int64_t r0 = ti * Shape::BM, c0 = tj * Shape::BN;
  const int64_t k_begin = (int64_t)blockIdx.z * slab;
  const int64_t k_end = k_begin + slab < s ? k_begin + slab : s;
  double acc[Shape::MT][Shape::NT][4];
  mma_block<Shape, false>(acc, reinterpret_cast<double*>(mma_smem), B, n, r0, n, B, n, c0, n,
                          k_begin, k_end);
  if (gridDim.z == 1) {
#pragma unroll
    for (int mt = 0; mt < Shape::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Shape::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store_sym(G, n, r0 + acc_row<Shape>(mt, q), c0 + acc_col<Shape>(nt, q), ti == tj,
                    acc[mt][nt][q]);
  } else {
    const int64_t tile = (int64_t)blockIdx.z * gridDim.x + blockIdx.x;
    store_partial<Shape>(acc, part + tile * Shape::BM * Shape::BN);
  }
}

// The split's second kernel: tile blockIdx.x of `tiles` is the sum of its
// `parts` partials, added in slab order.
template <int BM, int BN>
__device__ __forceinline__ double sum_parts(const double* __restrict__ part, int64_t tiles,
                                            int64_t parts, int e) {
  const int64_t tile_elems = (int64_t)BM * BN;
  double acc = part[(int64_t)blockIdx.x * tile_elems + e];
  for (int64_t p = 1; p < parts; ++p) acc += part[(p * tiles + blockIdx.x) * tile_elems + e];
  return acc;
}

template <int BM, int BN>
__global__ void __launch_bounds__(256)
dmma_sum_rect_kernel(const double* __restrict__ part, double* __restrict__ out, int64_t rows,
                     int64_t cols, int64_t tiles_x, int64_t parts) {
  const int64_t r0 = (int64_t)(blockIdx.x / tiles_x) * BM;
  const int64_t c0 = (int64_t)(blockIdx.x % tiles_x) * BN;
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    const int64_t i = r0 + e / BN, j = c0 + e % BN;
    const double v = sum_parts<BM, BN>(part, gridDim.x, parts, e);
    if (i < rows && j < cols) out[i * cols + j] = v;
  }
}

template <int T>
__global__ void __launch_bounds__(256)
dmma_sum_sym_kernel(const double* __restrict__ part, double* __restrict__ G, int64_t n,
                    int64_t parts) {
  int64_t ti, tj;
  upper_tile(blockIdx.x, cdiv(n, T), ti, tj);
  for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
    const double v = sum_parts<T, T>(part, gridDim.x, parts, e);
    store_sym(G, n, ti * T + e / T, tj * T + e % T, ti == tj, v);
  }
}

// A split of a reduction of `length` rows into `parts` slabs of `slab`
// rows, the last one shorter: the plan the wrapper passes.
inline bool valid_split(int64_t length, int64_t slab, int64_t parts, const void* scratch) {
  if (slab < kMmaStep || slab % kMmaStep != 0 || parts < 1 || parts > 65535) return false;
  if (parts > 1 && scratch == nullptr) return false;
  return length == 0 ? parts == 1 : cdiv(length, slab) == parts;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class Shape>
cudaError_t launch_dmma_sketch(const double* S, const double* A, double* out, double* scratch,
                               int64_t d, int64_t m, int64_t n, int64_t slab, int64_t parts,
                               cudaStream_t stream) {
  if (!valid_split(m, slab, parts, scratch)) return cudaErrorInvalidValue;
  const int64_t gy = cdiv(d, Shape::BM), gx = cdiv(n, Shape::BN);
  if (gy > 65535 || gx * gy > 2147483647) return cudaErrorInvalidConfiguration;
  constexpr size_t kBytes = MmaSmem<Shape, true>::kBytes;
  cudaError_t err = allow_smem(dmma_sketch_kernel<Shape>, kBytes);
  if (err != cudaSuccess) return err;
  dmma_sketch_kernel<Shape><<<dim3((unsigned)gx, (unsigned)gy, (unsigned)parts),
                              Shape::kThreads, kBytes, stream>>>(S, A, out, scratch, d, m, n,
                                                                 slab);
  if (parts > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dmma_sum_rect_kernel<Shape::BM, Shape::BN>
        <<<(unsigned)(gx * gy), 256, 0, stream>>>(scratch, out, d, n, gx, parts);
  }
  return cudaGetLastError();
}

template <class Shape>
cudaError_t launch_dmma_gram(const double* B, double* G, double* scratch, int64_t s, int64_t n,
                             int64_t slab, int64_t parts, cudaStream_t stream) {
  if (!valid_split(s, slab, parts, scratch)) return cudaErrorInvalidValue;
  const int64_t T = cdiv(n, Shape::BM);
  const int64_t tiles = T * (T + 1) / 2;
  if (tiles > 2147483647) return cudaErrorInvalidConfiguration;
  constexpr size_t kBytes = MmaSmem<Shape, false>::kBytes;
  cudaError_t err = allow_smem(dmma_gram_kernel<Shape>, kBytes);
  if (err != cudaSuccess) return err;
  dmma_gram_kernel<Shape><<<dim3((unsigned)tiles, 1, (unsigned)parts), Shape::kThreads, kBytes,
                            stream>>>(B, G, scratch, s, n, slab);
  if (parts > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dmma_sum_sym_kernel<Shape::BM><<<(unsigned)tiles, 256, 0, stream>>>(scratch, G, n, parts);
  }
  return cudaGetLastError();
}


// ---- The generating producer: kernel B4's S made in the ring ---------------
//
// B4 is S (d, m) * A (m, n) with S = scale * G never in device memory: the
// X half of each ring stage is generated, element (i, k) from Src::at (the
// threefry counter (i, k) and Box-Muller, exactly as the FMA route), and
// only A's half is a cp.async.  Generating an element costs about as much
// issue as 25 of its products, so S is generated once per cluster, not
// once per n-tile: the blocks that share a row tile of S (same blockIdx.y
// and slab, consecutive blockIdx.x) form a thread-block cluster of C <=
// kGenClusterMax blocks along n.  Each block generates 1/C of each stage's
// rows and stores them, 16 bytes a thread, into that stage's slot in every
// block of the cluster through distributed shared memory.
//
// The block is warp-specialized.  Shape's warps (3 x 4 warps of 32 x 32 on
// a 96 x 128 tile for B4) only multiply; one more warpgroup produces each
// stage: it generates its share of S, releases it to the cluster, then
// issues A's copies, whose landing an mbarrier tracks.  The producer runs
// up to STAGES stages ahead, so the integer and FP32 pipes of the
// generation work while the tensor cores multiply, and no block-wide
// barrier stalls the loop.  Each slot has two mbarriers in every block:
// `full` completes when all C blocks have stored their shares (release /
// acquire at cluster scope) and this block's A has landed; `empty` when
// every multiplying warp of all C blocks is done reading it, so no block
// overwrites a peer's slot before the peer has read it.  A 96-row tile
// keeps the multiplying warps at B6's 128 registers (64 x 32 warp tiles
// for a 128-row tile spill even with setmaxnreg).  A grid whose n-tiles
// are not a multiple of C is padded with blocks that generate their share
// but neither multiply nor store.

constexpr int kGenClusterMax = 8;  // blocks of a cluster along n

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// The address of this block's shared `addr` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_store2(uint32_t addr, double a, double b) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};\n" ::"r"(addr), "d"(a), "d"(b)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t addr, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}
// One arrival on an mbarrier of any block of the cluster; the writes that
// precede it (this block's, through the __syncthreads before it) are
// released to the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait for the phase of parity `parity` of this block's mbarrier `addr`.
// A phase that has not completed after kBarrierTimeoutNs is a fault of
// the protocol: the launch fails rather than hanging the card.
constexpr uint64_t kBarrierTimeoutNs = 10000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
}

constexpr int kGenGroup = 128;  // threads of the producing warpgroup

// An arrival on this block's mbarrier `bar` once this thread's cp.asyncs
// so far have landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Dynamic shared memory of the generating engine: the ring, then the full
// and the empty mbarrier of each slot.
template <class Shape>
struct GenSmem {
  static constexpr size_t kRing = MmaSmem<Shape, true>::kBytes;
  static constexpr size_t kBytes = kRing + 2 * Shape::STAGES * sizeof(uint64_t);
  static constexpr int kThreads = Shape::kThreads + kGenGroup;
};

// out = S (d, m) * A (m, n) with S(i, k) = src.at(i, k): tile (blockIdx.y,
// blockIdx.x), reduction slab blockIdx.z of `slab` rows; blocks with
// blockIdx.x * BN >= n are the grid's padding.  Shape's warps multiply;
// the last warpgroup produces each stage: it generates this block's share
// of S's half into every block of the cluster, then copies A's half.  No
// block-wide barrier inside the loop: each role waits only on the slots'
// mbarriers.
//  full[s]:  C arrivals (one per block of the cluster, after its share of
//            S is stored) + kGenGroup (this block's copies of A, as they
//            land);
//  empty[s]: C * (Shape's warps) arrivals (each multiplying warp of each
//            block, when it is done reading the slot).
template <class Shape, class Src>
__global__ void __launch_bounds__(GenSmem<Shape>::kThreads, 1)
dmma_gen_sketch_kernel(Src src, const double* __restrict__ A, double* __restrict__ out,
                       double* __restrict__ part, int64_t d, int64_t m, int64_t n,
                       int64_t slab) {
  using Sm = MmaSmem<Shape, true>;
  constexpr int kS = Shape::STAGES, kMma = Shape::kThreads, kMmaWarps = kMma / 32;
  constexpr int kPairs = kMmaStep / 2;  // pairs of k in a row of one stage
  extern __shared__ __align__(16) unsigned char mma_smem[];
  double* smem = reinterpret_cast<double*>(mma_smem);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + (uint32_t)GenSmem<Shape>::kRing, empty = full + 8 * kS;
  const uint32_t rank = cluster_rank(), blocks = cluster_blocks();

  const int64_t r0 = (int64_t)blockIdx.y * Shape::BM, c0 = (int64_t)blockIdx.x * Shape::BN;
  const bool active = c0 < n;
  const int64_t k_begin = (int64_t)blockIdx.z * slab;
  const int64_t k_end = k_begin + slab < m ? k_begin + slab : m;
  const int64_t steps = k_end > k_begin ? cdiv(k_end - k_begin, kMmaStep) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, blocks + kGenGroup);
      mbar_init(empty + 8 * s, blocks * kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are set before a peer uses them

  if (threadIdx.x >= kMma) {  // produce
    const int t = threadIdx.x - kMma;
    const KRowsCopy<Shape::BN, kGenGroup, true> acopy(A, n, c0, n, t);
    // Rows [row_lo, row_hi) of each stage's S tile, as pairs of adjacent
    // k: eight threads cover a row's 16 doubles, 128 contiguous bytes, so
    // the 16-byte stores of a quarter-warp fall on distinct banks.
    const int share = (Shape::BM + (int)blocks - 1) / (int)blocks;
    const int row_lo = (int)rank * share < Shape::BM ? (int)rank * share : Shape::BM;
    const int row_hi = row_lo + share < Shape::BM ? row_lo + share : Shape::BM;
    const int pairs = (row_hi - row_lo) * kPairs;
    for (int64_t g = 0; g < steps; ++g) {
      const int s = (int)(g % kS);
      // every block of the cluster is done with stage g - kS, the slot's last use
      if (g >= kS) mbar_wait(empty + 8 * s, (uint32_t)(g / kS - 1) & 1);
      const int64_t k0 = k_begin + g * kMmaStep;
      const uint32_t slot = ring + (uint32_t)(sizeof(double) * s * Sm::kStage);
      for (int p = t; p < pairs; p += kGenGroup) {
        const int r = row_lo + p / kPairs, kk = 2 * (p % kPairs);
        const int64_t i = r0 + r;
        // Both values without a branch around them, so that their chains
        // overlap: rows >= d and columns >= k_end are zeros, generated
        // from a counter inside S and dropped.
        double v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool inside = i < d && k0 + kk + e < k_end;
          const double x = src.template at<double>(inside ? i : 0, inside ? k0 + kk + e : 0);
          v[e] = inside ? x : 0.0;
        }
        const uint32_t at = slot + (uint32_t)(sizeof(double) * (r * Sm::kXLd + kk));
        for (uint32_t q = 0; q < blocks; ++q) cluster_store2(cluster_map(at, q), v[0], v[1]);
      }
      // The group's stores are done; one thread a block releases them to
      // it.  The release waits for this thread's memory operations, so A's
      // copies of the stage are issued after it.
      asm volatile("bar.sync 1, %0;\n" ::"n"(kGenGroup) : "memory");
      if (t < (int)blocks) mbar_arrive_cluster(cluster_map(full + 8 * s, t));
      acopy(smem + s * Sm::kStage + Sm::kXElems, k0, k_end);
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {  // multiply
    const int lane = threadIdx.x % 32;
    double acc[Shape::MT][Shape::NT][4];
    mma_zero<Shape>(acc);
    for (int64_t kt = 0; kt < steps; ++kt) {
      const int s = (int)(kt % kS);
      mbar_wait(full + 8 * s, (uint32_t)(kt / kS) & 1);  // all C shares and A landed
      if (active) mma_stage<Shape, true>(acc, smem + s * Sm::kStage);
      if (kt + kS < steps) {  // the slot is reused: tell every block this warp is done
        __syncwarp();
        if (lane < (int)blocks) mbar_arrive_cluster(cluster_map(empty + 8 * s, lane));
      }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (active) {
      if (gridDim.z == 1) {
        store_rect<Shape>(acc, out, d, n, r0, c0);
      } else {
        const int64_t tiles_x = cdiv(n, Shape::BN);
        const int64_t tile =
            ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * tiles_x + blockIdx.x;
        store_partial<Shape>(acc, part + tile * Shape::BM * Shape::BN);
      }
    }
  }
  // No block leaves while a peer may still store to it or arrive on its
  // barriers.
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Blocks of the generating engine's cluster for n output columns: the
// n-tiles that share a row tile of S, in the fewest groups of at most
// kGenClusterMax, as even as possible (kernels/common.py:gen_cluster).
inline int gen_cluster(int64_t n, int64_t tile) {
  const int64_t tiles = n > tile ? cdiv(n, tile) : 1;
  return (int)cdiv(tiles, cdiv(tiles, kGenClusterMax));
}

template <class Shape>
cudaLaunchConfig_t gen_config(int64_t gx, int64_t gy, int64_t parts, cudaLaunchAttribute* attr,
                              int cluster, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)gx, (unsigned)gy, (unsigned)parts);
  config.blockDim = dim3(GenSmem<Shape>::kThreads);
  config.dynamicSmemBytes = GenSmem<Shape>::kBytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// out = S * A through the generating engine with clusters of `cluster`
// blocks; the sum over m in `parts` slabs of `slab` rows, as for B6.  A
// refused cluster launch returns its error: there is no other route.
template <class Shape, class Src>
cudaError_t launch_dmma_gen_sketch(Src src, const double* A, double* out, double* scratch,
                                   int64_t d, int64_t m, int64_t n, int64_t slab, int64_t parts,
                                   int cluster, cudaStream_t stream) {
  if (!valid_split(m, slab, parts, scratch)) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kGenClusterMax) return cudaErrorInvalidValue;
  const int64_t gy = cdiv(d, Shape::BM), tiles_x = cdiv(n, Shape::BN);
  const int64_t gx = cdiv(tiles_x, cluster) * cluster;
  if (gy > 65535 || gx * gy > 2147483647) return cudaErrorInvalidConfiguration;
  auto kernel = dmma_gen_sketch_kernel<Shape, Src>;
  cudaError_t err = allow_smem(kernel, GenSmem<Shape>::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = gen_config<Shape>(gx, gy, parts, &attr, cluster, stream);
  err = cudaLaunchKernelEx(&config, kernel, src, A, out, scratch, d, m, n, slab);
  if (err != cudaSuccess) return err;
  if (parts > 1)
    dmma_sum_rect_kernel<Shape::BM, Shape::BN>
        <<<(unsigned)(tiles_x * gy), 256, 0, stream>>>(scratch, out, d, n, tiles_x, parts);
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of the generating engine, with its
// shared memory, can be resident on the card at once.
template <class Shape, class Src>
cudaError_t dmma_gen_clusters(int cluster, int* count) {
  if (cluster < 1 || cluster > kGenClusterMax) return cudaErrorInvalidValue;
  auto kernel = dmma_gen_sketch_kernel<Shape, Src>;
  cudaError_t err = allow_smem(kernel, GenSmem<Shape>::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = gen_config<Shape>(cluster, 1, 1, &attr, cluster, nullptr);
  return cudaOccupancyMaxActiveClusters(count, kernel, &config);
}

}  // namespace
