// Dense sketch apply out = S (d, m) * A (m, n): kernels B4 (S generated in
// the kernel) and B6 (S read from memory).
//
// Replaces the TPU kernels repro/kernels/sketch_matmul/kernel.py:27
// (matmul_kernel) and :40 (fused_gaussian_kernel), which accumulate an
// output block in VMEM over a sequential m grid on the MXU.
//
// The work is 2*d*m*n operations (5.2e11 at d = 4000, m = 2^16, n = 1000)
// against d*m + m*n + d*n elements moved (B6) or m*n + d*n (B4), so both
// are bound by operations on this card.
//
// B6 in f64 (n >= 2) runs on the FP64 tensor cores: dense_mma.cuh's engine
// with 128 x 128 block tiles, sixteen warps of 32 x 32, and a 4-stage
// cp.async ring (X = S^T, whose tile is read along m).
//
// B6 on bf16 or f16 inputs (n >= 2; f32 sums and output) runs on the bf16
// and f16 tensor cores: half_mma.cuh's engine, wgmma m64n256k16 with f32
// accumulators, both operands in shared memory, fed by multicast TMA in
// thread-block clusters of 2, 256 x 128 block tiles.  B6 in f32 (n >= 2)
// runs on the TF32 tensor cores in split TF32 (three TF32 products a
// product, within the 2*gamma_m*|S||A| bound of the f32 sums):
// tf32_mma.cuh's engine: A^T's two TF32 parts written by a first kernel,
// then the half engine's design with both operands K-major and S's small
// part written beside its tile in each stage.  B7's product half takes the
// same routes, so its B is bitwise B6's.
//
// B4 in f64 (n >= 2) runs on the same tensor cores through the engine's
// generating producer (dense_mma.cuh, dmma_gen_sketch_kernel): 96 x 128
// tiles, twelve warps of 32 x 32 that only multiply, and a warpgroup that
// generates each stage's S tile into the ring (GaussianTile's values, the
// same bits as the FMA route) and copies A's.  S is generated once per
// thread-block cluster of up to 8 blocks along n, which share it through
// distributed shared memory: at n = 1000 each element once, where the FMA
// route generated it once per n-block (8 times).  The sums of every
// tensor-core route may be split along m by the wrapper's plan; the
// partials are added in a fixed order, so the results are deterministic.
//
// B4 in f32 and on bf16/f16 inputs (f32 sums) runs dense_sketch_tile_kernel
// below on the FMA pipes: its S is generated in the loop, and the
// tensor-core route with the generating producer at those precisions is
// not written yet.  Each block owns one 128 x 128 output tile and loops
// over m itself, in chunks of 16: it stages the (128 x 16) S tile and the
// (16 x 128) A tile in shared memory and every thread keeps an 8 x 8
// register micro-tile, with the rows and columns of a micro-tile 16 apart
// so that shared-memory reads and global stores of a warp fall on
// consecutive addresses.  Each output is one FMA chain over k = 0 .. m-1
// in order: no atomics, no split of m, and the result is deterministic.
// It does not overlap the loads of the next chunk with the products of
// this one, and its S tile is stored transposed (Ss[kk][r]), so the 16
// threads of a half-warp that share a row store 128 elements apart, on
// one bank; PERF.md has its times against the bound.  Index arithmetic is
// 64-bit.
//
// The S tile of that loop comes from the template argument Src,
// GaussianTile (B4): element (i, j) from threefry2x32(k0, k1, i, col0 + j)
// and Box-Muller in f32, times the f32 scale, then cast to A's dtype (bf16
// A: S rounded to bf16, products summed in f32).  The counter is the
// reference's, so the values do not depend on the tiling.  Rows >= d and
// columns >= m are never generated.  S never reaches device memory; on
// this route each block regenerates its rows of S once for each n-block.
//
// A vector (n = 1, the right-hand side b) uses dense_sketch_vec_kernel
// instead, in every dtype, with S from either source (MatrixTile: S
// row-major in A's dtype, for B6): one warp per output row sums its row in
// a fixed lane-strided order and a fixed xor-butterfly, so b is not padded
// to a 128-wide tile.
#pragma once

#include "common.cuh"
#include "dense_mma.cuh"
#include "half_mma.cuh"
#include "tf32_mma.cuh"
#include "threefry.cuh"

namespace {

constexpr int kSketchTileD = 128;  // output rows of a block
constexpr int kSketchTileN = 128;  // output columns of a block
constexpr int kSketchTileK = 16;   // depth of one shared-memory stage
constexpr int kSketchThreads = 256;
constexpr int kSketchMicro = 8;    // 8 x 8 outputs per thread, 16 apart

// B6's f64 engine: 128 x 128 tiles, 4 x 4 warps of 32 x 32, a 4-stage
// ring, one block an SM.
constexpr int kSketchMmaTile = 128;
using SketchMma = MmaShape<kSketchMmaTile, kSketchMmaTile, 4, 4, 4, 1>;
// B4's f64 engine: 96 x 128 tiles, 3 x 4 warps of 32 x 32 beside a
// producing warpgroup, a 4-stage ring, one block an SM.
constexpr int kGaussMmaRows = 96;
using GaussianMma = MmaShape<kGaussMmaRows, kSketchMmaTile, 3, 4, 4, 1>;

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  return static_cast<T>(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename T>
struct MatrixTile {
  const T* S;  // (d, m) row-major
  int64_t m;
  template <typename Acc>
  __device__ __forceinline__ Acc at(int64_t i, int64_t j) const {
    return to_acc<Acc>(S[i * m + j]);
  }
};

template <typename T>
struct GaussianTile {
  uint32_t k0, k1;
  float scale;
  // The counter column of A's row 0: a row tile of A starting at row col0
  // meets the columns S[:, col0 : col0 + m] (the streaming accumulator's
  // tiles).  0 for the whole of A (an initializer list that stops at scale
  // leaves it 0); the wrapper keeps col0 + m <= 2^32.
  uint32_t col0;
  template <typename Acc>
  __device__ __forceinline__ Acc at(int64_t i, int64_t j) const {
    uint32_t x0 = (uint32_t)i, x1 = col0 + (uint32_t)j;
    threefry2x32(k0, k1, x0, x1);
    const float s = __fmul_rn(bits_to_gaussian(x0, x1), scale);
    return to_acc<Acc>(from_f32<T>(s));
  }
};

template <typename T, typename Acc, typename Src>
__global__ void __launch_bounds__(kSketchThreads)
dense_sketch_tile_kernel(Src src, const T* __restrict__ A,
                         Acc* __restrict__ out, int64_t d, int64_t m,
                         int64_t n) {
  __shared__ Acc Ss[kSketchTileK][kSketchTileD];  // S tile, transposed
  __shared__ Acc As[kSketchTileK][kSketchTileN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t i0 = (int64_t)blockIdx.y * kSketchTileD;
  const int64_t j0 = (int64_t)blockIdx.x * kSketchTileN;

  Acc acc[kSketchMicro][kSketchMicro];
#pragma unroll
  for (int r = 0; r < kSketchMicro; ++r)
#pragma unroll
    for (int c = 0; c < kSketchMicro; ++c) acc[r][c] = Acc(0);

  for (int64_t k0 = 0; k0 < m; k0 += kSketchTileK) {
    // S tile: consecutive threads walk along a row of S (along m).
    for (int e = threadIdx.x; e < kSketchTileK * kSketchTileD; e += kSketchThreads) {
      const int r = e / kSketchTileK;
      const int kk = e % kSketchTileK;
      const int64_t i = i0 + r;
      const int64_t k = k0 + kk;
      Ss[kk][r] = (i < d && k < m) ? src.template at<Acc>(i, k) : Acc(0);
    }
    for (int e = threadIdx.x; e < kSketchTileK * kSketchTileN; e += kSketchThreads) {
      const int kk = e / kSketchTileN;
      const int c = e % kSketchTileN;
      const int64_t k = k0 + kk;
      const int64_t j = j0 + c;
      As[kk][c] = (k < m && j < n) ? to_acc<Acc>(A[k * n + j]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSketchTileK; ++kk) {
      Acc a[kSketchMicro], b[kSketchMicro];
#pragma unroll
      for (int r = 0; r < kSketchMicro; ++r) {
        a[r] = Ss[kk][ty + 16 * r];
        b[r] = As[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < kSketchMicro; ++r)
#pragma unroll
        for (int c = 0; c < kSketchMicro; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kSketchMicro; ++r) {
    const int64_t i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < kSketchMicro; ++c) {
      const int64_t j = j0 + tx + 16 * c;
      if (i < d && j < n) out[i * n + j] = acc[r][c];
    }
  }
}

template <typename T, typename Acc, typename Src>
__global__ void __launch_bounds__(kSketchThreads)
dense_sketch_vec_kernel(Src src, const T* __restrict__ x,
                        Acc* __restrict__ out, int64_t d, int64_t m) {
  const int lane = threadIdx.x % 32;
  const int64_t i = (int64_t)blockIdx.x * (kSketchThreads / 32) + threadIdx.x / 32;
  if (i >= d) return;  // whole warps leave together
  Acc acc = Acc(0);
#pragma unroll 4
  for (int64_t j = lane; j < m; j += 32) {
    acc += src.template at<Acc>(i, j) * to_acc<Acc>(x[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = acc;
}

// The vector kernel for n = 1; nothing for d = 0 or n = 0 (n > 1 is a
// matrix, which the caller routes elsewhere).
template <typename T, typename Acc, typename Src>
cudaError_t launch_dense_vec(Src src, const void* A, void* out, int64_t d, int64_t m, int64_t n,
                             cudaStream_t stream) {
  if (d > 0 && n == 1) {
    const int64_t blocks = cdiv(d, kSketchThreads / 32);
    if (blocks > 2147483647) return cudaErrorInvalidConfiguration;
    dense_sketch_vec_kernel<T, Acc, Src><<<(unsigned)blocks, kSketchThreads, 0, stream>>>(
        src, static_cast<const T*>(A), static_cast<Acc*>(out), d, m);
  }
  return cudaGetLastError();
}

template <typename T, typename Acc, typename Src>
cudaError_t launch_dense_sketch(Src src, const void* A, void* out, int64_t d,
                                int64_t m, int64_t n, cudaStream_t stream) {
  if (d > 0 && n > 0) {
    if (n == 1) {
      return launch_dense_vec<T, Acc, Src>(src, A, out, d, m, n, stream);
    } else {
      const int64_t gy = cdiv(d, kSketchTileD);
      const int64_t gx = cdiv(n, kSketchTileN);
      if (gy > 65535 || gx > 2147483647) return cudaErrorInvalidConfiguration;
      dim3 grid((unsigned)gx, (unsigned)gy);
      dense_sketch_tile_kernel<T, Acc, Src><<<grid, kSketchThreads, 0, stream>>>(
          src, static_cast<const T*>(A), static_cast<Acc*>(out), d, m, n);
    }
  }
  return cudaGetLastError();
}

// dtype code of A -> (input type, accumulator type): half inputs sum in
// f32.  S is in A's dtype.  A matrix (d >= 1, n >= 2) goes to a tensor-core
// engine: f64 to the FP64 one, f32 to the split-TF32 one, bf16 or f16 to
// the half one, each with its sum over m cut into `parts` slabs of `slab`
// rows (partials in `scratch` when parts > 1: f64 words, read as f32 by the
// f32, bf16 and f16 engines; the f32 engine also keeps A^T's parts there).
// A vector runs the vector kernel.  lds and lda are the row pitches of S
// and A in elements: the operands that the f32 and half engines read by
// TMA may be padded to 16-byte pitches by the wrapper; every other route
// takes contiguous operands (lds = m, lda = n).
inline cudaError_t dispatch_sketch_matmul(int dtype, const void* S, const void* A, void* out,
                                          void* scratch, int64_t d, int64_t m, int64_t n,
                                          int64_t slab, int64_t parts, cudaStream_t stream,
                                          int64_t lds, int64_t lda) {
  const bool matrix = d > 0 && n > 1;
  const bool pitched = dtype == kF32 || dtype == kBF16 || dtype == kF16;
  if (!(pitched && matrix) && (lds != m || lda != n)) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF64:
      if (matrix)
        return launch_dmma_sketch<SketchMma>(
            static_cast<const double*>(S), static_cast<const double*>(A),
            static_cast<double*>(out), static_cast<double*>(scratch), d, m, n, slab, parts,
            stream);
      return launch_dense_vec<double, double>(
          MatrixTile<double>{static_cast<const double*>(S), m}, A, out, d, m, n, stream);
    case kF32:
      if (matrix)
        return launch_tf32_sketch(static_cast<const float*>(S), static_cast<const float*>(A),
                                  static_cast<float*>(out), static_cast<float*>(scratch), d, m, n,
                                  lds, lda, slab, parts, stream);
      return launch_dense_vec<float, float>(
          MatrixTile<float>{static_cast<const float*>(S), m}, A, out, d, m, n, stream);
    case kBF16:
      if (matrix)
        return launch_hmma_sketch<__nv_bfloat16>(
            static_cast<const __nv_bfloat16*>(S), static_cast<const __nv_bfloat16*>(A),
            static_cast<float*>(out), static_cast<float*>(scratch), d, m, n, lds, lda, slab, parts,
            stream);
      return launch_dense_vec<__nv_bfloat16, float>(
          MatrixTile<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(S), m}, A, out, d, m, n,
          stream);
    case kF16:
      if (matrix)
        return launch_hmma_sketch<__half>(
            static_cast<const __half*>(S), static_cast<const __half*>(A), static_cast<float*>(out),
            static_cast<float*>(scratch), d, m, n, lds, lda, slab, parts, stream);
      return launch_dense_vec<__half, float>(
          MatrixTile<__half>{static_cast<const __half*>(S), m}, A, out, d, m, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// B4: an f64 matrix goes to the tensor-core engine with the generating
// producer, clusters of gen_cluster(n) blocks, its sum over m cut into
// `parts` slabs of `slab` rows (partials in `scratch` when parts > 1).
// col0: A's row 0 meets counter column col0 (every route: the tensor-core
// engine, the FMA tile kernel and the vector kernel read S through
// GaussianTile::at).
inline cudaError_t dispatch_fused_gaussian(int dtype, uint32_t k0, uint32_t k1, float scale,
                                           const void* A, void* out, void* scratch, int64_t d,
                                           int64_t m, int64_t n, int64_t slab, int64_t parts,
                                           cudaStream_t stream, uint32_t col0 = 0) {
  switch (dtype) {
    case kF64:
      if (d > 0 && n > 1)
        return launch_dmma_gen_sketch<GaussianMma>(
            GaussianTile<double>{k0, k1, scale, col0}, static_cast<const double*>(A),
            static_cast<double*>(out), static_cast<double*>(scratch), d, m, n, slab, parts,
            gen_cluster(n, kSketchMmaTile), stream);
      return launch_dense_sketch<double, double>(
          GaussianTile<double>{k0, k1, scale, col0}, A, out, d, m, n, stream);
    case kF32:
      return launch_dense_sketch<float, float>(
          GaussianTile<float>{k0, k1, scale, col0}, A, out, d, m, n, stream);
    case kBF16:
      return launch_dense_sketch<__nv_bfloat16, float>(
          GaussianTile<__nv_bfloat16>{k0, k1, scale, col0}, A, out, d, m, n, stream);
    case kF16:
      return launch_dense_sketch<__half, float>(
          GaussianTile<__half>{k0, k1, scale, col0}, A, out, d, m, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
