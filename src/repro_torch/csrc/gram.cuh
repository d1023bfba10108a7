// Panel Gram G = B^T B for a row-major B (s, n), G (n, n) in the
// accumulation dtype.
//
// Replaces the TPU kernel repro/kernels/tsqr/kernel.py:51
// (panel_gram_kernel), which accumulates B^T B over row panels held in VMEM
// across a sequential grid.  On Hopper the Gram is bound by operations
// (s*n*(n+1) multiply-adds for the symmetric result) once n is more than a
// few dozen, so both routes compute only the upper-triangle 64x64 tiles
// (ti <= tj), which halves the work of a full product, and write each
// value at (i, j) and (j, i); a diagonal tile keeps only its entries with
// i <= j.  G is therefore exactly symmetric.
//
// f64 runs on the FP64 tensor cores: dense_mma.cuh's engine with X = Y = B,
// 64 x 64 tiles, four warps of 32 x 32, a 4-stage cp.async ring and three
// blocks an SM.  At n = 1000 there are 136 upper tiles, about one per SM,
// each with s = 4000 rows to walk, so the wrapper's plan splits s into
// slabs; a second kernel adds the partials in slab order and mirrors them.
// No atomics: the result is bitwise the same from run to run.
//
// f32 (also the Gram of the f32 B of B3, B5 and B7, on f32 and on half
// inputs) runs on the TF32 tensor cores in split TF32: each value cut
// exactly into three TF32 parts, six TF32 products a product, the largest
// summed apart from the rest (tf32_mma.cuh: mma.sync m16n8k8 on fragments
// loaded by hand, the same 64 x 64 upper tiles and store, its sum over s
// split by the wrapper's plan and added in slab order), within the
// 2*gamma_s*|B|^T|B| bound of the f32 sums down to s = 1.
//
// The Gram of a bf16 or f16 B (f32 sums) runs gram_upper_kernel below on
// the FMA pipes.  Each block stages a 16-row slab of both column panels in
// shared memory and every thread keeps a 4x4 register micro-tile, with the
// rows and columns of a micro-tile 16 apart so that shared-memory reads and
// the upper-triangle stores of a warp fall on consecutive addresses.  The
// sum over s runs inside the block, in one fixed order, and the diagonal
// tiles compute (i, j) and (j, i) with the same products in the same
// order.
#pragma once

#include "common.cuh"
#include "dense_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kGramTile = 64;
constexpr int kGramK = 16;

// B2's f64 engine: 64 x 64 tiles, 2 x 2 warps of 32 x 32, a 4-stage ring,
// three blocks an SM.
constexpr int kGramMmaTile = kGramTile;
using GramMma = MmaShape<kGramMmaTile, kGramMmaTile, 2, 2, 4, 3>;

template <typename T, typename Acc>
__global__ void __launch_bounds__(256)
gram_upper_kernel(const T* __restrict__ B, Acc* __restrict__ G, int64_t s,
                  int64_t n) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (ti > tj) return;
  __shared__ Acc Pi[kGramK][kGramTile];
  __shared__ Acc Pj[kGramK][kGramTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t ci0 = (int64_t)ti * kGramTile;
  const int64_t cj0 = (int64_t)tj * kGramTile;

  Acc acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = Acc(0);

  for (int64_t k0 = 0; k0 < s; k0 += kGramK) {
    for (int e = threadIdx.x; e < kGramK * kGramTile; e += blockDim.x) {
      const int kk = e / kGramTile;
      const int c = e % kGramTile;
      const int64_t k = k0 + kk;
      const int64_t gi = ci0 + c;
      const int64_t gj = cj0 + c;
      Pi[kk][c] = (k < s && gi < n) ? to_acc<Acc>(B[k * n + gi]) : Acc(0);
      Pj[kk][c] = (k < s && gj < n) ? to_acc<Acc>(B[k * n + gj]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGramK; ++kk) {
      Acc a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = Pi[kk][ty + 16 * r];
        b[r] = Pj[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = ci0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t j = cj0 + tx + 16 * c;
      if (i < n && j < n) {
        G[i * n + j] = acc[r][c];
        if (ti != tj) G[j * n + i] = acc[r][c];
      }
    }
  }
}

template <typename T, typename Acc>
cudaError_t launch_gram(const void* B, void* G, int64_t s, int64_t n,
                        cudaStream_t stream) {
  const int64_t tiles = cdiv(n, kGramTile);
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  if (n > 0) {
    dim3 grid((unsigned)tiles, (unsigned)tiles);
    gram_upper_kernel<T, Acc><<<grid, 256, 0, stream>>>(
        static_cast<const T*>(B), static_cast<Acc*>(G), s, n);
  }
  return cudaGetLastError();
}

// dtype code of B -> (input type, accumulator type): half inputs sum in f32.
// f64 and f32 go to their tensor-core engines, each with its sum over s cut
// into `parts` slabs of `slab` rows (partials in `scratch` when parts > 1:
// f64 words, read as f32 by the f32 engine).
inline cudaError_t dispatch_gram(int dtype, const void* B, void* G, void* scratch, int64_t s,
                                 int64_t n, int64_t slab, int64_t parts, cudaStream_t stream) {
  switch (dtype) {
    case kF64:
      if (n < 1) return cudaGetLastError();
      return launch_dmma_gram<GramMma>(static_cast<const double*>(B), static_cast<double*>(G),
                                       static_cast<double*>(scratch), s, n, slab, parts, stream);
    case kF32:
      return launch_tf32_gram(static_cast<const float*>(B), static_cast<float*>(G),
                              static_cast<float*>(scratch), s, n, slab, parts, stream);
    case kBF16:
      return launch_gram<__nv_bfloat16, float>(B, G, s, n, stream);
    case kF16:
      return launch_gram<__half, float>(B, G, s, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
