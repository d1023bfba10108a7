// CountSketch apply SA[h(i)] += s(i) * A[i] as a deterministic segmented sum.
//
// Replaces the TPU kernel repro/kernels/countsketch/kernel.py:27
// (countsketch_kernel), which recasts the scatter as a blocked one-hot
// matmul because the TPU has no scatter and no atomics.  On Hopper the
// apply is bound by reading A once (m*n elements) and writing SA once
// (d*n), so this kernel does no extra arithmetic and no atomics: the caller
// hands it a bucket -> entries CSR (a stable argsort of the entries'
// buckets, each entry's row id and weight in that order, and d+1 offsets),
// and one thread owns one (bucket, column) output.  It sums w*A[row] over
// its bucket's entries in order, so the result is bitwise the sequential
// index_add_ of the plain version: each product is rounded on its own
// (mul_rn, no FMA contraction) and the additions happen in the same order.
// The CountSketch has one +-1 entry per row (nnz = m); the sparse-sign
// sketch k per row (nnz = k*m), and the uniform-sparse sketch one entry
// with a uniform weight per row.  A warp covers consecutive columns of one
// bucket, so each row read is one coalesced segment.  Index arithmetic is
// 64-bit (m*n exceeds 2^31 at the paper's size).
//
// Fold mode (kFold) is the streaming accumulator's: each (bucket, column)
// sum starts from out[bucket, col], the state of the tiles folded so far,
// instead of from 0, and goes on in row order.  Since 0 + a = a exactly, a
// tile-by-tile fold is bitwise the one-launch apply over all rows, for any
// tiling, and bitwise the reference's row-order .at[].add fold
// (repro/streaming/accumulate.py:109-124).  It reads and writes the state
// of every bucket the tile has an entry in (d*n at most) beside the tile's
// t*n elements; a bucket with none is left as it stands, unread.
#pragma once

#include "common.cuh"

namespace {

template <typename T, typename Acc, bool kFold>
__global__ void countsketch_csr_kernel(const T* __restrict__ A,
                                       const int32_t* __restrict__ rows,
                                       const T* __restrict__ sgn,
                                       const int64_t* __restrict__ offsets,
                                       Acc* __restrict__ out, int64_t d,
                                       int64_t n) {
  const int64_t bucket = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (bucket >= d || col >= n) return;
  const int64_t lo = offsets[bucket];
  const int64_t hi = offsets[bucket + 1];
  if (kFold && lo == hi) return;  // no entry of this tile: the state stands
  Acc acc = kFold ? out[bucket * n + col] : Acc(0);
#pragma unroll 4
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t r = rows[j];
    acc += mul_rn(to_acc<Acc>(sgn[j]), to_acc<Acc>(A[r * n + col]));
  }
  out[bucket * n + col] = acc;
}

// Block shape: tx columns x ty buckets, 256 threads.  Narrow inputs (the
// right-hand side b has n = 1) give the lanes to buckets instead of idle
// columns.
template <typename T, typename Acc>
cudaError_t launch_countsketch(const void* A, const void* rows,
                               const void* sgn, const void* offsets,
                               void* out, int64_t d, int64_t n,
                               cudaStream_t stream, bool fold) {
  int tx = 1;
  while (tx < 32 && tx < n) tx *= 2;
  const int ty = 256 / tx;
  const int64_t gy = cdiv(n, tx);
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  if (d > 0 && n > 0) {
    dim3 block(tx, ty);
    dim3 grid((unsigned)cdiv(d, ty), (unsigned)gy);
    auto kernel = fold ? countsketch_csr_kernel<T, Acc, true> : countsketch_csr_kernel<T, Acc, false>;
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const int32_t*>(rows),
        static_cast<const T*>(sgn), static_cast<const int64_t*>(offsets),
        static_cast<Acc*>(out), d, n);
  }
  return cudaGetLastError();
}

// dtype code -> (input type, accumulator type): half inputs sum in f32.
// fold: start each sum from out (the streaming accumulator's state).
inline cudaError_t dispatch_countsketch(int dtype, const void* A,
                                        const void* rows, const void* sgn,
                                        const void* offsets, void* out,
                                        int64_t d, int64_t n,
                                        cudaStream_t stream, bool fold = false) {
  switch (dtype) {
    case kF64:
      return launch_countsketch<double, double>(A, rows, sgn, offsets, out, d, n, stream, fold);
    case kF32:
      return launch_countsketch<float, float>(A, rows, sgn, offsets, out, d, n, stream, fold);
    case kBF16:
      return launch_countsketch<__nv_bfloat16, float>(A, rows, sgn, offsets, out, d, n, stream, fold);
    case kF16:
      return launch_countsketch<__half, float>(A, rows, sgn, offsets, out, d, n, stream, fold);
    default:
      return cudaErrorInvalidValue;
  }
}

// The coordinate scatter of the bucket sketches: SA for a sparse A given by
// its entries (r, c, v), each adding w_j(r) * v to the cell (h_j(r), c) for
// j = 0..k-1.  It replaces no TPU kernel: the reference scatters with a jnp
// .at[].add (repro/core/sketch.py:506-518, :577-590, :641-650), and CUDA's
// index_add_ would sum it with atomics, in an order that changes from run
// to run.  The caller sorts the k*nnz products by cell (a stable sort of the
// int64 keys h*n + c in the reference's j-major, entry-order ravel, and d*n+1
// offsets; repro_torch/kernels/countsketch/ops.py:countsketch_coo_plan), and
// one thread owns one cell: it walks its segment of the permutation in that
// order, gathers the entry's row, value and weight through it (product id
// e = j*nnz + i; no permuted copy is written), rounds each product on its
// own (mul_rn) and writes the cell once, empty cells as 0.  The sum is thus
// bitwise the sequential index_add_ of the plain version on the CPU.  It is
// bound by reading the sorted products once (their id, value and weight)
// and writing the d*n cells once; the gathers of v and w are not coalesced.
template <typename T>
__global__ void coo_scatter_kernel(const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ rows,
                                   const T* __restrict__ vals,
                                   const T* __restrict__ w,
                                   const int64_t* __restrict__ offsets,
                                   T* __restrict__ out, int64_t cells,
                                   int64_t nnz, int64_t m) {
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const int64_t lo = offsets[cell];
  const int64_t hi = offsets[cell + 1];
  T acc = T(0);
  for (int64_t p = lo; p < hi; ++p) {
    const int64_t e = perm[p];
    const int64_t j = e / nnz;
    const int64_t i = e - j * nnz;
    acc += mul_rn(w[j * m + rows[i]], vals[i]);
  }
  out[cell] = acc;
}

template <typename T>
cudaError_t launch_coo_scatter(const void* perm, const void* rows,
                               const void* vals, const void* w,
                               const void* offsets, void* out, int64_t cells,
                               int64_t nnz, int64_t m, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = cdiv(cells, kThreads);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  if (cells > 0) {
    coo_scatter_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const int64_t*>(perm), static_cast<const int64_t*>(rows),
        static_cast<const T*>(vals), static_cast<const T*>(w),
        static_cast<const int64_t*>(offsets), static_cast<T*>(out), cells, nnz,
        m);
  }
  return cudaGetLastError();
}

inline cudaError_t dispatch_coo_scatter(int dtype, const void* perm,
                                        const void* rows, const void* vals,
                                        const void* w, const void* offsets,
                                        void* out, int64_t cells, int64_t nnz,
                                        int64_t m, cudaStream_t stream) {
  switch (dtype) {
    case kF64:
      return launch_coo_scatter<double>(perm, rows, vals, w, offsets, out, cells, nnz, m, stream);
    case kF32:
      return launch_coo_scatter<float>(perm, rows, vals, w, offsets, out, cells, nnz, m, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
