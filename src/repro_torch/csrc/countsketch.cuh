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
#pragma once

#include "common.cuh"

namespace {

template <typename T, typename Acc>
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
  Acc acc = Acc(0);
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
                               cudaStream_t stream) {
  int tx = 1;
  while (tx < 32 && tx < n) tx *= 2;
  const int ty = 256 / tx;
  const int64_t gy = cdiv(n, tx);
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  if (d > 0 && n > 0) {
    dim3 block(tx, ty);
    dim3 grid((unsigned)cdiv(d, ty), (unsigned)gy);
    countsketch_csr_kernel<T, Acc><<<grid, block, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const int32_t*>(rows),
        static_cast<const T*>(sgn), static_cast<const int64_t*>(offsets),
        static_cast<Acc*>(out), d, n);
  }
  return cudaGetLastError();
}

// dtype code -> (input type, accumulator type): half inputs sum in f32.
inline cudaError_t dispatch_countsketch(int dtype, const void* A,
                                        const void* rows, const void* sgn,
                                        const void* offsets, void* out,
                                        int64_t d, int64_t n,
                                        cudaStream_t stream) {
  switch (dtype) {
    case kF64:
      return launch_countsketch<double, double>(A, rows, sgn, offsets, out, d, n, stream);
    case kF32:
      return launch_countsketch<float, float>(A, rows, sgn, offsets, out, d, n, stream);
    case kBF16:
      return launch_countsketch<__nv_bfloat16, float>(A, rows, sgn, offsets, out, d, n, stream);
    case kF16:
      return launch_countsketch<__half, float>(A, rows, sgn, offsets, out, d, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
