// C entry for kernel B7, the fused dense-sketch apply + Gram (B = S A,
// G = B^T B).
//
// Replaces the TPU kernel repro/kernels/tsqr/kernel.py:101
// (matmul_gram_kernel), which keeps each B panel in VMEM and folds it into
// G on the panel's last grid step, carrying G across a sequential grid.  On
// Hopper a single launch cannot fold every panel into one G without atomics
// or a partial G per block (blocks run in parallel, in no order), so this
// entry runs two hand kernels back to back on one stream: B6's tiled
// product writes B (d, n) once, then B2's upper-tile Gram reads it once.
// The read-back of B is d*n elements against the d*m + m*n the product
// reads (0.3% at d = 4000, m = 2^16, n = 1000).  Both halves are
// deterministic, so B is bitwise B6's output and G is exactly symmetric.
#include "dense_sketch.cuh"
#include "gram.cuh"

extern "C" int repro_matmul_gram(int dtype, const void* S, const void* A,
                                 void* B, void* G, int64_t d, int64_t m,
                                 int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_sketch_matmul(dtype, S, A, B, d, m, n, st);
  if (err != cudaSuccess) return (int)err;
  // B is in the accumulation dtype: f64 for f64 input, f32 otherwise.
  const int acc_dtype = dtype == kF64 ? kF64 : kF32;
  return (int)dispatch_gram(acc_dtype, B, G, d, n, st);
}
