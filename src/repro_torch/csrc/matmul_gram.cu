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
// In f64 each half runs on the tensor-core engine with its own split plan
// (slab_b/parts_b over m, slab_g/parts_g over d); the two share `scratch`,
// which the stream's order frees for the Gram once B6's partials are
// summed.  On bf16/f16 inputs the product half runs on B6's half engine
// (half_mma.cuh; lds and lda its operands' row pitches, slab_b/parts_b its
// split) and the Gram of the f32 B on the FMA pipes.
#include "dense_sketch.cuh"
#include "gram.cuh"

extern "C" int repro_matmul_gram(int dtype, const void* S, const void* A, void* B, void* G,
                                 void* scratch, int64_t d, int64_t m, int64_t n,
                                 int64_t slab_b, int64_t parts_b, int64_t slab_g,
                                 int64_t parts_g, int64_t lds, int64_t lda, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dispatch_sketch_matmul(dtype, S, A, B, scratch, d, m, n, slab_b, parts_b, st, lds, lda);
  if (err != cudaSuccess) return (int)err;
  // B is in the accumulation dtype: f64 for f64 input, f32 otherwise.
  const int acc_dtype = dtype == kF64 ? kF64 : kF32;
  return (int)dispatch_gram(acc_dtype, B, G, scratch, d, n, slab_g, parts_g, st);
}
