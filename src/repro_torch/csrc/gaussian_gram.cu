// C entry for kernel B5, the fused in-kernel Gaussian apply + Gram
// (B = scale * G * A, G = B^T B); S never exists in device memory.
//
// Replaces the TPU kernel repro/kernels/tsqr/kernel.py:131
// (gaussian_gram_kernel, made by make_gaussian_gram_kernel at :121), which
// generates each S tile in VMEM, masks rows >= d, and folds the finished B
// panel into G across a sequential grid.  As for B3 and B7, a single
// Hopper launch cannot fold every panel into one G without atomics or a
// partial G per block, so this entry runs B4's kernel (which never
// generates rows >= d) to write B once, then B2's upper-tile Gram to read
// it once.  B is bitwise B4's output on the same inputs; G is exactly
// symmetric.
#include "dense_sketch.cuh"
#include "gram.cuh"

// The f64 Gram's sum over d runs in `parts` slabs of `slab` rows (the
// wrapper's split plan); with parts > 1 the partials go to `scratch`.
extern "C" int repro_gaussian_gram(int dtype, uint32_t k0, uint32_t k1, float scale,
                                   const void* A, void* B, void* G, void* scratch, int64_t d,
                                   int64_t m, int64_t n, int64_t slab, int64_t parts,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dispatch_fused_gaussian(dtype, k0, k1, scale, A, B, d, m, n, st);
  if (err != cudaSuccess) return (int)err;
  const int acc_dtype = dtype == kF64 ? kF64 : kF32;
  return (int)dispatch_gram(acc_dtype, B, G, scratch, d, n, slab, parts, st);
}
