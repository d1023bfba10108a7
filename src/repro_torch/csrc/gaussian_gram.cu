// C entry for kernel B5, the fused in-kernel Gaussian apply + Gram
// (B = scale * G * A, G = B^T B); S never exists in device memory.
//
// Replaces the TPU kernel repro/kernels/tsqr/kernel.py:131
// (gaussian_gram_kernel, made by make_gaussian_gram_kernel at :121), which
// generates each S tile in VMEM, masks rows >= d, and folds the finished B
// panel into G across a sequential grid.  As for B3 and B7, a single
// Hopper launch cannot fold every panel into one G without atomics or a
// partial G per block, so this entry runs B4's kernel (which never
// generates rows >= d; in f64 the tensor-core engine that generates S in
// its ring, once per thread-block cluster) to write B once, then B2's
// upper-tile Gram to read it once.  Both halves are bound by operations
// (2*d*m*n for B4 against d*n*(n+1) for the Gram).  B is bitwise B4's
// output on the same inputs; G is exactly symmetric.
#include "dense_sketch.cuh"
#include "gram.cuh"

// In f64 each half runs on the tensor-core engine with its own split plan
// (slab_b/parts_b over m, slab_g/parts_g over d); the two share `scratch`,
// which the stream's order frees for the Gram once B4's partials are
// summed.
extern "C" int repro_gaussian_gram(int dtype, uint32_t k0, uint32_t k1, float scale,
                                   const void* A, void* B, void* G, void* scratch, int64_t d,
                                   int64_t m, int64_t n, int64_t slab_b, int64_t parts_b,
                                   int64_t slab_g, int64_t parts_g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_fused_gaussian(dtype, k0, k1, scale, A, B, scratch, d, m, n, slab_b,
                                            parts_b, st);
  if (err != cudaSuccess) return (int)err;
  const int acc_dtype = dtype == kF64 ? kF64 : kF32;
  return (int)dispatch_gram(acc_dtype, B, G, scratch, d, n, slab_g, parts_g, st);
}
