// C entry for kernel B3, the fused CountSketch apply + Gram (B = SA,
// G = B^T B).
//
// Replaces the TPU kernel repro/kernels/tsqr/kernel.py:68
// (countsketch_gram_kernel), which keeps each B panel in VMEM and folds it
// into G on the panel's last grid step.  On Hopper a single launch cannot
// fold every bucket panel into one G without atomics or a partial G per
// block, so this entry runs two hand kernels back to back on one stream:
// the CountSketch segmented sum writes B (d, n) once, then the upper-tile
// Gram reads it once.  Bytes moved: A read once (m*n), the CSR read once
// (m*(4+esize) + 8*(d+1)), B written and read back once (2*d*n), G written
// once (n*n).  The read-back of B is d*n against A's m*n, 0.4% at the
// paper's size (m = 2^20, d = 4000).  Both halves are deterministic, so B
// is bitwise the plain CountSketch and G is exactly symmetric.
#include "countsketch.cuh"
#include "gram.cuh"

// The f64 Gram's sum over d runs in `parts` slabs of `slab` rows (the
// wrapper's split plan); with parts > 1 the partials go to `scratch`.
extern "C" int repro_countsketch_gram(int dtype, const void* A, const void* rows,
                                      const void* sgn, const void* offsets, void* B, void* G,
                                      void* scratch, int64_t d, int64_t n, int64_t slab,
                                      int64_t parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dispatch_countsketch(dtype, A, rows, sgn, offsets, B, d, n, st);
  if (err != cudaSuccess) return (int)err;
  // B is in the accumulation dtype: f64 for f64 input, f32 otherwise.
  const int acc_dtype = dtype == kF64 ? kF64 : kF32;
  return (int)dispatch_gram(acc_dtype, B, G, scratch, d, n, slab, parts, st);
}
