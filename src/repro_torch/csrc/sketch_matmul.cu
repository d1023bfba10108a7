// C entry for kernel B6 (dense S * A); the kernel is in dense_sketch.cuh.
#include "dense_sketch.cuh"

// The tensor-core sums over m run in `parts` slabs of `slab` rows (the
// wrapper's split plan); with parts > 1 the partials go to `scratch`.  lds
// and lda: the row pitches of S and A in elements.
extern "C" int repro_sketch_matmul(int dtype, const void* S, const void* A, void* out,
                                   void* scratch, int64_t d, int64_t m, int64_t n,
                                   int64_t slab, int64_t parts, int64_t lds, int64_t lda,
                                   void* stream) {
  return (int)dispatch_sketch_matmul(dtype, S, A, out, scratch, d, m, n, slab, parts,
                                     static_cast<cudaStream_t>(stream), lds, lda);
}
