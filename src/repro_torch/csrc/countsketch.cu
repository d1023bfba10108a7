// C entries for kernel B1 (CountSketch apply) and the bucket sketches'
// coordinate scatter; the kernels are in countsketch.cuh.
#include "countsketch.cuh"

extern "C" int repro_countsketch_apply(int dtype, const void* A,
                                       const void* rows, const void* sgn,
                                       const void* offsets, void* out,
                                       int64_t d, int64_t n, void* stream) {
  return (int)dispatch_countsketch(dtype, A, rows, sgn, offsets, out, d, n,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int repro_coo_scatter(int dtype, const void* perm, const void* rows,
                                 const void* vals, const void* w,
                                 const void* offsets, void* out, int64_t cells,
                                 int64_t nnz, int64_t m, void* stream) {
  return (int)dispatch_coo_scatter(dtype, perm, rows, vals, w, offsets, out,
                                   cells, nnz, m,
                                   static_cast<cudaStream_t>(stream));
}
