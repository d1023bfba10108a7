// C entries for kernel B1 (CountSketch apply, and its fold mode for the
// streaming accumulator) and the bucket sketches' coordinate scatter; the
// kernels are in countsketch.cuh.
#include "countsketch.cuh"

extern "C" int repro_countsketch_apply(int dtype, const void* A,
                                       const void* rows, const void* sgn,
                                       const void* offsets, void* out,
                                       int64_t d, int64_t n, void* stream) {
  return (int)dispatch_countsketch(dtype, A, rows, sgn, offsets, out, d, n,
                                   static_cast<cudaStream_t>(stream));
}

// Fold mode: out (d, n) holds the state and each sum starts from it.
extern "C" int repro_countsketch_fold(int dtype, const void* A,
                                      const void* rows, const void* sgn,
                                      const void* offsets, void* out,
                                      int64_t d, int64_t n, void* stream) {
  return (int)dispatch_countsketch(dtype, A, rows, sgn, offsets, out, d, n,
                                   static_cast<cudaStream_t>(stream), true);
}

// The coordinate scatter over a plan grouped by bucket: by row (rowptr
// given; items the bucket CSR's int32 rows, item_w their weights) or by
// product (rowptr NULL; items the int64 product ids, w the (k, m) weights).
extern "C" int repro_coo_scatter(int dtype, const void* offsets, const void* items,
                                 const void* item_w, const void* rowptr, const void* rows,
                                 const void* cols, const void* vals, const void* w, void* out,
                                 int64_t d, int64_t n, int64_t nnz, int64_t m, void* stream) {
  return (int)dispatch_coo_scatter(dtype, offsets, items, item_w, rowptr, rows, cols, vals, w,
                                   out, d, n, nnz, m, static_cast<cudaStream_t>(stream));
}
