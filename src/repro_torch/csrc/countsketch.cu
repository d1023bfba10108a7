// C entry for kernel B1 (CountSketch apply); the kernel is in countsketch.cuh.
#include "countsketch.cuh"

extern "C" int repro_countsketch_apply(int dtype, const void* A,
                                       const void* rows, const void* sgn,
                                       const void* offsets, void* out,
                                       int64_t d, int64_t n, void* stream) {
  return (int)dispatch_countsketch(dtype, A, rows, sgn, offsets, out, d, n,
                                   static_cast<cudaStream_t>(stream));
}
