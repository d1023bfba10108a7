// C entry for kernel B6 (dense S * A); the kernel is in dense_sketch.cuh.
#include "dense_sketch.cuh"

extern "C" int repro_sketch_matmul(int dtype, const void* S, const void* A,
                                   void* out, int64_t d, int64_t m, int64_t n,
                                   void* stream) {
  return (int)dispatch_sketch_matmul(dtype, S, A, out, d, m, n,
                                     static_cast<cudaStream_t>(stream));
}
