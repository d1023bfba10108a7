// C entry for kernel B4 (scale * G * A, G generated in the kernel); the
// kernel is in dense_sketch.cuh, the generator in threefry.cuh.
#include "dense_sketch.cuh"

extern "C" int repro_fused_gaussian(int dtype, uint32_t k0, uint32_t k1,
                                    float scale, const void* A, void* out,
                                    int64_t d, int64_t m, int64_t n,
                                    void* stream) {
  return (int)dispatch_fused_gaussian(dtype, k0, k1, scale, A, out, d, m, n,
                                      static_cast<cudaStream_t>(stream));
}
