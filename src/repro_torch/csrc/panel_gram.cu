// C entry for kernel B2 (panel Gram); the kernel is in gram.cuh.
#include "gram.cuh"

extern "C" int repro_panel_gram(int dtype, const void* B, void* G, int64_t s,
                                int64_t n, void* stream) {
  return (int)dispatch_gram(dtype, B, G, s, n,
                            static_cast<cudaStream_t>(stream));
}
