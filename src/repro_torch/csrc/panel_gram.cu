// C entry for kernel B2 (panel Gram); the kernel is in gram.cuh.
#include "gram.cuh"

// The f64 sum over s runs in `parts` slabs of `slab` rows (the wrapper's
// split plan); with parts > 1 the partials go to `scratch`.
extern "C" int repro_panel_gram(int dtype, const void* B, void* G, void* scratch, int64_t s,
                                int64_t n, int64_t slab, int64_t parts, void* stream) {
  return (int)dispatch_gram(dtype, B, G, scratch, s, n, slab, parts,
                            static_cast<cudaStream_t>(stream));
}
