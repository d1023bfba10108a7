// C entries for kernel B4 (scale * G * A, G generated in the kernel).
//
// Replaces the TPU kernel repro/kernels/sketch_matmul/kernel.py:40
// (fused_gaussian_kernel), which generates each S tile in VMEM and
// accumulates the output block on the MXU over a sequential m grid.  B4 is
// bound by operations (2*d*m*n = 5.2e11 at d = 4000, m = 2^16, n = 1000
// against m*n + d*n elements moved), and generating S anew for every
// output tile adds 2.1e9 threefry + Box-Muller evaluations at that shape
// (2.6e8 once per cluster).  In f64 (n >= 2) the
// kernel is dense_mma.cuh's dmma_gen_sketch_kernel: the products on the
// FP64 tensor cores, S generated by a producing warpgroup into the ring,
// once per thread-block cluster along n; the other dtypes and the vector
// b stay on dense_sketch.cuh's FMA kernels.  The generator is in
// threefry.cuh.
#include "dense_sketch.cuh"

// The f64 sum over m runs in `parts` slabs of `slab` rows (the wrapper's
// split plan); with parts > 1 the partials go to `scratch`.
extern "C" int repro_fused_gaussian(int dtype, uint32_t k0, uint32_t k1, float scale,
                                    const void* A, void* out, void* scratch, int64_t d,
                                    int64_t m, int64_t n, int64_t slab, int64_t parts,
                                    void* stream) {
  return (int)dispatch_fused_gaussian(dtype, k0, k1, scale, A, out, scratch, d, m, n, slab,
                                      parts, static_cast<cudaStream_t>(stream));
}

// The same with A's rows meeting the counter columns col0 .. col0 + m - 1 of
// S: a row tile of a streamed A (the streaming accumulator's Gaussian fold).
// col0 = 0 is the entry above, bitwise.
extern "C" int repro_fused_gaussian_cols(int dtype, uint32_t k0, uint32_t k1, uint32_t col0,
                                         float scale, const void* A, void* out, void* scratch,
                                         int64_t d, int64_t m, int64_t n, int64_t slab,
                                         int64_t parts, void* stream) {
  return (int)dispatch_fused_gaussian(dtype, k0, k1, scale, A, out, scratch, d, m, n, slab,
                                      parts, static_cast<cudaStream_t>(stream), col0);
}

// Check entries, on no solver path.  repro_gaussian_engine runs B4's f64
// engine on A (m, n), n >= 2, with clusters of `cluster` blocks and the
// sum over m in one slab, so a run can time the design at C = 1 (each
// block generates its whole S tile) beside the C that B4 plans.
// repro_gaussian_clusters reports how many clusters of `cluster` blocks of
// that engine can be resident on the current device at once.
extern "C" int repro_gaussian_engine(uint32_t k0, uint32_t k1, float scale, const void* A,
                                     void* out, int64_t d, int64_t m, int64_t n, int cluster,
                                     void* stream) {
  if (d < 1 || n < 2) return (int)cudaErrorInvalidValue;
  const int64_t slab = m > kMmaStep ? cdiv(m, kMmaStep) * kMmaStep : kMmaStep;
  return (int)launch_dmma_gen_sketch<GaussianMma>(
      GaussianTile<double>{k0, k1, scale}, static_cast<const double*>(A),
      static_cast<double*>(out), nullptr, d, m, n, slab, 1, cluster,
      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_gaussian_clusters(int cluster, int* count) {
  return (int)dmma_gen_clusters<GaussianMma, GaussianTile<double>>(cluster, count);
}
