// Check entry: the raw threefry bits of a tile of counters, from the same
// device function kernels B4 and B5 generate S with (threefry.cuh).  It is
// no kernel of any solver path; it lets a run hold the card's bits bitwise
// against the plain int64 threefry of repro_torch/kernels/common.py.
#include "common.cuh"
#include "threefry.cuh"

namespace {

__global__ void threefry_bits_kernel(uint32_t k0, uint32_t k1, int64_t row0,
                                     int64_t col0, int64_t rows, int64_t cols,
                                     uint32_t* b0, uint32_t* b1) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * cols) return;
  uint32_t x0 = (uint32_t)(row0 + e / cols);
  uint32_t x1 = (uint32_t)(col0 + e % cols);
  threefry2x32(k0, k1, x0, x1);
  b0[e] = x0;
  b1[e] = x1;
}

}  // namespace

extern "C" int repro_threefry_bits(uint32_t k0, uint32_t k1, int64_t row0,
                                   int64_t col0, int64_t rows, int64_t cols,
                                   void* b0, void* b1, void* stream) {
  const int64_t total = rows * cols;
  if (total > 0) {
    const int64_t blocks = cdiv(total, 256);
    if (blocks > 2147483647) return (int)cudaErrorInvalidConfiguration;
    threefry_bits_kernel<<<(unsigned)blocks, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        k0, k1, row0, col0, rows, cols, static_cast<uint32_t*>(b0),
        static_cast<uint32_t*>(b1));
  }
  return (int)cudaGetLastError();
}
