// C entries for kernel B8: the Walsh-Hadamard transform and the SRHT apply
// (1/sqrt(d)) * P * H * D * A.  The kernels are in hadamard.cuh.
#include "hadamard.cuh"

namespace {

// dtype code -> (input type, accumulator type): half inputs transform in f32.
template <template <typename, typename> class Fn, typename... Args>
cudaError_t by_dtype(int dtype, Args... args) {
  switch (dtype) {
    case kF64:
      return Fn<double, double>::run(args...);
    case kF32:
      return Fn<float, float>::run(args...);
    case kBF16:
      return Fn<__nv_bfloat16, float>::run(args...);
    case kF16:
      return Fn<__half, float>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename Acc>
struct Hadamard {
  static cudaError_t run(const void* x, void* out, int64_t m, int64_t n,
                         cudaStream_t stream) {
    return hadamard_passes<T, Acc>(static_cast<const T*>(x), nullptr,
                                   static_cast<Acc*>(out), m, m, n, stream);
  }
};

template <typename T, typename Acc>
struct Srht {
  static cudaError_t run(const void* A, const void* signs, const void* rows,
                         void* buf, void* out, int64_t m, int64_t m_pad,
                         int64_t n, int64_t d, double scale,
                         cudaStream_t stream) {
    return launch_srht<T, Acc>(A, signs, rows, buf, out, m, m_pad, n, d,
                               scale, stream);
  }
};

}  // namespace

// out (m, n) = H x for x (m, n), m a power of two.
extern "C" int repro_hadamard(int dtype, const void* x, void* out, int64_t m,
                              int64_t n, void* stream) {
  return (int)by_dtype<Hadamard>(dtype, x, out, m, n,
                                 static_cast<cudaStream_t>(stream));
}

// out (d, n) = (H D [A; 0])[rows] / scale, through the (m_pad, n) scratch
// buffer buf; signs (m_pad,) and buf, out in the accumulation dtype, rows
// int64 in [0, m_pad) (a row outside it gives a NaN output row).
extern "C" int repro_srht_apply(int dtype, const void* A, const void* signs,
                                const void* rows, void* buf, void* out,
                                int64_t m, int64_t m_pad, int64_t n, int64_t d,
                                double scale, void* stream) {
  return (int)by_dtype<Srht>(dtype, A, signs, rows, buf, out, m, m_pad, n, d,
                             scale, static_cast<cudaStream_t>(stream));
}
