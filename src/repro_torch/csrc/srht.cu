// C entries for kernel B8: the Walsh-Hadamard transform and the SRHT apply
// (1/sqrt(d)) * P * H * D * A.  The kernel is in hadamard.cuh.
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
    return launch_transform<T, Acc>(x, out, m, n, stream);
  }
};

template <typename T, typename Acc>
struct Srht {
  static cudaError_t run(const void* A, const void* mask, const void* g_rows,
                         const void* g_index, const void* g_offsets, void* buf, void* out,
                         int64_t m, int64_t m_pad, int64_t n, int64_t d, int64_t w,
                         double scale, cudaStream_t stream) {
    return launch_srht<T, Acc>(A, mask, g_rows, g_index, g_offsets, buf, out, m, m_pad, n, d,
                               w, scale, stream);
  }
};

}  // namespace

// out (m, n) = H x for x (m, n), m a power of two, out in the accumulation
// dtype (also the intermediate between passes).
extern "C" int repro_hadamard(int dtype, const void* x, void* out, int64_t m,
                              int64_t n, void* stream) {
  return (int)by_dtype<Hadamard>(dtype, x, out, m, n,
                                 static_cast<cudaStream_t>(stream));
}

// out (d, n) = (H D [A; 0])[rows] / scale in panels of w columns: mask
// holds D's sign bits in the first pass's order; g_rows, g_index (d,) and
// g_offsets (groups of the last pass + 2,) the gather list of rows (a row
// outside [0, m_pad) gives a NaN output row); buf (m_pad, min(w, n)) in the
// accumulation dtype (null for m_pad <= 2^10, one pass).
extern "C" int repro_srht_apply(int dtype, const void* A, const void* mask,
                                const void* g_rows, const void* g_index,
                                const void* g_offsets, void* buf, void* out, int64_t m,
                                int64_t m_pad, int64_t n, int64_t d, int64_t w, double scale,
                                void* stream) {
  return (int)by_dtype<Srht>(dtype, A, mask, g_rows, g_index, g_offsets, buf, out, m, m_pad,
                             n, d, w, scale, static_cast<cudaStream_t>(stream));
}
