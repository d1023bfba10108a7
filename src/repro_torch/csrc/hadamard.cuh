// Unnormalized Walsh-Hadamard transform along axis 0 as radix-2 butterflies
// (kernel B8; the SRHT's transform).
//
// Replaces the TPU kernels repro/kernels/srht/kernel.py:25
// (block_hadamard_kernel) and :32 (cross_hadamard_kernel), which turn the
// transform into two dense +-1 matmuls (H_c within blocks of c <= 1024 rows,
// then H_r across them) because strided butterflies fit badly in VMEM.
// That costs m*(r+c) multiply-adds per column.  On Hopper the transform is
// bound by memory traffic (m*log2(m) adds per column against 8 bytes read
// per element in f64), so this kernel keeps the butterflies.
//
// Bit order.  The stages run from the highest bit of the row index down to
// bit 0, and each stage maps a pair (a = x[i], b = x[i + h]) with bit h of
// i clear to (a + b, a - b): the stage loop of the plain version
// (repro_torch/kernels/srht/ref.py:fwht) in the same order.  Every output is
// therefore the same sequence of correctly rounded adds, and the kernel is
// bitwise equal to the plain version, on the card and on the CPU.
//
// Passes.  The p = log2(m_pad) bits are split into passes of at most
// kHadMaxBits bits, highest bits first.  A pass over bits [lo, lo + G) gives
// each group of 2^G rows {base + k * 2^lo : k < 2^G} (the other bits fixed)
// to one block, for a slice of W columns that are contiguous in the
// row-major matrix.  The block runs the G stages in two rounds of
// butterflies held in registers: round 1 the high half of the bits (each
// thread owns the 2^Q1 rows that differ in them), then an exchange through
// shared memory, then round 2 the low half.  A pass reads and writes each
// element once.  At m = 2^20 two passes of 10 bits run: the first reads A
// (rows 2^10 apart), applies the signs D as it loads and reads rows >= m as
// zeros, so no padded or signed copy of A is made; it writes an (m_pad, n)
// scratch buffer that the second pass (contiguous rows) transforms in
// place.  Bytes moved: A read once, the buffer written, read and written
// once more (~4*m*n elements against the 1*m*n floor).
//
// Shapes.  A block has W * gpb = kHadLanes column-groups: W columns of
// gpb groups, so the vector b (n = 1) stacks 8 groups in a block instead of
// leaving 7 of 8 lanes idle.  The exchange pads one row every 2^Q2 rows so
// that round 2's reads fall on distinct banks.  Index arithmetic is 64-bit.
#pragma once

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kHadMaxBits = 10;  // rows of one pass's group: up to 2^10
constexpr int kHadLanes = 8;     // columns x groups of one block

template <int G>
struct HadShape {
  static constexpr int Q1 = (G + 1) / 2;  // bits of round 1 (the high half)
  static constexpr int Q2 = G / 2;        // bits of round 2 (the low half)
  static constexpr int TPC = 1 << Q1;     // threads per column of a group
  static constexpr int ROWS = 1 << G;
  static constexpr int PADDED = ROWS + (ROWS >> Q2);  // one pad row per 2^Q2
};

// The Q stages of bits Q-1 .. 0 of the local index, highest first.
template <typename Acc, int Q>
__device__ __forceinline__ void butterflies(Acc (&v)[1 << Q]) {
#pragma unroll
  for (int t = Q - 1; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < (1 << Q); ++i) {
      if (!(i & (1 << t))) {
        const Acc a = v[i];
        const Acc b = v[i + (1 << t)];
        v[i] = a + b;
        v[i + (1 << t)] = a - b;
      }
    }
  }
}

// One pass: the stages of bits [lo_bit, lo_bit + G).  src is A (type T,
// m_src rows; rows >= m_src read as zero) on the first pass and the buffer
// (dst itself, m_src = m_pad) on the others; signs (length m_pad, or null)
// multiply each row as it is read.
template <typename T, typename Acc, int G>
__global__ void __launch_bounds__(kHadLanes * HadShape<G>::TPC)
    hadamard_pass_kernel(const T* src, const Acc* __restrict__ signs, Acc* dst,
                         int64_t m_src, int64_t n, int lo_bit, int64_t groups,
                         int64_t chunks) {
  using S = HadShape<G>;
  extern __shared__ __align__(16) unsigned char had_smem[];
  const int W = blockDim.x;
  const int c = threadIdx.x, y = threadIdx.y, z = threadIdx.z;
  const int64_t chunk = blockIdx.x % chunks;
  const int64_t grp = (int64_t)(blockIdx.x / chunks) * blockDim.z + z;
  const int64_t col = chunk * W + c;
  const bool live = grp < groups && col < n;
  const int64_t low_mask = ((int64_t)1 << lo_bit) - 1;
  const int64_t base = ((grp & ~low_mask) << G) | (grp & low_mask);
  Acc* tile = reinterpret_cast<Acc*>(had_smem) + (int64_t)z * S::PADDED * W;

  // Round 1: thread y owns local rows (j << Q2) | y, j < 2^Q1.
  if (y < (1 << S::Q2)) {
    Acc v[1 << S::Q1];
#pragma unroll
    for (int j = 0; j < (1 << S::Q1); ++j) {
      const int64_t k = ((int64_t)j << S::Q2) | y;
      const int64_t row = base + (k << lo_bit);
      Acc x = Acc(0);
      if (live) {
        if (row < m_src) x = to_acc<Acc>(src[row * n + col]);
        if (signs != nullptr) x = signs[row] * x;
      }
      v[j] = x;
    }
    butterflies<Acc, S::Q1>(v);
#pragma unroll
    for (int j = 0; j < (1 << S::Q1); ++j) {
      const int k = (j << S::Q2) | y;
      tile[(k + j) * W + c] = v[j];  // k >> Q2 == j: the pad row
    }
  }
  __syncthreads();

  // Round 2: thread y owns local rows (y << Q2) | j, j < 2^Q2.
  Acc u[1 << S::Q2];
#pragma unroll
  for (int j = 0; j < (1 << S::Q2); ++j) {
    const int k = (y << S::Q2) | j;
    u[j] = tile[(k + y) * W + c];
  }
  butterflies<Acc, S::Q2>(u);
  if (live) {
#pragma unroll
    for (int j = 0; j < (1 << S::Q2); ++j) {
      const int64_t k = ((int64_t)y << S::Q2) | j;
      dst[(base + (k << lo_bit)) * n + col] = u[j];
    }
  }
}

template <typename T, typename Acc, int G>
cudaError_t launch_hadamard_pass(const T* src, const Acc* signs, Acc* dst,
                                 int64_t m_src, int64_t m_pad, int64_t n,
                                 int lo_bit, cudaStream_t stream) {
  using S = HadShape<G>;
  int W = kHadLanes;  // columns of a block; narrow inputs stack groups
  while (W > 1 && W / 2 >= n) W /= 2;
  const int gpb = kHadLanes / W;
  const int64_t groups = m_pad >> G;
  const int64_t chunks = cdiv(n, W);
  const int64_t blocks = chunks * cdiv(groups, gpb);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kHadLanes * S::PADDED * sizeof(Acc);
  auto kernel = hadamard_pass_kernel<T, Acc, G>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 block(W, S::TPC, gpb);
  kernel<<<(unsigned)blocks, block, smem, stream>>>(
      src, signs, dst, m_src, n, lo_bit, groups, chunks);
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t dispatch_hadamard_pass(int G, const T* src, const Acc* signs,
                                   Acc* dst, int64_t m_src, int64_t m_pad,
                                   int64_t n, int lo_bit,
                                   cudaStream_t stream) {
#define REPRO_HAD_CASE(g)                                                  \
  case g:                                                                  \
    return launch_hadamard_pass<T, Acc, g>(src, signs, dst, m_src, m_pad, \
                                           n, lo_bit, stream);
  switch (G) {
    REPRO_HAD_CASE(0)
    REPRO_HAD_CASE(1)
    REPRO_HAD_CASE(2)
    REPRO_HAD_CASE(3)
    REPRO_HAD_CASE(4)
    REPRO_HAD_CASE(5)
    REPRO_HAD_CASE(6)
    REPRO_HAD_CASE(7)
    REPRO_HAD_CASE(8)
    REPRO_HAD_CASE(9)
    REPRO_HAD_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_HAD_CASE
}

// out (m_pad, n) = H * D * [x; 0]: x has m rows, signs (m_pad,) or null.
// The passes split p = log2(m_pad) bits as evenly as they can, highest
// bits first; out may not alias x.
template <typename T, typename Acc>
cudaError_t hadamard_passes(const T* x, const Acc* signs, Acc* out, int64_t m,
                            int64_t m_pad, int64_t n, cudaStream_t stream) {
  if (m_pad <= 0 || (m_pad & (m_pad - 1)) || m > m_pad) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0) return cudaGetLastError();
  int p = 0;
  while (((int64_t)1 << p) < m_pad) ++p;
  int passes = (int)cdiv(p, kHadMaxBits);
  if (passes < 1) passes = 1;
  int left = p;  // bits not yet transformed: [0, left)
  for (int i = 0; i < passes; ++i) {
    const int G = (int)cdiv(left, passes - i);
    left -= G;
    cudaError_t err =
        i == 0 ? dispatch_hadamard_pass<T, Acc>(G, x, signs, out, m, m_pad, n,
                                                left, stream)
               : dispatch_hadamard_pass<Acc, Acc>(G, out, nullptr, out, m_pad,
                                                  m_pad, n, left, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// out (d, n) = hx[rows] / scale: the SRHT's row sample P and its 1/sqrt(d),
// as a division (not a product with the reciprocal), as the plain version.
// A row outside [0, m_pad) gives a NaN row rather than an out-of-bounds read.
template <typename Acc>
__global__ void srht_gather_kernel(const Acc* __restrict__ hx,
                                   const int64_t* __restrict__ rows,
                                   Acc* __restrict__ out, int64_t d, int64_t n,
                                   int64_t m_pad, Acc scale) {
  const int64_t total = d * n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / n;
    const int64_t col = i - r * n;
    const int64_t row = rows[r];
    out[i] = (row >= 0 && row < m_pad) ? hx[row * n + col] / scale : Acc(NAN);
  }
}

template <typename T, typename Acc>
cudaError_t launch_srht(const void* A, const void* signs, const void* rows,
                        void* buf, void* out, int64_t m, int64_t m_pad,
                        int64_t n, int64_t d, double scale,
                        cudaStream_t stream) {
  Acc* hx = static_cast<Acc*>(buf);
  cudaError_t err = hadamard_passes<T, Acc>(
      static_cast<const T*>(A), static_cast<const Acc*>(signs), hx, m, m_pad,
      n, stream);
  if (err != cudaSuccess) return err;
  const int64_t total = d * n;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = cdiv(total, threads) < 65536 ? cdiv(total, threads) : 65536;
    srht_gather_kernel<Acc><<<(unsigned)blocks, threads, 0, stream>>>(
        hx, static_cast<const int64_t*>(rows), static_cast<Acc*>(out), d, n,
        m_pad, static_cast<Acc>(scale));
  }
  return cudaGetLastError();
}

}  // namespace
