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
// bitwise equal to the plain version, on the card and on the CPU, whatever
// the panel width and whatever order the work items run in.
//
// Passes.  The p = log2(m_pad) bits are split into passes of at most
// kHadMaxBits bits, highest bits first (kernels/common.py:hadamard_passes).
// A pass over bits [lo, lo + G) gives each group of 2^G rows
// {base + k * 2^lo : k < 2^G} (the other bits fixed) to one work item, for
// W columns.  The item runs the G stages in two rounds of butterflies held
// in registers: round 1 the high half of the bits (each thread owns the
// 2^Q1 rows that differ in them), then an exchange through shared memory,
// then round 2 the low half.  The first pass reads A (rows 2^10 apart at
// m = 2^20), reads rows >= m as zeros and applies the signs D, so no padded
// or signed copy of A is made.
//
// Panels.  What the first pass writes the second reads in other groups, so
// a column's intermediate must be whole before the next pass starts.  Kept
// for all n columns it is an (m_pad, n) buffer as large as A.  The SRHT
// instead cuts the columns into panels of w (kernels/common.py:
// hadamard_panel) and runs every pass of a panel before the next panel's
// first pass, through ONE compact (m_pad, w) panel buffer reused for every
// panel.  Its width is the trade: the first pass reads A in row segments
// of w elements, 2^lo rows apart, and the H100's HBM serves such scattered
// segments at a rate in segments, not bytes, so w is set by the segment
// (64 bytes: 8 f64 columns, a 67 MB buffer at m_pad = 2^20), not by the
// L2: w = 4 (33.5 MB, inside the 50 MB L2) lost (PERF.md, PR 16).  The
// transform's output is as large as its input anyway, so it runs one panel
// of all n columns with the output itself as the buffer (no scratch).
//
// The last pass writes only what the caller keeps.  The transform writes
// every row.  The SRHT writes its d sampled rows (P), divided by sqrt(d) (a
// true division, as the plain version), found through a gather list (a
// stable sort of the rows, the output row of each entry, and offsets per
// group of the last pass; kernels/srht/ops.py:gather_list).  A row outside
// [0, m_pad) sorts into a last bucket that belongs to no group, and the
// items of group 0 write NaN into those output rows.
//
// D.  The first pass flips the sign bit of each element whose row has a
// negative sign: bitwise the product with -1 for every non-NaN value,
// signed zeros included.  The signs come as bits in the first pass's order
// (kernels/srht/ops.py:sign_mask): a thread's 2^Q1 rows are one aligned
// run of bits of one 32-bit word, one load per item in place of an f64 load
// per element.
//
// Schedule.  Each pass of each panel is one ordinary launch of a block per
// work item, in order on the stream: every pass of a panel before the next
// panel's first pass, which overwrites the buffer the last pass read.  The
// stream orders the passes, so no item waits for another and the buffer is
// read with plain loads.  At A (2^20, 1000) f64 that is 250 launches; one
// persistent launch that took the items by ticket and ordered them with
// per-pass counters was slower at every panel width (PERF.md, PR 16).
//
// Bytes, SRHT at A (2^20, 1000) f64: A read once (8.39 GB, in 64-byte row
// segments), the panel buffer written and read once per panel (8.39 GB
// each, partly in the L2), out 32 MB.  The transform: x read, out written,
// read and written again (33.6 GB).  Tried and dropped (PERF.md, PR 16):
// the panel in the L2 (w = 4); L2 cache hints (evict_last on the buffer,
// evict_first on A and the output: 3% slower than none); A's loads as
// ld.global.nc.L1::no_allocate (slower than plain loads); cp.async staging
// of the next item in a second tile; the persistent launch above.
//
// Shapes.  A block has W * gpb = kHadLanes column-groups: W columns of gpb
// groups, so the vector b (n = 1) stacks 8 groups in an item instead of
// leaving 7 of 8 lanes idle.  The exchange pads one row every 2^Q2 rows so
// that round 2's reads fall on distinct banks.  Row and address arithmetic
// is 64-bit; items, columns and gather entries are 32-bit (the plan
// refuses n >= 2^31, d >= 2^31 or 2^31 items in a pass).
#pragma once

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHadMaxBits = 10;   // rows of one pass's group: up to 2^10
constexpr int kHadMaxPasses = 4;  // m_pad up to 2^40
constexpr int kHadLanes = 8;      // columns x groups of one block

template <int G>
struct HadShape {
  static constexpr int Q1 = (G + 1) / 2;  // bits of round 1 (the high half)
  static constexpr int Q2 = G / 2;        // bits of round 2 (the low half)
  static constexpr int TPC = 1 << Q1;     // threads per column of a group
  static constexpr int ROWS = 1 << G;
  static constexpr int PADDED = ROWS + (ROWS >> Q2);  // one pad row per 2^Q2
};

// The passes, the panels and their work items.
template <typename Acc>
struct HadPlan {
  const void* src;             // the input (type T): m rows of n
  const uint32_t* mask;        // D's sign bits in the first pass's order, or null
  Acc* buf;                    // (m_pad, w) panel buffer (two passes or more)
  Acc* out;                    // (m_pad, n) for the transform, (d, n) for the SRHT
  const int64_t* g_rows;       // gather list of the SRHT, or null (the transform)
  const int64_t* g_index;
  const int64_t* g_offsets;
  int64_t m, m_pad, n;
  int64_t w;                   // columns of a panel; the last may be narrower
  int64_t chunks;              // W-column chunks of a panel
  int64_t panels;
  int64_t groups[kHadMaxPasses];
  int64_t items[kHadMaxPasses];
  int G[kHadMaxPasses], lo[kHadMaxPasses];
  int passes, W, gpb;
  Acc scale;                   // the SRHT's sqrt(d)
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

// Where a thread's part of work item `item` of pass q of a panel lies.
struct HadItem {
  int64_t base;         // the group's first row
  int panel, grp, lcol, col, q, lo;
  bool live, last, gather;
};

template <typename Acc, int G>
__device__ __forceinline__ HadItem item_at(const HadPlan<Acc>& a, int q, int64_t panel,
                                           int64_t item) {
  HadItem it;
  const uint32_t chunks = (uint32_t)a.chunks;
  it.panel = (int)panel;
  it.q = q;
  it.grp = (int)((uint32_t)item / chunks) * a.gpb + (int)threadIdx.z;
  it.lcol = (int)((uint32_t)item % chunks) * a.W + (int)threadIdx.x;  // column within the panel
  it.col = it.panel * (int)a.w + it.lcol;
  it.live = it.grp < a.groups[q] && it.lcol < a.w && it.col < a.n;
  it.last = q == a.passes - 1;
  it.gather = it.last && a.g_rows != nullptr;
  it.lo = a.lo[q];
  const int64_t low_mask = ((int64_t)1 << it.lo) - 1;
  it.base = (((int64_t)it.grp & ~low_mask) << G) | ((int64_t)it.grp & low_mask);
  return it;
}

// What a thread reads for an item besides its data: the signs of its rows
// (first pass) and its first entry of the gather list (the SRHT's last
// pass; the group's entries are [e0, e1)).
struct HadPre {
  int e0, e1, k0, o0;  // d < 2^31
  uint32_t bits;
};

template <typename Acc, int G, bool FIRST>
__device__ __forceinline__ HadPre fetch_pre(const HadPlan<Acc>& a, const HadItem& it) {
  using S = HadShape<G>;
  HadPre pre{0, 0, 0, 0, 0u};
  const int y = threadIdx.y;
  if (FIRST && it.live && a.mask != nullptr && y < (1 << S::Q2)) {
    const int64_t bit = ((int64_t)it.grp << G) | ((int64_t)y << S::Q1);
    pre.bits = __ldg(a.mask + (bit >> 5)) >> (bit & 31);
  }
  if (it.gather && it.live) {
    pre.e0 = (int)a.g_offsets[it.grp];
    pre.e1 = (int)a.g_offsets[it.grp + 1];
    if (pre.e0 + y < pre.e1) {
      pre.k0 = (int)(a.g_rows[pre.e0 + y] - it.base);
      pre.o0 = (int)a.g_index[pre.e0 + y];
    }
  }
  return pre;
}

// One work item: the G stages of pass q on gpb groups of W columns of one
// panel.  FIRST: the source is the input (type T) with the signs; else the
// panel buffer.  The last pass writes the output, the others the buffer.
template <typename T, typename Acc, int G, bool FIRST>
__device__ __forceinline__ void had_item(const HadPlan<Acc>& a, const HadItem& it,
                                         Acc* tile_base) {
  using S = HadShape<G>;
  const int W = a.W;
  const int c = threadIdx.x, y = threadIdx.y;
  Acc* tile = tile_base + (int64_t)threadIdx.z * S::PADDED * W;
  HadPre pre;

  // Round 1: thread y owns local rows (j << Q2) | y, j < 2^Q1.
  if (y < (1 << S::Q2)) {
    Acc v[1 << S::Q1];
    if constexpr (FIRST) {
      // row j = row0 + j * 2^(Q2 + lo); the rows < m are j < jend
      const int64_t row0 = it.base + ((int64_t)y << it.lo);
      const int64_t jstep = (int64_t)1 << (S::Q2 + it.lo);
      const int64_t left =
          it.live && row0 < a.m ? (a.m - row0 + jstep - 1) >> (S::Q2 + it.lo) : 0;
      const int jend = left < (1 << S::Q1) ? (int)left : (1 << S::Q1);
      const T* p = static_cast<const T*>(a.src) + row0 * a.n + it.col;
      const int64_t step = jstep * a.n;
#pragma unroll
      for (int j = 0; j < (1 << S::Q1); ++j) {
        v[j] = j < jend ? to_acc<Acc>(p[j * step]) : Acc(0);
      }
    } else {
      const Acc* p = a.buf + (it.base + ((int64_t)y << it.lo)) * a.w + it.lcol;
      const int64_t step = ((int64_t)1 << (S::Q2 + it.lo)) * a.w;
#pragma unroll
      for (int j = 0; j < (1 << S::Q1); ++j) v[j] = it.live ? p[j * step] : Acc(0);
    }
    pre = fetch_pre<Acc, G, FIRST>(a, it);  // while the loads fly
    if constexpr (FIRST) {
#pragma unroll
      for (int j = 0; j < (1 << S::Q1); ++j) v[j] = (pre.bits >> j) & 1u ? -v[j] : v[j];
    }
    butterflies<Acc, S::Q1>(v);
#pragma unroll
    for (int j = 0; j < (1 << S::Q1); ++j) {
      const int k = (j << S::Q2) | y;
      tile[(k + j) * W + c] = v[j];  // k >> Q2 == j: the pad row
    }
  } else {
    pre = fetch_pre<Acc, G, FIRST>(a, it);
  }
  __syncthreads();

  // Round 2: thread y owns local rows (y << Q2) | j, j < 2^Q2.
  if (y < S::TPC) {
    Acc u[1 << S::Q2];
#pragma unroll
    for (int j = 0; j < (1 << S::Q2); ++j) {
      const int k = (y << S::Q2) | j;
      u[j] = tile[(k + y) * W + c];
    }
    butterflies<Acc, S::Q2>(u);
#pragma unroll
    for (int j = 0; j < (1 << S::Q2); ++j) {
      const int k = (y << S::Q2) | j;
      const int64_t row = it.base + ((int64_t)k << it.lo);
      if (it.gather) {
        tile[(k + y) * W + c] = u[j];  // the place it was read from
      } else if (it.live) {
        if (it.last) {
          a.out[row * a.n + it.col] = u[j];
        } else {
          a.buf[row * a.w + it.lcol] = u[j];
        }
      }
    }
  }
  if (it.gather) {
    // The sampled rows of this group (lo = 0: rows base .. base + 2^G - 1),
    // and, for group 0, the NaN rows of indices outside [0, m_pad).
    __syncthreads();
    if (it.live) {
      for (int e = pre.e0 + y; e < pre.e1; e += blockDim.y) {
        const bool first = e == pre.e0 + y;
        const int64_t k = first ? pre.k0 : a.g_rows[e] - it.base;
        const int64_t o = first ? pre.o0 : a.g_index[e];
        a.out[o * a.n + it.col] = tile[(k + (k >> S::Q2)) * W + c] / a.scale;
      }
      if (it.grp == 0) {
        const int64_t groups = a.groups[it.q];
        const int64_t bad_end = a.g_offsets[groups + 1];
        for (int64_t e = a.g_offsets[groups] + y; e < bad_end; e += blockDim.y) {
          a.out[a.g_index[e] * a.n + it.col] = Acc(NAN);
        }
      }
    }
  }
}

// Pass q of one panel: a block an item, the pass before it finished by
// stream order.
template <typename T, typename Acc, int G, bool FIRST>
__global__ void __launch_bounds__(kHadLanes * HadShape<G>::TPC)
    hadamard_pass_kernel(const HadPlan<Acc> a, int q, int panel) {
  extern __shared__ __align__(16) unsigned char had_smem[];
  const HadItem it = item_at<Acc, G>(a, q, panel, blockIdx.x);
  had_item<std::conditional_t<FIRST, T, Acc>, Acc, G, FIRST>(a, it,
                                                             reinterpret_cast<Acc*>(had_smem));
}

template <typename T, typename Acc, int G, bool FIRST>
cudaError_t launch_pass(const HadPlan<Acc>& a, int q, int panel, cudaStream_t stream) {
  using S = HadShape<G>;
  auto kernel = hadamard_pass_kernel<T, Acc, G, FIRST>;
  const size_t smem = (size_t)kHadLanes * S::PADDED * sizeof(Acc);  // the exchange tiles
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)a.items[q], dim3(a.W, S::TPC, a.gpb), smem, stream>>>(a, q, panel);
  return cudaGetLastError();
}

// Every pass of every panel, panel by panel; the first pass has GH bits,
// every later one GH or GH - 1.
template <typename T, typename Acc, int GH>
cudaError_t launch_hadamard(const HadPlan<Acc>& a, cudaStream_t stream) {
  constexpr int GL = GH > 0 ? GH - 1 : 0;
  cudaError_t err = cudaSuccess;
  for (int p = 0; p < (int)a.panels && err == cudaSuccess; ++p) {
    err = launch_pass<T, Acc, GH, true>(a, 0, p, stream);
    for (int q = 1; q < a.passes && err == cudaSuccess; ++q) {
      err = a.G[q] == GH ? launch_pass<T, Acc, GH, false>(a, q, p, stream)
                         : launch_pass<T, Acc, GL, false>(a, q, p, stream);
    }
  }
  return err;
}

// The passes, panels and items (the same split and panel count as
// kernels/common.py:hadamard_passes and the wrappers').
template <typename Acc>
cudaError_t plan_hadamard(HadPlan<Acc>& a, int64_t m, int64_t m_pad, int64_t n,
                          int64_t w) {
  if (m_pad <= 0 || (m_pad & (m_pad - 1)) || m > m_pad || n < 1 || w < 1 ||
      n >= ((int64_t)1 << 31)) {
    return cudaErrorInvalidValue;
  }
  int p = 0;
  while (((int64_t)1 << p) < m_pad) ++p;
  int passes = (int)cdiv(p, kHadMaxBits);
  if (passes < 1) passes = 1;
  if (passes > kHadMaxPasses) return cudaErrorInvalidValue;
  a.m = m;
  a.m_pad = m_pad;
  a.n = n;
  a.w = w < n ? w : n;
  a.passes = passes;
  int left = p;  // bits not yet transformed: [0, left)
  for (int i = 0; i < passes; ++i) {
    a.G[i] = (int)cdiv(left, passes - i);
    left -= a.G[i];
    a.lo[i] = left;
  }
  a.W = kHadLanes;  // columns of an item; narrow panels stack groups
  while (a.W > 1 && a.W / 2 >= a.w) a.W /= 2;
  a.gpb = kHadLanes / a.W;
  a.chunks = cdiv(a.w, a.W);
  a.panels = cdiv(n, a.w);
  for (int i = 0; i < passes; ++i) {
    a.groups[i] = m_pad >> a.G[i];
    a.items[i] = a.chunks * cdiv(a.groups[i], a.gpb);
    // a pass's items are a grid, counted in 32 bits
    if (a.items[i] >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T, typename Acc>
cudaError_t dispatch_hadamard(const HadPlan<Acc>& a, cudaStream_t stream) {
#define REPRO_HAD_CASE(g) \
  case g:                 \
    return launch_hadamard<T, Acc, g>(a, stream);
  switch (a.G[0]) {
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

// out (m, n) = H x, m a power of two: one panel of all n columns, with out
// itself as the buffer.
template <typename T, typename Acc>
cudaError_t launch_transform(const void* x, void* out, int64_t m, int64_t n,
                             cudaStream_t stream) {
  if (n == 0) return cudaGetLastError();
  HadPlan<Acc> a{};
  cudaError_t err = plan_hadamard(a, m, m, n, n);
  if (err != cudaSuccess) return err;
  a.src = x;
  a.buf = static_cast<Acc*>(out);
  a.out = static_cast<Acc*>(out);
  return dispatch_hadamard<T, Acc>(a, stream);
}

// out (d, n) = (H D [A; 0])[rows] / scale: D as sign bits (mask), rows as
// the gather list (g_rows, g_index, g_offsets).
template <typename T, typename Acc>
cudaError_t launch_srht(const void* A, const void* mask, const void* g_rows,
                        const void* g_index, const void* g_offsets, void* buf,
                        void* out, int64_t m, int64_t m_pad,
                        int64_t n, int64_t d, int64_t w, double scale,
                        cudaStream_t stream) {
  if (n == 0 || d == 0) return cudaGetLastError();
  if (d >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  HadPlan<Acc> a{};
  cudaError_t err = plan_hadamard(a, m, m_pad, n, w);
  if (err != cudaSuccess) return err;
  if (a.passes > 1 && buf == nullptr) return cudaErrorInvalidValue;
  a.src = A;
  a.mask = static_cast<const uint32_t*>(mask);
  a.buf = static_cast<Acc*>(buf);
  a.out = static_cast<Acc*>(out);
  a.g_rows = static_cast<const int64_t*>(g_rows);
  a.g_index = static_cast<const int64_t*>(g_index);
  a.g_offsets = static_cast<const int64_t*>(g_offsets);
  a.scale = static_cast<Acc>(scale);
  return dispatch_hadamard<T, Acc>(a, stream);
}

}  // namespace
