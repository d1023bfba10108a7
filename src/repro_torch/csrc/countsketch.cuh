// CountSketch apply SA[h(i)] += s(i) * A[i] as a deterministic segmented sum.
//
// Replaces the TPU kernel repro/kernels/countsketch/kernel.py:27
// (countsketch_kernel), which recasts the scatter as a blocked one-hot
// matmul because the TPU has no scatter and no atomics.  On Hopper the
// apply is bound by reading A once (m*n elements) and writing SA once
// (d*n), so this kernel does no extra arithmetic and no atomics: the caller
// hands it a bucket -> entries CSR (a stable argsort of the entries'
// buckets, each entry's row id and weight in that order, and d+1 offsets),
// and one thread owns one (bucket, column) output.  It sums w*A[row] over
// its bucket's entries in order, so the result is bitwise the sequential
// index_add_ of the plain version: each product is rounded on its own
// (mul_rn, no FMA contraction) and the additions happen in the same order.
// The CountSketch has one +-1 entry per row (nnz = m); the sparse-sign
// sketch k per row (nnz = k*m), and the uniform-sparse sketch one entry
// with a uniform weight per row.  A warp covers consecutive columns of one
// bucket, so each row read is one coalesced segment.  Index arithmetic is
// 64-bit (m*n exceeds 2^31 at the paper's size).
//
// Fold mode (kFold) is the streaming accumulator's: each (bucket, column)
// sum starts from out[bucket, col], the state of the tiles folded so far,
// instead of from 0, and goes on in row order.  Since 0 + a = a exactly, a
// tile-by-tile fold is bitwise the one-launch apply over all rows, for any
// tiling, and bitwise the reference's row-order .at[].add fold
// (repro/streaming/accumulate.py:109-124).  It reads and writes the state
// of every bucket the tile has an entry in (d*n at most) beside the tile's
// t*n elements; a bucket with none is left as it stands, unread.
#pragma once

#include "common.cuh"

namespace {

template <typename T, typename Acc, bool kFold>
__global__ void countsketch_csr_kernel(const T* __restrict__ A,
                                       const int32_t* __restrict__ rows,
                                       const T* __restrict__ sgn,
                                       const int64_t* __restrict__ offsets,
                                       Acc* __restrict__ out, int64_t d,
                                       int64_t n) {
  const int64_t bucket = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (bucket >= d || col >= n) return;
  const int64_t lo = offsets[bucket];
  const int64_t hi = offsets[bucket + 1];
  if (kFold && lo == hi) return;  // no entry of this tile: the state stands
  Acc acc = kFold ? out[bucket * n + col] : Acc(0);
#pragma unroll 4
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t r = rows[j];
    acc += mul_rn(to_acc<Acc>(sgn[j]), to_acc<Acc>(A[r * n + col]));
  }
  out[bucket * n + col] = acc;
}

// Block shape: tx columns x ty buckets, 256 threads.  Narrow inputs (the
// right-hand side b has n = 1) give the lanes to buckets instead of idle
// columns.
template <typename T, typename Acc>
cudaError_t launch_countsketch(const void* A, const void* rows,
                               const void* sgn, const void* offsets,
                               void* out, int64_t d, int64_t n,
                               cudaStream_t stream, bool fold) {
  int tx = 1;
  while (tx < 32 && tx < n) tx *= 2;
  const int ty = 256 / tx;
  const int64_t gy = cdiv(n, tx);
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  if (d > 0 && n > 0) {
    dim3 block(tx, ty);
    dim3 grid((unsigned)cdiv(d, ty), (unsigned)gy);
    auto kernel = fold ? countsketch_csr_kernel<T, Acc, true> : countsketch_csr_kernel<T, Acc, false>;
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(A), static_cast<const int32_t*>(rows),
        static_cast<const T*>(sgn), static_cast<const int64_t*>(offsets),
        static_cast<Acc*>(out), d, n);
  }
  return cudaGetLastError();
}

// dtype code -> (input type, accumulator type): half inputs sum in f32.
// fold: start each sum from out (the streaming accumulator's state).
inline cudaError_t dispatch_countsketch(int dtype, const void* A,
                                        const void* rows, const void* sgn,
                                        const void* offsets, void* out,
                                        int64_t d, int64_t n,
                                        cudaStream_t stream, bool fold = false) {
  switch (dtype) {
    case kF64:
      return launch_countsketch<double, double>(A, rows, sgn, offsets, out, d, n, stream, fold);
    case kF32:
      return launch_countsketch<float, float>(A, rows, sgn, offsets, out, d, n, stream, fold);
    case kBF16:
      return launch_countsketch<__nv_bfloat16, float>(A, rows, sgn, offsets, out, d, n, stream, fold);
    case kF16:
      return launch_countsketch<__half, float>(A, rows, sgn, offsets, out, d, n, stream, fold);
    default:
      return cudaErrorInvalidValue;
  }
}

// The coordinate scatter of the bucket sketches: SA for a sparse A given by
// its entries (r, c, v), each adding w_j(r) * v to the cell (h_j(r), c) for
// j = 0..k-1.  It replaces no TPU kernel: the reference scatters with a jnp
// .at[].add (repro/core/sketch.py:506-518, :577-590, :641-650), and CUDA's
// index_add_ would sum it with atomics, in an order that changes from run
// to run.  Every cell must sum its products in the reference's order, the
// j-major, entry-order ravel (product p = j*nnz + e), each product rounded
// on its own (mul_rn): then the result is bitwise the sequential
// index_add_ of the plain version on the CPU.
//
// The products are grouped by bucket, not by cell
// (repro_torch/kernels/countsketch/ops.py:countsketch_coo_plan), and one
// warp owns one bucket: it holds the bucket's output row (a column tile of
// at most kCooTile columns) in shared memory, walks the bucket's products
// in plan order, 32 lanes at a time, and writes the row once, coalesced;
// empty cells are 0.  Each lane of a batch adds its product to its column;
// the lanes whose column another lane of the batch also hits are found
// through a byte tag per column (each lane writes its lane id there; a
// lane that reads another id back marks the column) and add one by one in
// lane order, so each cell sums exactly the sequence it sums in the plain
// version.  The plan lists a bucket's
// products in ascending p in one of two forms:
//  - by row (kByRow), where the entries are in row order (rows
//    nondecreasing, as a coalesced COO or a CSR gives them): B1's bucket
//    CSR of the sketch (each bucket's (j, r) in (j, r) order, with the
//    weight w_j(r)) and a row pointer over the raw entries.  Walking a
//    bucket's (j, r) list and, for each, row r's entries in order gives
//    ascending p with no sort over the entries.  A warp loads 32 (j, r)
//    items at a time with their row's span, scans the spans' lengths, and
//    finds each lane's item by a binary search over the scan in registers
//    (shuffles);
//  - by product, for entries in any order: the product ids p sorted by
//    bucket (a stable sort of the k*nnz int32 bucket ids), each decoded to
//    (j, e) in the kernel.
// kCooUnroll batches of 32 products issue their loads before any of them
// is added, to keep several gathers in flight.  It is bound by reading
// each product's column and value (and its id, by product) once and
// writing the d*n cells once.
constexpr int kCooWarps = 4;     // buckets (warps) of a block
constexpr int kCooTile = 1024;   // most columns of a bucket row held at once
constexpr int kCooUnroll = 4;    // batches of 32 products loaded together

// The adds of one batch: `col` is the lane's column inside the tile, or -1
// where the lane has no product; tag is the warp's byte a column.  A lane
// whose column no other lane hits adds at once; the lanes of a column hit
// twice or more add in lane order.
constexpr unsigned kCooAll = 0xffffffffu;
constexpr unsigned char kCooClash = 0xff;

template <typename T>
__device__ __forceinline__ void coo_add(T* row, unsigned char* tag, int lane, int col, T prod) {
  const bool live = col >= 0;
  if (live) tag[col] = (unsigned char)lane;
  __syncwarp();
  if (live && tag[col] != lane) tag[col] = kCooClash;  // another lane's id: a clash
  __syncwarp();
  const bool serial = live && tag[col] == kCooClash;
  if (live && !serial) row[col] += prod;
  unsigned pend = __ballot_sync(kCooAll, serial);
  while (pend) {  // warp-uniform: the clashing lanes in lane order
    if (lane == __ffs(pend) - 1) row[col] += prod;
    __syncwarp();
    pend &= pend - 1;
  }
  // the next batch's two barriers order these adds before its own
}

template <typename T, bool kByRow>
__global__ void __launch_bounds__(32 * kCooWarps)
coo_scatter_kernel(const int64_t* __restrict__ offsets, const void* __restrict__ items,
                   const T* __restrict__ item_w, const int64_t* __restrict__ rowptr,
                   const int64_t* __restrict__ rows, const int64_t* __restrict__ cols,
                   const T* __restrict__ vals, const T* __restrict__ w, T* __restrict__ out,
                   int64_t d, int64_t n, int64_t nnz, int64_t m, int tile) {
  extern __shared__ __align__(16) unsigned char coo_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t bucket = (int64_t)blockIdx.x * kCooWarps + warp;
  if (bucket >= d) return;  // whole warps leave together
  const int64_t c0 = (int64_t)blockIdx.y * tile;
  const int width = (int)(n - c0 < tile ? n - c0 : tile);
  T* row = reinterpret_cast<T*>(coo_smem) + warp * tile;
  unsigned char* tag = coo_smem + sizeof(T) * kCooWarps * tile + warp * tile;
  for (int c = lane; c < width; c += 32) row[c] = T(0);
  __syncwarp();
  // the lane's column inside the tile, or -1
  auto in_tile = [&](bool live, int64_t col) {
    return live && col >= c0 && col < c0 + width ? (int)(col - c0) : -1;
  };
  const int64_t lo = offsets[bucket], hi = offsets[bucket + 1];

  if (kByRow) {
    const int32_t* csr_rows = static_cast<const int32_t*>(items);
    // this group's item (row and weight) in registers, the next one's in flight
    int64_t r = lo + lane < hi ? csr_rows[lo + lane] : -1;
    T wt = lo + lane < hi ? item_w[lo + lane] : T(0);
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t t_next = base + 32 + lane;
      const int64_t r_next = t_next < hi ? csr_rows[t_next] : -1;
      const T w_next = t_next < hi ? item_w[t_next] : T(0);
      long long e0 = 0, len = 0;
      if (r >= 0) {
        e0 = rowptr[r];
        len = rowptr[r + 1] - e0;
      }
      long long incl = len;  // inclusive scan of the items' spans
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const long long v = __shfl_up_sync(kCooAll, incl, off);
        if (lane >= off) incl += v;
      }
      const long long excl = incl - len;
      const long long total = __shfl_sync(kCooAll, incl, 31);
      for (long long q0 = 0; q0 < total; q0 += 32 * kCooUnroll) {
        int col[kCooUnroll];
        T prod[kCooUnroll];
#pragma unroll
        for (int u = 0; u < kCooUnroll; ++u) {
          const long long q = q0 + 32 * u + lane;
          // the item of product q: the number of items whose span ends at or before q
          int pos = 0;
#pragma unroll
          for (int s = 16; s > 0; s /= 2)
            if (__shfl_sync(kCooAll, incl, pos + s - 1) <= q) pos += s;
          const long long e = __shfl_sync(kCooAll, e0, pos) + (q - __shfl_sync(kCooAll, excl, pos));
          const T wv = __shfl_sync(kCooAll, wt, pos);
          const bool live = q < total;
          const int64_t c = live ? cols[e] : 0;
          prod[u] = mul_rn(wv, live ? vals[e] : T(0));
          col[u] = in_tile(live, c);
        }
#pragma unroll
        for (int u = 0; u < kCooUnroll; ++u) coo_add(row, tag, lane, col[u], prod[u]);
      }
      r = r_next;
      wt = w_next;
    }
  } else {
    const int64_t* perm = static_cast<const int64_t*>(items);
    for (int64_t base = lo; base < hi; base += 32 * kCooUnroll) {
      int col[kCooUnroll];
      T prod[kCooUnroll];
#pragma unroll
      for (int u = 0; u < kCooUnroll; ++u) {
        const int64_t t = base + 32 * u + lane;
        const bool live = t < hi;
        int64_t c = 0;
        T p = T(0);
        if (live) {
          const int64_t id = perm[t];
          // j = id / nnz: k is small, so by subtraction (a 64-bit division
          // costs more than the gathers around it)
          int64_t j = 0, e = id;
          while (e >= nnz) {
            e -= nnz;
            ++j;
          }
          c = cols[e];
          p = mul_rn(w[j * m + rows[e]], vals[e]);
        }
        prod[u] = p;
        col[u] = in_tile(live, c);
      }
#pragma unroll
      for (int u = 0; u < kCooUnroll; ++u) coo_add(row, tag, lane, col[u], prod[u]);
    }
  }
  __syncwarp();
  T* dst = out + bucket * n + c0;
  for (int c = lane; c < width; c += 32) dst[c] = row[c];
}

// by_row: items are B1's CSR rows (int32) with their weights item_w, and
// rowptr the entries' row pointer; else items are the product ids (int64)
// sorted by bucket, and w the (k, m) weights.
template <typename T>
cudaError_t launch_coo_scatter(const void* offsets, const void* items, const void* item_w,
                               const void* rowptr, const void* rows, const void* cols,
                               const void* vals, const void* w, void* out, int64_t d,
                               int64_t n, int64_t nnz, int64_t m, cudaStream_t stream) {
  if (d <= 0 || n <= 0) return cudaGetLastError();
  const int tile = (int)(n < kCooTile ? n : kCooTile);
  const int64_t gx = cdiv(d, kCooWarps), gy = cdiv(n, tile);
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = (sizeof(T) + 1) * kCooWarps * tile;
  const bool by_row = rowptr != nullptr;
  auto kernel = by_row ? coo_scatter_kernel<T, true> : coo_scatter_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), 32 * kCooWarps, smem, stream>>>(
      static_cast<const int64_t*>(offsets), items, static_cast<const T*>(item_w),
      static_cast<const int64_t*>(rowptr), static_cast<const int64_t*>(rows),
      static_cast<const int64_t*>(cols), static_cast<const T*>(vals), static_cast<const T*>(w),
      static_cast<T*>(out), d, n, nnz, m, tile);
  return cudaGetLastError();
}

inline cudaError_t dispatch_coo_scatter(int dtype, const void* offsets, const void* items,
                                        const void* item_w, const void* rowptr, const void* rows,
                                        const void* cols, const void* vals, const void* w,
                                        void* out, int64_t d, int64_t n, int64_t nnz,
                                        int64_t m, cudaStream_t stream) {
  switch (dtype) {
    case kF64:
      return launch_coo_scatter<double>(offsets, items, item_w, rowptr, rows, cols, vals, w, out,
                                        d, n, nnz, m, stream);
    case kF32:
      return launch_coo_scatter<float>(offsets, items, item_w, rowptr, rows, cols, vals, w, out,
                                       d, n, nnz, m, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
