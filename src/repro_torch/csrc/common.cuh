// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every C entry point takes a dtype code (the order of DTYPE_CODES in
// repro_torch/kernels/_build.py), raw device pointers, 64-bit sizes and the
// caller's CUDA stream, launches on that stream, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum DtypeCode : int { kF64 = 0, kF32 = 1, kBF16 = 2, kF16 = 3 };

template <typename Acc, typename T>
__device__ __forceinline__ Acc to_acc(T x) {
  return static_cast<Acc>(x);
}
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_acc<float, __half>(__half x) {
  return __half2float(x);
}

// A product rounded on its own, never contracted with the add that follows
// into an FMA: the kernels then round as the plain versions do.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace
