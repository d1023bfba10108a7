// Counter-based threefry2x32 (20 rounds) and Box-Muller, on the device.
//
// The same arithmetic as repro_torch/kernels/common.py (the plain version)
// and as the reference's repro/kernels/common.py: the reference's key
// schedule and rotations, in native uint32 arithmetic, so the bits are
// those of the plain version exactly.  Box-Muller runs in f32 in the
// reference's order of operations.  Every product and sum is written with
// the _rn intrinsics, which nvcc never contracts into an FMA; logf, cosf
// and sqrtf are the accurate library functions (the build has no
// --use_fast_math), so the Gaussians stay within a few f32 ulps of the
// plain version.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0) ^ x0;
  x0 += x1; x1 = rotl32(x1, r1) ^ x0;
  x0 += x1; x1 = rotl32(x1, r2) ^ x0;
  x0 += x1; x1 = rotl32(x1, r3) ^ x0;
}

// In place: (x0, x1) <- threefry2x32((k0, k1), (x0, x1)).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// Box-Muller on two 32-bit words -> one N(0, 1) value in f32.  The
// uniforms are 24-bit: u1 = (b0 >> 8) * 2^-24 + 2^-25 in (0, 1) and
// u2 = (b1 >> 8) * 2^-24; 2*pi is rounded to f32 once.
__device__ __forceinline__ float bits_to_gaussian(uint32_t b0, uint32_t b1) {
  constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
  const float u1 = __fadd_rn(__fmul_rn((float)(b0 >> 8), 5.9604644775390625e-08f),
                             2.98023223876953125e-08f);
  const float u2 = __fmul_rn((float)(b1 >> 8), 5.9604644775390625e-08f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

}  // namespace
