// Device helpers shared by the tracker's kernels (lk_track.cu,
// zncc_gate.cu): the bilinear blend, the warp sum, the centre clamp.
// Every float step uses a round-to-nearest intrinsic, which nvcc never
// contracts into an FMA, in the order of tracker/klt.py's plain versions
// (_lerp2, _split_frac).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// (1-fy) * ((1-fx) * a + fx * b) + fy * ((1-fx) * c + fx * d), each
// operation rounded on its own as the plain version's _lerp2 rounds it.
__device__ __forceinline__ float lerp2(float a, float b, float c, float d,
                                       float fx, float fy) {
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float top = __fadd_rn(__fmul_rn(gx, a), __fmul_rn(fx, b));
  const float bot = __fadd_rn(__fmul_rn(gx, c), __fmul_rn(fx, d));
  return __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
}

// Sum over the warp; every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  }
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// _split_frac: clamp the centre, split into integer corner and fraction.
// fminf/fmaxf return the other operand for a NaN, so the corner is always
// finite and the int conversion defined; a caller for which a NaN centre
// matters tests for it itself.
__device__ __forceinline__ void split_frac(float u, float v, float lo,
                                           float hi_x, float hi_y, int& ix,
                                           int& iy, float& fx, float& fy) {
  const float x = fminf(fmaxf(u, lo), hi_x);
  const float y = fminf(fmaxf(v, lo), hi_y);
  const float flx = floorf(x);
  const float fly = floorf(y);
  ix = static_cast<int>(flx);
  iy = static_cast<int>(fly);
  fx = __fsub_rn(x, flx);
  fy = __fsub_rn(y, fly);
}

}  // namespace
