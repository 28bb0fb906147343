// One pyramid level of batched Lucas-Kanade tracking on Hopper (sm_90a):
// template window, bilinear blend, gradients, normal equations and all
// iterations of every feature in ONE launch.
//
// Replaces, for the KLT caller, the Pallas TPU kernel
// mono_lidar_depth_tpu/core/pallas_windows.py::_window_kernel (launched by
// _windows_vmem) together with the JAX code around it in
// mono_lidar_depth_tpu/tracker/klt.py::_lk_level: per level that code makes
// two edge-padded copies of the images, cuts one (patch+3)^2 window per
// feature for the template and one (patch+1)^2 window per feature and
// iteration, and runs the blend, two dot products and a 2x2 solve on the
// windows it wrote to device memory.  Here a tap at padded coordinate p
// reads img[clamp(p - pad, 0, size - 1)], which is what the edge pad
// followed by the crop reads, so no padded copy and no window is ever
// written: per level the kernel writes uv_out and ok, N * 9 bytes.
//
// What bounds it on this card: not device-memory bytes.  Both images of
// the finest KITTI level are 3.6 MB and stay in the 50 MB L2; the least
// traffic (both images read once, uv in, uv and ok out) is about 1 us at
// 3.35 TB/s.  The time goes to L2/L1 reads of overlapping windows,
// N * ((patch+3)^2 + iters * 4 * patch^2) taps, and above all to latency:
// the iterations of one feature depend on each other (the next window's
// address comes out of the previous update), so a level costs
// 1 + iters round trips of load -> blend -> warp reduction -> update.
//
// Design.  One warp per feature, kWarpsPerBlock = 4 features per
// 128-thread block: at N = 2048 that is 512 small blocks, about 4 on each
// of the 132 SMs, so every SM holds some 16 independent dependency chains
// to hide each other's load latency (the block size was chosen by this
// argument; 8 features per block was not timed).  The warp stages the (patch+3)^2
// template window and its blend in shared memory (the gradient stencils
// read neighbours), then keeps template, gx and gy of its taps in
// registers, T = ceil(patch^2 / 32) taps per lane (3 at patch 9); the
// kernel is instantiated for T = 1, 2, 3, 4, 6 and 8, the counts that the
// odd patches 1..kMaxPatch = 15 give (no odd square needs 5 or 7).  Sums go through xor-shuffle butterflies, which leave
// the same bits in every lane, so the carried position stays uniform
// across the warp with no broadcast.  In the iterations every lane loads
// the 4 corners of its taps straight from the image (the duplicates hit
// L1), with no shared-memory staging and no barrier.
//
// Numbers.  Every elementwise step uses the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, ...), which nvcc never contracts into FMAs, in
// the order of the plain PyTorch version (tracker/klt.py::
// _lk_level_reference).  So the blend, the gradients, the residual and the
// 2x2 update are the plain version's to the bit for the same inputs, and
// the one difference is the order of the 81-term sums (lane-strided
// partial sums, then a butterfly, against torch.sum), which the iterations
// carry along: the kernel is held to a stated tolerance, not to bits.
//
// No allocation, no synchronisation: the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "lk_common.cuh"

namespace {

constexpr int kMaxPatch = 15;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxTaps = (kMaxPatch * kMaxPatch + 31) / 32;  // per lane
constexpr int kWinMax = (kMaxPatch + 3) * (kMaxPatch + 3);
constexpr int kBlendMax = (kMaxPatch + 2) * (kMaxPatch + 2);

template <int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lk_level_kernel(const float* __restrict__ prev_img,
                const float* __restrict__ next_img,
                const float* __restrict__ uv_prev,
                const float* __restrict__ uv_guess,
                float* __restrict__ uv_out, uint8_t* __restrict__ ok_out,
                int H, int W, int N, int P, int iters, float min_det,
                float lo, float hi_x, float hi_y) {
  __shared__ float s_win[kWarpsPerBlock][kWinMax];
  __shared__ float s_blend[kWarpsPerBlock][kBlendMax];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;  // the whole warp leaves; only warp barriers follow

  const int r = (P - 1) / 2;
  const int K3 = P + 3;  // template window
  const int K2 = P + 2;  // its blend: template plus a 1-px gradient ring
  const int PP = P * P;
  float* win = s_win[warp];
  float* blend = s_blend[warp];

  // ---- template stage: window of prev_img -> blend -> template, gx, gy
  int ix, iy;
  float fx, fy;
  split_frac(__ldg(uv_prev + 2 * n), __ldg(uv_prev + 2 * n + 1), lo, hi_x,
             hi_y, ix, iy, fx, fy);
  for (int j = lane; j < K3 * K3; j += 32) {
    const int y = j / K3;
    const int x = j - y * K3;
    const int yy = clampi(iy - r - 1 + y, 0, H - 1);
    const int xx = clampi(ix - r - 1 + x, 0, W - 1);
    win[j] = __ldg(prev_img + static_cast<size_t>(yy) * W + xx);
  }
  __syncwarp();
  for (int j = lane; j < K2 * K2; j += 32) {
    const int y = j / K2;
    const int x = j - y * K2;
    const float* w = win + y * K3 + x;
    blend[j] = lerp2(w[0], w[1], w[K3], w[K3 + 1], fx, fy);
  }
  __syncwarp();

  float tpl[T], gx[T], gy[T];
  int ty[T], tx[T];
  float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int k = lane + 32 * t;
    tpl[t] = gx[t] = gy[t] = 0.0f;
    ty[t] = tx[t] = 0;
    if (k < PP) {
      ty[t] = k / P;
      tx[t] = k - ty[t] * P;
      const float* b = blend + (ty[t] + 1) * K2 + tx[t] + 1;
      tpl[t] = b[0];
      gx[t] = __fmul_rn(__fsub_rn(b[1], b[-1]), 0.5f);
      gy[t] = __fmul_rn(__fsub_rn(b[K2], b[-K2]), 0.5f);
    }
    gxx = __fadd_rn(gxx, __fmul_rn(gx[t], gx[t]));
    gxy = __fadd_rn(gxy, __fmul_rn(gx[t], gy[t]));
    gyy = __fadd_rn(gyy, __fmul_rn(gy[t], gy[t]));
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const bool ok = det > min_det;
  const float inv_det = ok ? __fdiv_rn(1.0f, det == 0.0f ? 1.0f : det) : 0.0f;

  // ---- iterations: the carried position is uniform across the warp
  float u = __ldg(uv_guess + 2 * n);
  float v = __ldg(uv_guess + 2 * n + 1);
  for (int it = 0; it < iters; ++it) {
    int jx, jy;
    float hx, hy;
    split_frac(u, v, lo, hi_x, hi_y, jx, jy, hx, hy);
    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (lane + 32 * t < PP) {
        const int y0 = jy - r + ty[t];
        const int x0 = jx - r + tx[t];
        const float* row0 =
            next_img + static_cast<size_t>(clampi(y0, 0, H - 1)) * W;
        const float* row1 =
            next_img + static_cast<size_t>(clampi(y0 + 1, 0, H - 1)) * W;
        const int xa = clampi(x0, 0, W - 1);
        const int xb = clampi(x0 + 1, 0, W - 1);
        const float cur = lerp2(__ldg(row0 + xa), __ldg(row0 + xb),
                                __ldg(row1 + xa), __ldg(row1 + xb), hx, hy);
        const float err = __fsub_rn(cur, tpl[t]);
        bx = __fadd_rn(bx, __fmul_rn(err, gx[t]));
        by = __fadd_rn(by, __fmul_rn(err, gy[t]));
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    // du = -(gyy * bx - gxy * by) * inv_det
    // dv = -(-gxy * bx + gxx * by) * inv_det
    const float du = __fmul_rn(
        -__fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)), inv_det);
    const float dv = __fmul_rn(
        -__fadd_rn(__fmul_rn(-gxy, bx), __fmul_rn(gxx, by)), inv_det);
    u = __fadd_rn(u, du);
    v = __fadd_rn(v, dv);
  }
  if (lane == 0) {
    uv_out[2 * n] = u;
    uv_out[2 * n + 1] = v;
    ok_out[n] = ok ? 1 : 0;
  }
}

template <int T>
void launch(const float* prev_img, const float* next_img,
            const float* uv_prev, const float* uv_guess, float* uv_out,
            uint8_t* ok_out, int H, int W, int N, int P, int iters,
            float min_det, float lo, float hi_x, float hi_y,
            cudaStream_t stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_level_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      prev_img, next_img, uv_prev, uv_guess, uv_out, ok_out, H, W, N, P,
      iters, min_det, lo, hi_x, hi_y);
}

}  // namespace

// prev_img, next_img: f32 [H, W]; uv_prev, uv_guess, uv_out: f32 [N, 2];
// ok_out: one byte per feature (0 or 1).  patch is odd, 1..kMaxPatch (the
// wrapper checks); lo, hi_x, hi_y are _split_frac's clamp bounds in f32.
extern "C" int mld_lk_level(const float* prev_img, const float* next_img,
                            const float* uv_prev, const float* uv_guess,
                            float* uv_out, uint8_t* ok_out, int H, int W,
                            int N, int patch, int iters, float min_det,
                            float lo, float hi_x, float hi_y, void* stream) {
  if (patch < 1 || patch > kMaxPatch || patch % 2 != 1 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int taps = (patch * patch + 31) / 32;
    static_assert(kMaxTaps == 8, "the switch below ends at T = 8");
#define MLD_LK_CASE(T)                                                     \
  case T:                                                                  \
    launch<T>(prev_img, next_img, uv_prev, uv_guess, uv_out, ok_out, H, W, \
              N, patch, iters, min_det, lo, hi_x, hi_y, s);                \
    break;
    switch (taps) {
      MLD_LK_CASE(1)
      MLD_LK_CASE(2)
      MLD_LK_CASE(3)
      MLD_LK_CASE(4)
      MLD_LK_CASE(6)
      MLD_LK_CASE(8)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef MLD_LK_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
