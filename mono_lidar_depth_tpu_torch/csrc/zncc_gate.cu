// The acceptance gate of pyramidal Lucas-Kanade tracking on Hopper
// (sm_90a): both bilinear patches of every feature, their zero-normalized
// cross-correlation, the forward-backward error, the in-image test and
// the conjunction of all six flags in ONE launch per tracked frame.
//
// Replaces, for the ZNCC caller, the Pallas TPU kernel
// mono_lidar_depth_tpu/core/pallas_windows.py::_window_kernel (launched by
// _windows_vmem) together with the JAX code around it in
// mono_lidar_depth_tpu/tracker/klt.py::track_features: that code makes an
// edge-padded copy of each finest-level image, cuts one (patch+1)^2 window
// per feature from each, blends the windows into patches, reduces the
// patches to a correlation and combines it with the other tests, each step
// through device memory.  Here a tap at padded coordinate p reads
// img[clamp(p - pad, 0, size - 1)], which is what the edge pad followed by
// the crop reads, so no padded copy, no window and no patch is written:
// the kernel writes ok and ncc, 5 bytes per feature.
//
// What bounds it on this card: bytes, nominally (both images read once,
// three positions and three flags per feature in, ok and ncc out: about
// 1.1 us at 370x1226 and 2,048 features; its 2 * patch^2 * ~20 flop per
// feature are far below that).  Both images are 3.6 MB and stay in the
// 50 MB L2, so what the launch really costs is its ramp and tail and two
// rounds of latency: load -> blend -> 2 sums for the means -> 3 centred
// sums -> gate.
//
// Design.  One warp per feature, kWarpsPerBlock = 4 features per
// 128-thread block: 512 small blocks at N = 2048, about 4 on each SM.  A
// lane holds T = ceil(patch^2 / 32) taps of each patch in
// registers (3 at patch 9; instantiated for T = 1, 2, 3, 4, 6, 8, the
// counts of the odd patches up to kMaxPatch = 15).  The two patches of a
// feature do not depend on each other, so the 8 corner loads of every tap
// (4 per image; the duplicates between neighbouring taps hit L1) are all
// started before the first blend and one round trip covers both images.
// Nothing is staged in shared memory and there is no barrier.
//
// Numbers.  Every elementwise step uses the round-to-nearest intrinsics in
// the order of the plain PyTorch version (tracker/klt.py::
// _track_gate_reference), so the blends, the centring, the products, the
// forward-backward error and every comparison are the plain version's to
// the bit for the same inputs.  The five sums run lane-strided and then
// through an xor-shuffle butterfly, which is not torch.sum's order: ncc is
// held to a stated tolerance, ok to the lanes whose ncc is not within that
// tolerance of min_ncc.  The mean is the sum times the f32 reciprocal of
// patch^2, as torch.mean forms it on the card (the CPU divides instead, a
// difference of an ulp of the mean).  A NaN coordinate
// in uv or uv_f makes the plain version's fraction, patch and ncc NaN;
// split_frac's fminf/fmaxf would drop the NaN, so the kernel tests for it
// and writes ncc = NaN, ok = false.  Infinite coordinates clamp to the
// border as they do in the plain version.
//
// No allocation, no synchronisation: the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "lk_common.cuh"

namespace {

constexpr int kMaxPatch = 15;
// gate_variants.py builds this source with 2, 8 and 16 warps per block,
// and with MLD_GATE_EMPTY, beside the shipped 4, to time them in turns.
#ifndef MLD_GATE_WARPS
#define MLD_GATE_WARPS 4
#endif
constexpr int kWarpsPerBlock = MLD_GATE_WARPS;
constexpr int kMaxTaps = (kMaxPatch * kMaxPatch + 31) / 32;  // per lane
constexpr float kEps = 1e-8f;  // _zncc's floor of the denominator

template <int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
zncc_gate_kernel(const float* __restrict__ prev_img,
                 const float* __restrict__ next_img,
                 const float* __restrict__ uv, const float* __restrict__ uv_f,
                 const float* __restrict__ uv_b,
                 const uint8_t* __restrict__ valid,
                 const uint8_t* __restrict__ ok_f,
                 const uint8_t* __restrict__ ok_b, uint8_t* __restrict__ ok_out,
                 float* __restrict__ ncc_out, int H, int W, int N, int P,
                 float min_ncc, float fb_threshold, float lo, float hi_x,
                 float hi_y, float in_hi_x, float in_hi_y) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;  // the whole warp leaves; only shuffles follow
#ifndef MLD_GATE_EMPTY  // defined: the same grid doing nothing, a launch's cost

  const int r = (P - 1) / 2;
  const int PP = P * P;
  const float u0 = __ldg(uv + 2 * n), v0 = __ldg(uv + 2 * n + 1);
  const float u1 = __ldg(uv_f + 2 * n), v1 = __ldg(uv_f + 2 * n + 1);
  // Everything else the gate reads, asked for now (every lane, one
  // address) so that it arrives under the patches' round trip and not as
  // a third one after the sums.
  const float u2 = __ldg(uv_b + 2 * n), v2 = __ldg(uv_b + 2 * n + 1);
  const bool flags = __ldg(valid + n) && __ldg(ok_f + n) && __ldg(ok_b + n);
  int ix, iy, jx, jy;
  float fx, fy, hx, hy;
  split_frac(u0, v0, lo, hi_x, hi_y, ix, iy, fx, fy);
  split_frac(u1, v1, lo, hi_x, hi_y, jx, jy, hx, hy);

  // ---- all corner loads of both patches, then the blends
  float a[T][4], b[T][4];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int k = lane + 32 * t;
    if (k < PP) {
      const int ty = k / P;
      const int tx = k - ty * P;
      const float* pr0 =
          prev_img + static_cast<size_t>(clampi(iy - r + ty, 0, H - 1)) * W;
      const float* pr1 =
          prev_img + static_cast<size_t>(clampi(iy - r + ty + 1, 0, H - 1)) * W;
      const float* nr0 =
          next_img + static_cast<size_t>(clampi(jy - r + ty, 0, H - 1)) * W;
      const float* nr1 =
          next_img + static_cast<size_t>(clampi(jy - r + ty + 1, 0, H - 1)) * W;
      const int pa = clampi(ix - r + tx, 0, W - 1);
      const int pb = clampi(ix - r + tx + 1, 0, W - 1);
      const int na = clampi(jx - r + tx, 0, W - 1);
      const int nb = clampi(jx - r + tx + 1, 0, W - 1);
      a[t][0] = __ldg(pr0 + pa);
      a[t][1] = __ldg(pr0 + pb);
      a[t][2] = __ldg(pr1 + pa);
      a[t][3] = __ldg(pr1 + pb);
      b[t][0] = __ldg(nr0 + na);
      b[t][1] = __ldg(nr0 + nb);
      b[t][2] = __ldg(nr1 + na);
      b[t][3] = __ldg(nr1 + nb);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[t][c] = b[t][c] = 0.0f;
    }
  }
  float pa_[T], pb_[T];  // the template and the tracked patch
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    pa_[t] = lerp2(a[t][0], a[t][1], a[t][2], a[t][3], fx, fy);
    pb_[t] = lerp2(b[t][0], b[t][1], b[t][2], b[t][3], hx, hy);
    sa = __fadd_rn(sa, pa_[t]);  // a tap past the patch adds +0
    sb = __fadd_rn(sb, pb_[t]);
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  const float inv_count = __fdiv_rn(1.0f, static_cast<float>(PP));
  const float ma = __fmul_rn(sa, inv_count);
  const float mb = __fmul_rn(sb, inv_count);

  // ---- the three centred sums
  float num = 0.0f, saa = 0.0f, sbb = 0.0f;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (lane + 32 * t < PP) {
      const float am = __fsub_rn(pa_[t], ma);
      const float bm = __fsub_rn(pb_[t], mb);
      num = __fadd_rn(num, __fmul_rn(am, bm));
      saa = __fadd_rn(saa, __fmul_rn(am, am));
      sbb = __fadd_rn(sbb, __fmul_rn(bm, bm));
    }
  }
  num = warp_sum(num);
  saa = warp_sum(saa);
  sbb = warp_sum(sbb);

  if (lane == 0) {
    const float den = __fsqrt_rn(__fmul_rn(saa, sbb));
    // torch.clamp(den, min=eps) keeps a NaN, as this comparison does
    float ncc = __fdiv_rn(num, den < kEps ? kEps : den);
    if (isnan(u0) || isnan(v0) || isnan(u1) || isnan(v1)) ncc = CUDART_NAN_F;
    const float dx = __fsub_rn(u2, u0);
    const float dy = __fsub_rn(v2, v0);
    const float fb_err =
        __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    // every comparison is false on a NaN, as in the plain version
    const bool in_img = u1 > 1.0f && u1 < in_hi_x && v1 > 1.0f && v1 < in_hi_y;
    const bool ok = flags && fb_err < fb_threshold && in_img && ncc > min_ncc;
    ok_out[n] = ok ? 1 : 0;
    ncc_out[n] = ncc;
  }
#endif  // MLD_GATE_EMPTY
}

template <int T>
void launch(const float* prev_img, const float* next_img, const float* uv,
            const float* uv_f, const float* uv_b, const uint8_t* valid,
            const uint8_t* ok_f, const uint8_t* ok_b, uint8_t* ok_out,
            float* ncc_out, int H, int W, int N, int P, float min_ncc,
            float fb_threshold, float lo, float hi_x, float hi_y,
            float in_hi_x, float in_hi_y, cudaStream_t stream) {
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  zncc_gate_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      prev_img, next_img, uv, uv_f, uv_b, valid, ok_f, ok_b, ok_out, ncc_out,
      H, W, N, P, min_ncc, fb_threshold, lo, hi_x, hi_y, in_hi_x, in_hi_y);
}

}  // namespace

// prev_img, next_img: f32 [H, W]; uv, uv_f, uv_b: f32 [N, 2]; valid, ok_f,
// ok_b, ok_out: one byte per feature (0 or 1); ncc_out: f32 [N].  patch is
// odd, 1..kMaxPatch (the wrapper checks); lo, hi_x, hi_y are _split_frac's
// clamp bounds and in_hi_x, in_hi_y the in-image limits W - 2 and H - 2,
// all in f32.
extern "C" int mld_zncc_gate(const float* prev_img, const float* next_img,
                             const float* uv, const float* uv_f,
                             const float* uv_b, const uint8_t* valid,
                             const uint8_t* ok_f, const uint8_t* ok_b,
                             uint8_t* ok_out, float* ncc_out, int H, int W,
                             int N, int patch, float min_ncc,
                             float fb_threshold, float lo, float hi_x,
                             float hi_y, float in_hi_x, float in_hi_y,
                             void* stream) {
  if (patch < 1 || patch > kMaxPatch || patch % 2 != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int taps = (patch * patch + 31) / 32;
    static_assert(kMaxTaps == 8, "the switch below ends at T = 8");
#define MLD_GATE_CASE(T)                                                    \
  case T:                                                                   \
    launch<T>(prev_img, next_img, uv, uv_f, uv_b, valid, ok_f, ok_b,        \
              ok_out, ncc_out, H, W, N, patch, min_ncc, fb_threshold, lo,   \
              hi_x, hi_y, in_hi_x, in_hi_y, s);                             \
    break;
    switch (taps) {
      MLD_GATE_CASE(1)
      MLD_GATE_CASE(2)
      MLD_GATE_CASE(3)
      MLD_GATE_CASE(4)
      MLD_GATE_CASE(6)
      MLD_GATE_CASE(8)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef MLD_GATE_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
