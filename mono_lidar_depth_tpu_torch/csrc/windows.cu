// Per-feature rectangular window extraction on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mono_lidar_depth_tpu/core/pallas_windows.py::_window_kernel (launched
// by _windows_vmem).  It computes the same pure copy:
//
//     out[n, c, y, x] = stack[c, sy[n] + y, sx[n] + x]
//
// with the starts clamped to [0, H-Ky] x [0, W-Kx] exactly as
// lax.dynamic_slice clamps them, so no start can read out of bounds.
//
// What bounds it on this card: nothing but bytes.  The plane stack of a
// KITTI-sized frame (C = 2 planes of 384 x 1248 f32, 3.8 MB) stays
// resident in the 50 MB L2 across the launch, so the reads of
// overlapping windows hit L2; the device-memory traffic is the output,
// N * C * Ky * Kx * 4 bytes: 1.4 MB for the 11 x 8 primary window and
// 3.4 MB for the 15 x 14 road window at N = 2048, C = 2.  The TPU
// design (VMEM-resident stack, 8-row / 128-lane aligned slab, two
// rolls, 64-feature blocks, 128-lane output padding) answers TPU tiling
// rules that do not exist here, so none of it is carried over.
//
// Design: one thread block per group of kFeatsPerBlock features; inside
// a block the threads are laid over (feature, c, y, x) with x fastest,
// so neighbouring threads read neighbouring columns of one stack row
// and write neighbouring output words (both coalesced).  No shared
// memory, no allocation, no synchronisation: the launch goes on the
// caller's stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kFeatsPerBlock = 8;
constexpr int kThreads = 256;

__global__ void slice_windows_kernel(const float* __restrict__ stack,
                                     const int32_t* __restrict__ sy,
                                     const int32_t* __restrict__ sx,
                                     float* __restrict__ out,
                                     int C, int H, int W, int N,
                                     int Ky, int Kx) {
  const int per_feat = C * Ky * Kx;
  const int n0 = blockIdx.x * kFeatsPerBlock;
  const int n_here = min(kFeatsPerBlock, N - n0);
  const int total = n_here * per_feat;
  const size_t plane = static_cast<size_t>(H) * W;
  float* out_blk = out + static_cast<size_t>(n0) * per_feat;
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const int f = j / per_feat;
    const int r = j - f * per_feat;
    const int c = r / (Ky * Kx);
    const int yx = r - c * (Ky * Kx);
    const int y = yx / Kx;
    const int x = yx - y * Kx;
    const int n = n0 + f;
    const int y0 = min(max(__ldg(sy + n), 0), H - Ky);
    const int x0 = min(max(__ldg(sx + n), 0), W - Kx);
    out_blk[j] = __ldg(stack + c * plane
                       + static_cast<size_t>(y0 + y) * W + (x0 + x));
  }
}

}  // namespace

extern "C" int mld_slice_windows(const float* stack, const int32_t* sy,
                                 const int32_t* sx, float* out, int C, int H,
                                 int W, int N, int Ky, int Kx,
                                 void* stream) {
  if (N > 0) {
    const int blocks = (N + kFeatsPerBlock - 1) / kFeatsPerBlock;
    slice_windows_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        stack, sy, sx, out, C, H, W, N, Ky, Kx);
  }
  return static_cast<int>(cudaGetLastError());
}
