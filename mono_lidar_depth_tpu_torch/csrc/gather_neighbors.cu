// The whole neighbor gather of one odometry step on Hopper (sm_90a): crop,
// cell mask and decode of every search scale and every frame in ONE launch.
//
// Replaces, for the depth-path caller, the Pallas TPU kernel
// mono_lidar_depth_tpu/core/pallas_windows.py::_window_kernel (launched by
// _windows_vmem) together with the JAX code around it in
// mono_lidar_depth_tpu/core/neighbors.py::_gather_from_stack.  That code
// crops one raw [C, Ky, Kx] window per feature into device memory and then
// reads it back several times to build the clamped rectangle, the cell
// mask, the ground flag from the sign bit, the subpixel unpack, x/y from
// the pinhole relation, the masked points and the count; it does so once
// per search scale and per frame, and the caller joins the frames' fields
// afterwards.  Here the raw windows are never written: a warp reads a
// feature's cells straight from the frame's plane stack and writes the
// finished NeighborSet fields (mask, z, flags, points_cam, count and, when
// asked, indices) of that feature and scale, at the feature's place in the
// joined [N_a + N_b] lane order.
//
// What bounds it on this card: the bytes it writes.  Per step of the main
// path (two 384 x 1248 stacks of 2 planes, 2,048 features per frame,
// windows 11 x 8 and 15 x 14) the inputs are 7.7 MB, which stay in the
// 50 MB L2 from the rasterization that has just written them, and the
// outputs are 18 bytes per cell (mask 1, flags 1, z 4, points 12) x 298
// cells x 4,096 lanes = 22 MB.  The arithmetic is ~15 fp32 operations per
// cell, far below the fp32 peak for those bytes.
//
// Design.  One warp per (lane, scale), kWarpsPerBlock = 4 per 128-thread
// block.  The jobs are ordered by scale, the last (largest) scale first:
// a block's warps then all walk windows of one size and finish together,
// and the long jobs start first, so the SMs drain evenly.  (With the two
// scales of a lane in neighbouring warps of one block, which would let the
// second scale's reads hit the first's lines in L1, half of every block's
// warps sat idle while the other half finished the large window: slower
// on the card.  The stacks are in L2 either way.)  The clamped rectangle
// and the window start come from uv once per warp and are uniform across
// it.  The warp walks the window in rounds of 32 cells with x fastest, so
// neighbouring threads read neighbouring columns of a stack row and write
// neighbouring bytes or words of mask, flags, z and indices.  Both planes
// of a cell inside the rectangle are loaded before the occupancy test, so
// the two L2 round trips overlap.  points_cam has a 12-byte stride per
// cell: each round stages its 32 x 3 floats in shared memory and the warp
// writes them back as 96 consecutive words, three full 128-byte stores
// (storing them from registers with the 12-byte stride was slower).  The
// count is the sum of the rounds' ballots.  Cells outside the rectangle
// are not read at all.  The window size is a run-time argument and has no
// upper limit beyond the grid's.  The kernel takes 56 registers; capping
// them for more resident blocks spilled and was slower.
//
// Numbers.  Every fp32 step uses the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into FMAs,
// in the order of the plain PyTorch version
// (core/neighbors.py::_gather_from_stack), and the scalars (half sizes, cx,
// cy, 1/f) arrive as the f32 values PyTorch rounds a Python scalar to.  So
// every field is the plain version's to the bit.  A NaN feature position
// gives 0 at the integer cast, as in XLA and in the plain version.
//
// No allocation, no synchronisation: the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// One search scale: the rectangle's half sizes, the static window and the
// output fields [N, Ky * Kx] ([N, Ky * Kx, 3] for points, [N] for count).
// The layout is shared with the ctypes structure in kernels.py.
struct MldGatherScale {
  float half_x, half_y;
  int32_t ky, kx;
  uint8_t* mask;
  float* z;
  uint8_t* flags;
  float* points;
  int32_t* count;
  int32_t* indices;  // null unless with_indices
};

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxScales = 2;
constexpr unsigned kFullMask = 0xffffffffu;

struct GatherParams {
  const float* stack_a;  // [C, H, W] of the first frame
  const float* stack_b;  // of the second frame (unused when n_b == 0)
  const float* uv_a;     // [n_a, 2]
  const float* uv_b;     // [n_b, 2]
  int n_a, n_total;
  int H, W;
  int with_indices;  // plane 2 holds the raw point index
  int n_scales;
  float cx, cy, inv_f;
  MldGatherScale scale[kMaxScales];
};

// int32 of t clamped into [lo, hi], truncated toward zero; 0 for a NaN.
__device__ __forceinline__ int trunc_clamped(float t, float lo, float hi) {
  if (t != t) return 0;
  return __float2int_rz(fminf(fmaxf(t, lo), hi));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_neighbors_kernel(const GatherParams p) {
  __shared__ float s_points[kWarpsPerBlock][96];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarpsPerBlock + warp;
  // The whole warp leaves; only warp-level barriers follow.
  if (job >= p.n_total * p.n_scales) return;
  // Jobs in scale order, the last scale first; n is the lane of the joined
  // [n_a + n_b] order.
  const int behind = job / p.n_total;
  const int n = job - behind * p.n_total;
  const MldGatherScale sc =
      (p.n_scales - 1 - behind == 0) ? p.scale[0] : p.scale[1];
  const bool second = n >= p.n_a;
  const float* stack = second ? p.stack_b : p.stack_a;
  const float* uv = second ? p.uv_b + 2 * (n - p.n_a) : p.uv_a + 2 * n;

  const int H = p.H, W = p.W, Ky = sc.ky, Kx = sc.kx, K = Ky * Kx;
  const float u = __ldg(uv);
  const float v = __ldg(uv + 1);
  // The reference's dynamic rectangle, inclusive; x1 < x0 or y1 < y0 for
  // a feature off the image.
  const int x0 = trunc_clamped(__fsub_rn(u, sc.half_x), 0.0f,
                               static_cast<float>(W));
  const int x1 = trunc_clamped(__fadd_rn(u, sc.half_x), -1.0f,
                               static_cast<float>(W - 1));
  const int y0 = trunc_clamped(__fsub_rn(v, sc.half_y), 0.0f,
                               static_cast<float>(H));
  const int y1 = trunc_clamped(__fadd_rn(v, sc.half_y), -1.0f,
                               static_cast<float>(H - 1));
  // Start of the static window, shifted to stay inside the grid.
  const int sy = min(y0, H - Ky);
  const int sx = min(x0, W - Kx);

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t out0 = static_cast<size_t>(n) * K;
  float* stage = s_points[warp];
  // This thread's cell of the current round, advanced by 32 cells a round.
  int y = lane / Kx;
  int x = lane - y * Kx;
  const int step_y = 32 / Kx;
  const int step_x = 32 - step_y * Kx;
  int count = 0;

  for (int base = 0; base < K; base += 32) {
    const int j = base + lane;
    bool m = false, flag = false;
    int idx = -1;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    const int row = sy + y;
    const int col = sx + x;
    if (j < K && row >= y0 && row <= y1 && col >= x0 && col <= x1) {
      const float* cell = stack + static_cast<size_t>(row) * W + col;
      const float z_enc = __ldg(cell);
      const float packed = __ldg(cell + plane);
      if (p.with_indices) {
        idx = __float2int_rz(__ldg(cell + 2 * plane));
        m = idx != -1;
      } else {
        m = z_enc != 0.0f;  // winners have z > 0: 0 means an empty cell
      }
      if (m) {
        flag = z_enc < 0.0f;  // the ground-inlier flag rides in the sign
        pz = fabsf(z_enc);
        const float qu = floorf(__fmul_rn(packed, 1.0f / 4096.0f));
        const float qv = __fsub_rn(packed, __fmul_rn(qu, 4096.0f));
        const float uu = __fadd_rn(
            __int2float_rn(col),
            __fmul_rn(__fadd_rn(qu, 0.5f), 1.0f / 4096.0f));
        const float vv = __fadd_rn(
            __int2float_rn(row),
            __fmul_rn(__fadd_rn(qv, 0.5f), 1.0f / 4096.0f));
        px = __fmul_rn(__fmul_rn(__fsub_rn(uu, p.cx), p.inv_f), pz);
        py = __fmul_rn(__fmul_rn(__fsub_rn(vv, p.cy), p.inv_f), pz);
      }
    }
    count += __popc(__ballot_sync(kFullMask, m));
    if (j < K) {
      sc.mask[out0 + j] = m ? 1 : 0;
      sc.flags[out0 + j] = flag ? 1 : 0;
      sc.z[out0 + j] = pz;
      if (sc.indices != nullptr) sc.indices[out0 + j] = idx;
    }
    stage[3 * lane] = px;
    stage[3 * lane + 1] = py;
    stage[3 * lane + 2] = pz;
    __syncwarp();
    const int words = 3 * min(32, K - base);
    float* dst = sc.points + 3 * (out0 + base);
    for (int i = lane; i < words; i += 32) dst[i] = stage[i];
    __syncwarp();

    y += step_y;
    x += step_x;
    if (x >= Kx) {
      x -= Kx;
      ++y;
    }
  }
  if (lane == 0) sc.count[n] = count;
}

}  // namespace

// stack_a, stack_b: f32 [C, H, W] plane stacks of the two frames (plane 0:
// z with the ground flag in its sign bit, plane 1: packed subpixel offsets,
// plane 2 when with_indices: the raw point index as f32); uv_a [n_a, 2],
// uv_b [n_b, 2]: feature positions.  n_b == 0 is the one-frame form.
// scales: n_scales (1 or 2) MldGatherScale records in host memory, read
// before the launch.  cx, cy, inv_f: the pinhole's centre and 1 / f.
extern "C" int mld_gather_neighbors(const float* stack_a, const float* stack_b,
                                    const float* uv_a, const float* uv_b,
                                    int n_a, int n_b, int C, int H, int W,
                                    int with_indices, float cx, float cy,
                                    float inv_f, const MldGatherScale* scales,
                                    int n_scales, void* stream) {
  if (n_scales < 1 || n_scales > kMaxScales || n_a < 0 || n_b < 0 ||
      C < (with_indices ? 3 : 2) || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherParams p;
  p.stack_a = stack_a;
  p.stack_b = stack_b;
  p.uv_a = uv_a;
  p.uv_b = uv_b;
  p.n_a = n_a;
  p.n_total = n_a + n_b;
  p.H = H;
  p.W = W;
  p.with_indices = with_indices;
  p.n_scales = n_scales;
  p.cx = cx;
  p.cy = cy;
  p.inv_f = inv_f;
  for (int s = 0; s < kMaxScales; ++s) {
    p.scale[s] = scales[s < n_scales ? s : 0];
    if (p.scale[s].ky < 1 || p.scale[s].ky > H || p.scale[s].kx < 1 ||
        p.scale[s].kx > W) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long jobs = static_cast<long long>(p.n_total) * n_scales;
  if (jobs > 0) {
    const unsigned blocks =
        static_cast<unsigned>((jobs + kWarpsPerBlock - 1) / kWarpsPerBlock);
    gather_neighbors_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
