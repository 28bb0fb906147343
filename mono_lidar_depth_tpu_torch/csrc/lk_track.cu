// All of track_features' Lucas-Kanade work on Hopper (sm_90a) in ONE
// launch: for every feature the forward pass over every pyramid level,
// coarse to fine, then the backward pass from the forward result.
//
// Replaces, for the KLT caller, the Pallas TPU kernel
// mono_lidar_depth_tpu/core/pallas_windows.py::_window_kernel (launched by
// _windows_vmem) together with the JAX code around it in
// mono_lidar_depth_tpu/tracker/klt.py: _lk_level, which per level makes two
// edge-padded copies of the images, cuts one (patch+3)^2 window per feature
// for the template and one (patch+1)^2 window per feature and iteration,
// and runs the blend, two dot products and a 2x2 solve on the windows it
// wrote to device memory; and _pyramidal, run twice by track_features,
// which chains the levels.  The kernel computes what the plain PyTorch
// composition tracker/klt.py::_track_passes_reference computes,
//
//   uv_f, ok_f = _pyramidal(prev_pyr, next_pyr, uv, guess=guess)
//   uv_b, ok_b = _pyramidal(next_pyr, prev_pyr, uv_f, guess=uv),
//
// and writes those four arrays and nothing else.  A tap at padded
// coordinate p reads img[clamp(p - pad, 0, size - 1)], which is what the
// edge pad followed by the crop reads, so no padded copy and no window is
// ever written to device memory.
//
// What bounds it on this card: not bytes (both pyramids are 4.8 MB at the
// KITTI size and stay in the 50 MB L2) and not operations (~180 MFLOP per
// call at patch 9, 8 iterations, 4 levels), but the chain of dependent
// rounds of each feature: 2 x levels x (1 + iters) rounds of load ->
// blend -> warp reduction -> update, each of which needs the one before.
// What the design does about it:
//   * one launch per track_features: the levels and the two passes follow
//     each other in registers (the _pyramidal steps guess / 2^(L-1),
//     uv / s, guess * 2 and the AND of the level flags, all exact in fp32
//     for powers of two), so no launch, ramp-up or host op sits between
//     two levels;
//   * each level's template window leaves the chain: a pass's templates
//     depend only on its start point (uv / s forward, uv_f / s backward),
//     so while a level iterates, the next level's (patch+3)^2 window is
//     already on its way into shared memory with cp.async (4-byte copies;
//     TMA needs a 16-byte row pitch, and 1226, 613, 306 and 153 floats are
//     none).  Only the first level of each pass waits for its window;
//   * the iterated image's neighbourhood of the level's start point,
//     kMargin px around the iteration window, is staged in shared memory,
//     issued before the template stage so that the two overlap; an
//     iteration whose window lies inside it reads shared memory, 1
//     wavefront per corner load (its row stride P + 32 is P modulo the 32
//     banks), where a read through L1 touches about 4 lines; a window
//     outside it reads global memory, which holds the same values;
//   * the patch is a template parameter, so window shapes, strides and
//     the divisions that place a tap are constants;
//   * one warp per feature, 4 per block.
// A half-warp per feature, reads through L1 instead of the staged
// neighbourhood, and margins of 2 and 5 px were each slower on the H100
// (PERF.md, PR 8).
//
// Numbers.  Every elementwise step uses the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, ...), which nvcc never contracts into FMAs, in
// the order of the plain version (tracker/klt.py::_lk_level_reference,
// _pyramidal), and every P^2-term sum runs in the order in which torch.sum
// sums a row on the card (TapOrder below).  So the kernel gives the plain
// version's bits on the card.
//
// No allocation, no synchronisation: the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "lk_common.cuh"

// One pyramid level of both frames: the two images and _split_frac's
// clamp bounds at this level (tracker/klt.py::_clamp_bounds, in f32).
struct MldLkLevel {
  const float* prev;  // prev_pyr[level], f32 [H, W]
  const float* next;  // next_pyr[level], f32 [H, W]
  int32_t H, W;
  float lo, hi_x, hi_y;
};

namespace {

constexpr int kMaxPatch = 15;
constexpr int kMaxLevels = 8;
constexpr int kGroups = 4;  // features (warps) per block
constexpr int kThreads = 32 * kGroups;
// 2,048 features make 512 blocks of 4 warps: 4 blocks on each of the 132
// SMs hold them all at once.  Saying so lets ptxas use up to 128
// registers a thread, where it would otherwise spill to fit more blocks;
// the 10 tap slots of patches 13 and 15 need more, and take 3 blocks.
template <int P>
constexpr int kMinBlocks = P * P >= 128 ? 3 : 4;
// Staged margin, px on each side of the iteration window.
constexpr int kMargin = 3;
static_assert(2 * kMargin + 1 <= 32,
              "the staged rows must fit their stride P + 32");

struct Params {
  MldLkLevel level[kMaxLevels];
  const float* uv;
  const float* guess;
  float* uv_f;
  uint8_t* ok_f;
  float* uv_b;
  uint8_t* ok_b;
  int n_levels, N, iters;
  float min_det;
};

// The order of every P^2-term sum: the one torch.sum takes on the card
// for a row of a contiguous float32 [N, P^2] tensor, which is what the
// plain version sums.  It is read off ATen's Reduce.cuh as torch 2.11 has
// it (the inner-dimension reduction; the 4-wide vector loads from a
// reduced dimension of 128 on, `dim0 >= 128`), and chip_smoke.py phase 3
// checks it to the bit: if a later torch changes that layout, the check
// fails there while the kernel still meets its 1e-3 px bar, and this order
// is to be read again from the new Reduce.cuh.  32 threads ("columns",
// here the feature's lanes) share a row; each sums its terms, and the 32
// column sums pair up as an xor butterfly with offsets 16, 8, 4, 2, 1.  Below 128 terms column c takes
// the terms c, c + 32, ... in turn.  From 128 terms on (patches 13 and
// 15) the row is read 4 aligned floats at a time into 4 accumulators: a
// row that starts `shift` floats past a 16-byte boundary (shift = n P^2
// mod 4 for row n) gives its first 4 - shift terms to columns shift..3 as
// the first value of their accumulator 0; then column c takes the
// 4-vectors c and c + 32 of what follows, term i of a vector into
// accumulator i; then column c < (terms left) % 4 takes one tail term
// into accumulator 0; and the 4 accumulators are added in turn.
template <int P>
struct TapOrder {
  static constexpr int kTerms = P * P;
  static constexpr bool kVec = kTerms >= 128;
  // slots of a column: the terms in turn, or head, 2 x 4 vector terms and
  // tail; a patch of at most 15 has at most 64 vectors.
  static constexpr int kSlots = kVec ? 10 : (kTerms + 31) / 32;
  static_assert(kTerms <= 256, "two vectors per column at most");

  __device__ static constexpr int acc(int s) {
    return kVec && s != 0 && s != 9 ? (s - 1) & 3 : 0;
  }
  // The term (tap index) of slot s of column c in a row with this shift,
  // or -1.
  __device__ static int term(int c, int s, int shift) {
    if (!kVec) {
      const int k = c + 32 * s;
      return k < kTerms ? k : -1;
    }
    const int base = shift ? 4 - shift : 0;
    const int end = kTerms - base;
    if (s == 0) return shift && c >= shift && c < 4 ? c - shift : -1;
    if (s == 9) return c < (end & 3) ? base + (end & ~3) + c : -1;
    const int vec = c + 32 * ((s - 1) >> 2);
    return 4 * vec + 3 < end ? base + 4 * vec + ((s - 1) & 3) : -1;
  }
  __device__ static float total(const float (&a)[4]) {
    return kVec ? __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3])
                : a[0];
  }
};

// Shared memory of one feature, in floats: two template windows (the
// current level's and the next one's, on its way), the template blend
// and the neighbourhood of the iterated image.
template <int P>
struct Smem {
  static constexpr int kK3 = P + 3;  // template window
  static constexpr int kK2 = P + 2;  // its blend: template + gradient ring
  static constexpr int kRows = P + 1 + 2 * kMargin;  // staged rows
  static constexpr int kStride = P + 32;  // = P mod 32: no bank conflict
  static constexpr int kWindow = kK3 * kK3;
  static constexpr int kHood = kRows * kStride;
  static constexpr int kFloats = 2 * kWindow + kK2 * kK2 + kHood;
};

// img[clamp(y0 + y), clamp(x0 + x)] for a rows x cols block into dst (row
// stride ld), by the feature's warp with 4-byte cp.async copies, as one
// committed batch.
template <int kRowsN, int kColsN, int kLd>
__device__ __forceinline__ void issue_block(float* dst, const float* img,
                                            int H, int W, int x0, int y0,
                                            int l) {
#pragma unroll
  for (int j = l; j < kRowsN * kColsN; j += 32) {
    const int y = j / kColsN;
    const int x = j - y * kColsN;
    const float* src = img +
                       static_cast<size_t>(clampi(y0 + y, 0, H - 1)) * W +
                       clampi(x0 + x, 0, W - 1);
    __pipeline_memcpy_async(dst + y * kLd + x, src, sizeof(float));
  }
  __pipeline_commit();
}

// Stage k of a launch runs pass k / L (0 forward, 1 backward) at level
// L - 1 - k % L; its template window is cut around the pass' start point
// (uv forward, the forward result backward) at that level's scale.
__device__ __forceinline__ int stage_level(int k, int L) {
  return L - 1 - (k < L ? k : k - L);
}

__device__ __forceinline__ void template_frac(const Params& p, int k,
                                              float su, float sv, int& ix,
                                              int& iy, float& fx, float& fy) {
  const int lvl = stage_level(k, p.n_levels);
  const MldLkLevel& lev = p.level[lvl];
  const float s = static_cast<float>(1 << lvl);
  split_frac(__fdiv_rn(su, s), __fdiv_rn(sv, s), lev.lo, lev.hi_x, lev.hi_y,
             ix, iy, fx, fy);
}

// Stage k's template window into its buffer, as one cp.async batch.
template <int P>
__device__ __forceinline__ void issue_template(const Params& p, int k,
                                               float* windows, float su,
                                               float sv, int l) {
  using M = Smem<P>;
  const MldLkLevel& lev = p.level[stage_level(k, p.n_levels)];
  constexpr int r = (P - 1) / 2;
  int ix, iy;
  float fx, fy;
  template_frac(p, k, su, sv, ix, iy, fx, fy);
  issue_block<M::kK3, M::kK3, M::kK3>(
      windows + (k & 1) * M::kWindow, k < p.n_levels ? lev.prev : lev.next,
      lev.H, lev.W, ix - r - 1, iy - r - 1, l);
}

// Stage k's neighbourhood of its iterated image around (cu, cv), a point
// at the level's scale, as one cp.async batch; returns the
// neighbourhood's corner in (sx0, sy0).
template <int P>
__device__ __forceinline__ void issue_staged(const Params& p, int k,
                                             float* staged, float cu,
                                             float cv, int& sx0, int& sy0,
                                             int l) {
  using M = Smem<P>;
  constexpr int r = (P - 1) / 2;
  const MldLkLevel& lev = p.level[stage_level(k, p.n_levels)];
  int jx, jy;
  float hx, hy;
  split_frac(cu, cv, lev.lo, lev.hi_x, lev.hi_y, jx, jy, hx, hy);
  sx0 = jx - r - kMargin;
  sy0 = jy - r - kMargin;
  issue_block<M::kRows, M::kRows, M::kStride>(
      staged, k < p.n_levels ? lev.next : lev.prev,
      lev.H, lev.W, sx0, sy0, l);
}

template <int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
lk_track_kernel(const __grid_constant__ Params p) {
  using M = Smem<P>;
  using O = TapOrder<P>;
  constexpr int r = (P - 1) / 2;
  constexpr int K2 = M::kK2, K3 = M::kK3, S = M::kStride;
  constexpr int kS = O::kSlots;
  extern __shared__ float smem[];

  const int g = threadIdx.x / 32;  // feature within the block
  const int l = threadIdx.x % 32;  // lane within the feature
  const int n = blockIdx.x * kGroups + g;
  // A whole warp past the last feature leaves; no block-wide barrier
  // follows.
  if (n >= p.N) return;
  const int L = p.n_levels, iters = p.iters;
  float* const windows = smem + g * M::kFloats;
  float* const blend = windows + 2 * M::kWindow;
  float* const staged = blend + K2 * K2;

  // This lane's taps: slot s of column l, in TapOrder.
  const int shift = static_cast<int>((static_cast<int64_t>(n) * P * P) & 3);
  int ty[kS], tx[kS];
  unsigned used = 0u;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int k = O::term(l, s, shift);
    used |= k >= 0 ? 1u << s : 0u;
    ty[s] = k >= 0 ? k / P : 0;
    tx[s] = k >= 0 ? k - ty[s] * P : 0;
  }

  const float u0 = __ldg(p.uv + 2 * n), v0 = __ldg(p.uv + 2 * n + 1);
  const float gu0 = __ldg(p.guess + 2 * n), gv0 = __ldg(p.guess + 2 * n + 1);
  float uf = 0.0f, vf = 0.0f;  // the forward pass' result
  bool okf = false;

  // A pass starts at its guess / 2^(L-1).
  const float top = static_cast<float>(1 << (L - 1));
  issue_template<P>(p, 0, windows, u0, v0, l);
  float u = 0.0f, v = 0.0f;  // the carried position, uniform over the lanes
  bool ok_all = true;
  for (int k = 0; k < 2 * L; ++k) {
    const bool fwd = k < L;
    const int lvl = stage_level(k, L);
    const MldLkLevel& lev = p.level[lvl];
    const float* const img = fwd ? lev.next : lev.prev;  // iterated image
    const int H = lev.H, W = lev.W;
    if (k == 0 || k == L) {
      u = __fdiv_rn(fwd ? gu0 : u0, top);
      v = __fdiv_rn(fwd ? gv0 : v0, top);
      ok_all = true;
    }
    // The neighbourhood of the level's start goes out first; the template
    // window was issued during the last stage (the first of each pass: at
    // the start and at the pass' end).
    int sx0, sy0;
    __syncwarp();  // no lane still reads the last level's neighbourhood
    issue_staged<P>(p, k, staged, u, v, sx0, sy0, l);
    __pipeline_wait_prior(1);
    __syncwarp();

    // ---- template stage: window -> blend -> template, gx, gy
    int ix, iy;
    float fx, fy;
    template_frac(p, k, fwd ? u0 : uf, fwd ? v0 : vf, ix, iy, fx, fy);
    const float* const win = windows + (k & 1) * M::kWindow;
#pragma unroll
    for (int j = l; j < K2 * K2; j += 32) {
      const int y = j / K2;
      const int x = j - y * K2;
      const float* w = win + y * K3 + x;
      blend[j] = lerp2(w[0], w[1], w[K3], w[K3 + 1], fx, fy);
    }
    __syncwarp();
    float tpl[kS], gx[kS], gy[kS];
    float axx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float axy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ayy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      tpl[s] = gx[s] = gy[s] = 0.0f;
      if (used >> s & 1u) {
        const float* b = blend + (ty[s] + 1) * K2 + tx[s] + 1;
        tpl[s] = b[0];
        gx[s] = __fmul_rn(__fsub_rn(b[1], b[-1]), 0.5f);
        gy[s] = __fmul_rn(__fsub_rn(b[K2], b[-K2]), 0.5f);
        const int a = O::acc(s);
        axx[a] = __fadd_rn(axx[a], __fmul_rn(gx[s], gx[s]));
        axy[a] = __fadd_rn(axy[a], __fmul_rn(gx[s], gy[s]));
        ayy[a] = __fadd_rn(ayy[a], __fmul_rn(gy[s], gy[s]));
      }
    }
    const float gxx = warp_sum(O::total(axx));
    const float gxy = warp_sum(O::total(axy));
    const float gyy = warp_sum(O::total(ayy));
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    const bool ok = det > p.min_det;
    const float inv_det =
        ok ? __fdiv_rn(1.0f, det == 0.0f ? 1.0f : det) : 0.0f;

    // The next level's window goes out now; its level waits for it.
    const bool next_known = k + 1 < 2 * L && k + 1 != L;
    if (next_known) {
      const bool next_fwd = k + 1 < L;
      issue_template<P>(p, k + 1, windows, next_fwd ? u0 : uf,
                        next_fwd ? v0 : vf, l);
    }

    // The neighbourhood is in.
    if (next_known) {
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();

    // ---- iterations
    for (int it = 0; it < iters; ++it) {
      int jx, jy;
      float hx, hy;
      split_frac(u, v, lev.lo, lev.hi_x, lev.hi_y, jx, jy, hx, hy);
      const int ox = jx - r - sx0;
      const int oy = jy - r - sy0;
      const bool inside = static_cast<unsigned>(ox) <= 2u * kMargin &&
                          static_cast<unsigned>(oy) <= 2u * kMargin;
      float abx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float aby[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        if (used >> s & 1u) {
          float a, b, c, d;
          if (inside) {
            const float* q = staged + (oy + ty[s]) * S + ox + tx[s];
            a = q[0];
            b = q[1];
            c = q[S];
            d = q[S + 1];
          } else {
            const int y0 = jy - r + ty[s];
            const int x0 = jx - r + tx[s];
            const float* row0 =
                img + static_cast<size_t>(clampi(y0, 0, H - 1)) * W;
            const float* row1 =
                img + static_cast<size_t>(clampi(y0 + 1, 0, H - 1)) * W;
            const int xa = clampi(x0, 0, W - 1);
            const int xb = clampi(x0 + 1, 0, W - 1);
            a = __ldg(row0 + xa);
            b = __ldg(row0 + xb);
            c = __ldg(row1 + xa);
            d = __ldg(row1 + xb);
          }
          const float err = __fsub_rn(lerp2(a, b, c, d, hx, hy), tpl[s]);
          const int t = O::acc(s);
          abx[t] = __fadd_rn(abx[t], __fmul_rn(err, gx[s]));
          aby[t] = __fadd_rn(aby[t], __fmul_rn(err, gy[s]));
        }
      }
      const float bx = warp_sum(O::total(abx));
      const float by = warp_sum(O::total(aby));
      // du = -(gyy * bx - gxy * by) * inv_det
      // dv = -(-gxy * bx + gxx * by) * inv_det
      const float du = __fmul_rn(
          -__fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)), inv_det);
      const float dv = __fmul_rn(
          -__fadd_rn(__fmul_rn(-gxy, bx), __fmul_rn(gxx, by)), inv_det);
      u = __fadd_rn(u, du);
      v = __fadd_rn(v, dv);
    }
    ok_all = ok_all && ok;
    if (lvl > 0) {
      u = __fmul_rn(u, 2.0f);
      v = __fmul_rn(v, 2.0f);
    }
    if (k == L - 1) {  // the forward pass is done: the backward one starts
      uf = u;
      vf = v;
      okf = ok_all;
      issue_template<P>(p, L, windows, uf, vf, l);
    }
  }
  if (l == 0) {
    p.uv_f[2 * n] = uf;
    p.uv_f[2 * n + 1] = vf;
    p.ok_f[n] = okf ? 1 : 0;
    p.uv_b[2 * n] = u;
    p.uv_b[2 * n + 1] = v;
    p.ok_b[n] = ok_all ? 1 : 0;
  }
}

template <int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = kGroups * Smem<P>::kFloats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(lk_track_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.N + kGroups - 1) / kGroups;
  lk_track_kernel<P><<<blocks, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

}  // namespace

// levels: n_levels MldLkLevel records in host memory, finest first, read
// before the launch.  uv, guess: f32 [N, 2] at the finest level (guess is
// the forward pass' start; the backward pass starts at uv).  uv_f, uv_b:
// f32 [N, 2]; ok_f, ok_b: one byte per feature (0 or 1).  patch is odd,
// 1..kMaxPatch; n_levels 1..kMaxLevels (the wrapper checks both).
extern "C" int mld_lk_track(const MldLkLevel* levels, int n_levels,
                            const float* uv, const float* guess, float* uv_f,
                            uint8_t* ok_f, float* uv_b, uint8_t* ok_b, int N,
                            int patch, int iters, float min_det,
                            void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || patch < 1 ||
      patch > kMaxPatch || patch % 2 != 1 || iters < 0 || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0) {
    Params p = {};
    for (int i = 0; i < n_levels; ++i) p.level[i] = levels[i];
    p.uv = uv;
    p.guess = guess;
    p.uv_f = uv_f;
    p.ok_f = ok_f;
    p.uv_b = uv_b;
    p.ok_b = ok_b;
    p.n_levels = n_levels;
    p.N = N;
    p.iters = iters;
    p.min_det = min_det;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaErrorInvalidValue;
    switch (patch) {
      case 1: e = launch<1>(p, s); break;
      case 3: e = launch<3>(p, s); break;
      case 5: e = launch<5>(p, s); break;
      case 7: e = launch<7>(p, s); break;
      case 9: e = launch<9>(p, s); break;
      case 11: e = launch<11>(p, s); break;
      case 13: e = launch<13>(p, s); break;
      case 15: e = launch<15>(p, s); break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
