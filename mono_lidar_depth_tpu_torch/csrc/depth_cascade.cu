// The depth association's per-feature cascade on Hopper (sm_90a): histogram
// segmentation, the primary plane (max-spanning triangle or first three
// points, or PCA), its gates, the road pass against the ground plane with
// its plane fit and gates, and the final select, for every lane in ONE
// launch.
//
// It replaces no TPU kernel.  The JAX package leaves this cascade to XLA,
// which fuses it; PyTorch runs it op by op
// (core/depth_estimator.py::_depth_cascade_plain), some 640 launches a call
// on the card, and builds float64 [N, K, K] planes for the triangle's
// ranking (254 MB each at 4,096 lanes and K = 88) and segmented float64
// sorts for the fits' sums.  At the benchmark's shapes that took 5.25 ms of
// device time a frame, two thirds of the association's.
//
// What bounds it on this card: the bytes it reads.  Per call of the main
// path (4,096 lanes, windows 11 x 8 = 88 and 15 x 14 = 210 cells) the
// windows are 4,096 x (88 x 17 + 210 x 18) B = 21.6 MB (points, depths,
// masks and ground flags), ~6.5 us at 3.35 TB/s; the float64 arithmetic
// (3,828 pairs a lane for the triangle, ten sorted sums of 256 terms for
// the road fit of the lanes that need it) is a few hundred MFLOP, ~0.01 ms
// at the fp64 rate.  Nothing of the plain version's intermediates is
// written.
//
// Design.  One warp per lane, kWarpsPerBlock = 4 per block.  A lane's
// windows are staged in the warp's slice of dynamic shared memory (~7.7 KB
// at the main path's shapes) and everything after is warp-level work:
//   * the histogram: the K bin ids are sorted by a bitonic sort in shared
//     memory, and the reference's first-local-max scan walks the groups of
//     equal bins (the integer logic of core/histogram.py, which stops at
//     the first break or abort);
//   * the triangle: the K (K - 1) / 2 pairs are spread over the warp's
//     threads, each keeping its first largest squared distance in
//     row-major order, then a shuffle argmax that keeps the smaller flat
//     index on ties, as torch.argmax does; the third corner likewise;
//   * each `geometry.sum_sorted` becomes a bitonic sort of the K terms and
//     +inf sentinels in a power-of-two buffer, the sentinels set to 0.0
//     (the plain version's zero pad after the sorted terms), and the same
//     pairwise halving;
//   * the 3x3 eigensolver, the plane, the ray intersection and the gates
//     are scalar work that every thread of the warp repeats; thread 0
//     writes the lane's outputs.
// Work whose result the outputs cannot show is skipped: the primary plane
// where the lane is invalid, short of neighbors or has no histogram bin,
// and the road fit where the road pass does not decide the lane; with
// `collect_debug` the primary plane runs everywhere, for its corners.
//
// Numbers.  Every float32 and float64 add, multiply, divide and square root
// is written as its round-to-nearest intrinsic (__fadd_rn, __dmul_rn,
// __ddiv_rn, __dsqrt_rn, ...), which nvcc never contracts into FMAs, in the
// plain version's order (`dot3` left to right, `_det3` in Sarrus order,
// `x ** 3` as (x * x) * x).  A threshold that the plain version compares
// with a float32 tensor arrives as float32 (a c_float rounds a Python float
// to nearest, as PyTorch rounds a scalar to the tensor's type); one it
// compares in float64 is `geometry.f32(t)`, the float32 value widened.
// `_div`'s divisions are true divisions, `1.0 / x` the float64 quotient,
// acos and cos the CUDA math library's, which ATen's float64 kernels call.
// So every output is the plain version's to the bit on the card.
//
// No allocation, no synchronisation: the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

// The cascade's switches and thresholds, shared with the ctypes structure
// kernels.CascadeParams.
struct MldCascadeParams {
  int32_t k1, k2;  // window cells of the primary and road scales (k2 0: no road pass)
  int32_t count_min;
  int32_t use_histogram, num_bins, hist_min_count;
  float bin_width;
  int32_t use_pca, use_triangle, check_planar;
  float planar_threshold;
  int32_t check_ortho;
  float ortho_threshold;
  int32_t depth_enabled, depth_mode;
  float depth_min, depth_max;
  int32_t local_enabled, local_mode, local_relative;
  float local_value;
  int32_t cut_behind;
  float pca_abs_min, pca_32_rel_max, pca_21_rel_min;
  int32_t road_estimator;  // 0 M-estimator, 1 least squares, 2 triangle
  int32_t far_veto;
  float far_threshold, z_x_min;
  float cx, cy, focal;
  int32_t collect_debug;
};

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// core/result_types.py::DepthResultType
constexpr int kUnspecified = 0;
constexpr int kSuccess = 1;
constexpr int kRadiusSearchInsufficientPoints = 2;
constexpr int kHistogramNoLocalMax = 3;
constexpr int kTresholdDepthGlobalGreaterMax = 4;
constexpr int kTresholdDepthGlobalSmallerMin = 5;
constexpr int kTresholdDepthLocalGreaterMax = 6;
constexpr int kTresholdDepthLocalSmallerMin = 7;
constexpr int kTriangleNotPlanar = 8;
constexpr int kTriangleNotPlanarInsufficientPoints = 9;
constexpr int kCornerBehindCamera = 10;
constexpr int kPlaneViewrayNotOrthogonal = 11;
constexpr int kPcaIsPoint = 12;
constexpr int kPcaIsLine = 13;
constexpr int kPcaIsCubic = 14;
constexpr int kInsufficientRoadPoints = 15;
constexpr int kSuccessRoad = 16;

struct CascadeArgs {
  const float* uv;       // [N, 2]
  const uint8_t* valid;  // [N]
  const uint8_t* mask1;  // [N, k1]
  const float* points1;  // [N, k1, 3]
  const int32_t* count1; // [N]
  const float* z1;       // [N, k1]
  const uint8_t* mask2;  // [N, k2] (road pass only, as below)
  const float* points2;  // [N, k2, 3]
  const int32_t* count2; // [N]
  const float* z2;       // [N, k2]
  const uint8_t* flags2; // [N, k2]
  const float* coeffs;   // [4] or [N, 4]: the camera-frame ground plane
  int coeff_stride;      // 0 or 4
  const uint8_t* gp_ok;  // [] or [N]
  int ok_stride;         // 0 or 1
  int n;
  float* depths;         // [N]
  int32_t* codes;        // [N]
  int32_t* seg_count;    // [N] (collect_debug only, as below)
  int32_t* hist_bin;     // [N]
  float* hist_lower;     // [N]
  float* hist_upper;     // [N]
  float* corners;        // [N, 3, 3]
  int32_t* road_count;   // [N]
  MldCascadeParams p;
};

__host__ __device__ inline int pow2_ceil(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align8(size_t b) { return (b + 7) & ~size_t(7); }

// One warp's slice of dynamic shared memory.
struct Slice {
  double* buf;   // [P]: sort buffer, the primary triangle's |p|^2, the bin ids
  double* w2;    // [k2]: road weights (or sqrt of them), or the road triangle's |p|^2
  float *x1, *y1, *z1;
  float *x2, *y2, *z2;
  uint8_t *m1, *m2;  // segmented primary mask, road mask
};

__host__ __device__ inline int sort_slots(int k1, int k2) {
  const int a = pow2_ceil(k1), b = pow2_ceil(k2 > 0 ? k2 : 1);
  return a > b ? a : b;
}

__host__ __device__ inline size_t slice_bytes(int k1, int k2) {
  return align8(8 * size_t(sort_slots(k1, k2))) + align8(8 * size_t(k2)) +
         3 * align8(4 * size_t(k1)) + 3 * align8(4 * size_t(k2)) +
         align8(k1) + align8(k2);
}

__device__ Slice carve(unsigned char* base, int k1, int k2) {
  Slice s;
  unsigned char* at = base;
  s.buf = reinterpret_cast<double*>(at);
  at += align8(8 * size_t(sort_slots(k1, k2)));
  s.w2 = reinterpret_cast<double*>(at);
  at += align8(8 * size_t(k2));
  float** f1[3] = {&s.x1, &s.y1, &s.z1};
  for (float** f : f1) {
    *f = reinterpret_cast<float*>(at);
    at += align8(4 * size_t(k1));
  }
  float** f2[3] = {&s.x2, &s.y2, &s.z2};
  for (float** f : f2) {
    *f = reinterpret_cast<float*>(at);
    at += align8(4 * size_t(k2));
  }
  s.m1 = at;
  at += align8(k1);
  s.m2 = at;
  return s;
}

// ---- float32 helpers (the plain version's eager ops, one rounding each)

struct F3 {
  float x, y, z;
};

__device__ inline F3 fsub3(F3 a, F3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

__device__ inline float fdot3(F3 a, F3 b) {  // geometry.dot3
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}

__device__ inline F3 fcross3(F3 a, F3 b) {  // geometry.cross3
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

__device__ inline float fnorm3(F3 a) { return __fsqrt_rn(fdot3(a, a)); }

__device__ inline F3 fdiv3(F3 a, float d) {
  return {__fdiv_rn(a.x, d), __fdiv_rn(a.y, d), __fdiv_rn(a.z, d)};
}

__device__ inline float nonzero_f(float x) { return x == 0.0f ? 1.0f : x; }

// torch.clamp(v, lo, hi): NaN passes, then min(max(v, lo), hi).
__device__ inline float clamp_f(float v, float lo, float hi) {
  if (isnan(v)) return v;
  return fminf(fmaxf(v, lo), hi);
}

// ---- float64 helpers

struct D3 {
  double x, y, z;
};

__device__ inline double ddot3(D3 a, D3 b) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y)),
                   __dmul_rn(a.z, b.z));
}

__device__ inline D3 dcross3(D3 a, D3 b) {
  return {__dsub_rn(__dmul_rn(a.y, b.z), __dmul_rn(a.z, b.y)),
          __dsub_rn(__dmul_rn(a.z, b.x), __dmul_rn(a.x, b.z)),
          __dsub_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x))};
}

__device__ inline double dnorm3(D3 a) { return __dsqrt_rn(ddot3(a, a)); }

__device__ inline double clamp_min_d(double v, double lo) {
  if (isnan(v)) return v;
  return fmax(v, lo);
}

// ---- warp-level building blocks

__device__ inline int warp_count(const uint8_t* m, int k, int lane) {
  int c = 0;
  for (int b = 0; b < k; b += 32) {
    const int i = b + lane;
    c += __popc(__ballot_sync(kFullMask, i < k && m[i]));
  }
  return c;
}

// (value, index) of the warp's largest value; the smaller index on ties.
__device__ inline void warp_argmax(double& v, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFullMask, v, o);
    const int oi = __shfl_xor_sync(kFullMask, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

__device__ inline float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Ascending bitonic sort of s[0, P), P a power of two, by the warp.
template <typename T>
__device__ void warp_sort(T* s, int P, int lane) {
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < P; i += 32) {
        const int l = i ^ j;
        if (l > i) {
          const T a = s[i], b = s[l];
          const bool up = (i & k) == 0;
          if (up ? (a > b) : (a < b)) {
            s[i] = b;
            s[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// geometry.sum_sorted of term(0) .. term(K - 1): the terms ascending, a zero
// pad to the next power of two, then pairwise halving.
template <typename Term>
__device__ double sorted_sum(double* s, int K, Term term, int lane) {
  const int P = pow2_ceil(K);
  __syncwarp();
  for (int i = lane; i < P; i += 32) s[i] = i < K ? term(i) : CUDART_INF;
  warp_sort(s, P, lane);
  for (int i = K + lane; i < P; i += 32) s[i] = 0.0;
  __syncwarp();
  for (int half = P >> 1; half > 0; half >>= 1) {
    for (int i = lane; i < half; i += 32) s[i] = __dadd_rn(s[i], s[i + half]);
    __syncwarp();
  }
  const double r = s[0];
  __syncwarp();
  return r;
}

// ---- the 3x3 symmetric eigensolver (geometry.sym3x3_eigenvalues,
// _eigenvector_for), float64

struct Sym3 {
  double a[3][3];
};

__device__ Sym3 minus_diag(const Sym3& A, double lam) {  // A - lam * I
  Sym3 B;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      B.a[i][j] = __dsub_rn(A.a[i][j], __dmul_rn(lam, i == j ? 1.0 : 0.0));
  return B;
}

__device__ double det3(const Sym3& M) {  // geometry._det3, Sarrus order
  const double a = M.a[0][0], b = M.a[0][1], c = M.a[0][2];
  const double d = M.a[1][0], e = M.a[1][1], f = M.a[1][2];
  const double g = M.a[2][0], h = M.a[2][1], i = M.a[2][2];
  double t = __dmul_rn(__dmul_rn(a, e), i);
  t = __dadd_rn(t, __dmul_rn(__dmul_rn(b, f), g));
  t = __dadd_rn(t, __dmul_rn(__dmul_rn(c, d), h));
  t = __dsub_rn(t, __dmul_rn(__dmul_rn(c, e), g));
  t = __dsub_rn(t, __dmul_rn(__dmul_rn(a, f), h));
  return __dsub_rn(t, __dmul_rn(__dmul_rn(b, d), i));
}

// Ascending eigenvalues (Smith 1961).
__device__ void sym3_eigenvalues(const Sym3& A, double ev[3]) {
  const double q =
      __ddiv_rn(__dadd_rn(__dadd_rn(A.a[0][0], A.a[1][1]), A.a[2][2]), 3.0);
  const Sym3 B = minus_diag(A, q);
  double p2 = __dmul_rn(B.a[0][0], B.a[0][0]);
  for (int k = 1; k < 9; ++k) {
    const double b = B.a[k / 3][k % 3];
    p2 = __dadd_rn(p2, __dmul_rn(b, b));
  }
  p2 = __ddiv_rn(p2, 6.0);
  const double p = __dsqrt_rn(clamp_min_d(p2, 0.0));
  if (p == 0.0) {
    ev[0] = ev[1] = ev[2] = q;
    return;
  }
  const double cube = __dmul_rn(__dmul_rn(p, p), p);
  double r = __ddiv_rn(det3(B), __dmul_rn(2.0, cube));
  if (!isnan(r)) r = fmin(fmax(r, -1.0), 1.0);
  const double phi = __ddiv_rn(acos(r), 3.0);
  const double two_p = __dmul_rn(2.0, p);
  const double third = __ddiv_rn(__dmul_rn(2.0, CUDART_PI), 3.0);
  const double e_hi = __dadd_rn(q, __dmul_rn(two_p, cos(phi)));
  const double e_lo = __dadd_rn(q, __dmul_rn(two_p, cos(__dadd_rn(phi, third))));
  const double e_mid = __dsub_rn(__dsub_rn(__dmul_rn(3.0, q), e_hi), e_lo);
  ev[0] = e_lo;
  ev[1] = e_mid;
  ev[2] = e_hi;
}

// Unit eigenvector for lam: the longest cross product of rows of A - lam I
// (the first on ties), e_z for a degenerate input.
__device__ D3 eigenvector_for(const Sym3& A, double lam) {
  const Sym3 M = minus_diag(A, lam);
  const D3 r0 = {M.a[0][0], M.a[0][1], M.a[0][2]};
  const D3 r1 = {M.a[1][0], M.a[1][1], M.a[1][2]};
  const D3 r2 = {M.a[2][0], M.a[2][1], M.a[2][2]};
  const D3 c[3] = {dcross3(r0, r1), dcross3(r0, r2), dcross3(r1, r2)};
  int best = 0;
  double nb = dnorm3(c[0]);
  for (int k = 1; k < 3; ++k) {
    const double nk = dnorm3(c[k]);
    if (nk > nb || (isnan(nk) && !isnan(nb))) {
      nb = nk;
      best = k;
    }
  }
  const D3 v = c[best];
  const double n = dnorm3(v);
  if (n > 1e-20) return {__ddiv_rn(v.x, n), __ddiv_rn(v.y, n), __ddiv_rn(v.z, n)};
  return {0.0, 0.0, 1.0};
}

// ---- the plane fits

struct Fit {
  F3 normal, anchor;
};

// Σ_k c_k c_kᵀ of centered(k) (planefit._scatter3), then the normal.
template <typename Centered>
__device__ void scatter_eigen(double* buf, int K, Centered centered, int lane,
                              Sym3& S, double ev[3]) {
  double s[6];
  const int pa[6] = {0, 0, 0, 1, 1, 2}, pb[6] = {0, 1, 2, 1, 2, 2};
  for (int t = 0; t < 6; ++t) {
    const int a = pa[t], b = pb[t];
    s[t] = sorted_sum(buf, K, [&](int k) {
      const D3 c = centered(k);
      const double ca = a == 0 ? c.x : (a == 1 ? c.y : c.z);
      const double cb = b == 0 ? c.x : (b == 1 ? c.y : c.z);
      return __dmul_rn(ca, cb);
    }, lane);
  }
  const double m[3][3] = {{s[0], s[1], s[2]}, {s[1], s[3], s[4]}, {s[2], s[4], s[5]}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) S.a[i][j] = m[i][j];
  sym3_eigenvalues(S, ev);
}

__device__ inline F3 to_f3(D3 v) {
  return {__double2float_rn(v.x), __double2float_rn(v.y), __double2float_rn(v.z)};
}

// planefit._masked_mean_centered: the masked mean (float64) and the
// centered masked points.
__device__ D3 masked_mean(double* buf, const float* xs, const float* ys,
                          const float* zs, const uint8_t* m, int K, int cnt,
                          int lane) {
  const double den = cnt == 0 ? 1.0 : static_cast<double>(cnt);
  const float* c[3] = {xs, ys, zs};
  double mean[3];
  for (int a = 0; a < 3; ++a) {
    const float* v = c[a];
    mean[a] = __ddiv_rn(sorted_sum(buf, K, [&](int k) {
      return __dmul_rn(m[k] ? 1.0 : 0.0, static_cast<double>(v[k]));
    }, lane), den);
  }
  return {mean[0], mean[1], mean[2]};
}

// least_squares_plane over (xs, ys, zs) and m; PCA's scatter shares it.
__device__ Fit least_squares(double* buf, const float* xs, const float* ys,
                             const float* zs, const uint8_t* m, int K,
                             int cnt, int lane, double ev[3], Sym3& S) {
  const D3 mean = masked_mean(buf, xs, ys, zs, m, K, cnt, lane);
  scatter_eigen(buf, K, [&](int k) -> D3 {
    const double w = m[k] ? 1.0 : 0.0;
    return {__dmul_rn(__dsub_rn(xs[k], mean.x), w),
            __dmul_rn(__dsub_rn(ys[k], mean.y), w),
            __dmul_rn(__dsub_rn(zs[k], mean.z), w)};
  }, lane, S, ev);
  return {to_f3(eigenvector_for(S, ev[0])), to_f3(mean)};
}

// ---- the triangles

struct Tri {
  int i, j, k;
  bool ok;
};

__device__ inline double pair_d2(double xa, double ya, double za, double sa,
                                 double xb, double yb, double zb, double sb) {
  const double gram = __dadd_rn(__dadd_rn(__dmul_rn(xa, xb), __dmul_rn(ya, yb)),
                                __dmul_rn(za, zb));
  const double d = __dsub_rn(__dadd_rn(sa, sb), __dmul_rn(2.0, gram));
  return d < 0.0 ? 0.0 : d;  // clamp(min=0), NaN passes
}

// planefit.max_spanning_triangle with dist_threshold 0.
__device__ Tri max_spanning_triangle(const float* xs, const float* ys,
                                     const float* zs, const uint8_t* m, int K,
                                     double* sq, int lane) {
  for (int k = lane; k < K; k += 32) {
    const double x = xs[k], y = ys[k], z = zs[k];
    sq[k] = __dadd_rn(__dadd_rn(__dmul_rn(x, x), __dmul_rn(y, y)), __dmul_rn(z, z));
  }
  __syncwarp();
  double best = -1.0;  // flat index 0 is a diagonal pair: -1
  int flat = 0;
  for (int i = 0; i + 1 < K; ++i) {
    if (!m[i]) continue;
    const double xi = xs[i], yi = ys[i], zi = zs[i], si = sq[i];
    for (int j = i + 1 + lane; j < K; j += 32) {
      if (!m[j]) continue;
      const double d2 = pair_d2(xi, yi, zi, si, xs[j], ys[j], zs[j], sq[j]);
      if (d2 > best) {
        best = d2;
        flat = i * K + j;
      }
    }
  }
  warp_argmax(best, flat);
  Tri t;
  t.i = flat / K;
  t.j = flat - t.i * K;
  t.ok = warp_count(m, K, lane) >= 3 && best > 0.0;
  const double xi = xs[t.i], yi = ys[t.i], zi = zs[t.i], si = sq[t.i];
  const double xj = xs[t.j], yj = ys[t.j], zj = zs[t.j], sj = sq[t.j];
  double score = -1.0;
  int kb = 0;
  for (int k = lane; k < K; k += 32) {
    if (!m[k] || k == t.i || k == t.j) continue;
    const double xk = xs[k], yk = ys[k], zk = zs[k], sk = sq[k];
    const double di = pair_d2(xk, yk, zk, sk, xi, yi, zi, si);
    const double dj = pair_d2(xk, yk, zk, sk, xj, yj, zj, sj);
    if (di > 0.0 && dj > 0.0) {
      const double s = __dadd_rn(di, dj);
      if (s > score) {
        score = s;
        kb = k;
      }
    }
  }
  warp_argmax(score, kb);
  t.k = kb;
  t.ok = t.ok && score > -1.0;
  __syncwarp();
  return t;
}

// planefit.first_three_points: the first three masked cells (cell 0 for
// each that is missing).
__device__ Tri first_three(const uint8_t* m, int K, int lane) {
  int idx[3] = {0, 0, 0};
  int found = 0;
  for (int b = 0; b < K && found < 3; b += 32) {
    const int i = b + lane;
    unsigned bal = __ballot_sync(kFullMask, i < K && m[i]);
    while (bal != 0u && found < 3) {
      idx[found++] = b + __ffs(bal) - 1;
      bal &= bal - 1u;
    }
  }
  Tri t;
  t.i = idx[0];
  t.j = idx[1];
  t.k = idx[2];
  t.ok = warp_count(m, K, lane) >= 3;
  return t;
}

__device__ inline F3 unit_f(F3 v) { return fdiv3(v, nonzero_f(fnorm3(v))); }

// planefit.check_planar
__device__ bool check_planar(F3 c1, F3 c2, F3 c3, float thr) {
  const F3 e1 = unit_f(fsub3(c2, c1)), e2 = unit_f(fsub3(c3, c1)),
           e3 = unit_f(fsub3(c3, c2));
  return fnorm3(fcross3(e1, e2)) >= thr && fnorm3(fcross3(e1, e3)) >= thr &&
         fnorm3(fcross3(e2, e3)) >= thr;
}

// geometry.plane_from_points: (unit normal, offset).
__device__ F3 plane_normal(F3 p1, F3 p2, F3 p3) {
  const F3 n = fcross3(fsub3(p2, p1), fsub3(p3, p1));
  return fdiv3(n, nonzero_f(fnorm3(n)));
}

// geometry.ray_plane_intersection from the origin: the depth.
__device__ float ray_depth(F3 n, float offset, F3 dir) {
  const float denom = fdot3(n, dir);
  const F3 zero = {0.0f, 0.0f, 0.0f};
  const float num = -__fadd_rn(fdot3(n, zero), offset);
  const float t = __fdiv_rn(num, nonzero_f(denom));
  if (denom == 0.0f) return -CUDART_INF_F;
  return __fadd_rn(0.0f, __fmul_rn(t, dir.z));
}

// depth_estimator._apply_depth_gates: zs the window's depths, m its mask.
__device__ float depth_gates(const MldCascadeParams& p, float depth,
                             const float* zs, const uint8_t* m, int K,
                             int lane, int& code) {
  code = 0;
  if (p.depth_enabled) {
    const bool below = depth < p.depth_min, above = depth > p.depth_max;
    if (p.depth_mode == 0) {
      if (above && code == 0) code = kTresholdDepthGlobalGreaterMax;
      if (below && code == 0) code = kTresholdDepthGlobalSmallerMin;
    } else {
      depth = clamp_f(depth, p.depth_min, p.depth_max);
    }
  }
  if (p.local_enabled) {
    float lo_z = CUDART_INF_F, hi_z = -CUDART_INF_F;
    bool any = false;
    for (int k = lane; k < K; k += 32) {
      if (m[k]) {
        lo_z = fminf(lo_z, zs[k]);
        hi_z = fmaxf(hi_z, zs[k]);
        any = true;
      }
    }
    const float min_z = warp_min(lo_z), max_z = warp_max(hi_z);
    const bool has = __any_sync(kFullMask, any);
    const float interval = __fsub_rn(max_z, min_z);
    const float tol = p.local_relative ? __fmul_rn(interval, p.local_value)
                                       : p.local_value;
    const float lo = __fsub_rn(min_z, tol), hi = __fadd_rn(max_z, tol);
    if (p.local_mode == 0) {
      if (has && depth < lo && code == 0) code = kTresholdDepthLocalSmallerMin;
      if (has && depth > hi && code == 0) code = kTresholdDepthLocalGreaterMax;
    } else if (has) {
      depth = clamp_f(depth, lo, hi);
    }
  }
  if (p.cut_behind && depth < 0.0f && code == 0) code = kCornerBehindCamera;
  return depth;
}

__device__ inline F3 point_at(const float* xs, const float* ys, const float* zs, int k) {
  return {xs[k], ys[k], zs[k]};
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
depth_cascade_kernel(const CascadeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= a.n) return;  // the whole warp leaves
  const MldCascadeParams& p = a.p;
  const int K1 = p.k1, K2 = p.k2;
  const Slice s = carve(smem + warp * slice_bytes(K1, K2), K1, K2);
  const bool dbg = p.collect_debug != 0;

  // The viewing ray (PinholeCamera.viewing_rays, flipped to z >= 0).
  F3 ray;
  {
    const float rx = __fdiv_rn(__fsub_rn(a.uv[2 * n], p.cx), p.focal);
    const float ry = __fdiv_rn(__fsub_rn(a.uv[2 * n + 1], p.cy), p.focal);
    const F3 d = {rx, ry, 1.0f};
    ray = fdiv3(d, fnorm3(d));
    if (ray.z < 0.0f) ray = {-ray.x, -ray.y, -ray.z};
  }
  const bool valid = a.valid[n] != 0;
  const bool enough1 = a.count1[n] >= p.count_min;

  // ---- histogram segmentation (histogram.filter_points_min_dist_blob)
  const size_t row1 = static_cast<size_t>(n) * K1;
  const uint8_t* mask1 = a.mask1 + row1;
  const float* z1 = a.z1 + row1;
  bool hist_found = true;
  int bin_id = -1;
  float lower = -1.0f, upper = -1.0f;
  const bool need_hist = dbg || (valid && enough1);
  if (p.use_histogram && need_hist) {
    const int B = p.num_bins, P1 = pow2_ceil(K1);
    int* bins = reinterpret_cast<int*>(s.buf);
    for (int k = lane; k < P1; k += 32) {
      int b = 0x7fffffff;  // the pad sorts after every bin and B
      if (k < K1) {
        if (mask1[k]) {
          const float d = fminf(z1[k], 999.0f);
          const float t = fminf(__fdiv_rn(fabsf(d), p.bin_width), static_cast<float>(B));
          b = min(max(static_cast<int>(t), 0), B - 1);
        } else {
          b = B;
        }
      }
      bins[k] = b;
    }
    warp_sort(bins, P1, lane);
    // The first-local-max scan over the groups of equal bins, ascending.
    int m_run = -1, best = -1, prev = -1, k = 0;
    bool decided = false, found = false;
    while (k < K1) {
      const int b = bins[k];
      if (b >= B) break;
      int e = k + 1;
      while (e < K1 && bins[e] == b) ++e;
      const int c = e - k;
      const bool gap = prev >= 0 && b > prev + 1;
      if (gap && m_run == -1) {  // abort
        decided = true;
        found = false;
        break;
      }
      if ((gap && m_run >= 0) || (!gap && c < m_run)) {  // break
        decided = true;
        found = true;
        break;
      }
      const int q = c >= p.hist_min_count ? c : -1;
      if (q > m_run) {
        m_run = q;
        best = b;
      }
      prev = b;
      k = e;
    }
    if (!decided) found = m_run >= 0;
    hist_found = found;
    bin_id = found ? best : -1;
    lower = __fmul_rn(static_cast<float>(bin_id), p.bin_width);
    upper = __fadd_rn(lower, p.bin_width);
    __syncwarp();
    for (int i = lane; i < K1; i += 32) {
      const float d = fminf(z1[i], 999.0f);
      s.m1[i] = (mask1[i] && d >= lower && d < upper && found) ? 1 : 0;
    }
    if (!found) {
      lower = -1.0f;
      upper = -1.0f;
    }
  } else {
    for (int i = lane; i < K1; i += 32) s.m1[i] = mask1[i];
  }
  __syncwarp();

  // ---- the primary plane (depth_estimator._segment_depth)
  int code_p;
  float depth_primary = -1.0f;
  const bool need_primary = dbg || (valid && enough1 && hist_found);
  F3 corner[3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (need_primary) {
    const float* pts = a.points1 + 3 * row1;
    for (int k = lane; k < K1; k += 32) {
      s.x1[k] = pts[3 * k];
      s.y1[k] = pts[3 * k + 1];
      s.z1[k] = pts[3 * k + 2];
    }
    __syncwarp();
    Tri tri;
    int tri_fail;
    if (!p.use_pca && p.use_triangle) {
      tri = max_spanning_triangle(s.x1, s.y1, s.z1, s.m1, K1, s.buf, lane);
      tri_fail = kTriangleNotPlanarInsufficientPoints;
    } else {
      tri = first_three(s.m1, K1, lane);
      tri_fail = kHistogramNoLocalMax;
    }
    corner[0] = point_at(s.x1, s.y1, s.z1, tri.i);
    corner[1] = point_at(s.x1, s.y1, s.z1, tri.j);
    corner[2] = point_at(s.x1, s.y1, s.z1, tri.k);
    const bool planar_ok = (!p.use_pca && p.check_planar)
        ? check_planar(corner[0], corner[1], corner[2], p.planar_threshold)
        : true;
    F3 normal;
    float offset;
    bool is_cubic = false, is_linear = false, is_point = false;
    if (p.use_pca) {  // planefit.pca_classify
      double ev[3];
      Sym3 S;
      const int cnt = warp_count(s.m1, K1, lane);
      const Fit f = least_squares(s.buf, s.x1, s.y1, s.z1, s.m1, K1, cnt,
                                  lane, ev, S);
      const double e1 = ev[0], e2 = ev[1], e3 = ev[2];
      const double safe_e3 = e3 == 0.0 ? 1.0 : e3;
      is_cubic = __ddiv_rn(__dsub_rn(e2, e1), safe_e3) <
                 static_cast<double>(p.pca_21_rel_min);
      is_linear = !is_cubic && __ddiv_rn(__dsub_rn(e3, e2), safe_e3) >
                                   static_cast<double>(p.pca_32_rel_max);
      is_point = !is_cubic && !is_linear &&
                 e3 < static_cast<double>(p.pca_abs_min);
      normal = f.normal;
      offset = -fdot3(normal, f.anchor);
    } else {
      normal = plane_normal(corner[0], corner[1], corner[2]);
      offset = -fdot3(normal, corner[0]);
    }
    const float cosang = fabsf(fdot3(normal, ray));
    const bool ortho_ok = p.check_ortho ? cosang >= p.ortho_threshold : true;
    int gate;
    const float depth = depth_gates(p, ray_depth(normal, offset, ray),
                                    s.z1, s.m1, K1, lane, gate);
    int code = kSuccess;
    if (gate != 0) code = gate;
    if (!ortho_ok) code = kPlaneViewrayNotOrthogonal;
    if (p.use_pca) {
      if (is_cubic) code = kPcaIsCubic;
      if (is_linear) code = kPcaIsLine;
      if (is_point) code = kPcaIsPoint;
    } else if (!planar_ok) {
      code = kTriangleNotPlanar;
    }
    if (!tri.ok) code = tri_fail;
    code_p = code;
    depth_primary = depth;
  } else {
    code_p = kSuccess;  // decided by the two overrides below
  }
  if (!hist_found) code_p = kHistogramNoLocalMax;
  if (!enough1) code_p = kRadiusSearchInsufficientPoints;
  const bool primary_success = code_p == kSuccess;
  if (!primary_success) depth_primary = -1.0f;

  // ---- the road pass (depth_estimator._road_pass)
  int code_f = code_p;
  float depth_f = depth_primary;
  int road_cnt = 0;
  if (K2 > 0) {
    const size_t row2 = static_cast<size_t>(n) * K2;
    const uint8_t* mask2 = a.mask2 + row2;
    const uint8_t* flags2 = a.flags2 + row2;
    const bool gp_ok = a.gp_ok[n * a.ok_stride] != 0;
    const bool enough2 = a.count2[n] >= p.count_min;
    const bool applicable = gp_ok && enough1 && !primary_success;
    const bool decides = valid && applicable && enough2;
    if (dbg || decides) {
      for (int k = lane; k < K2; k += 32) s.m2[k] = (mask2[k] && flags2[k]) ? 1 : 0;
      __syncwarp();
      road_cnt = warp_count(s.m2, K2, lane);
    }
    if (decides) {
      const float* cf = a.coeffs + n * a.coeff_stride;
      const F3 gn = {cf[0], cf[1], cf[2]};
      const float gd = cf[3];
      const float gnorm = nonzero_f(fnorm3(gn));
      const float* pts = a.points2 + 3 * row2;
      bool far = false;
      for (int k = lane; k < K2; k += 32) {
        const F3 q = {pts[3 * k], pts[3 * k + 1], pts[3 * k + 2]};
        s.x2[k] = q.x;
        s.y2[k] = q.y;
        s.z2[k] = q.z;
        // point_plane_distance, then the M-estimator's weight
        const float dist = __fdiv_rn(fabsf(__fadd_rn(fdot3(q, gn), gd)), gnorm);
        far = far || (mask2[k] && dist > p.far_threshold);
        s.w2[k] = s.m2[k]
            ? __ddiv_rn(1.0, clamp_min_d(static_cast<double>(dist),
                                         static_cast<double>(1e-9f)))
            : 0.0;
      }
      const bool any_far = __any_sync(kFullMask, far);
      __syncwarp();
      const bool seg_ok = (p.far_veto ? !any_far : true) && road_cnt >= 3;
      if (seg_ok) {
        F3 rn, anchor;
        bool flat_ok = true, tri_ok = true;
        if (p.road_estimator == 0) {  // planefit.mestimator_plane
          const double wsum = sorted_sum(s.buf, K2, [&](int k) { return s.w2[k]; }, lane);
          const double den = wsum == 0.0 ? 1.0 : wsum;
          const float* c[3] = {s.x2, s.y2, s.z2};
          double ctr[3];
          for (int t = 0; t < 3; ++t) {
            const float* v = c[t];
            ctr[t] = __ddiv_rn(sorted_sum(s.buf, K2, [&](int k) {
              return __dmul_rn(s.w2[k], static_cast<double>(v[k]));
            }, lane), den);
          }
          for (int k = lane; k < K2; k += 32) s.w2[k] = __dsqrt_rn(s.w2[k]);
          __syncwarp();
          double ev[3];
          Sym3 S;
          scatter_eigen(s.buf, K2, [&](int k) -> D3 {
            const double sw = s.w2[k];
            return {__dmul_rn(__dsub_rn(s.x2[k], ctr[0]), sw),
                    __dmul_rn(__dsub_rn(s.y2[k], ctr[1]), sw),
                    __dmul_rn(__dsub_rn(s.z2[k], ctr[2]), sw)};
          }, lane, S, ev);
          rn = to_f3(eigenvector_for(S, ev[0]));
          anchor = to_f3({ctr[0], ctr[1], ctr[2]});
        } else if (p.road_estimator == 1) {  // planefit.least_squares_plane
          double ev[3];
          Sym3 S;
          const Fit f = least_squares(s.buf, s.x2, s.y2, s.z2, s.m2, K2,
                                      road_cnt, lane, ev, S);
          rn = f.normal;
          anchor = f.anchor;
        } else {  // the triangle with the XZ flatness check
          const Tri t = max_spanning_triangle(s.x2, s.y2, s.z2, s.m2, K2, s.w2, lane);
          const F3 c0 = point_at(s.x2, s.y2, s.z2, t.i);
          rn = plane_normal(c0, point_at(s.x2, s.y2, s.z2, t.j),
                            point_at(s.x2, s.y2, s.z2, t.k));
          anchor = c0;
          tri_ok = t.ok;
          float lx = CUDART_INF_F, hx = -CUDART_INF_F, lz = CUDART_INF_F,
                hz = -CUDART_INF_F;
          bool any = false;
          for (int k = lane; k < K2; k += 32) {
            if (s.m2[k]) {
              lx = fminf(lx, s.x2[k]);
              hx = fmaxf(hx, s.x2[k]);
              lz = fminf(lz, s.z2[k]);
              hz = fmaxf(hz, s.z2[k]);
              any = true;
            }
          }
          const float size_x = __fsub_rn(warp_max(hx), warp_min(lx));
          const float size_z = __fsub_rn(warp_max(hz), warp_min(lz));
          const float safe_x = size_x == 0.0f ? 1e-30f : size_x;
          flat_ok = __any_sync(kFullMask, any) &&
                    __fdiv_rn(size_z, safe_x) >= p.z_x_min;
        }
        const float offset = -fdot3(rn, anchor);
        int gate;
        float depth_r = depth_gates(p, ray_depth(rn, offset, ray),
                                    a.z2 + row2, s.m2, K2, lane, gate);
        int code_r = gate != 0 ? gate : kSuccessRoad;
        if (p.road_estimator == 2) {
          if (!flat_ok) code_r = kInsufficientRoadPoints;
          if (!tri_ok) code_r = kRadiusSearchInsufficientPoints;
        }
        if (code_r != kSuccessRoad) depth_r = -1.0f;
        code_f = code_r;
        depth_f = depth_r;
      } else {
        code_f = code_p;
        depth_f = -1.0f;
      }
    } else if (applicable) {
      code_f = enough2 ? code_p : kRadiusSearchInsufficientPoints;
      depth_f = -1.0f;  // the lane is invalid or short of road neighbors
    }
  }

  if (!valid) {
    code_f = kUnspecified;
    depth_f = -1.0f;
  }
  if (lane == 0) {
    a.depths[n] = depth_f;
    a.codes[n] = code_f;
  }
  if (dbg) {
    const int seg = warp_count(s.m1, K1, lane);
    if (lane == 0) {
      a.seg_count[n] = seg;
      a.hist_bin[n] = p.use_histogram ? bin_id : -1;
      a.hist_lower[n] = p.use_histogram ? lower : -1.0f;
      a.hist_upper[n] = p.use_histogram ? upper : -1.0f;
      a.road_count[n] = road_cnt;
      float* c = a.corners + 9 * static_cast<size_t>(n);
      for (int r = 0; r < 3; ++r) {
        c[3 * r] = corner[r].x;
        c[3 * r + 1] = corner[r].y;
        c[3 * r + 2] = corner[r].z;
      }
    }
  }
}

}  // namespace

// uv [n, 2] f32 feature positions, valid [n] bool; the primary window's
// mask1 [n, k1] bool, points1 [n, k1, 3] f32, count1 [n] i32, z1 [n, k1]
// f32; the road window's mask2, points2, count2, z2 and flags2 alike with
// k2 cells (all null when params->k2 is 0); coeffs the camera-frame ground
// plane, [4] (coeff_stride 0) or [n, 4] (4), gp_ok [] (ok_stride 0) or [n]
// (1).  Writes depths [n] f32 and codes [n] i32 and, with
// params->collect_debug, seg_count, hist_bin, road_count [n] i32,
// hist_lower, hist_upper [n] f32 and corners [n, 3, 3] f32.  params is
// host memory, read before the launch.
extern "C" int mld_depth_cascade(
    const float* uv, const uint8_t* valid, const uint8_t* mask1,
    const float* points1, const int32_t* count1, const float* z1,
    const uint8_t* mask2, const float* points2, const int32_t* count2,
    const float* z2, const uint8_t* flags2, const float* coeffs,
    int coeff_stride, const uint8_t* gp_ok, int ok_stride, int n,
    float* depths, int32_t* codes, int32_t* seg_count, int32_t* hist_bin,
    float* hist_lower, float* hist_upper, float* corners,
    int32_t* road_count, const MldCascadeParams* params, void* stream) {
  const MldCascadeParams& p = *params;
  if (n < 0 || p.k1 < 1 || p.k2 < 0 || p.num_bins < 1 ||
      (p.road_estimator < 0 || p.road_estimator > 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  // Above the default 48 KB of dynamic shared memory a block, the limit is
  // raised for this launch; the attribute is per device, so it is set on
  // every such call, on the current one.
  const size_t smem = kWarpsPerBlock * slice_bytes(p.k1, p.k2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        depth_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  CascadeArgs a;
  a.uv = uv;
  a.valid = valid;
  a.mask1 = mask1;
  a.points1 = points1;
  a.count1 = count1;
  a.z1 = z1;
  a.mask2 = mask2;
  a.points2 = points2;
  a.count2 = count2;
  a.z2 = z2;
  a.flags2 = flags2;
  a.coeffs = coeffs;
  a.coeff_stride = coeff_stride;
  a.gp_ok = gp_ok;
  a.ok_stride = ok_stride;
  a.n = n;
  a.depths = depths;
  a.codes = codes;
  a.seg_count = seg_count;
  a.hist_bin = hist_bin;
  a.hist_lower = hist_lower;
  a.hist_upper = hist_upper;
  a.corners = corners;
  a.road_count = road_count;
  a.p = p;
  const unsigned blocks = static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  depth_cascade_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
