"""The plain reference that decides `correct` for the tracklet-depth node,
written for the benchmark apart from the program: numpy, one feature at a
time, in the order of the reference C++.

  * the ground plane from the road labels: SemanticPlane::
    CalculateInliersPlane (RansacPlane.cpp:195-274), an orthogonal
    least-squares plane through the points that project onto a road
    label, then again through every point within the refinement
    threshold of it;
  * the pixel grid: every visible point into the cell under it
    (NeighborFinderPixel.cpp:40-58);
  * per feature the state machine of DepthEstimator::CalculateDepth
    (DepthEstimator.cpp:491-600): the rectangle of neighbors, the
    first-local-maximum depth histogram (HistogramPointDepth.cpp:36-122),
    the largest spanning triangle, its planarity, the view ray's angle,
    the global and local depth gates and the cut behind the camera
    (CalculateDepthSegmented, :903-1037); failing that, the road
    fallback (:782-900): the wider rectangle, the veto of a neighbor off
    the ground plane, the M-estimator plane through the road points
    (RoadDepthEstimatorMEstimator.cpp) and the same gates.

Where the node's configuration departs from the C++ the reference
follows the configuration, as the port documents it: a cell keeps its
nearest point (depth quantized to 160 m / 16,382, then the lower raw
index) and not the first; a neighbor's x and y come back from its cell
and a 12-bit subpixel offset; the M-estimator weighs a road point by
1 / its distance to the ground plane; the triangle search takes every
point as a third corner; depths beyond `histogram_max_depth` share the
last bin.  The sensor data is float32, and so are the quantities that
decide a discrete step from it: the camera-frame points (the product in
float64, rounded once, then the translation added in float32), their
pixel coordinates and depth keys, the neighbors' decoded coordinates and
the depth bins.  The fits, the triangle's ranking and the depths are
float64.

Nothing here imports the program or takes anything that it made: the
inputs are the sensor data and the tracks that the benchmark made.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

F32 = np.float32
IDX_BITS = 17
ZQ_MAX = (1 << (31 - IDX_BITS)) - 2
ZQ_RANGE = 160.0
BIG = np.int64(2 ** 62)

# eDepthResultType.h:9-31
UNSPECIFIED = 0
SUCCESS = 1
RADIUS_INSUFFICIENT = 2
HISTOGRAM_NO_MAX = 3
GLOBAL_GREATER_MAX = 4
GLOBAL_SMALLER_MIN = 5
LOCAL_GREATER_MAX = 6
LOCAL_SMALLER_MIN = 7
TRIANGLE_NOT_PLANAR = 8
TRIANGLE_INSUFFICIENT = 9
BEHIND_CAMERA = 10
NOT_ORTHOGONAL = 11
SUCCESS_ROAD = 16


# The paths of the C++ that the reference implements; a configuration
# that asks for another is refused.
MODES = {"do_use_ransac_plane": True, "grid_collision_rule": "nearest",
         "fast_rasterization": False, "do_use_histogram_segmentation": True,
         "do_use_depth_segmentation": False, "do_use_PCA": False,
         "do_use_triangle_size_maximation": True,
         "plane_estimator_use_mestimator": True,
         "plane_estimator_use_leastsquares": False,
         "plane_estimator_use_triangle_maximation": False,
         "road_any_far_veto": True, "set_all_depths_to_zero": False}


class Camera(NamedTuple):
    width: int
    height: int
    f: float
    cx: float
    cy: float


class Raster(NamedTuple):
    """A cloud in the pixel grid: per cell the raw index of its point
    (-1 empty), that point's depth and ground flag, and the neighbors'
    decoded camera-frame coordinates."""

    grid: np.ndarray  # [H, W] int64
    z: np.ndarray  # [H, W] float32
    flag: np.ndarray  # [H, W] bool
    xyz: np.ndarray  # [H, W, 3] float32 decoded point


def _smallest_eigvec(points: np.ndarray, w: np.ndarray):
    """(unit normal, centre) of the weighted orthogonal LS plane."""
    c = (w[:, None] * points).sum(0) / w.sum()
    d = (points - c) * np.sqrt(w)[:, None]
    _, vecs = np.linalg.eigh(d.T @ d)
    return vecs[:, 0], c


def semantic_plane(cloud: np.ndarray, valid: np.ndarray, labels: np.ndarray,
                   cam: Camera, R: np.ndarray, t: np.ndarray, p: dict):
    """(coeffs [4] float32 in the lidar frame, normal up; inlier mask;
    ok) of the ground plane through the points on a road label."""
    H, W = labels.shape
    pts = cloud.astype(np.float64)
    pc = pts @ R.T + t
    z = pc[:, 2]
    safe = np.where(z == 0, 1.0, z)
    u = (F32(cam.f) * pc[:, 0] + F32(cam.cx) * z) / safe
    v = (F32(cam.f) * pc[:, 1] + F32(cam.cy) * z) / safe
    inside = (u >= 0) & (u <= W) & (v >= 0) & (v <= H) & (z > 0)
    col = np.clip(np.nan_to_num(u), 0, W - 1).astype(np.int64)
    row = np.clip(np.nan_to_num(v), 0, H - 1).astype(np.int64)
    road = np.isin(labels[row, col], p["semantic_ground_labels"])
    seed = valid & inside & road
    ok = int(seed.sum()) >= 3
    if not seed.any():
        return np.array([0, 0, 1, 0], F32), np.zeros_like(valid), False

    def fit(mask):
        n, c = _smallest_eigvec(pts[mask], np.ones(int(mask.sum())))
        return np.append(n, -n @ c).astype(F32)

    first = fit(seed).astype(np.float64)
    inliers = valid & (np.abs(pts @ first[:3] + first[3])
                       < F32(p["ransac_plane_refinement_treshold"]))
    coeffs = fit(inliers)
    if coeffs[2] < 0:
        coeffs = -coeffs
    return coeffs, inliers, ok


def plane_in_camera(coeffs: np.ndarray, R: np.ndarray, t: np.ndarray):
    """A lidar-frame plane in the camera frame, stored in float32."""
    c = coeffs.astype(np.float64)
    n = R @ c[:3]
    return np.append(n, c[3] - n @ t).astype(F32)


def camera_points(cloud: np.ndarray, R: np.ndarray, t32: np.ndarray):
    """The cloud in the camera frame, float32."""
    return (cloud.astype(np.float64) @ R.T).astype(F32) + t32


def raster(cloud: np.ndarray, valid: np.ndarray, flags: np.ndarray,
           cam: Camera, R: np.ndarray, t32: np.ndarray, H: int, W: int
           ) -> Raster:
    """The pixel grid [H, W] of a cloud: each cell keeps its nearest
    visible point."""
    pc = camera_points(cloud, R, t32)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    safe = np.where(z == 0, F32(1), z)
    u = F32(cam.f) * x / safe + F32(cam.cx)
    v = F32(cam.f) * y / safe + F32(cam.cy)
    vis = ((u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
           & (z > 0) & valid)
    col = np.clip(np.clip(u, -1, W).astype(np.int64), 0, W - 1)
    row = np.clip(np.clip(v, -1, H).astype(np.int64), 0, H - 1)
    zq = np.clip(np.clip(z * F32(ZQ_MAX / ZQ_RANGE), -1, ZQ_MAX + 1)
                 .astype(np.int64), 0, ZQ_MAX)
    key = (zq << IDX_BITS) | np.arange(len(cloud), dtype=np.int64)
    best = np.full(H * W, BIG)
    np.minimum.at(best, (row * W + col)[vis], key[vis])
    occupied = best != BIG
    idx = np.where(occupied, best & ((1 << IDX_BITS) - 1), 0)
    grid = np.where(occupied, idx, -1).reshape(H, W)
    # the winner's subpixel offset in 12 bits, decoded at its centre
    qu = np.clip((u - col.astype(F32)) * F32(4096), 0, 4095).astype(np.int64)
    qv = np.clip((v - row.astype(F32)) * F32(4096), 0, 4095).astype(np.int64)
    cells = np.arange(H * W)
    uu = (cells % W).astype(F32) + (qu[idx].astype(F32) + F32(0.5)) \
        * F32(1 / 4096)
    vv = (cells // W).astype(F32) + (qv[idx].astype(F32) + F32(0.5)) \
        * F32(1 / 4096)
    zw = np.where(occupied, z[idx], F32(0))
    inv_f = F32(1.0 / cam.f)
    xyz = np.stack([(uu - F32(cam.cx)) * inv_f * zw,
                    (vv - F32(cam.cy)) * inv_f * zw, zw], -1)
    return Raster(grid=grid, z=zw.reshape(H, W),
                  flag=(occupied & flags[idx]).reshape(H, W),
                  xyz=xyz.reshape(H, W, 3))


def neighbors(r: Raster, u: float, v: float, hx: float, hy: float):
    """The points of the cells in the rectangle around (u, v), row by
    row: (xyz [K, 3] float64, z [K] float32, ground flag [K])."""
    H, W = r.grid.shape
    u, v = F32(u), F32(v)
    x0 = int(max(u - F32(hx), F32(0)))
    x1 = int(min(u + F32(hx), F32(W - 1)))
    y0 = int(max(v - F32(hy), F32(0)))
    y1 = int(min(v + F32(hy), F32(H - 1)))
    g = r.grid[y0:y1 + 1, x0:x1 + 1]
    m = g >= 0
    return (r.xyz[y0:y1 + 1, x0:x1 + 1][m].astype(np.float64),
            r.z[y0:y1 + 1, x0:x1 + 1][m], r.flag[y0:y1 + 1, x0:x1 + 1][m])


def histogram_segment(z: np.ndarray, p: dict):
    """Indices of the points in the first local-maximum depth bin, or
    None where there is none (HistogramPointDepth.cpp:36-122)."""
    w = F32(p["histogram_segmentation_bin_witdh"])
    n_bins = int(np.floor(p["histogram_max_depth"]
                          / p["histogram_segmentation_bin_witdh"])) + 2
    d = np.minimum(z, F32(999))
    bins = np.clip(np.minimum(np.abs(d) / w, F32(n_bins)).astype(np.int64),
                   0, n_bins - 1)
    counts = np.bincount(bins)
    best, best_count, last, value = -1, -1, 0, 0
    for i in range(len(counts)):
        last, value = value, int(counts[i])
        if value > best_count and value >= p[
                "histogram_segmentation_min_pointcount"]:
            best, best_count = i, value
        elif value < best_count:
            break
        if last > 0 and value == 0:
            return None
    if best < 0:
        return None
    lower = F32(best) * w
    upper = lower + w
    return np.nonzero((d >= lower) & (d < upper))[0]


def spanning_triangle(pts: np.ndarray):
    """The farthest pair, then the point farthest from both: corners
    [3, 3], or None."""
    n = len(pts)
    if n < 3:
        return None
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    upper = np.triu(np.ones((n, n), bool), 1)
    flat = np.where(upper, d2, -1.0).ravel()
    best = int(np.argmax(flat))
    i, j = divmod(best, n)
    if flat[best] <= 0:
        return None
    score = d2[:, i] + d2[:, j]
    ok = (d2[:, i] > 0) & (d2[:, j] > 0)
    ok[[i, j]] = False
    if not ok.any():
        return None
    k = int(np.argmax(np.where(ok, score, -1.0)))
    return pts[[i, j, k]]


def _unit(v):
    n = np.linalg.norm(v)
    return v / (n if n else 1.0)


def planar(c: np.ndarray, threshold: float) -> bool:
    e1, e2, e3 = _unit(c[1] - c[0]), _unit(c[2] - c[0]), _unit(c[2] - c[1])
    return all(np.linalg.norm(np.cross(a, b)) >= threshold
               for a, b in ((e1, e2), (e1, e3), (e2, e3)))


def view_ray(cam: Camera, u: float, v: float) -> np.ndarray:
    f = float(F32(cam.f))
    d = np.array([(float(F32(u)) - float(F32(cam.cx))) / f,
                  (float(F32(v)) - float(F32(cam.cy))) / f, 1.0])
    return d / np.linalg.norm(d)


def intersect(normal: np.ndarray, offset: float, ray: np.ndarray) -> float:
    """Depth (z) where the ray from the origin meets the plane."""
    denom = float(normal @ ray)
    if denom == 0:
        return -np.inf
    return float(-offset / denom * ray[2])


def gates(depth: float, seg_z: np.ndarray, p: dict):
    """(depth, failure code or None): the global gate, the local gate,
    the cut behind the camera (CalculateDepthSegmented :1006-1026)."""
    if p["treshold_depth_enabled"]:
        lo, hi = p["treshold_depth_min"], p["treshold_depth_max"]
        if p["treshold_depth_mode"] == 0:
            if depth > hi:
                return -1.0, GLOBAL_GREATER_MAX
            if depth < lo:
                return -1.0, GLOBAL_SMALLER_MIN
        else:
            depth = min(max(depth, lo), hi)
    if p["treshold_depth_local_enabled"] and len(seg_z):
        zmin, zmax = float(seg_z.min()), float(seg_z.max())
        tol = (p["treshold_depth_local_value"] * (zmax - zmin)
               if p["treshold_depth_local_valuetype"] == 1
               else p["treshold_depth_local_value"])
        if p["treshold_depth_local_mode"] == 0:
            if depth < zmin - tol:
                return -1.0, LOCAL_SMALLER_MIN
            if depth > zmax + tol:
                return -1.0, LOCAL_GREATER_MAX
        else:
            depth = min(max(depth, zmin - tol), zmax + tol)
    if depth < 0 and p["do_use_cut_behind_camera"]:
        return -1.0, BEHIND_CAMERA
    return depth, None


def segment_depth(pts: np.ndarray, seg_z: np.ndarray, ray: np.ndarray,
                  p: dict):
    """(depth, code) of the triangle through a segmented point set."""
    tri = spanning_triangle(pts)
    if tri is None:
        return -1.0, TRIANGLE_INSUFFICIENT
    if p["do_check_triangleplanar_condition"] and not planar(
            tri, p["triangleplanar_crossnorm_treshold"]):
        return -1.0, TRIANGLE_NOT_PLANAR
    normal = _unit(np.cross(tri[1] - tri[0], tri[2] - tri[0]))
    th = p["viewray_plane_orthoganality_treshold"]
    if th > 0 and abs(float(normal @ ray)) < th:
        return -1.0, NOT_ORTHOGONAL
    depth, code = gates(intersect(normal, -float(normal @ tri[0]), ray),
                        seg_z, p)
    return (depth, SUCCESS) if code is None else (-1.0, code)


def feature_depth(r: Raster, plane_cam: np.ndarray, plane_ok: bool,
                  cam: Camera, u: float, v: float, p: dict):
    """(depth, code) of one feature (DepthEstimator.cpp:491-600)."""
    hx = p["pixelarea_search_witdh"] * 0.5
    hy = p["pixelarea_search_height"] * 0.5
    pts, z, _ = neighbors(r, u, v, hx, hy)
    if len(pts) < p["radiusSearch_count_min"]:
        return -1.0, RADIUS_INSUFFICIENT
    ray = view_ray(cam, u, v)
    sel = histogram_segment(z, p)
    if sel is None:
        code = HISTOGRAM_NO_MAX
    else:
        depth, code = segment_depth(pts[sel], z[sel], ray, p)
        if code == SUCCESS:
            return depth, code
    if not plane_ok:
        return -1.0, code
    pts2, z2, flag2 = neighbors(r, u, v, hx * p["road_search_scale_x"],
                                hy * p["road_search_scale_y"])
    if len(pts2) < p["radiusSearch_count_min"]:
        return -1.0, RADIUS_INSUFFICIENT
    n = plane_cam[:3].astype(np.float64)
    dist = np.abs(pts2 @ n + float(plane_cam[3])) / (np.linalg.norm(n) or 1.0)
    if (dist > p["ransac_plane_point_distance_treshold"]).any():
        return -1.0, code
    if int(flag2.sum()) < 3:
        return -1.0, code
    w = 1.0 / np.maximum(dist[flag2], float(F32(1e-9)))
    normal, centre = _smallest_eigvec(pts2[flag2], w)
    depth, gate = gates(intersect(normal, -float(normal @ centre), ray),
                        z2[flag2], p)
    return (depth, SUCCESS_ROAD) if gate is None else (-1.0, gate)


class Frame(NamedTuple):
    """One cloud as the reference sees it: its raster, and its ground
    plane in the camera frame."""

    raster: Raster
    plane_cam: np.ndarray
    plane_ok: bool
    plane: np.ndarray  # lidar frame


def frame(cloud, valid, labels, cam: Camera, R, t32, p: dict) -> Frame:
    """The ground plane of a cloud from its labels, and its raster with
    the plane's inliers flagged."""
    wrong = {k: p.get(k) for k, v in MODES.items() if p.get(k) != v}
    if wrong:
        raise ValueError(f"the reference implements {MODES}, not {wrong}")
    t = t32.astype(np.float64)
    coeffs, inliers, ok = semantic_plane(cloud, valid, labels, cam, R, t, p)
    r = raster(cloud, valid, inliers, cam, R, t32, p["image_height"],
               p["image_width"])
    return Frame(raster=r, plane_cam=plane_in_camera(coeffs, R, t),
                 plane_ok=ok, plane=coeffs)


def depths(fr: Frame, cam: Camera, uv: np.ndarray, lanes: np.ndarray,
           p: dict):
    """(depths [M], codes [M]) of the features uv [M, 2] on `lanes`; the
    other lanes read -1 and Unspecified."""
    out_d = np.full(len(uv), -1.0)
    out_c = np.full(len(uv), UNSPECIFIED, np.int64)
    for m in np.nonzero(lanes)[0]:
        out_d[m], out_c[m] = feature_depth(fr.raster, fr.plane_cam,
                                           fr.plane_ok, cam, uv[m, 0],
                                           uv[m, 1], p)
    return out_d, out_c
