"""A plain float64 reference for one step of the LIMO odometry stream:
the image tracker's frame, the pose Gauss-Newton with its retry and
acceptance gates, the window ring and the damped window bundle
adjustment with lidar depth priors.

Written from the equations (Graeter, Wilczynski and Lauer, "LIMO:
Lidar-Monocular Visual Odometry", IROS 2018, and the documented
semantics of the JAX package's tracker and VO modules, which it does
not import), in plain PyTorch: float64 throughout, no kernel, no cache,
no batching beyond plain vectorization over lanes.  It imports nothing
of the program it judges.

The tracker step (`tracker_step`):
  * a 2x2 mean pyramid of each grey image (odd last rows and columns
    dropped), finest level first;
  * pyramidal Lucas-Kanade, forward from the constant-velocity guess
    (the lane's last flow, or, for a lane with none, the per-axis median
    flow of the lanes that have one: the mean of the two middle values
    of an even count), then backward from the forward result to the
    start.  Each level samples bilinearly with every tap clamped into
    the image (an edge-replicated image), around a centre clamped to
    `[-s, size - 1.001 + s]` with s = patch // 2 + 1; the template and
    its central-difference gradients come from the previous level at
    the lane's start, the 2x2 normal matrix must have a determinant
    above `min_det` on every level of both passes, and each of `iters`
    iterations takes the full Newton step;
  * the acceptance gates: both passes well conditioned, the backward
    pass back within `fb_threshold` px, the tracked position more than
    1 px inside the image, and the zero-normalized cross-correlation of
    the two patches above `min_ncc`;
  * Shi-Tomasi detection: Sobel gradients (scale 1/8) and a box mean
    of their products over 5x5 pixels, both with zeros outside the
    image; the smaller eigenvalue; `border` pixels masked; the best
    pixel of each `cell_size` cell (the first in row order among
    equals); cells holding a surviving lane masked; the cells ranked by
    response, equals by cell index; a detection counts above
    `min_response`;
  * the detections, in rank order, go to the free lanes in lane order;
    each takes the next id.

The odometry tail (`odometry_tail`), from the track table that the
depth association left and the odometry state before the frame:
landmarks of the tracks seen in this and the last frame with a depth
at the last one; pose Gauss-Newton (left perturbation, Huber weights at
3 px, points nearer than 0.25 m left out, a hard refit on the points
within 6 px when at least 6 remain); the retry from identity under the
same predicates, kept when it has more inliers; the acceptance gates;
the window ring; landmarks initialised from their newest in-window
depth; and the bundle adjustment: reprojection residuals with Huber
weights at 2 px and depth residuals with weight `depth_weight` and
Huber at 0.5 m, Marquardt damping relative to each block's trace, the
oldest valid pose and the empty slots held fixed, the landmarks
eliminated by the Schur complement and the reduced system solved
exactly.

Departures, each on purpose:
  * float64 where the program runs float32;
  * the reference is handed the program's own state before the step,
    so that no drift builds up between the two;
  * `tracker_step` may be handed the program's survivors for its
    detection and lane allocation (`occupied`), so that a lane that a
    gate decides apart counts once, and not again in every birth
    allocated after it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

F64 = torch.float64


# ---------------------------------------------------------------------------
# the tracker


class TrackerParams(NamedTuple):
    cell_size: int = 16
    patch: int = 9
    iters: int = 8
    min_det: float = 1e-4
    min_ncc: float = 0.6
    fb_threshold: float = 1.0
    min_response: float = 1e-4
    border: int = 8


class TrackerIn(NamedTuple):
    """The tracker's state before a frame (any dtype, any device)."""

    uv: torch.Tensor  # [N, 2] lane positions in the previous image
    ids: torch.Tensor  # [N] track ids, -1 free
    age: torch.Tensor  # [N] frames observed
    valid: torch.Tensor  # [N] bool
    next_id: int
    flow: torch.Tensor  # [N, 2] last frame's image motion, 0 for none


class TrackerStep(NamedTuple):
    uv_f: torch.Tensor  # [N, 2] forward-tracked positions
    survived: torch.Tensor  # [N] bool
    emit: torch.Tensor  # [N] bool: survived, observed twice or more
    born: torch.Tensor  # [N] bool: a detection took the lane
    uv: torch.Tensor  # [N, 2] the state's positions after the frame
    ids: torch.Tensor  # [N]
    age: torch.Tensor  # [N]
    valid: torch.Tensor  # [N]
    next_id: int
    flow: torch.Tensor  # [N, 2]


def grey(img_u8: torch.Tensor) -> torch.Tensor:
    """An 8-bit grey image as float64 in [0, 1]."""
    return img_u8.to(F64) / 255.0


def pyramid(img: torch.Tensor, levels: int) -> list:
    out = [img]
    for _ in range(levels - 1):
        a = out[-1]
        h, w = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
        a = a[:h, :w]
        out.append(0.25 * (a[0::2, 0::2] + a[0::2, 1::2]
                           + a[1::2, 0::2] + a[1::2, 1::2]))
    return out


def sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
           ) -> torch.Tensor:
    """Bilinear samples at (x, y) (any equal shapes); every one of the
    four taps is clamped into the image."""
    H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()

    def tap(yy, xx):
        return img[yy.clamp(0, H - 1), xx.clamp(0, W - 1)]

    top = (1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1)
    bottom = (1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)
    return (1 - fy) * top + fy * bottom


def centre(uv: torch.Tensor, H: int, W: int, slack: int):
    """A patch's centre, clamped to `slack` px beyond the image."""
    x = uv[:, 0].clamp(-slack, W - 1.001 + slack)
    y = uv[:, 1].clamp(-slack, H - 1.001 + slack)
    return x, y


def patches(img: torch.Tensor, uv: torch.Tensor, reach: int, slack: int
            ) -> torch.Tensor:
    """[N, 2 reach + 1, 2 reach + 1] bilinear samples at integer offsets
    (row, column) around the clamped centres."""
    H, W = img.shape
    x, y = centre(uv, H, W, slack)
    k = torch.arange(-reach, reach + 1, dtype=F64, device=img.device)
    return sample(img, x[:, None, None] + k[None, None, :],
                  y[:, None, None] + k[None, :, None])


def lk_level(src, dst, start, guess, patch, iters, min_det):
    """One level: (positions [N, 2], well conditioned [N])."""
    r = patch // 2
    slack = r + 1
    B = patches(src, start, r + 1, slack)
    template = B[:, 1:-1, 1:-1]
    gx = 0.5 * (B[:, 1:-1, 2:] - B[:, 1:-1, :-2])
    gy = 0.5 * (B[:, 2:, 1:-1] - B[:, :-2, 1:-1])
    a = (gx * gx).sum((1, 2))
    b = (gx * gy).sum((1, 2))
    c = (gy * gy).sum((1, 2))
    det = a * c - b * b
    ok = det > min_det
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    uv = guess
    for _ in range(iters):
        e = patches(dst, uv, r, slack) - template
        ex, ey = (e * gx).sum((1, 2)), (e * gy).sum((1, 2))
        du = -(c * ex - b * ey) * inv
        dv = -(a * ey - b * ex) * inv
        uv = uv + torch.stack([du, dv], 1)
    return uv, ok


def lk_pyramidal(src_pyr, dst_pyr, start, guess, patch, iters, min_det):
    L = len(src_pyr)
    ok_all = torch.ones(start.shape[0], dtype=torch.bool,
                        device=start.device)
    g = guess / 2.0 ** (L - 1)
    for lvl in reversed(range(L)):
        g, ok = lk_level(src_pyr[lvl], dst_pyr[lvl], start / 2.0 ** lvl, g,
                         patch, iters, min_det)
        ok_all &= ok
        if lvl:
            g = 2.0 * g
    return g, ok_all


def zncc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.flatten(1) - a.flatten(1).mean(1, keepdim=True)
    b = b.flatten(1) - b.flatten(1).mean(1, keepdim=True)
    den = torch.sqrt((a * a).sum(1) * (b * b).sum(1))
    return (a * b).sum(1) / den.clamp(min=1e-8)


def median_flow(flow: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """Per axis, the median of the flows of the lanes in `has` (the mean
    of the two middle values of an even count); zero where none."""
    n = int(has.sum())
    if n == 0:
        return torch.zeros(2, dtype=F64, device=flow.device)
    ordered = torch.sort(flow[has], dim=0).values
    return 0.5 * (ordered[(n - 1) // 2] + ordered[n // 2])


def _correlate(img: torch.Tensor, kernel) -> torch.Tensor:
    """'Same' cross-correlation with zeros outside the image; `kernel`
    a list of rows."""
    kh, kw = len(kernel), len(kernel[0])
    H, W = img.shape
    pad = torch.zeros((H + kh - 1, W + kw - 1), dtype=F64, device=img.device)
    pad[kh // 2:kh // 2 + H, kw // 2:kw // 2 + W] = img
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            if kernel[i][j]:
                out = out + kernel[i][j] * pad[i:i + H, j:j + W]
    return out


SOBEL_X = [[-1 / 8, 0, 1 / 8], [-2 / 8, 0, 2 / 8], [-1 / 8, 0, 1 / 8]]
SOBEL_Y = [list(r) for r in zip(*SOBEL_X)]


def shi_tomasi(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    ix, iy = _correlate(img, SOBEL_X), _correlate(img, SOBEL_Y)
    box = [[1.0] * window for _ in range(window)]
    n = window * window
    sxx = _correlate(ix * ix, box) / n
    syy = _correlate(iy * iy, box) / n
    sxy = _correlate(ix * iy, box) / n
    disc = torch.sqrt(((sxx - syy) ** 2 + 4 * sxy * sxy).clamp(min=0))
    return 0.5 * (sxx + syy - disc)


def detect(img: torch.Tensor, n: int, p: TrackerParams,
           occupied_uv: torch.Tensor, occupied: torch.Tensor):
    """(uv [n, 2], valid [n]) in rank order."""
    H, W = img.shape
    dev = img.device
    cs = p.cell_size
    resp = shi_tomasi(img)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inside = ((xx >= p.border) & (xx < W - p.border)
              & (yy >= p.border) & (yy < H - p.border))
    resp = torch.where(inside, resp, -math.inf)
    gh, gw = -(-H // cs), -(-W // cs)
    grid = torch.full((gh * cs, gw * cs), -math.inf, dtype=F64, device=dev)
    grid[:H, :W] = resp
    cells = grid.reshape(gh, cs, gw, cs).permute(0, 2, 1, 3).reshape(
        gh * gw, cs * cs)
    best = cells.max(1).values
    first = torch.argmax((cells == best[:, None]).to(torch.uint8), dim=1)
    cx = (occupied_uv[:, 0] / cs).to(torch.int64).clamp(0, gw - 1)
    cy = (occupied_uv[:, 1] / cs).to(torch.int64).clamp(0, gh - 1)
    taken = torch.zeros(gh * gw, dtype=torch.bool, device=dev)
    taken[(cy * gw + cx)[occupied]] = True
    best = torch.where(taken, -math.inf, best)
    cell = torch.arange(gh * gw, device=dev)
    # by response, equals by cell index: a stable sort of the cells
    order = torch.sort(-best, stable=True).indices[:n]
    k = order.shape[0]
    uv = torch.zeros((n, 2), dtype=F64, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    c = cell[order]
    uv[:k, 0] = ((c % gw) * cs + first[c] % cs).to(F64)
    uv[:k, 1] = ((c // gw) * cs + first[c] // cs).to(F64)
    valid[:k] = best[order] > p.min_response
    return uv, valid


def tracker_step(prev_img: torch.Tensor, img: torch.Tensor, state: TrackerIn,
                 levels: int, p: TrackerParams,
                 occupied: Optional[tuple] = None) -> TrackerStep:
    """One frame of the tracker from `state` (module docstring).  The
    images are float64 [H, W] (`grey`).  `occupied` = (uv [N, 2],
    survived [N]) puts those lanes in place of this step's own survivors
    for detection and allocation."""
    dev = img.device
    N = state.uv.shape[0]
    uv = state.uv.to(dev, F64)
    flow = state.flow.to(dev, F64)
    valid = state.valid.to(dev)
    ids = state.ids.to(dev, torch.int64)
    age = state.age.to(dev, torch.int64)
    prev_pyr, next_pyr = pyramid(prev_img, levels), pyramid(img, levels)

    has = valid & (flow.abs().sum(1) > 0)
    guess = uv + torch.where(has[:, None], flow, median_flow(flow, has))
    uv_f, ok_f = lk_pyramidal(prev_pyr, next_pyr, uv, guess, p.patch,
                              p.iters, p.min_det)
    uv_b, ok_b = lk_pyramidal(next_pyr, prev_pyr, uv_f, uv, p.patch,
                              p.iters, p.min_det)
    H, W = img.shape
    r = p.patch // 2
    fb = torch.linalg.vector_norm(uv_b - uv, dim=1)
    inside = ((uv_f[:, 0] > 1) & (uv_f[:, 0] < W - 2)
              & (uv_f[:, 1] > 1) & (uv_f[:, 1] < H - 2))
    ncc = zncc(patches(prev_img, uv, r, r + 1),
               patches(img, uv_f, r, r + 1))
    survived = (valid & ok_f & ok_b & (fb < p.fb_threshold) & inside
                & (ncc > p.min_ncc))
    emit = survived & (age + 1 >= 2)

    occ_uv, occ = ((uv_f, survived) if occupied is None else
                   (occupied[0].to(dev, F64), occupied[1].to(dev)))
    det_uv, det_ok = detect(img, N, p, occ_uv, occ)
    free = torch.nonzero(~occ).flatten()  # lane order
    found = torch.nonzero(det_ok).flatten()  # rank order
    m = min(len(free), len(found))
    lanes, picks = free[:m], found[:m]

    born = torch.zeros(N, dtype=torch.bool, device=dev)
    born[lanes] = True
    new_uv = torch.where(survived[:, None], uv_f, 0.0)
    new_uv[lanes] = det_uv[picks]
    new_ids = torch.where(survived, ids, -1)
    new_ids[lanes] = state.next_id + torch.arange(m, device=dev)
    new_age = torch.where(survived, age + 1, 0)
    new_age[lanes] = 1
    new_flow = torch.where(survived[:, None], uv_f - uv, 0.0)
    new_flow[lanes] = 0.0
    return TrackerStep(uv_f=uv_f, survived=survived, emit=emit, born=born,
                       uv=new_uv, ids=new_ids, age=new_age,
                       valid=survived | born, next_id=state.next_id + m,
                       flow=new_flow)


# ---------------------------------------------------------------------------
# rigid motions


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp_se3(xi: torch.Tensor):
    """[..., 6] (translation part, rotation part) -> (R, t): Rodrigues and
    the left Jacobian, with their series near zero."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1)[..., None, None]
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, 1.0, th2))
    A = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th ** 2)
    C = torch.where(small, 1 / 6 - th2 / 120,
                    (th - torch.sin(th)) / th ** 3)
    K = skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + A * K + B * (K @ K)
    V = eye + B * K + C * (K @ K)
    return R, (V @ rho[..., None])[..., 0]


def angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle of Ra^T Rb in degrees."""
    M = Ra.transpose(-1, -2) @ Rb
    c = ((M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] - 1) / 2).clamp(-1, 1)
    # acos loses its precision near 0: take the angle from the skew part
    s = torch.linalg.vector_norm(torch.stack(
        [M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
         M[..., 1, 0] - M[..., 0, 1]], -1), dim=-1) / 2
    return torch.rad2deg(torch.atan2(s, c))


# ---------------------------------------------------------------------------
# the odometry tail


class Camera(NamedTuple):
    f: float
    cx: float
    cy: float


class OdometryParams(NamedTuple):
    ba_window: int = 5
    ba_iters: int = 6
    ba_every: int = 1
    depth_weight: float = 2.0
    min_motion_tracks: int = 12
    gn_iters: int = 10
    accept_max_err: float = 1.5
    accel_gate_m: float = 1.0
    retry_inlier_ratio: float = 0.5
    retry_max_err: float = 1.0
    persist_landmarks: bool = False


class Table(NamedTuple):
    """The track table after the depth association (any dtype)."""

    track_id: torch.Tensor  # [T], -1 free
    length: torch.Tensor  # [T]
    uv: torch.Tensor  # [T, L, 2], column 0 the newest
    depth: torch.Tensor  # [T, L], <= 0 none


class OdometryIn(NamedTuple):
    """The odometry state before a frame (any dtype)."""

    win_R: torch.Tensor  # [W, 3, 3] camera-from-world, slot 0 newest
    win_t: torch.Tensor  # [W, 3]
    win_valid: torch.Tensor  # [W] bool
    frame_idx: int
    rel_R: torch.Tensor  # [3, 3] last accepted motion (cur <- prev)
    rel_t: torch.Tensor  # [3]
    motion_ok: bool


class Pose(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # [N] bool
    n_inliers: int
    mean_error: float


class OdometryStep(NamedTuple):
    R_cw: torch.Tensor  # [3, 3] the step's pose (the BA's newest)
    t_cw: torch.Tensor  # [3]
    win_R: torch.Tensor  # [W, 3, 3] the window after the BA
    win_t: torch.Tensor
    win_valid: torch.Tensor
    frame_idx: int
    rel_R: torch.Tensor
    rel_t: torch.Tensor
    motion_ok: bool
    n_usable: int
    n_inliers: int
    mean_error: float
    n_landmarks: int  # landmarks the window BA holds
    retry: bool
    accepted: bool
    ran_ba: bool


MIN_DEPTH = 0.25


def unproject(cam: Camera, uv: torch.Tensor, d: torch.Tensor
              ) -> torch.Tensor:
    """Camera-frame points [..., 3] at depth d through pixels uv."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.f * d,
                        (uv[..., 1] - cam.cy) / cam.f * d, d], -1)


def projection(cam: Camera, p: torch.Tensor):
    """(pixels [..., 2], d pixels / d p [..., 2, 3], behind [...])."""
    z = p[..., 2]
    iz = 1.0 / z.clamp(min=MIN_DEPTH)
    x, y = p[..., 0] * iz, p[..., 1] * iz
    uv = torch.stack([cam.f * x + cam.cx, cam.f * y + cam.cy], -1)
    zero = torch.zeros_like(z)
    J = cam.f * iz[..., None, None] * torch.stack([
        torch.stack([torch.ones_like(z), zero, -x], -1),
        torch.stack([zero, torch.ones_like(z), -y], -1)], -2)
    return uv, J, z <= MIN_DEPTH


def motion_jacobian(p: torch.Tensor) -> torch.Tensor:
    """d p / d xi [..., 3, 6] of p -> exp(xi) p: [I | -[p]x]."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        *p.shape[:-1], 3, 3)
    return torch.cat([eye, -skew(p)], -1)


def huber_weight(err: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(err <= delta, 1.0, delta / err.clamp(min=1e-9))


def pose_gn(cam: Camera, X: torch.Tensor, obs: torch.Tensor,
            valid: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            iters: int, huber: float = 3.0, outlier: float = 6.0) -> Pose:
    """T with obs ~ pi(T X): Huber-weighted Gauss-Newton from (R, t),
    then a refit on the points within `outlier` px when 6 or more."""
    eye6 = torch.eye(6, dtype=F64, device=X.device)

    def residuals(R, t):
        p = X @ R.T + t
        uv, Jp, behind = projection(cam, p)
        r = uv - obs
        return r, Jp @ motion_jacobian(p), behind, torch.sqrt(
            (r * r).sum(-1) + 1e-18)

    def solve(R, t, use, n):
        for _ in range(n):
            r, J, behind, err = residuals(R, t)
            w = torch.where(use & ~behind, huber_weight(err, huber), 0.0)
            H = torch.einsum("n,nai,naj->ij", w, J, J) + 1e-6 * eye6
            g = torch.einsum("n,nai,na->i", w, J, r)
            dR, dt = exp_se3(-torch.linalg.solve(H, g))
            R, t = dR @ R, dR @ t + dt
        return R, t

    R, t = solve(R, t, valid, iters)
    _, _, behind, err = residuals(R, t)
    keep = valid & ~behind & (err < outlier)
    if int(keep.sum()) >= 6:
        R, t = solve(R, t, keep, max(iters // 2, 3))
    _, _, behind, err = residuals(R, t)
    inl = valid & ~behind & (err < outlier)
    n = int(inl.sum())
    mean = float(torch.where(inl, err, 0.0).sum()) / max(n, 1)
    return Pose(R, t, inl, n, mean)


def ba_iteration(cam, R, t, X, obs, seen, prior, has_d, fixed, lm_ok,
                 depth_weight, huber=2.0, huber_d=0.5, damping=1e-4):
    """One damped Gauss-Newton step of the window [K] x landmarks [L]."""
    K, L = seen.shape
    dev = X.device
    p = torch.einsum("kij,lj->kli", R, X) + t[:, None, :]  # [K, L, 3]
    uv, Jp, behind = projection(cam, p)
    r = uv - obs
    z = p[..., 2]
    r_d = z - prior
    use = seen & lm_ok[None, :] & ~behind
    use_d = (has_d & seen & lm_ok[None, :] & (z > MIN_DEPTH)
             & (prior > 0))
    err = torch.sqrt((r * r).sum(-1) + 1e-18)
    w = torch.where(use, huber_weight(err, huber), 0.0)
    w_d = torch.where(use_d, depth_weight * huber_weight(r_d.abs(), huber_d),
                      0.0)

    Jc = Jp @ motion_jacobian(p)  # [K, L, 2, 6]
    Jl = Jp @ R[:, None]  # [K, L, 2, 3]
    zero = torch.zeros_like(z)
    Jc_d = torch.stack([zero, zero, torch.ones_like(z), p[..., 1],
                        -p[..., 0], zero], -1)  # [K, L, 6]
    Jl_d = R[:, None, 2, :].expand(K, L, 3)

    Hcc = (torch.einsum("kl,klai,klaj->kij", w, Jc, Jc)
           + torch.einsum("kl,kli,klj->kij", w_d, Jc_d, Jc_d))
    Hll = (torch.einsum("kl,klai,klaj->lij", w, Jl, Jl)
           + torch.einsum("kl,kli,klj->lij", w_d, Jl_d, Jl_d))
    Hcl = (torch.einsum("kl,klai,klaj->klij", w, Jc, Jl)
           + torch.einsum("kl,kli,klj->klij", w_d, Jc_d, Jl_d))
    bc = (torch.einsum("kl,klai,kla->ki", w, Jc, r)
          + torch.einsum("kl,kli,kl->ki", w_d, Jc_d, r_d))
    bl = (torch.einsum("kl,klai,kla->li", w, Jl, r)
          + torch.einsum("kl,kli,kl->li", w_d, Jl_d, r_d))

    eye3 = torch.eye(3, dtype=F64, device=dev)
    eye6 = torch.eye(6, dtype=F64, device=dev)
    free = ((w.sum(0) + w_d.sum(0)) > 0) & lm_ok
    tr_l = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1) / 3
    lam = damping * tr_l.clamp(min=1.0) + 1e-8
    Hll = torch.where(free[:, None, None], Hll + lam[:, None, None] * eye3,
                      eye3)
    bl = torch.where(free[:, None], bl, 0.0)
    tr_c = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1) / 6
    Hcc = Hcc + (damping * tr_c.clamp(min=1.0))[:, None, None] * eye6

    # eliminate the landmarks: S = Hcc - Hcl Hll^-1 Hcl^T
    Hll_inv = torch.linalg.inv(Hll)  # [L, 3, 3]
    HclHinv = Hcl @ Hll_inv[None]  # [K, L, 6, 3]
    S = -torch.einsum("alij,blkj->aibk", HclHinv, Hcl)  # [K, 6, K, 6]
    for k in range(K):
        S[k, :, k, :] += Hcc[k]
    rhs = -(bc - torch.einsum("klij,lj->ki", HclHinv, bl))
    for k in range(K):
        if fixed[k]:
            S[k, :, :, :] = 0.0
            S[:, :, k, :] = 0.0
            S[k, :, k, :] = eye6
            rhs[k] = 0.0
    dx = torch.linalg.solve(S.reshape(6 * K, 6 * K),
                            rhs.reshape(6 * K)).reshape(K, 6)
    dx = torch.where(fixed[:, None], 0.0, dx)
    dl = torch.einsum("lij,lj->li", Hll_inv,
                      -bl - torch.einsum("klji,kj->li", Hcl, dx))
    dl = torch.where(free[:, None], dl, 0.0)
    dR, dt = exp_se3(dx)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt, X + dl


def odometry_tail(cam: Camera, table: Table, state: OdometryIn,
                  p: OdometryParams, device=None) -> OdometryStep:
    """The odometry step after the depth association (module
    docstring), from the program's table and state, in float64."""
    dev = device if device is not None else table.uv.device
    tid = table.track_id.to(dev)
    length = table.length.to(dev, torch.int64)
    uv = table.uv.to(dev, F64)
    depth = table.depth.to(dev, F64)
    win_R, win_t = state.win_R.to(dev, F64), state.win_t.to(dev, F64)
    win_valid = state.win_valid.to(dev)
    rel_R, rel_t = state.rel_R.to(dev, F64), state.rel_t.to(dev, F64)
    active = tid >= 0
    W = win_R.shape[0]

    usable = active & (length >= 2) & (depth[:, 1] > 0)
    X = unproject(cam, uv[:, 1], depth[:, 1])
    n_usable = int(usable.sum())
    est = pose_gn(cam, X, uv[:, 0], usable, rel_R, rel_t, p.gn_iters)
    retry = (est.n_inliers < p.min_motion_tracks
             or est.n_inliers < p.retry_inlier_ratio * n_usable
             or est.mean_error > p.retry_max_err)
    if retry:
        est2 = pose_gn(cam, X, uv[:, 0], usable,
                       torch.eye(3, dtype=F64, device=dev),
                       torch.zeros(3, dtype=F64, device=dev), p.gn_iters)
        if est2.n_inliers > est.n_inliers:
            est = est2

    gate = max(0.5 * float(torch.linalg.vector_norm(rel_t)), p.accel_gate_m)
    plausible = (not state.motion_ok) or float(
        torch.linalg.vector_norm(est.t - rel_t)) <= gate
    confident = (est.n_inliers >= 3 * p.min_motion_tracks
                 and est.mean_error <= 0.8)
    accepted = (est.n_inliers >= p.min_motion_tracks
                and est.mean_error <= p.accept_max_err
                and (plausible or confident))
    if accepted:
        rel_R, rel_t = est.R, est.t

    R_new = rel_R @ win_R[0]
    t_new = rel_R @ win_t[0] + rel_t
    win_R = torch.cat([R_new[None], win_R[:-1]])
    win_t = torch.cat([t_new[None], win_t[:-1]])
    win_valid = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           win_valid[:-1]])

    # the window: frame k of the window is table column k
    k = torch.arange(W, device=dev)
    seen = (active[None, :] & (k[:, None] < length[None, :])
            & win_valid[:, None])
    obs = uv[:, :W].transpose(0, 1)  # [W, T, 2]
    prior = depth[:, :W].transpose(0, 1)  # [W, T]
    has_d = seen & (prior > 0)
    newest = torch.argmax(has_d.to(torch.uint8), dim=0)  # first column
    lanes = torch.arange(tid.shape[0], device=dev)
    X_cam = unproject(cam, obs[newest, lanes], prior[newest, lanes])
    X_w = torch.einsum("lji,lj->li", win_R[newest],
                       X_cam - win_t[newest])  # R^T (p - t)
    lm_ok = active & has_d.any(0) & (seen.sum(0) >= 2)
    fixed = (k == int(win_valid.sum()) - 1) | ~win_valid

    ran_ba = state.frame_idx % p.ba_every == 0 and state.frame_idx >= 1
    if ran_ba:
        for _ in range(p.ba_iters):
            win_R, win_t, X_w = ba_iteration(
                cam, win_R, win_t, X_w, obs, seen, prior, has_d, fixed,
                lm_ok, p.depth_weight)
    return OdometryStep(
        R_cw=win_R[0], t_cw=win_t[0], win_R=win_R, win_t=win_t,
        win_valid=win_valid, frame_idx=state.frame_idx + 1, rel_R=rel_R,
        rel_t=rel_t, motion_ok=bool(state.motion_ok) or accepted,
        n_usable=n_usable, n_inliers=est.n_inliers,
        mean_error=est.mean_error, n_landmarks=int(lm_ok.sum()),
        retry=bool(retry), accepted=accepted,
        ran_ba=ran_ba)
