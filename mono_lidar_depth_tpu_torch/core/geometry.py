"""Batched geometry primitives (PyTorch counterpart of core/geometry.py).

Pinhole camera, rigid transforms, ray-plane intersection, plane
distance and the closed-form symmetric 3x3 eigensolvers.  Every
function is shape-polymorphic over leading batch dimensions.  The
3-vector helpers (`dot3`, `cross3`, `norm3`) spell out the component
arithmetic in the order the JAX package's XLA lowering evaluates it,
so that the CPU parity tests can hold integer/select outputs built on
them bit-exact.  No LAPACK or cuSOLVER call is reachable from here: the
3x3 determinant is written out.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import torch

from ..device import Device, default_device


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last (size-3) axis of a * b, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(v, v))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (jnp.cross's formula)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    """x with exact zeros replaced by 1 (safe divisor)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as a true division on every device.  On a card ATen
    computes `x / c` for a Python number c as x * (1 / c), which can be
    one ulp off the quotient; a 0-dim divisor on x's device is divided
    by, as the CPU divides by either."""
    return x / x.new_full((), c)


def f32(t: float) -> float:
    """t rounded to the nearest float32, as a Python float.

    The depth association's fits and rankings (`core/ransac.py`,
    `core/planefit.py`, `depth_estimator.plane_to_camera`) run in float64
    from their float32 inputs and round to float32 once, at their output.
    A float32 x float32 product is exact in float64, a sum of three terms
    is written out left to right (`dot3`) and a longer sum is taken in an
    order that its terms fix (`sum_sorted`), so the card and the CPU
    compute the same float64 fit, and land on the same float32 result.
    A threshold is compared in float64 with f32(t), the value the JAX
    package's float32 comparison uses."""
    return struct.unpack("f", struct.pack("f", t))[0]


def sum_sorted(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in an order that the values alone fix: the
    terms ascending, then added pairwise in halves.  Every device and
    every order of the terms give the same bits, which the closed-form
    eigensolver needs: on a window whose two smallest eigenvalues nearly
    coincide it turns a rounding of its input into an error of about
    eps * kappa**2 in the normal (kappa = ev2 / (ev1 - ev0))."""
    x = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


class PinholeCamera(NamedTuple):
    """Single-focal-length pinhole camera, fx == fy."""

    width: int
    height: int
    focal_length: float
    cx: float
    cy: float

    def intrinsics(self, device: Device = default_device()) -> torch.Tensor:
        f = self.focal_length
        return torch.tensor([[f, 0.0, self.cx], [0.0, f, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)

    def project(self, points_cam: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(uv [..., 2], in_bounds [...]); z == 0 is out of bounds."""
        z = points_cam[..., 2]
        safe_z = _nonzero(z)
        u = self.focal_length * points_cam[..., 0] / safe_z + self.cx
        v = self.focal_length * points_cam[..., 1] / safe_z + self.cy
        in_bounds = ((z != 0) & (u >= 0.0) & (u <= float(self.width))
                     & (v >= 0.0) & (v <= float(self.height)))
        return torch.stack([u, v], dim=-1), in_bounds

    def viewing_rays(self, uv: torch.Tensor) -> torch.Tensor:
        """Unit viewing-ray directions through pixels uv [..., 2]."""
        f = self.focal_length
        x = _div(uv[..., 0] - self.cx, f)
        y = _div(uv[..., 1] - self.cy, f)
        d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return d / norm3(d)[..., None]


class SE3(NamedTuple):
    """Rigid transform x' = R @ x + t."""

    rotation: torch.Tensor  # [..., 3, 3]
    translation: torch.Tensor  # [..., 3]

    @classmethod
    def identity(cls, device: Device = default_device()) -> "SE3":
        return cls(torch.eye(3, device=device),
                   torch.zeros(3, device=device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return points @ self.rotation.transpose(-1, -2) + self.translation

    def inverse(self) -> "SE3":
        rt = self.rotation.transpose(-1, -2)
        return SE3(rt, -(rt @ self.translation[..., None])[..., 0])

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply `other` first."""
        return SE3(self.rotation @ other.rotation,
                   (self.rotation @ other.translation[..., None])[..., 0]
                   + self.translation)


def plane_from_points(p1: torch.Tensor, p2: torch.Tensor, p3: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(unit normal [..., 3], offset [...]) with n·x + offset == 0;
    degenerate triangles give a zero normal."""
    n = cross3(p2 - p1, p3 - p1)
    n = n / _nonzero(norm3(n))[..., None]
    return n, -dot3(n, p1)


def ray_plane_intersection(normal: torch.Tensor, offset: torch.Tensor,
                           origin: torch.Tensor, direction: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(point, depth) of origin + t·direction on n·x + offset = 0; the
    depth is the intersection's z, -inf for a ray parallel to the plane."""
    denom = dot3(normal, direction)
    num = -(dot3(normal, origin) + offset)
    t = num / _nonzero(denom)
    point = origin + t[..., None] * direction
    parallel = denom == 0
    depth = torch.where(parallel, torch.full_like(denom, -math.inf),
                        point[..., 2])
    point = torch.where(parallel[..., None], torch.zeros_like(point), point)
    return point, depth


def point_plane_distance(points: torch.Tensor, coeffs: torch.Tensor
                         ) -> torch.Tensor:
    """|a x + b y + c z + d| / ||(a, b, c)|| for coeffs [..., 4]."""
    n = coeffs[..., :3]
    return (torch.abs(dot3(points, n) + coeffs[..., 3])
            / _nonzero(norm3(n)))


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3], written out in the rule-of-Sarrus
    order that jnp.linalg.det uses for 3x3 inputs."""
    a, b, c = B[..., 0, 0], B[..., 0, 1], B[..., 0, 2]
    d, e, f = B[..., 1, 0], B[..., 1, 1], B[..., 1, 2]
    g, h, i = B[..., 2, 0], B[..., 2, 1], B[..., 2, 2]
    return (a * e * i + b * f * g + c * d * h
            - c * e * g - a * f * h - b * d * i)


def sym3x3_eigenvalues(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric [..., 3, 3] (Smith 1961)."""
    q = _div(A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2], 3.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    sq = (B * B).flatten(-2)
    p2 = sq[..., 0]
    for k in range(1, 9):  # row-major order, as XLA reduces it
        p2 = p2 + sq[..., k]
    p2 = _div(p2, 6.0)
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = _nonzero(p)
    r = torch.clamp(_det3(B) / (2.0 * safe_p ** 3), -1.0, 1.0)
    phi = _div(torch.arccos(r), 3.0)
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    # p == 0: A is q·I, all eigenvalues q.
    return torch.where(p[..., None] == 0, q[..., None], evals)


def _unit_axis(like: torch.Tensor, axis: int) -> torch.Tensor:
    """The unit vector [3] of `axis` in `like`'s dtype, made on its device:
    a tensor built from a Python list, and a scalar assigned to an
    element, would both be copied from the host."""
    return (torch.arange(3, device=like.device) == axis).to(like.dtype)


def _eigenvector_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector for eigenvalue lam via the largest cross product
    of rows of (A - lam I); e_z for fully degenerate input."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                              device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([cross3(r0, r1), cross3(r0, r2), cross3(r1, r2)],
                        dim=-2)  # [..., 3, 3]
    best = torch.argmax(norm3(cands), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 3)
    v = torch.gather(cands, -2, idx)[..., 0, :]
    n = norm3(v)[..., None]
    fallback = _unit_axis(v, 2).expand_as(v)
    return torch.where(n > 1e-20, v / _nonzero(n), fallback)


def _any_orthogonal(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit v."""
    base = torch.where(torch.abs(v[..., 0:1]) < 0.9, _unit_axis(v, 0),
                       _unit_axis(v, 1))
    w = cross3(v, base)
    return w / norm3(w)[..., None]


def sym3x3_eigh(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3] with
    row i the unit vector of eigenvalue i)."""
    evals = sym3x3_eigenvalues(A)
    v_lo = _eigenvector_for(A, evals[..., 0])
    v_hi = _eigenvector_for(A, evals[..., 2])
    # Repeated eigenvalues: re-orthogonalize hi against lo.
    v_hi_orth = v_hi - dot3(v_lo, v_hi)[..., None] * v_lo
    n = norm3(v_hi_orth)[..., None]
    v_hi = torch.where(n > 1e-8, v_hi_orth / _nonzero(n),
                       _any_orthogonal(v_lo))
    v_mid = cross3(v_hi, v_lo)
    return evals, torch.stack([v_lo, v_mid, v_hi], dim=-2)


def smallest_eigenvector_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric A — the
    best-fit plane normal of a scatter matrix."""
    return _eigenvector_for(A, sym3x3_eigenvalues(A)[..., 0])
