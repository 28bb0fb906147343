"""SO(3)/SE(3) exponential and logarithm maps, batched (counterpart of
vo/lie.py).  Closed-form Rodrigues / V-matrix formulas with series
branches near theta = 0; se3 vectors are [rho (3), phi (3)].
"""

from __future__ import annotations

import torch

from ..core.geometry import norm3

_SMALL = 1e-10


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)


def _theta_terms(phi: torch.Tensor):
    """(th2, th2_safe, theta_safe, small), each [..., 1, 1]."""
    th2 = (phi * phi).sum(-1)[..., None, None]
    small = th2 < _SMALL
    th2_safe = torch.where(small, 1.0, th2)
    return th2, th2_safe, torch.sqrt(th2_safe), small


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    th2, th2_safe, theta, small = _theta_terms(phi)
    K = hat(phi)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / th2_safe)
    return _eye_like(K) + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (|phi| <= pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos > 1.0 - 1e-8
    near_pi = cos < -1.0 + 1e-6
    theta_int = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    sin_int = torch.sin(theta_int)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(small, 0.5 + (1.0 - cos) / 6.0,
                        theta_int / (2.0 * sin_int))
    out = scale[..., None] * w

    # Near pi: axis from the symmetric part, signs fixed against the
    # largest component (see the JAX module).
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    mag = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=1e-12))
    sym01 = R[..., 0, 1] + R[..., 1, 0]
    sym02 = R[..., 0, 2] + R[..., 2, 0]
    sym12 = R[..., 1, 2] + R[..., 2, 1]
    zeros = torch.zeros_like(sym01)
    prods = torch.stack([
        torch.stack([zeros, sym01, sym02], dim=-1),
        torch.stack([sym01, zeros, sym12], dim=-1),
        torch.stack([sym02, sym12, zeros], dim=-1),
    ], dim=-2)
    k = torch.argmax(mag, dim=-1)
    row = torch.gather(prods, -2, k[..., None, None].expand(
        *k.shape, 1, 3))[..., 0, :]
    jidx = torch.arange(3, device=R.device)
    sign = torch.where(jidx == k[..., None], 1.0,
                       torch.where(row >= 0, 1.0, -1.0))
    axis = mag * sign
    norm = norm3(axis)[..., None]
    axis = axis / torch.where(norm == 0, 1.0, norm)
    return torch.where(near_pi[..., None], axis * theta_int[..., None], out)


def _V(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3)."""
    th2, th2_safe, theta, small = _theta_terms(phi)
    K = hat(phi)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / th2_safe)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta)) / (th2_safe * theta))
    return _eye_like(K) + b * K + c * (K @ K)


def _V_inv(phi: torch.Tensor) -> torch.Tensor:
    th2, th2_safe, theta, small = _theta_terms(phi)
    K = hat(phi)
    half = theta * 0.5
    sin_half = torch.where(small, 1.0, torch.sin(half))
    cot_term = (1.0 - half * torch.cos(half) / sin_half) / th2_safe
    coef = torch.where(small, 1.0 / 12.0 + th2 / 720.0, cot_term)
    return _eye_like(K) - 0.5 * K + coef * (K @ K)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 6] (rho, phi) -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), (_V(phi) @ rho[..., None])[..., 0]


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] (rho, phi)."""
    phi = so3_log(R)
    rho = (_V_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)
