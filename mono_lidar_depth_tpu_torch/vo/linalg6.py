"""Closed-form small-system solvers (counterpart of vo/linalg6.py).

A symmetric positive-definite 6x6 system splits into 3x3 blocks and is
solved with two adjugate 3x3 inverses and a Schur complement: no LAPACK
or cuSOLVER call, all products in fp32 (TF32 off, precision.py).
"""

from __future__ import annotations

import torch


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a single 3x3 (adjugate / determinant)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e]),
        torch.stack([B, a * i - c * g, -(a * f - c * d)]),
        torch.stack([C, -(a * h - b * g), a * e - b * d]),
    ])
    return adj * (1.0 / det)


def inv6_spd(H: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD [6, 6] by the same 3x3 block Schur structure."""
    A, B, C = H[:3, :3], H[:3, 3:], H[3:, 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    Mi = inv3(C - B.T @ AiB)
    AiBMi = AiB @ Mi
    top = torch.cat([Ai + AiBMi @ AiB.T, -AiBMi], dim=1)
    bottom = torch.cat([-AiBMi.T, Mi], dim=1)
    return torch.cat([top, bottom], dim=0)


def solve6_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD H [6, 6] via the 3x3 block Schur complement."""
    A, B, C = H[:3, :3], H[:3, 3:], H[3:, 3:]
    g1, g2 = g[:3], g[3:]
    Ai = inv3(A)
    AiB = Ai @ B
    Mi = inv3(C - B.T @ AiB)
    Aig1 = Ai @ g1
    x2 = Mi @ (g2 - B.T @ Aig1)
    x1 = Aig1 - AiB @ x2
    return torch.cat([x1, x2])
