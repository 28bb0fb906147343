"""Sliding-window bundle adjustment with depth priors, Schur form
(counterpart of vo/ba.py, single device).

The observation set is a dense [K, L] grid (K window frames x L
landmark slots) with a mask; every per-landmark tensor keeps L as the
last axis.  One damped GN iteration: residuals and Jacobians, Hessian
blocks, landmark elimination with closed-form 3x3 inverses, the
[6K, 6K] reduced camera system solved in fp32, landmark back-
substitution.  The contractions are fp32 einsums (TF32 off,
precision.py): the Schur complement S = Hpp - W Hplᵀ cancels strongly
and needs full fp32.

`group=` (the counterpart of JAX's `axis_name`) makes the landmark
dimension this rank's shard of a landmark-sharded problem (every
per-landmark tensor holds this rank's landmarks, the poses are the same
on every rank).  `ba_iteration` then assembles the blocks of its own
landmarks, eliminates them, and sums the pose-side terms over the group's
ranks: Hpp, the Schur cross term S_cross, bp and the reduced landmark
gradient b_red_lm, in one all-reduce (collectives.py), at the point where
JAX psums them.  That is before the Marquardt damping of Hpp, which is
relative to Hpp's trace and so must see the whole sum.  The [6K, 6K]
solve and the pose update then run on every rank on the same numbers;
the landmark back-substitution stays local.  `ba_cost` sums its total
over the group.  Communication is O(K^2) per iteration, whatever L.

On a card `run_ba` replays a CUDA graph of `_run_ba_eager`
(`vo/graphed.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..collectives import all_reduce_sum
from ..core.geometry import PinholeCamera, _div
from .graphed import Graphed
from .lie import se3_exp


class BAProblem(NamedTuple):
    R: torch.Tensor  # [K, 3, 3] camera-from-world rotations
    t: torch.Tensor  # [K, 3]
    landmarks: torch.Tensor  # [L, 3] world points
    obs_uv: torch.Tensor  # [K, L, 2]
    obs_mask: torch.Tensor  # [K, L]
    depth_prior: torch.Tensor  # [K, L]
    depth_mask: torch.Tensor  # [K, L]
    fixed: torch.Tensor  # [K] gauge-fixed poses
    lm_valid: torch.Tensor  # [L]


class BAResult(NamedTuple):
    problem: BAProblem
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _residuals_lanes(camera: PinholeCamera, pb: BAProblem,
                     min_depth: float = 0.25):
    """(r [K,2,L], p [K,3,L], inv_z, active, r_d, active_d)."""
    p = torch.einsum("kij,jl->kil", pb.R, pb.landmarks.T) + pb.t[:, :, None]
    z = p[:, 2]
    behind = z <= min_depth
    inv_z = 1.0 / torch.clamp(z, min=min_depth)
    f = camera.focal_length
    u = f * p[:, 0] * inv_z + camera.cx
    v = f * p[:, 1] * inv_z + camera.cy
    r = torch.stack([u, v], dim=1) - pb.obs_uv.transpose(1, 2)
    active = pb.obs_mask & pb.lm_valid[None, :] & ~behind
    r_d = z - pb.depth_prior
    active_d = (pb.depth_mask & pb.obs_mask & pb.lm_valid[None, :]
                & (z > min_depth) & (pb.depth_prior > 0))
    return r, p, inv_z, active, r_d, active_d


def _jacobians_lanes(camera: PinholeCamera, pb: BAProblem, p, inv_z):
    """Jpose [K,2,6,L], Jlm [K,2,3,L], Jpose_d [K,6,L], Jlm_d [K,3,L]."""
    f = camera.focal_length
    x, y = p[:, 0], p[:, 1]
    xiz, yiz = x * inv_z, y * inv_z
    fiz = f * inv_z
    zero = torch.zeros_like(fiz)
    Ju = torch.stack([fiz, zero, -fiz * xiz, -f * xiz * yiz,
                      f * (1.0 + xiz * xiz), -f * yiz], dim=1)
    Jv = torch.stack([zero, fiz, -fiz * yiz, -f * (1.0 + yiz * yiz),
                      f * xiz * yiz, f * xiz], dim=1)
    Jpose = torch.stack([Ju, Jv], dim=1)
    Jp = torch.stack([torch.stack([fiz, zero, -fiz * xiz], dim=1),
                      torch.stack([zero, fiz, -fiz * yiz], dim=1)], dim=1)
    Jlm = torch.einsum("kril,kij->krjl", Jp, pb.R)
    one = torch.ones_like(x)
    Jpose_d = torch.stack([zero, zero, one, y, -x, zero], dim=1)
    Jlm_d = pb.R[:, 2, :, None] * one[:, None, :]
    return Jpose, Jlm, Jpose_d, Jlm_d


def _inv3x3_lanes(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [3, 3, L] matrices (adjugate / det)."""
    a, b, c = H[0, 0], H[0, 1], H[0, 2]
    d, e, f_ = H[1, 0], H[1, 1], H[1, 2]
    g, h, i = H[2, 0], H[2, 1], H[2, 2]
    A = e * i - f_ * h
    B = -(d * i - f_ * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f_ - c * e]),
        torch.stack([B, a * i - c * g, -(a * f_ - c * d)]),
        torch.stack([C, -(a * h - b * g), a * e - b * d]),
    ])
    return adj * (1.0 / det)


def _huber_w(err, delta):
    return torch.where(err <= delta, 1.0, delta / torch.clamp(err, min=1e-9))


def ba_cost(camera: PinholeCamera, pb: BAProblem, huber_px: float = 2.0,
            depth_weight: float = 1.0, huber_depth: float = 0.5,
            group=None) -> torch.Tensor:
    """The robust cost; with `group`, summed over the group's landmark
    shards."""
    r, _, _, active, r_d, active_d = _residuals_lanes(camera, pb)
    err = torch.sqrt((r * r).sum(1) + 1e-18)
    he = torch.clamp(err, max=huber_px)
    c = torch.where(active, he * (err - 0.5 * he), 0.0).sum()
    ed = torch.abs(r_d)
    hd = torch.clamp(ed, max=huber_depth)
    c_d = torch.where(active_d, depth_weight * hd * (ed - 0.5 * hd),
                      0.0).sum()
    if group is not None:
        return all_reduce_sum(group, c + c_d)[0]
    return c + c_d


def ba_iteration(camera: PinholeCamera, pb: BAProblem, huber_px: float,
                 depth_weight: float, huber_depth: float,
                 damping: float, group=None) -> BAProblem:
    """One damped Gauss-Newton iteration; with `group`, over this rank's
    landmark shard (module docstring)."""
    K = pb.R.shape[0]
    dev = pb.R.device
    r, p, inv_z, active, r_d, active_d = _residuals_lanes(camera, pb)
    Jpose, Jlm, Jpose_d, Jlm_d = _jacobians_lanes(camera, pb, p, inv_z)

    err = torch.sqrt((r * r).sum(1) + 1e-18)  # [K, L]
    w = torch.where(active, _huber_w(err, huber_px), 0.0)
    w_d = torch.where(active_d,
                      depth_weight * _huber_w(torch.abs(r_d), huber_depth),
                      0.0)

    Jpw = Jpose * w[:, None, None, :]
    Jlw = Jlm * w[:, None, None, :]
    Jpdw = Jpose_d * w_d[:, None, :]
    Jldw = Jlm_d * w_d[:, None, :]

    Hpp = (torch.einsum("kril,krjl->kij", Jpw, Jpose)
           + torch.einsum("kil,kjl->kij", Jpdw, Jpose_d))  # [K, 6, 6]
    Hll = (torch.einsum("kril,krjl->ijl", Jlw, Jlm)
           + torch.einsum("kil,kjl->ijl", Jldw, Jlm_d))  # [3, 3, L]
    Hpl = (torch.einsum("kril,krjl->kijl", Jpw, Jlm)
           + Jpdw[:, :, None, :] * Jlm_d[:, None, :, :])  # [K, 6, 3, L]
    bp = (torch.einsum("kril,krl->ki", Jpw, r)
          + torch.einsum("kil,kl->ki", Jpdw, r_d))  # [K, 6]
    bl = (torch.einsum("kril,krl->il", Jlw, r)
          + torch.einsum("kil,kl->il", Jldw, r_d))  # [3, L]

    # Relative (Marquardt) damping bounds each 3x3 block's condition.
    obs_cnt = w.sum(0) + w_d.sum(0)
    lm_free = (obs_cnt > 0) & pb.lm_valid
    tr_l = _div(Hll[0, 0] + Hll[1, 1] + Hll[2, 2], 3.0)
    lam = damping * torch.clamp(tr_l, min=1.0) + 1e-8
    eye3 = torch.eye(3, device=dev)[:, :, None]
    Hll = torch.where(lm_free[None, None, :], Hll + lam * eye3, eye3)
    bl = torch.where(lm_free[None, :], bl, 0.0)

    Hll_inv = _inv3x3_lanes(Hll)  # [3, 3, L]
    W = torch.einsum("kiml,mjl->kijl", Hpl, Hll_inv)  # [K, 6, 3, L]

    S_cross = torch.einsum("aiml,bjml->abij", W, Hpl)  # [K, K, 6, 6]
    b_red_lm = torch.einsum("kiml,ml->ki", W, bl)  # [K, 6]
    if group is not None:
        Hpp, S_cross, bp, b_red_lm = all_reduce_sum(group, Hpp, S_cross, bp,
                                                    b_red_lm)

    tr_p = _div(torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1), 6.0)
    eye6 = torch.eye(6, device=dev)
    Hpp = Hpp + (damping * torch.clamp(tr_p, min=1.0))[:, None, None] * eye6
    kk = torch.arange(K, device=dev)
    S = -S_cross
    S[kk, kk] += Hpp
    b_red = bp - b_red_lm

    # Gauge: fixed poses get identity rows/cols and zero gradient.
    fix = pb.fixed
    S = torch.where(fix[:, None, None, None] | fix[None, :, None, None],
                    0.0, S)
    S[kk, kk] += torch.where(fix[:, None, None], eye6, 0.0)
    b_red = torch.where(fix[:, None], 0.0, b_red)

    Sd = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    # solve_ex: no singularity check, so no host sync (a singular system
    # gives non-finite steps, as jnp.linalg.solve does).
    dxi = -torch.linalg.solve_ex(Sd, b_red.reshape(-1))[0].reshape(K, 6)
    dxi = torch.where(fix[:, None], 0.0, dxi)

    rhs = -bl - torch.einsum("kiml,ki->ml", Hpl, dxi)  # [3, L]
    dl = torch.einsum("iml,ml->il", Hll_inv, rhs)
    dl = torch.where(lm_free[None, :], dl, 0.0)

    dR, dt = se3_exp(dxi)
    return pb._replace(R=dR @ pb.R,
                       t=torch.einsum("kij,kj->ki", dR, pb.t) + dt,
                       landmarks=pb.landmarks + dl.T)


def _run_ba_eager(camera: PinholeCamera, problem: BAProblem, iters: int = 8,
                  huber_px: float = 2.0, depth_weight: float = 1.0,
                  huber_depth: float = 0.5, damping: float = 1e-4,
                  compute_cost: bool = True) -> BAResult:
    """`run_ba`'s body, run eagerly."""
    zero = torch.zeros((), device=problem.R.device)
    c0 = (ba_cost(camera, problem, huber_px, depth_weight, huber_depth)
          if compute_cost else zero)
    out = problem
    for _ in range(iters):
        out = ba_iteration(camera, out, huber_px, depth_weight, huber_depth,
                           damping)
    c1 = (ba_cost(camera, out, huber_px, depth_weight, huber_depth)
          if compute_cost else zero)
    return BAResult(problem=out, initial_cost=c0, final_cost=c1)


_GRAPHS = Graphed(_run_ba_eager, "vo.ba.replay")


def run_ba(camera: PinholeCamera, problem: BAProblem, iters: int = 8,
           huber_px: float = 2.0, depth_weight: float = 1.0,
           huber_depth: float = 0.5, damping: float = 1e-4,
           compute_cost: bool = True) -> BAResult:
    """`iters` damped GN iterations; `compute_cost=False` skips the two
    diagnostic cost passes.

    On the current card the call replays the CUDA graph of its signature
    (span `vo.ba.replay`), captured on its first call, which runs eagerly;
    elsewhere it runs `_run_ba_eager` (`vo/graphed.py`)."""
    return _GRAPHS(camera, problem, iters, huber_px, depth_weight,
                   huber_depth, damping, compute_cost)
