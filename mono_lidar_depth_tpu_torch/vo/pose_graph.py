"""Pose-graph optimization, the loop-closure backend (counterpart of
vo/pose_graph.py).

Graph of absolute poses T_i (world<-cam) with relative SE(3) measurements
Z_ij ~ T_i^-1 T_j.  Gauss-Newton on the manifold with right-perturbations
T_i <- T_i exp(xi_i):

  r_e(xi) = log( Z_e^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j)) )

Edge Jacobians come from forward-mode autodiff of the residual at xi = 0
(`torch.func.jvp` along each basis direction, mapped with
`torch.func.vmap`, over all edges at once), and the
sparse normal equations are solved with conjugate gradients whose matvec
is two gathers and two `index_add_` scatters over the edge list.

Chain preconditioner: M = the block-tridiagonal Hessian of the
odometry-chain edges (plus the relative floor on its diagonal).  M^-1 H =
I + R with rank(R) <= 12 C for C closure edges, so PCG converges in
O(C) iterations whatever the trajectory length.  The 6x6-block Thomas
factorization of M is one sequential recurrence of N - 1 dependent steps
per GN iteration (a Python loop of small tensor ops here: it launches
O(N) kernels, and on the card at N = 4541 it is the bulk of a GN
iteration); each application of M^-1 is two affine recurrences, each a
Hillis-Steele scan inside 256-element blocks with a sequential carry
across the blocks.

What differs from the JAX package:

  * `index_add_` on the card sums with atomics in no fixed order: two runs
    on the card can differ in the last bits.  Results are held by
    tolerance.
  * The PCG loop has no device-side `while`: every iteration updates the
    state under a device-side `active` flag, which freezes it once the
    relative residual reaches 1e-4 (the iterate JAX's early exit
    returns), and the host reads the flag every `_CG_CHECK` iterations to
    leave the loop.  So a GN iteration reads the card at most
    ceil(cg_iters / _CG_CHECK) times, and nowhere else.

`group=` (the counterpart of JAX's `axis_name`) makes the edge arrays
this rank's shard of an edge-sharded graph; the poses are the same on
every rank.  Each rank linearizes its own edges, and three per-pose sums
are all-reduced over the group (collectives.py), where JAX psums them:
the gradient b; the CG matvec's scatter, before `+ damping * x` (the
damping term is added once, not once per rank); and the chain blocks D
and B, before the relative floor, whose scale is the mean trace of the
WHOLE D.  Everything after a sum (the preconditioner, the CG state, the
pose update) runs on every rank on the same numbers, so the iterates
never part.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..collectives import all_reduce_sum
from ..core.geometry import _div
from .lie import se3_exp, se3_log
from .linalg6 import inv6_spd

_SCAN_BLOCK = 256
_CG_CHECK = 8  # PCG iterations between two host reads of the exit flag


class PoseGraph(NamedTuple):
    R: torch.Tensor  # [N, 3, 3] world<-cam rotations
    t: torch.Tensor  # [N, 3]
    edge_i: torch.Tensor  # [E] int source pose index
    edge_j: torch.Tensor  # [E] int target pose index
    Z_R: torch.Tensor  # [E, 3, 3] measured relative rotation (i -> j)
    Z_t: torch.Tensor  # [E, 3]
    # [E] scalar information scale (1 = unit), or [E, 6] per-residual-
    # component weights in the se3_log ordering [rho (3), phi (3)].
    edge_weight: torch.Tensor
    edge_valid: torch.Tensor  # [E] bool
    fixed: torch.Tensor  # [N] bool gauge-fixed poses


def _weight6(g: PoseGraph) -> torch.Tensor:
    """Canonicalize edge_weight to [E, 6] per-residual-component form."""
    w = g.edge_weight
    if w.ndim == 2:
        return w
    return w[:, None].expand(w.shape[0], 6)


def _edge_residual(Ri, ti, Rj, tj, ZR, Zt, xi_i, xi_j):
    """r = log(Z^-1 (T_i exp(xi_i))^-1 T_j exp(xi_j)), for one edge or a
    batch of them."""
    dRi, dti = se3_exp(xi_i)
    dRj, dtj = se3_exp(xi_j)
    Ri2 = Ri @ dRi
    ti2 = (Ri @ dti[..., None])[..., 0] + ti
    Rj2 = Rj @ dRj
    tj2 = (Rj @ dtj[..., None])[..., 0] + tj
    # rel = T_i^-1 T_j
    R_rel = Ri2.mT @ Rj2
    t_rel = (Ri2.mT @ (tj2 - ti2)[..., None])[..., 0]
    # err = Z^-1 rel
    R_err = ZR.mT @ R_rel
    t_err = (ZR.mT @ (t_rel - Zt)[..., None])[..., 0]
    return se3_log(R_err, t_err)


def _edge_lin(Ri, ti, Rj, tj, ZR, Zt):
    """Residuals at xi = 0 and Jacobians wrt xi_i, xi_j ([E, 6, 6] each)
    of a batch of edges [E, ...], by forward-mode autodiff: one
    Jacobian-vector product per basis direction, the same direction at
    every edge (an edge's residual depends on its own xi alone), mapped
    over the six directions with `torch.func.vmap`.  (`jacfwd` per edge
    under `vmap` over the edges would make every per-edge scalar 0-dim,
    where the forward rule of `torch.clamp` with Python-float bounds
    promotes the tangent to float64.)"""
    zero = ti.new_zeros((ti.shape[0], 6))
    basis = torch.eye(6, dtype=ti.dtype, device=ti.device)[:, None, :]
    basis = basis.expand(6, ti.shape[0], 6)

    def jac(f):
        cols = torch.func.vmap(
            lambda v: torch.func.jvp(f, (zero,), (v,))[1])(basis)
        return cols.permute(1, 2, 0)  # [6 dirs, E, 6] -> [E, 6, 6 dirs]

    r0 = _edge_residual(Ri, ti, Rj, tj, ZR, Zt, zero, zero)
    Ji = jac(lambda xi: _edge_residual(Ri, ti, Rj, tj, ZR, Zt, xi, zero))
    Jj = jac(lambda xj: _edge_residual(Ri, ti, Rj, tj, ZR, Zt, zero, xj))
    return r0, Ji, Jj


def _affine_combine(e1, e2):
    """Associative combine for affine recurrences c_k = A_k c_{k-1} + b_k
    (element 2 composed after element 1)."""
    A1, b1 = e1
    A2, b2 = e2
    return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2


class _ScanPlan(NamedTuple):
    """What an affine scan needs of its transfer matrices A, computed once
    and applied to many right-hand sides b (every CG iteration applies
    M^-1 with the same A): the multiplier of each Hillis-Steele pass and
    the blocks' prefix products."""

    passes: list  # [(shift, A_k of the pass [..., L, 6, 6])]
    P: torch.Tensor  # [..., L, 6, 6] inclusive products A_k ... A_0
    n: int  # length of the recurrence (before padding to whole blocks)


def _scan_plan(A: torch.Tensor) -> _ScanPlan:
    """The plan of c_k = A_k c_{k-1} + b_k with c_{-1} = 0 over A [N, 6,
    6]; A[0] is ignored (no predecessor).  Up to 256 elements one block,
    else blocks of 256 (the last one padded with zeros)."""
    N = A.shape[0]
    A = torch.cat([torch.zeros_like(A[:1]), A[1:]])
    if N > _SCAN_BLOCK:
        pad = (-N) % _SCAN_BLOCK
        A = torch.cat([A, A.new_zeros((pad, 6, 6))]).reshape(
            -1, _SCAN_BLOCK, 6, 6)
    passes, shift = [], 1
    while shift < A.shape[-3]:
        passes.append((shift, A[..., shift:, :, :]))
        # the A part of `_affine_combine` of elements k - shift and k
        A = torch.cat([A[..., :shift, :, :],
                       A[..., shift:, :, :] @ A[..., :-shift, :, :]], dim=-3)
        shift *= 2
    return _ScanPlan(passes, A, N)


def _scan_apply(plan: _ScanPlan, b: torch.Tensor) -> torch.Tensor:
    """c [N, 6] of the planned recurrence for b [N, 6].  Inside a block:
    the Hillis-Steele passes of `_affine_combine` (b part).  Across
    blocks: every block was scanned from a zero carry, so block n's values
    are c_local + P c_in, c_in the last value of block n - 1, and the
    carries run block by block in order."""
    N = plan.n
    blocked = plan.P.ndim == 4
    if blocked:
        b = torch.cat([b, b.new_zeros((plan.P.shape[0] * _SCAN_BLOCK - N,
                                       6))]).reshape(-1, _SCAN_BLOCK, 6)
    for shift, A_hi in plan.passes:
        b = torch.cat([b[..., :shift, :],
                       (A_hi @ b[..., :-shift, :, None])[..., 0]
                       + b[..., shift:, :]], dim=-2)
    if not blocked:
        return b
    carry = b.new_zeros(6)
    carries = []
    for n in range(b.shape[0]):
        carries.append(carry)
        carry = plan.P[n, -1] @ carry + b[n, -1]
    c = b + (plan.P @ torch.stack(carries)[:, None, :, None])[..., 0]
    return c.reshape(-1, 6)[:N]


def _affine_scan(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c_k = A_k c_{k-1} + b_k with c_{-1} = 0 (A [N, 6, 6], b [N, 6] ->
    c [N, 6]); A[0] is ignored (no predecessor).  Blocked: a log-depth
    Hillis-Steele scan inside each 256-element block, the carry sequential
    across blocks."""
    return _scan_apply(_scan_plan(A), b)


def _inv6_scaled(S: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD [6, 6], Jacobi-scaled and symmetrized in and out
    (see the JAX module: unsymmetrized, the roundoff asymmetry of the
    block-Schur inverse grows through the Riccati recurrence)."""
    S = 0.5 * (S + S.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-20))
    Sn = S / d[:, None] / d[None, :]
    U = inv6_spd(Sn) / d[:, None] / d[None, :]
    return 0.5 * (U + U.T)


def _chain_factor(D: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Block-Thomas forward elimination of the SPD block-tridiagonal
    matrix with diagonal blocks D [N, 6, 6] and super-diagonal blocks B[k]
    = block (k, k+1) (the last entry unused): U_k = S_k^-1 with S_0 = D_0,
    S_k = D_k - B_{k-1}^T U_{k-1} B_{k-1}.  The one sequential recurrence:
    N - 1 dependent steps."""
    Ds, Bs = D.unbind(0), B.unbind(0)
    U = [_inv6_scaled(Ds[0])]
    for k in range(1, len(Ds)):
        U.append(_inv6_scaled(Ds[k] - Bs[k - 1].T @ (U[-1] @ Bs[k - 1])))
    return torch.stack(U)


def _chain_preconditioner(D: torch.Tensor, B: torch.Tensor):
    """Factor the chain matrix (`_chain_factor`) and return `apply(r)`,
    which computes M^-1 r [N, 6] by two affine scans: forward substitution
    c_k = U_k (r_k - B_{k-1}^T c_{k-1}), back substitution x_k = c_k -
    U_k B_k x_{k+1}.  The scans' products of transfer matrices are made
    here, once; an application multiplies vectors only."""
    U = _chain_factor(D, B)
    zero = D.new_zeros((1, 6, 6))
    # forward transfer A_k = -U_k B_{k-1}^T (k >= 1)
    fwd = _scan_plan(torch.cat([zero, -(U[1:] @ B[:-1].mT)]))
    # backward transfer A'_k = -U_k B_k (k <= N-2), reversed
    bwd = _scan_plan(torch.cat([-(U[:-1] @ B[:-1]), zero]).flip(0))

    def apply(r: torch.Tensor) -> torch.Tensor:
        c = _scan_apply(fwd, (U @ r[..., None])[..., 0])
        return _scan_apply(bwd, c.flip(0)).flip(0)

    return apply


class _Linearization(NamedTuple):
    r0: torch.Tensor  # [E, 6] residuals at the current poses
    Ji: torch.Tensor  # [E, 6, 6] Jacobians, zero on fixed poses
    Jj: torch.Tensor  # [E, 6, 6]
    w: torch.Tensor  # [E, 6] robust and component weights, 0 if invalid


def _linearize(g: PoseGraph, it: int, gn_iters: int,
               huber: float) -> _Linearization:
    """Edge residuals, Jacobians and weights of GN iteration `it`."""
    r0, Ji, Jj = _edge_lin(g.R[g.edge_i], g.t[g.edge_i], g.R[g.edge_j],
                           g.t[g.edge_j], g.Z_R, g.Z_t)
    err = torch.linalg.vector_norm(r0, dim=-1)
    # Graduated robustness: the Huber point starts at 2^k x huber and
    # halves each iteration down to `huber` halfway through the run
    # (see the JAX module for why).
    anneal_end = max(1, gn_iters // 2)
    huber_k = huber * max(1.0, 2.0 ** (anneal_end - it))
    w_h = torch.where(err <= huber_k, 1.0,
                      huber_k / torch.clamp(err, min=1e-12))
    w = torch.where(g.edge_valid[:, None], _weight6(g) * w_h[:, None], 0.0)
    free_i = ~g.fixed[g.edge_i]
    free_j = ~g.fixed[g.edge_j]
    return _Linearization(r0, Ji * free_i[:, None, None],
                          Jj * free_j[:, None, None], w)


def _scatter(n: int, lin_i: torch.Tensor, x_i: torch.Tensor,
             lin_j: torch.Tensor, x_j: torch.Tensor) -> torch.Tensor:
    """Per-pose sums of edge terms: x_i added at edge_i, x_j at edge_j."""
    out = x_i.new_zeros((n, *x_i.shape[1:]))
    return out.index_add_(0, lin_i, x_i).index_add_(0, lin_j, x_j)


def _chain_sums(g: PoseGraph, lin: _Linearization):
    """Per-pose sums of the chain edges' (edge_j = edge_i + 1) Hessian
    blocks: D [N, 6, 6] on the diagonal, B [N, 6, 6] above it."""
    N = g.R.shape[0]
    wc = torch.where((g.edge_j == g.edge_i + 1)[:, None], lin.w, 0.0)
    Hii = torch.einsum("eri,er,erj->eij", lin.Ji, wc, lin.Ji)
    Hjj = torch.einsum("eri,er,erj->eij", lin.Jj, wc, lin.Jj)
    Hij = torch.einsum("eri,er,erj->eij", lin.Ji, wc, lin.Jj)
    D = _scatter(N, g.edge_i, Hii, g.edge_j, Hjj)
    B = g.t.new_zeros((N, 6, 6)).index_add_(0, g.edge_i, Hij)
    return D, B


def _chain_blocks(g: PoseGraph, lin: _Linearization, group=None):
    """The preconditioner's blocks from the chain edges alone: D [N, 6, 6]
    with the relative floor on its diagonal (the identity on fixed poses),
    B [N, 6, 6].  With `group` the sums are all-reduced before the floor,
    which is relative to the whole graph's D."""
    D, B = _chain_sums(g, lin)
    if group is not None:
        D, B = all_reduce_sum(group, D, B)
    eye6 = torch.eye(6, dtype=g.t.dtype, device=g.t.device)
    # The relative floor shapes only the preconditioner; the raw damping
    # would underflow the f32 3x3 adjugate determinants.
    diag_scale = _div(torch.diagonal(D, dim1=1, dim2=2).sum(-1).mean(), 6.0)
    floor = 1e-3 * diag_scale + 1e-6
    D = torch.where(g.fixed[:, None, None], eye6, D + floor * eye6)
    return D, B


def _pcg(matvec, apply_Minv, b: torch.Tensor, cg_iters: int):
    """PCG for H dx = -b with the early exit at 1e-4 relative residual.
    Returns (dx, the number of iterations that updated the state as a
    0-dim device tensor)."""
    res0 = -b
    z0 = apply_Minv(res0)
    rr0 = (res0 * res0).sum()
    tol = (1e-4 ** 2) * rr0
    x, r, p = torch.zeros_like(b), res0, z0
    rz, rr = (res0 * z0).sum(), rr0
    active = rr > tol
    iterations = torch.zeros((), dtype=torch.int32, device=b.device)
    for k in range(1, cg_iters + 1):
        Ap = matvec(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        r_new = r - alpha * Ap
        z = apply_Minv(r_new)
        rz_new = (r_new * z).sum()
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, (r_new * r_new).sum(), rr)
        iterations = iterations + active.to(torch.int32)
        active = active & (rr > tol)
        # With an edge-sharded graph every rank must leave the loop at the
        # same read, or one waits in the matvec's all-reduce for a rank
        # that left.  They do: `active` is made from `rr` and `tol`, which
        # come from the all-reduced b and matvec sums through the same
        # replicated arithmetic on every rank, so it has the same bits.
        if k % _CG_CHECK == 0 and k < cg_iters and not bool(active):
            break  # the host read: at most ceil(cg_iters / _CG_CHECK)
    return x, iterations


def _gn_step(g: PoseGraph, it: int, gn_iters: int, cg_iters: int,
             huber: float, damping: float, precondition: bool, group=None):
    """One Gauss-Newton iteration: (updated graph, PCG iterations)."""
    N = g.R.shape[0]
    lin = _linearize(g, it, gn_iters, huber)
    # gradient b = J^T W r, scattered per pose
    wr = lin.w * lin.r0
    b = _scatter(N, g.edge_i, torch.einsum("eri,er->ei", lin.Ji, wr),
                 g.edge_j, torch.einsum("eri,er->ei", lin.Jj, wr))
    if group is not None:
        b, = all_reduce_sum(group, b)

    def matvec(x):  # H x with H = J^T w J + damping I
        Ax = (torch.einsum("erc,ec->er", lin.Ji, x[g.edge_i])
              + torch.einsum("erc,ec->er", lin.Jj, x[g.edge_j]))
        wAx = lin.w * Ax
        y = _scatter(N, g.edge_i, torch.einsum("eri,er->ei", lin.Ji, wAx),
                     g.edge_j, torch.einsum("eri,er->ei", lin.Jj, wAx))
        if group is not None:
            y, = all_reduce_sum(group, y)
        return y + damping * x

    if precondition:
        apply_Minv = _chain_preconditioner(*_chain_blocks(g, lin, group))
    else:
        def apply_Minv(r):
            return r

    dx, iterations = _pcg(matvec, apply_Minv, b, cg_iters)
    dx = torch.where(g.fixed[:, None], 0.0, dx)
    dR, dt = se3_exp(dx)
    R_new = g.R @ dR  # right perturbation
    t_new = (g.R @ dt[..., None])[..., 0] + g.t
    return g._replace(R=R_new, t=t_new), iterations


def optimize_pose_graph(graph: PoseGraph, gn_iters: int = 8,
                        cg_iters: int = 200, huber: float = 0.5,
                        damping: float = 1e-6,
                        precondition: bool = True, group=None) -> PoseGraph:
    """Run Gauss-Newton with (preconditioned) CG inner solves; returns the
    updated graph.

    With `precondition` (default) the CG is preconditioned with the
    block-tridiagonal chain Hessian: convergence takes O(closure-count)
    iterations independent of N, and the solve exits early at a 1e-4
    relative residual, so `cg_iters` is a cap, not a cost.
    `precondition=False` runs plain CG.  With `group` the edge arrays are
    this rank's shard of an edge-sharded graph (module docstring)."""
    for it in range(gn_iters):
        graph, _ = _gn_step(graph, it, gn_iters, cg_iters, huber, damping,
                            precondition, group)
    return graph


def graph_cost(graph: PoseGraph) -> torch.Tensor:
    """Sum over valid edges of the component-weighted squared residual."""
    zero = graph.t.new_zeros((graph.edge_i.shape[0], 6))
    r = _edge_residual(graph.R[graph.edge_i], graph.t[graph.edge_i],
                       graph.R[graph.edge_j], graph.t[graph.edge_j],
                       graph.Z_R, graph.Z_t, zero, zero)
    return torch.where(graph.edge_valid,
                       (r * r * _weight6(graph)).sum(-1), 0.0).sum()


def sequential_edges(R: torch.Tensor, t: torch.Tensor,
                     noise_free: bool = True):
    """Odometry-chain measurements from a pose sequence (helper for
    building graphs from VO output): (i, j, Z_R, Z_t)."""
    N = R.shape[0]
    i = torch.arange(N - 1, dtype=torch.int32, device=R.device)
    j = i + 1
    Ri, Rj = R[:-1], R[1:]
    ti, tj = t[:-1], t[1:]
    Z_R = torch.einsum("nij,nik->njk", Ri, Rj)  # Ri^T Rj
    Z_t = torch.einsum("nij,ni->nj", Ri, tj - ti)  # Ri^T (tj - ti)
    return i, j, Z_R, Z_t
