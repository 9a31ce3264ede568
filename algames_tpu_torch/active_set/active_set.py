"""Equilibrium-subspace analysis: the active-set extended KKT system and
its nullspace (counterpart of ``algames_tpu/active_set/active_set.py``).

The KKT system is extended with one scalar row per unordered colliding
player pair per knot (the shared constraint value) and one scalar column
per ordered pair per knot (each player's own multiplier on it):

  Sv = S + (N-1) p(p-1)/2    rows
  Sh = S + (N-1) p(p-1)      columns

appended knot-major, pair-minor in lexicographic order.  The nullspace of
the extended Jacobian restricted to the active rows and columns is a basis
for the manifold of nearby generalized Nash equilibria.

Two forms:

* host-driven, one scenario (``active_masks``, ``update_nullspace``): the
  active rows and columns are gathered, and an SVD of that submatrix gives
  the basis, as the reference does;
* fixed-shape, batch-first over lanes (``extended_jacobian_knotrows``,
  ``pair_active_flags``, ``update_nullspace_masked``): inactive appended
  rows are zeroed and a pinning row per inactive appended column is added,
  so that one batched SVD of a fixed-shape matrix per lane gives the same
  kernel, flagged by a mask.

``extended_residual`` and ``extended_jacobian`` are batch-first too (rows
in the reference's order, :func:`~..problem.residual.flatten_residual`).
Ranks count the singular values above ``atol`` (1e-10 by default).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..constraints import sets as gcm
from ..constraints.kernels import CollisionParams
from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual
from ..problem import residual as R
from ..problem.linear_solver import dense_from_tridiagonal
from ..problem.problem import GameProblem


def unordered_pairs(p: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(p) for j in range(i + 1, p)]


def ordered_pairs(p: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(p) for j in range(p) if j != i]


def sizes(spec: ProblemSpec) -> Tuple[int, int]:
    """(Sv, Sh) of the extended system."""
    p, T = spec.p, spec.T
    return spec.S + T * (p * (p - 1)) // 2, spec.S + T * p * (p - 1)


def vrow(spec: ProblemSpec, i: int, j: int, k: int) -> int:
    """Appended row of the unordered pair i < j at knot k (1..N-1)."""
    if not (i < j and 1 <= k <= spec.T):
        raise ValueError(f"no appended row for ({i}, {j}) at knot {k}")
    pairs = unordered_pairs(spec.p)
    return spec.S + (k - 1) * len(pairs) + pairs.index((i, j))


def hcol(spec: ProblemSpec, i: int, j: int, k: int) -> int:
    """Appended column of the ordered pair (i, j) at knot k (1..N-1)."""
    if not (i != j and 1 <= k <= spec.T):
        raise ValueError(f"no appended column for ({i}, {j}) at knot {k}")
    pairs = ordered_pairs(spec.p)
    return spec.S + (k - 1) * len(pairs) + pairs.index((i, j))


def get_collision_block(gc: gcm.GameConstraints, spec: ProblemSpec, i: int,
                        j: int):
    """Player i's collision block against player j, planar (``pxj`` =
    ``px[j]``) or spherical (``pxj`` = ``pz[j][:3]``); None if there is
    none."""
    j_pos = {tuple(spec.px[j]), tuple(spec.pz[j][:3])}
    for blk in gc.state_blocks:
        if (isinstance(blk.params, CollisionParams) and blk.owner == i
                and tuple(blk.params.pxj) in j_pos):
            return blk
    return None


def lane_slice(gc: gcm.GameConstraints, lane: int) -> gcm.GameConstraints:
    """``gc`` with its per-lane [B, K, C] leaves cut to lane ``lane`` (a
    batch of one, e.g. one scenario of a batched solve's result);
    unbatched [K, C] leaves are kept."""
    def cut(a):
        return a[lane:lane + 1] if a.dim() == 3 else a
    return gcm.map_blocks(gc, lambda b: dataclasses.replace(
        b, lam=cut(b.lam), mu=cut(b.mu), active=cut(b.active)))


def active(gc: gcm.GameConstraints, spec: ProblemSpec, i: int, j: int,
           k: int, lane: int = 0) -> bool:
    """Active flag of the (i, j) collision row at knot k (1..N-1), on lane
    ``lane`` of per-lane flags; False where the pair has no block."""
    blk = get_collision_block(gc, spec, i, j)
    if blk is None:
        return False
    a = blk.active if blk.active.dim() == 2 else blk.active[lane]
    return bool(a[k - 1, 0])


def _with_gc(prob: GameProblem, gc) -> GameProblem:
    return dataclasses.replace(prob, gc=gc)


def extended_residual(prob: GameProblem, traj: PrimalDual,
                      lam_col: torch.Tensor | None = None) -> torch.Tensor:
    """[B, Sv]: the flat residual (reference row order) followed by the
    collision values of the unordered pairs.  ``lam_col`` [B, T, p(p-1)]:
    the appended duals (``ordered_pairs`` order), whose terms
    grad(c)^T lam_col enter player i's statx rows; at lam_col = 0 (or
    None) the Jacobian of this function is :func:`extended_jacobian`."""
    spec = prob.spec
    Sv, _ = sizes(spec)
    base = R.residual(prob.model, spec, prob.obj, prob.gc, traj)
    if lam_col is not None:
        rx = base.rx.clone()
        for q, (i, j) in enumerate(ordered_pairs(spec.p)):
            blk = get_collision_block(prob.gc, spec, i, j)
            if blk is not None:
                rx[:, :, i] += (gcm.block_jacobian(blk, traj)[:, :, 0]
                                * lam_col[:, :, q, None])
        base = dataclasses.replace(base, rx=rx)
    out = traj.x.new_zeros((traj.x.shape[0], Sv))
    out[:, :spec.S] = R.flatten_residual(spec, base)
    for i, j in unordered_pairs(spec.p):
        blk = get_collision_block(prob.gc, spec, i, j)
        if blk is not None:
            rows = [vrow(spec, i, j, k) for k in range(1, spec.T + 1)]
            out[:, rows] += gcm.block_values(blk, traj)[:, :, 0]
    return out


def extended_jacobian(prob: GameProblem, traj: PrimalDual) -> torch.Tensor:
    """[B, Sv, Sh] dense extended Jacobian: the flat Jacobian, then per
    ordered pair (i, j) and knot k the collision gradient in player i's
    statx rows of column ``hcol``, and per unordered pair in row ``vrow``
    at the x columns of the knot."""
    spec = prob.spec
    Sv, Sh = sizes(spec)
    n = spec.n
    jb = R.jacobian_blocks(prob.model, spec, prob.obj, prob.gc, traj)
    J = traj.x.new_zeros((traj.x.shape[0], Sv, Sh))
    J[:, :spec.S, :spec.S] = R.flatten_jacobian(spec, jb)
    for i, j in ordered_pairs(spec.p):
        blk = get_collision_block(prob.gc, spec, i, j)
        if blk is None:
            continue
        jac = gcm.block_jacobian(blk, traj)[:, :, 0]            # [B, T, n]
        for k in range(1, spec.T + 1):
            r0 = spec.row_stat_x(i, k - 1)
            J[:, r0:r0 + n, hcol(spec, i, j, k)] += jac[:, k - 1]
            if i < j:
                c0 = spec.col_x(k - 1)
                J[:, vrow(spec, i, j, k), c0:c0 + n] += jac[:, k - 1]
    return J


def _pair_jacobians(prob: GameProblem, traj: PrimalDual, pairs):
    """Collision gradients [B, T, n] per pair (zeros without a block)."""
    spec = prob.spec
    out = []
    for i, j in pairs:
        blk = get_collision_block(prob.gc, spec, i, j)
        out.append(traj.x.new_zeros((traj.x.shape[0], spec.T, spec.n))
                   if blk is None else gcm.block_jacobian(blk, traj)[:, :, 0])
    return out


def extended_jacobian_knotrows(prob: GameProblem, traj: PrimalDual,
                               jb=None) -> torch.Tensor:
    """[B, Sv, Sh] extended Jacobian with the base rows in per-knot
    equation order (statx | statu | dyn per knot) instead of the
    reference's: a row permutation of :func:`extended_jacobian`, assembled
    from ``build_tridiagonal``'s blocks.  Appended rows and columns are
    those of :func:`extended_jacobian`."""
    spec = prob.spec
    T, W, n = spec.T, spec.W, spec.n
    Bsz = traj.x.shape[0]
    if jb is None:
        jb = R.jacobian_blocks(prob.model, spec, prob.obj, prob.gc, traj)
    D, U, L = R.build_tridiagonal(spec, jb)
    Sv, Sh = sizes(spec)
    S = spec.S
    J = dense_from_tridiagonal(spec, D, U, L,
                               out=traj.x.new_zeros((Bsz, Sv, Sh)))
    # Appended columns: ordered pair (i, j) at knot k couples player i's
    # statx rows of knot block k-1; appended rows read its x columns.
    opairs, upairs = ordered_pairs(spec.p), unordered_pairs(spec.p)
    nop, nup = len(opairs), len(upairs)
    cols = J[:, :S, S:].view(Bsz, T, W, T, nop)
    for q, ((i, _), jac) in enumerate(zip(opairs, _pair_jacobians(
            prob, traj, opairs))):
        for t in range(T):
            cols[:, t, i * n:(i + 1) * n, t, q] = jac[:, t]
    rows = J[:, S:, :S].view(Bsz, T, nup, T, W)
    for q, jac in enumerate(_pair_jacobians(prob, traj, upairs)):
        for t in range(T):
            rows[:, t, q, t, :n] = jac[:, t]
    return J


def active_masks(prob: GameProblem, gc: gcm.GameConstraints, lane: int = 0):
    """(vmask, hmask) of lane ``lane``: the indices 0..S-1 plus the
    appended rows / columns whose collision row is active, sorted."""
    spec = prob.spec
    vmask, hmask = list(range(spec.S)), list(range(spec.S))
    for k in range(1, spec.T + 1):
        for i, j in unordered_pairs(spec.p):
            if active(gc, spec, i, j, k, lane):
                vmask.append(vrow(spec, i, j, k))
        for i, j in ordered_pairs(spec.p):
            if active(gc, spec, i, j, k, lane):
                hmask.append(hcol(spec, i, j, k))
    return np.asarray(sorted(vmask)), np.asarray(sorted(hmask))


@dataclasses.dataclass
class NullSpace:
    """Nullspace basis of one scenario's active extended Jacobian: the
    columns of ``mat`` span the kernel of the active submatrix; ``vec``
    are their full-Sh embeddings, each row divided by its mean absolute
    value, split into the trajectory part ``dtraj`` and the collision-dual
    part ``dlam``."""
    mat: torch.Tensor     # [len(hmask), dim]
    vec: torch.Tensor     # [dim, Sh]
    dtraj: torch.Tensor   # [dim, S]
    dlam: torch.Tensor    # [dim, Sh - S]


def nullspace_basis(M: torch.Tensor, atol: float = 1e-10) -> torch.Tensor:
    """Kernel basis of M [r, c] by SVD: rank = #{s > atol}; the remaining
    right singular vectors (those beyond min(r, c) included)."""
    _, s, Vh = torch.linalg.svd(M, full_matrices=True)
    rank = int((s > atol).sum())
    return Vh[rank:].transpose(0, 1)


def update_nullspace(prob: GameProblem, traj: PrimalDual,
                     atol: float = 1e-10, lane: int = 0) -> NullSpace:
    """Lane ``lane``'s nullspace: refresh the active set at its point, gather
    the active rows and columns of its extended Jacobian, SVD."""
    spec = prob.spec
    _, Sh = sizes(spec)
    one = PrimalDual(x=traj.x[lane:lane + 1], u=traj.u[lane:lane + 1],
                     lam=traj.lam[lane:lane + 1])
    gc = gcm.update_active_set(lane_slice(prob.gc, lane), one)
    vmask, hmask = active_masks(prob, gc)
    J = extended_jacobian(_with_gc(prob, gc), one)[0]
    mat = nullspace_basis(J[vmask][:, hmask], atol)
    vec = J.new_zeros((mat.shape[1], Sh))
    vec[:, hmask] = mat.transpose(0, 1)
    norm = vec.abs().mean(dim=1, keepdim=True)
    vec = vec / torch.where(norm > 0, norm, torch.ones_like(norm))
    return NullSpace(mat=mat, vec=vec, dtraj=vec[:, :spec.S],
                     dlam=vec[:, spec.S:])


def pair_active_flags(gc: gcm.GameConstraints, spec: ProblemSpec):
    """Active flags of the appended rows and columns in ``vrow`` / ``hcol``
    order: (v [..., Sv - S], h [..., Sh - S]) bool, per lane where the
    flags are; a pair without a block reads inactive."""
    def flag(i, j):
        blk = get_collision_block(gc, spec, i, j)
        if blk is None:
            return torch.zeros((spec.T,), dtype=torch.bool,
                               device=gc.alpha_dual.device)
        return blk.active[..., 0]

    def stack(pairs):
        f = torch.broadcast_tensors(*[flag(i, j) for i, j in pairs])
        return torch.stack(f, dim=-1).flatten(-2)
    return stack(unordered_pairs(spec.p)), stack(ordered_pairs(spec.p))


@dataclasses.dataclass
class NullSpaceMasked:
    """Fixed-shape nullspace per lane: ``vec`` [B, Sh, Sh] holds every
    right singular vector (SVD order, the kernel last), ``mask`` [B, Sh]
    flags those spanning the kernel (each divided by its mean absolute
    value), ``dim`` [B] counts them, ``svals`` [B, Sh]."""
    vec: torch.Tensor
    mask: torch.Tensor
    dim: torch.Tensor
    svals: torch.Tensor


def update_nullspace_masked(prob: GameProblem, traj: PrimalDual,
                            atol: float = 1e-10) -> NullSpaceMasked:
    """The nullspace of every lane as one fixed-shape batched SVD: the
    extended Jacobian with inactive appended rows zeroed, and one pinning
    row e_c scaled by 1 - active(c) per appended column c (an inactive
    column's component is forced to zero, an active one stays free).  Its
    kernel is the active submatrix's embedded in Sh: the same dimension and
    span as :func:`update_nullspace`."""
    spec = prob.spec
    S = spec.S
    _, Sh = sizes(spec)
    Bsz = traj.x.shape[0]
    gc = gcm.update_active_set(prob.gc, traj)
    J = extended_jacobian_knotrows(_with_gc(prob, gc), traj)
    v_flags, h_flags = pair_active_flags(gc, spec)
    dtype = J.dtype
    v_flags = v_flags.to(dtype).expand(Bsz, v_flags.shape[-1])
    h_flags = h_flags.to(dtype).expand(Bsz, Sh - S)
    J[:, S:] *= v_flags[:, :, None]
    pin = torch.diag_embed(1.0 - h_flags)                  # [B, Sh-S, Sh-S]
    pin = torch.cat([J.new_zeros((Bsz, Sh - S, S)), pin], dim=2)
    M = torch.cat([J, pin], dim=1)                          # [B, Sv+Sh-S, Sh]
    _, s, Vh = torch.linalg.svd(M, full_matrices=False)
    mask = s <= atol
    norm = Vh.abs().mean(dim=2, keepdim=True)
    norm = torch.where((norm > 0) & mask[..., None], norm,
                       torch.ones_like(norm))
    return NullSpaceMasked(vec=Vh / norm, mask=mask,
                           dim=mask.sum(dim=1), svals=s)
