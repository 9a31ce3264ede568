"""KKT residual and Jacobian assembly (counterpart of
``algames_tpu/problem/residual.py``): the structured-Q form (diagonal plus
rank-1 statx Hessians) for diagonal objectives, the dense form for
objectives with collision-cost pairs and for the KKT ladder's methods,
the block-tridiagonal matrix (``build_tridiagonal``) and the reference's
flat row order (``flatten_residual``, ``flatten_jacobian``) that the
dense solves and the active-set analysis use.

Per-knot layout (0-based t):

  variable block  v_t = [x_{t+1} (n) | u_t (m) | lam_{0..p-1,t} (p n)]
  equation block  e_t = [statx(i,t) i=0..p-1 | statu(t) | dyn(t)]

Every function works on a batch of scenarios: leaves carry a leading [B]
axis.  The Jacobian is quasi-Newton as in the reference: second derivatives
of the dynamics are dropped.
"""
from __future__ import annotations

import dataclasses

import torch

from ..constraints import sets as gcm
from ..constraints.kernels import BoundParams
from ..core.spec import ProblemSpec, owner_map_u
from ..core.traj import PrimalDual
from ..models.integration import rk2_step, rk2_vjp, step_jacobians
from ..objective.objective import (cost_gradient, cost_hessian,
                                   cost_hessian_diag)
from ..utils import lanes
from .linear_solver import JacBlocks


@dataclasses.dataclass
class Residual:
    """rx [B, T, p, n] stationarity wrt x_{t+1} per player;
    ru [B, T, m] stationarity wrt u_t; rd [B, T, n] dynamics defects."""
    rx: torch.Tensor
    ru: torch.Tensor
    rd: torch.Tensor


@dataclasses.dataclass
class PointLite:
    """The AL-state-independent point quantities a line-search trial
    carries: the stationarity rows before constraint AL gradients
    (``rx0``/``ru0``), the RK2 defects and the per-block constraint
    values ([B, K, C] each)."""
    rx0: torch.Tensor
    ru0: torch.Tensor
    rd: torch.Tensor
    state_c: tuple
    control_c: tuple


@dataclasses.dataclass
class PointData:
    """:class:`PointLite` plus the RK2 step Jacobians A [B, T, n, n],
    B [B, T, n, m] and the per-block constraint Jacobians (empty tensors
    for bound blocks, whose Jacobian is a constant the closed forms never
    read)."""
    rx0: torch.Tensor
    ru0: torch.Tensor
    rd: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    state_c: tuple
    state_J: tuple
    control_c: tuple
    control_J: tuple


@dataclasses.dataclass
class StructuredQ:
    """Diagonal + rank-1 form of the statx Hessian blocks:

      Qblk[b, t, i] = diag(qdiag[b, t, i]) + sum_{k: w_owner[k] == i} wv[b, t, k] wv[b, t, k]^T

    exact for diagonal objectives: the cost Hessian and the bound AL
    Hessians are diagonal, and every collision row's AL Hessian is rank-1
    with w = sqrt(irho) J.
    """
    qdiag: torch.Tensor    # [B, T, p, n]
    wv: torch.Tensor       # [B, T, NW, n]
    Ublk: torch.Tensor     # [B, T, m, m]
    A: torch.Tensor        # [B, T, n, n]
    B: torch.Tensor        # [B, T, n, m]


def _pick_owner(spec: ProblemSpec, per_player):
    """[B, T, p, m] -> [B, T, m]: entry j of the owner of control j."""
    j = torch.arange(spec.m, device=per_player.device)
    own = torch.as_tensor(owner_map_u(spec), device=per_player.device)
    return per_player[:, :, own, j]


def _owner_stack(spec: ProblemSpec, per_player, like):
    """Stack per-player [B, T, w] accumulations (None = zero, shaped like
    ``like``) into [B, T, p, w]; None when no player has any."""
    if all(g is None for g in per_player):
        return None
    z = torch.zeros_like(like)
    return torch.stack([z if g is None else g for g in per_player], dim=2)


def dynamics_residual(model, spec: ProblemSpec, traj: PrimalDual):
    """RK2 defects [B, T, n]."""
    return rk2_step(model, traj.x[:, :-1], traj.u, spec.dt) - traj.x[:, 1:]


def _bound_masks(blk, like):
    dim = blk.params.z_max.shape[0]
    mk = torch.as_tensor(blk.params.mask, dtype=like.dtype, device=like.device)
    return mk[:dim], mk[dim:]


def _al_grad(blk, J, w):
    """J'w per knot: closed form for bounds (J is the constant
    [+I; -I] * mask), elementwise for single-row blocks, a contraction over
    the rows otherwise."""
    if isinstance(blk.params, BoundParams):
        dim = blk.params.z_max.shape[0]
        mu_, ml_ = _bound_masks(blk, w)
        return w[..., :dim] * mu_ - w[..., dim:] * ml_
    if J.shape[-2] == 1:
        return J[..., 0, :] * w
    return torch.einsum('...cd,...c->...d', J, w)


def _bound_hess_diag(blk, irho):
    """Diagonal of J' diag(irho) J of a bound block, [B, K, dim]."""
    dim = blk.params.z_max.shape[0]
    mu_, ml_ = _bound_masks(blk, irho)
    return irho[..., :dim] * mu_ + irho[..., dim:] * ml_


def _al_hess(blk, J, irho):
    """J' diag(irho) J per knot, [B, K, dim, dim] (same structure dispatch
    as :func:`_al_grad`)."""
    if isinstance(blk.params, BoundParams):
        return torch.diag_embed(_bound_hess_diag(blk, irho))
    if J.shape[-2] == 1:
        return ((J[..., 0, :, None] * J[..., 0, None, :])
                * irho[..., 0, None, None])
    return torch.einsum('...cd,...c,...ce->...de', J, irho, J)


def _blk_jacobian_for_carry(blk, traj):
    if isinstance(blk.params, BoundParams):
        return traj.x.new_zeros((0,))
    return gcm.block_jacobian(blk, traj)


def _add_al_grads(spec: ProblemSpec, gc: gcm.GameConstraints, rx, ru,
                  state_c, state_J, control_c, control_J):
    """Add every block's AL gradient under the current (lam, mu) to the
    stationarity rows: state blocks summed per owner, control blocks
    directly."""
    per = [None] * spec.p
    for blk, c, J in zip(gc.state_blocks, state_c, state_J):
        g = _al_grad(blk, J, blk.lam + gcm.al_irho(blk, c) * c)
        per[blk.owner] = g if per[blk.owner] is None else per[blk.owner] + g
    gsum = _owner_stack(spec, per, rx[:, :, 0])
    if gsum is not None:
        rx = rx + gsum
    for blk, c, J in zip(gc.control_blocks, control_c, control_J):
        ru = ru + _al_grad(blk, J, blk.lam + gcm.al_irho(blk, c) * c)
    return rx, ru


def point_lite_res(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
                   traj: PrimalDual):
    """Evaluate a trial point: ``(PointLite, Residual)`` in one pass.  The
    constraint Jacobians feed the residual's AL gradients but are not
    carried."""
    qx, ru_cost = cost_gradient(spec, obj, traj)
    rx = qx[:, :, 1:].permute(0, 2, 1, 3)                  # [B, T, p, n]
    ru = _pick_owner(spec, ru_cost.permute(0, 2, 1, 3))    # [B, T, m]
    lam_t = traj.lam.permute(0, 2, 1, 3)                   # [B, T, p, n]
    # Dual terms A_k^T lam_k / B_k^T lam_k as one VJP through the RK2 step.
    gx, gu = rk2_vjp(model, traj.x[:, :-1], traj.u, lam_t, spec.dt)
    rx = rx + torch.cat([gx[:, 1:], torch.zeros_like(gx[:, :1])], dim=1)
    rx = rx - lam_t
    ru = ru + _pick_owner(spec, gu)
    rd = dynamics_residual(model, spec, traj)

    blocks = gc.state_blocks + gc.control_blocks
    cs = [gcm.block_values(b, traj) for b in blocks]
    Js = [_blk_jacobian_for_carry(b, traj) for b in blocks]
    ns = len(gc.state_blocks)
    rx_res, ru_res = _add_al_grads(spec, gc, rx, ru, cs[:ns], Js[:ns],
                                   cs[ns:], Js[ns:])
    lite = PointLite(rx0=rx, ru0=ru, rd=rd, state_c=tuple(cs[:ns]),
                     control_c=tuple(cs[ns:]))
    return lite, Residual(rx=rx_res, ru=ru_res, rd=rd)


def point_from_lite(model, spec: ProblemSpec, gc: gcm.GameConstraints,
                    lite: PointLite, traj: PrimalDual) -> PointData:
    """Complete a PointLite with the RK2 step Jacobians and the constraint
    Jacobians at ``traj``."""
    A, B = step_jacobians(model, traj.x[:, :-1], traj.u, spec.dt)
    return PointData(
        rx0=lite.rx0, ru0=lite.ru0, rd=lite.rd, A=A, B=B,
        state_c=lite.state_c,
        state_J=tuple(_blk_jacobian_for_carry(b, traj)
                      for b in gc.state_blocks),
        control_c=lite.control_c,
        control_J=tuple(_blk_jacobian_for_carry(b, traj)
                        for b in gc.control_blocks))


def point_data(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
               traj: PrimalDual) -> PointData:
    lite, _ = point_lite_res(model, spec, obj, gc, traj)
    return point_from_lite(model, spec, gc, lite, traj)


def residual_from_point(spec: ProblemSpec, gc: gcm.GameConstraints,
                        pd: PointData) -> Residual:
    """Rebuild the residual from PointData under the current AL state."""
    rx, ru = _add_al_grads(spec, gc, pd.rx0, pd.ru0, pd.state_c, pd.state_J,
                           pd.control_c, pd.control_J)
    return Residual(rx=rx, ru=ru, rd=pd.rd)


def residual(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
             traj: PrimalDual, reg=0.0,
             traj_ref: PrimalDual | None = None) -> Residual:
    """Full KKT residual at ``traj``; with ``traj_ref``, plus the Tikhonov
    pull ``reg (traj - traj_ref)`` on the primal rows (``reg`` [B] or a
    scalar)."""
    res = residual_from_point(spec, gc,
                              point_data(model, spec, obj, gc, traj))
    if traj_ref is None:
        return res
    r = lanes(reg, 3)
    return Residual(
        rx=res.rx + (r * (traj.x[:, 1:] - traj_ref.x[:, 1:]))[:, :, None],
        ru=res.ru + r * (traj.u - traj_ref.u), rd=res.rd)


def jacobian_blocks(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
                    traj: PrimalDual, reg_x=0.0, reg_u=0.0) -> JacBlocks:
    """Dense Jacobian ingredients at ``traj``: cost Hessians, every
    block's AL Hessian (:func:`constraints.sets.al_expansion`; control
    blocks couple same-owner controls only), ``reg_x`` / ``reg_u`` on the
    primal diagonals and the RK2 step Jacobians."""
    T, p, n, m = spec.T, spec.p, spec.n, spec.m
    Bsz = traj.x.shape[0]
    dtype, device = traj.x.dtype, traj.x.device
    Qx, Ru = cost_hessian(spec, obj, traj)
    Qblk = Qx[:, :, 1:].permute(0, 2, 1, 3, 4)               # [B, T, p, n, n]
    Ublk, same = _control_hessian(spec, Ru, dtype, device)
    hess_per = [None] * p
    for blk in gc.state_blocks:
        _, hess = gcm.al_expansion(blk, traj)
        i = blk.owner
        hess_per[i] = hess if hess_per[i] is None else hess_per[i] + hess
    hsum = _owner_stack(spec, hess_per, Qblk[:, :, 0])
    if hsum is not None:
        Qblk = Qblk + hsum
    Ublk = Ublk.expand(Bsz, T, m, m)
    for blk in gc.control_blocks:
        _, hess = gcm.al_expansion(blk, traj)
        Ublk = Ublk + hess * same
    Qblk = Qblk + reg_x * torch.eye(n, dtype=dtype, device=device)
    Ublk = Ublk + reg_u * torch.eye(m, dtype=dtype, device=device)
    A, B = step_jacobians(model, traj.x[:, :-1], traj.u, spec.dt)
    return JacBlocks(Qblk=Qblk, Ublk=Ublk.expand(Bsz, T, m, m), A=A, B=B)


def build_tridiagonal(spec: ProblemSpec, jb: JacBlocks):
    """The block-tridiagonal KKT matrix as (D [B, T, W, W], U, L
    [B, T-1, W, W]): U[:, t] couples equation t to v_{t+1}, L[:, t]
    couples equation t+1 to v_t.

      statx(i) rows: Qblk_i at the x columns, -I at lam_i; A_{t+1}^T at
                     lam_i of the next knot (U)
      statu rows:    Ublk at the u columns; rows pu_i: B[:, pu_i]^T at lam_i
      dyn rows:      -I at the x columns, B at u; A_{t+1} at x of the
                     previous knot (L)
    """
    T, p, n, m, W = spec.T, spec.p, spec.n, spec.m, spec.W
    Bsz = jb.A.shape[0]
    eye_n = torch.eye(n, dtype=jb.A.dtype, device=jb.A.device)
    ru0, rd0 = p * n, p * n + m
    D = jb.A.new_zeros((Bsz, T, W, W))
    U = jb.A.new_zeros((Bsz, T - 1, W, W))
    L = jb.A.new_zeros((Bsz, T - 1, W, W))
    At1 = jb.A[:, 1:].transpose(-1, -2)
    for i in range(p):
        r, c = slice(i * n, (i + 1) * n), slice(n + m + i * n,
                                                 n + m + (i + 1) * n)
        D[:, :, r, :n] = jb.Qblk[:, :, i]
        D[:, :, r, c] = -eye_n
        pu = list(spec.pu[i])
        D[:, :, [ru0 + j for j in pu], c] = jb.B[..., pu].transpose(-1, -2)
        U[:, :, r, c] = At1
    D[:, :, ru0:rd0, n:n + m] = jb.Ublk
    D[:, :, rd0:, :n] = -eye_n
    D[:, :, rd0:, n:n + m] = jb.B
    L[:, :, rd0:, :n] = jb.A[:, 1:]
    return D, U, L


def assemble(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
             traj: PrimalDual, reg=0.0):
    """Residual, dense :class:`JacBlocks` and the violations (sta, con) at
    ``traj`` in one pass (:func:`point_data` + :func:`assemble_from_point`);
    ``reg`` on the Jacobian's primal diagonals only."""
    pd = point_data(model, spec, obj, gc, traj)
    return assemble_from_point(spec, obj, gc, traj, pd, reg=reg)


def structured_w_owner(gc: gcm.GameConstraints):
    """Owner of each rank-1 w vector: one per row of every non-bound state
    block, in ``gc.state_blocks`` order."""
    owners = []
    for blk in gc.state_blocks:
        if not isinstance(blk.params, BoundParams):
            owners.extend([blk.owner] * blk.lam.shape[-1])
    return tuple(owners)


def structured_q_supported(spec: ProblemSpec, obj, gc) -> bool:
    """True iff the statx Hessians decompose as :class:`StructuredQ`: the
    objective has no collision-cost pairs (their Hessians are dense
    cross-player blocks).  Every constraint family qualifies: bound blocks
    are diagonal, every other block adds one w vector per row."""
    return not obj.pair_i


def _control_hessian(spec: ProblemSpec, Ru, dtype, device):
    """Owner-embedded control cost Hessian [m, m] and the [m, m] 0/1 mask
    of same-owner control pairs (only those couple)."""
    own = torch.as_tensor(owner_map_u(spec), device=device)
    same = (own[:, None] == own[None, :]).to(dtype)
    Ublk = torch.zeros((spec.m, spec.m), dtype=dtype, device=device)
    for i in range(spec.p):
        oi = (own == i).to(dtype)
        Ublk = Ublk + Ru[i] * (oi[:, None] * oi[None, :])
    return Ublk, same


def assemble_from_point(spec: ProblemSpec, obj, gc, traj, pd: PointData,
                        reg=0.0):
    """Residual, dense :class:`JacBlocks` and the violations (sta, con),
    each [B], from carried PointData; ``reg`` [B] (or a scalar) is added to
    the primal diagonals.  Only the cost Hessians and the AL contractions
    with the current (lam, mu) are recomputed."""
    T, p, n, m = spec.T, spec.p, spec.n, spec.m
    Bsz = traj.x.shape[0]
    dtype, device = traj.x.dtype, traj.x.device
    Qx, Ru = cost_hessian(spec, obj, traj)
    Qblk = Qx[:, :, 1:].permute(0, 2, 1, 3, 4)               # [B, T, p, n, n]
    Ublk, same = _control_hessian(spec, Ru, dtype, device)

    rx, ru = pd.rx0, pd.ru0
    sta_v = torch.zeros((Bsz,), dtype=dtype, device=device)
    con_v = torch.zeros((Bsz,), dtype=dtype, device=device)
    grad_per = [None] * p
    hess_per = [None] * p
    for blk, c, J in zip(gc.state_blocks, pd.state_c, pd.state_J):
        irho = gcm.al_irho(blk, c)
        grad = _al_grad(blk, J, blk.lam + irho * c)
        hess = _al_hess(blk, J, irho)
        i = blk.owner
        grad_per[i] = grad if grad_per[i] is None else grad_per[i] + grad
        hess_per[i] = hess if hess_per[i] is None else hess_per[i] + hess
        sta_v = torch.maximum(sta_v, gcm.block_violation_max(c, blk.sense))
    gsum = _owner_stack(spec, grad_per, pd.rd)
    if gsum is not None:
        rx = rx + gsum
    hsum = _owner_stack(spec, hess_per, Qblk[:, :, 0])
    if hsum is not None:
        Qblk = Qblk + hsum
    Ublk = Ublk.expand(Bsz, T, m, m)
    for blk, c, J in zip(gc.control_blocks, pd.control_c, pd.control_J):
        irho = gcm.al_irho(blk, c)
        ru = ru + _al_grad(blk, J, blk.lam + irho * c)
        Ublk = Ublk + _al_hess(blk, J, irho) * same
        con_v = torch.maximum(con_v, gcm.block_violation_max(c, blk.sense))

    eye_n = torch.eye(n, dtype=dtype, device=device)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    Qblk = Qblk + lanes(reg, 5) * eye_n
    Ublk = (Ublk + lanes(reg, 4) * eye_m).expand(Bsz, T, m, m)
    return (Residual(rx=rx, ru=ru, rd=pd.rd),
            JacBlocks(Qblk=Qblk, Ublk=Ublk, A=pd.A, B=pd.B), sta_v, con_v)


def assemble_structured_from_point(spec: ProblemSpec, obj, gc, traj,
                                   pd: PointData, reg=0.0):
    """:func:`assemble_from_point` with the statx Hessians in
    :class:`StructuredQ` form (the dense Qblk never exists); requires
    :func:`structured_q_supported`."""
    T, p, n, m = spec.T, spec.p, spec.n, spec.m
    Bsz = traj.x.shape[0]
    dtype, device = traj.x.dtype, traj.x.device
    Qx, Ru = cost_hessian_diag(spec, obj, dtype, device)
    Ublk, same = _control_hessian(spec, Ru, dtype, device)
    qdiag = Qx[:, 1:].permute(1, 0, 2)                       # [T, p, n]

    rx, ru = pd.rx0, pd.ru0
    sta_v = torch.zeros((Bsz,), dtype=dtype, device=device)
    con_v = torch.zeros((Bsz,), dtype=dtype, device=device)
    grad_per = [None] * p
    qadd_per = [None] * p
    wvs = []
    for blk, c, J in zip(gc.state_blocks, pd.state_c, pd.state_J):
        irho = gcm.al_irho(blk, c)
        grad = _al_grad(blk, J, blk.lam + irho * c)
        i = blk.owner
        grad_per[i] = grad if grad_per[i] is None else grad_per[i] + grad
        if isinstance(blk.params, BoundParams):
            dvec = _bound_hess_diag(blk, irho)
            qadd_per[i] = dvec if qadd_per[i] is None else qadd_per[i] + dvec
        else:
            for cc in range(blk.lam.shape[-1]):
                wvs.append(torch.sqrt(irho[..., cc])[..., None]
                           * J[..., cc, :])                  # [B, T, n]
        sta_v = torch.maximum(sta_v, gcm.block_violation_max(c, blk.sense))
    gsum = _owner_stack(spec, grad_per, pd.rd)
    if gsum is not None:
        rx = rx + gsum
    qsum = _owner_stack(spec, qadd_per, pd.rd)
    if qsum is not None:
        qdiag = qdiag + qsum
    Ublk = Ublk.expand(Bsz, T, m, m)
    for blk, c, J in zip(gc.control_blocks, pd.control_c, pd.control_J):
        irho = gcm.al_irho(blk, c)
        ru = ru + _al_grad(blk, J, blk.lam + irho * c)
        Ublk = Ublk + _al_hess(blk, J, irho) * same
        con_v = torch.maximum(con_v, gcm.block_violation_max(c, blk.sense))

    qdiag = (qdiag + lanes(reg, 4)).expand(Bsz, T, p, n)
    eye_m = torch.eye(m, dtype=dtype, device=device)
    Ublk = (Ublk + lanes(reg, 4) * eye_m).expand(Bsz, T, m, m)
    wv = (torch.stack(wvs, dim=2) if wvs
          else torch.zeros((Bsz, T, 0, n), dtype=dtype, device=device))
    return (Residual(rx=rx, ru=ru, rd=pd.rd),
            StructuredQ(qdiag=qdiag, wv=wv, Ublk=Ublk, A=pd.A, B=pd.B),
            sta_v, con_v)


def point_violations(gc: gcm.GameConstraints, pd: PointData):
    """(sta_vio_max, con_vio_max) per lane from carried constraint values."""
    Bsz = pd.rd.shape[0]
    sta_v = pd.rd.new_zeros((Bsz,))
    con_v = pd.rd.new_zeros((Bsz,))
    for blk, c in zip(gc.state_blocks, pd.state_c):
        sta_v = torch.maximum(sta_v, gcm.block_violation_max(c, blk.sense))
    for blk, c in zip(gc.control_blocks, pd.control_c):
        con_v = torch.maximum(con_v, gcm.block_violation_max(c, blk.sense))
    return sta_v, con_v


def residual_norm(spec: ProblemSpec, res: Residual) -> torch.Tensor:
    """Mean 1-norm over all S entries, per lane [B]."""
    total = (res.rx.abs().sum(dim=(1, 2, 3)) + res.ru.abs().sum(dim=(1, 2))
             + res.rd.abs().sum(dim=(1, 2)))
    return total / spec.S


def optimality_violation(res: Residual) -> torch.Tensor:
    """Max-abs over all stationarity rows, per lane."""
    return torch.maximum(res.rx.abs().amax(dim=(1, 2, 3)),
                         res.ru.abs().amax(dim=(1, 2)))


def dynamics_violation(res: Residual) -> torch.Tensor:
    """Max-abs dynamics defect, per lane."""
    return res.rd.abs().amax(dim=(1, 2))


def residual_knot_blocks(spec: ProblemSpec, res: Residual) -> torch.Tensor:
    """Residual in per-knot equation order [B, T, W]."""
    Bsz = res.rd.shape[0]
    return torch.cat([res.rx.reshape(Bsz, spec.T, spec.p * spec.n), res.ru,
                      res.rd], dim=2)


def flatten_residual(spec: ProblemSpec, res: Residual) -> torch.Tensor:
    """The residual [B, S] in the reference's row order: per player, per
    knot its n statx rows then its mi statu rows; then the dynamics rows."""
    Bsz = res.rd.shape[0]
    parts = [torch.cat([res.rx[:, :, i], res.ru[:, :, list(spec.pu[i])]],
                       dim=2).reshape(Bsz, -1) for i in range(spec.p)]
    return torch.cat(parts + [res.rd.reshape(Bsz, -1)], dim=1)


def flatten_jacobian(spec: ProblemSpec, jb: JacBlocks) -> torch.Tensor:
    """The dense Jacobian [B, S, S]: rows in the reference's order
    (:func:`flatten_residual`), columns in per-knot order
    [x_{t+1} | u_t | lam_{., t}]."""
    S, T, p, n, m = spec.S, spec.T, spec.p, spec.n, spec.m
    Bsz = jb.A.shape[0]
    J = jb.A.new_zeros((Bsz, S, S))
    eye_n = torch.eye(n, dtype=jb.A.dtype, device=jb.A.device)
    for t in range(T):
        cx, cu = spec.col_x(t), spec.col_u(t)
        for i in range(p):
            pu = list(spec.pu[i])
            cl = spec.col_lam(i, t)
            rx, ru = spec.row_stat_x(i, t), spec.row_stat_u(i, t)
            J[:, rx:rx + n, cx:cx + n] = jb.Qblk[:, t, i]
            J[:, rx:rx + n, cl:cl + n] = -eye_n
            if t + 1 < T:
                cl1 = spec.col_lam(i, t + 1)
                J[:, rx:rx + n, cl1:cl1 + n] = jb.A[:, t + 1].transpose(-1, -2)
            J[:, ru:ru + len(pu), cl:cl + n] = jb.B[:, t][:, :, pu].transpose(
                -1, -2)
            J[:, ru:ru + len(pu), [cu + j for j in pu]] = (
                jb.Ublk[:, t][:, pu][:, :, pu])
        rd = spec.row_dyn(t)
        J[:, rd:rd + n, cx:cx + n] = -eye_n
        J[:, rd:rd + n, cu:cu + m] = jb.B[:, t]
        if t >= 1:
            cxm = spec.col_x(t - 1)
            J[:, rd:rd + n, cxm:cxm + n] = jb.A[:, t]
    return J
