"""Game constraint container, AL state and its updates (counterpart of
``algames_tpu/constraints/sets.py``: planar and spherical collision, circle,
wall, 3D wall, cylinder, state/velocity and control bound families, each
block of one cone: inequality, equality or second-order cone).

A ``ConBlock`` pairs a family-parameter record (shared by every lane) with
the AL state ``lam``/``mu`` [B, K, C] (K = applied knots, C = rows) and the
active-set flags ``active``.  A problem built by the builders below holds
unbatched [K, C] state; the solver resets it to per-lane [B, K, C] tensors,
because dual and penalty updates make it differ per lane.

AL math by sense:

    Irho  = ((c >= 0) | (lam > 0)) * mu   (ineq, soc);  mu   (eq)
    grad  = J' lam + J' (Irho * c)
    hess  = J' diag(Irho) J
    dual update:  clamp(lam + alpha*mu*c, 0, lam_max)         (ineq)
                  clamp(lam + alpha*mu*c, -lam_max, lam_max)  (eq)
                  proj_soc(lam - alpha*mu*c)                  (soc)
    penalty update: mu <- min(phi * mu, mu_max)
    active set: (c >= -tol) | (lam > 0)  (ineq, soc);  always  (eq)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.spec import ProblemSpec
from . import kernels
from .kernels import (CircleParams, CollisionParams, CylinderParams,
                      Wall2DParams, Wall3DParams, make_bound)


@dataclasses.dataclass
class ConBlock:
    """One constraint instance: family params + AL state.

    ``owner``: player whose stationarity rows receive the AL gradient
    (state constraints); -1 for the shared control constraints.
    ``sense``: the cone, "ineq" (c <= 0), "eq" (c == 0) or "soc" (the
    second-order cone, its axis in the last row).  ``active``: the
    active-set flags (bool, the shape of ``lam``; all False when not
    given), refreshed by :func:`update_active_set`.
    """
    params: object
    lam: torch.Tensor                 # [B, K, C] (or [K, C] before a solve)
    mu: torch.Tensor                  # [B, K, C]
    owner: int
    is_state: bool
    sense: str = "ineq"
    active: torch.Tensor | None = None

    def __post_init__(self):
        if self.sense not in ("ineq", "eq", "soc"):
            raise ValueError(f"unknown constraint sense {self.sense!r}")
        if self.active is None and isinstance(self.lam, torch.Tensor):
            self.active = torch.zeros(self.lam.shape, dtype=torch.bool,
                                      device=self.lam.device)


@dataclasses.dataclass
class GameConstraints:
    """All constraint blocks + dual-ascent step sizes, AL parameters and the
    active-set tolerance (0-d tensors, ``alphax_dual`` [p]); shared by
    every lane."""
    state_blocks: Tuple[ConBlock, ...]
    control_blocks: Tuple[ConBlock, ...]
    alpha_dual: torch.Tensor
    alphax_dual: torch.Tensor
    phi: torch.Tensor
    mu0: torch.Tensor
    mu_max: torch.Tensor
    lam_max: torch.Tensor
    active_tol: torch.Tensor


def game_constraints(spec: ProblemSpec, dtype, device) -> GameConstraints:
    """Empty constraint set with the reference-default parameters."""
    def s(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return GameConstraints(
        state_blocks=(), control_blocks=(),
        alpha_dual=s(1.0), alphax_dual=torch.ones((spec.p,), dtype=dtype,
                                                  device=device),
        phi=s(10.0), mu0=s(1.0), mu_max=s(1e7), lam_max=s(1e7),
        active_tol=s(0.0))


def set_constraint_params(gc: GameConstraints, opts) -> GameConstraints:
    """Push solver options into the constraint set."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    p = gc.alphax_dual.shape[0]

    def s(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)
    gc = dataclasses.replace(
        gc, alpha_dual=s(opts.alpha_dual),
        alphax_dual=s(opts.alphax_dual[:p]), phi=s(opts.rho_increase),
        mu0=s(opts.rho_0), mu_max=s(opts.rho_max), lam_max=s(opts.lam_max),
        active_tol=s(opts.active_set_tolerance))
    return map_blocks(gc, lambda b: dataclasses.replace(
        b, mu=torch.full_like(b.mu, opts.rho_0)))


def map_blocks(gc: GameConstraints, fn) -> GameConstraints:
    """Apply ``fn`` to every state and control block."""
    return dataclasses.replace(
        gc, state_blocks=tuple(fn(b) for b in gc.state_blocks),
        control_blocks=tuple(fn(b) for b in gc.control_blocks))


def _new_block(spec: ProblemSpec, params, owner: int, is_state: bool,
               dtype, device) -> ConBlock:
    K = spec.T       # state: knots 1..N-1; control: knots 0..N-2
    C = kernels.num_rows(params)
    return ConBlock(params=params,
                    lam=torch.zeros((K, C), dtype=dtype, device=device),
                    mu=torch.ones((K, C), dtype=dtype, device=device),
                    owner=owner, is_state=is_state)


def add_collision_avoidance(spec: ProblemSpec, gc: GameConstraints, radius,
                            i: int | None = None,
                            j: int | None = None) -> GameConstraints:
    """Pairwise planar collision avoidance: with ``i``/``j`` one block owned
    by player i against j; without, one per ordered pair with radius
    ``radius[i] + radius[j]`` (a scalar radius is broadcast)."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    if i is not None:
        par = CollisionParams(
            radius=torch.as_tensor(float(radius), dtype=dtype, device=device),
            pxi=spec.px[i], pxj=spec.px[j])
        return _push_state(gc, _new_block(spec, par, i, True, dtype, device))
    radius = np.broadcast_to(np.asarray(radius, np.float64), (spec.p,))
    for a in range(spec.p):
        for b in range(spec.p):
            if a != b:
                gc = add_collision_avoidance(spec, gc, radius[a] + radius[b],
                                             a, b)
    return gc


def add_spherical_collision_avoidance(spec: ProblemSpec, gc: GameConstraints,
                                      radius) -> GameConstraints:
    """3D collision avoidance on the first three state components of each
    player: one block per ordered pair with radius ``radius[i] +
    radius[j]`` (a scalar radius is broadcast)."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    radius = np.broadcast_to(np.asarray(radius, np.float64), (spec.p,))
    for a in range(spec.p):
        for b in range(spec.p):
            if a != b:
                par = CollisionParams(
                    radius=torch.as_tensor(float(radius[a] + radius[b]),
                                           dtype=dtype, device=device),
                    pxi=spec.pz[a][:3], pxj=spec.pz[b][:3])
                gc = _push_state(gc, _new_block(spec, par, a, True, dtype,
                                                device))
    return gc


def _promote_bound(z, dim):
    """A scalar bound is broadcast to the full dimension."""
    z = np.asarray(z, np.float64)
    return np.full((dim,), float(z)) if z.ndim == 0 else z


def _push_state(gc: GameConstraints, blk: ConBlock) -> GameConstraints:
    return dataclasses.replace(gc, state_blocks=gc.state_blocks + (blk,))


def add_state_bound(spec: ProblemSpec, gc: GameConstraints, i: int,
                    x_max, x_min) -> GameConstraints:
    """Box bound on the full state, owned by player i (infinite entries are
    masked out)."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    par = make_bound(_promote_bound(x_max, spec.n),
                     _promote_bound(x_min, spec.n), dtype, device)
    return _push_state(gc, _new_block(spec, par, i, True, dtype, device))


def add_control_bound(spec: ProblemSpec, gc: GameConstraints,
                      u_max, u_min) -> GameConstraints:
    """Shared box bound on the full control vector (a scalar is
    broadcast)."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    par = make_bound(_promote_bound(u_max, spec.m),
                     _promote_bound(u_min, spec.m), dtype, device)
    blk = _new_block(spec, par, -1, False, dtype, device)
    return dataclasses.replace(gc, control_blocks=gc.control_blocks + (blk,))


def add_circle_constraint(spec: ProblemSpec, gc: GameConstraints, xc, yc,
                          radius, i: int | None = None) -> GameConstraints:
    """Static circular obstacles on player i's position, or one block per
    player when ``i`` is None."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    if i is None:
        for a in range(spec.p):
            gc = add_circle_constraint(spec, gc, xc, yc, radius, a)
        return gc

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)
    par = CircleParams(xc=vec(xc), yc=vec(yc), radius=vec(radius),
                       xi=spec.px[i][0], yi=spec.px[i][1])
    return _push_state(gc, _new_block(spec, par, i, True, dtype, device))


class Wall:
    """2D wall segment from p1 to p2 with normal-like direction v."""

    def __init__(self, p1, p2, v):
        self.p1, self.p2, self.v = (np.asarray(p1), np.asarray(p2),
                                    np.asarray(v))


class Wall3D:
    """3D parallelepiped facet with corners p1, p2, p3 and direction v."""

    def __init__(self, p1, p2, p3, v):
        self.p1, self.p2 = np.asarray(p1), np.asarray(p2)
        self.p3, self.v = np.asarray(p3), np.asarray(v)


class CylinderWall:
    """Axis-aligned finite cylinder: base point p, axis v in ('x', 'y',
    'z'), length l, radius r."""

    def __init__(self, p, v, l, r):
        self.p, self.v, self.l, self.r = np.asarray(p), v, float(l), float(r)


def add_wall_constraint(spec: ProblemSpec, gc: GameConstraints, walls,
                        i: int | None = None) -> GameConstraints:
    """One block of ``walls`` (all of one kind: :class:`Wall`,
    :class:`Wall3D` or :class:`CylinderWall`) on player i's position, or one
    block per player when ``i`` is None."""
    dtype, device = gc.alpha_dual.dtype, gc.alpha_dual.device
    if i is None:
        for a in range(spec.p):
            gc = add_wall_constraint(spec, gc, walls, a)
        return gc
    kinds = {type(w) for w in walls}
    if len(kinds) != 1:
        raise ValueError("one call takes walls of one kind")
    kind = kinds.pop()

    def arr(vals):
        return torch.as_tensor(np.asarray(vals, np.float64), dtype=dtype,
                               device=device)

    def coord(attr, k):
        return arr([getattr(w, attr)[k] for w in walls])
    if kind is Wall:
        par = Wall2DParams(x1=coord("p1", 0), y1=coord("p1", 1),
                           x2=coord("p2", 0), y2=coord("p2", 1),
                           xv=coord("v", 0), yv=coord("v", 1),
                           xi=spec.px[i][0], yi=spec.px[i][1])
    elif kind is Wall3D:
        par = Wall3DParams(
            x1=coord("p1", 0), y1=coord("p1", 1), z1=coord("p1", 2),
            x2=coord("p2", 0), y2=coord("p2", 1), z2=coord("p2", 2),
            x3=coord("p3", 0), y3=coord("p3", 1), z3=coord("p3", 2),
            xv=coord("v", 0), yv=coord("v", 1), zv=coord("v", 2),
            xi=spec.pz[i][0], yi=spec.pz[i][1], zi=spec.pz[i][2])
    elif kind is CylinderWall:
        axis_of = {"x": 0, "y": 1, "z": 2}
        par = CylinderParams(
            p1=coord("p", 0), p2=coord("p", 1), p3=coord("p", 2),
            l=arr([w.l for w in walls]), r=arr([w.r for w in walls]),
            axis=tuple(axis_of[w.v] for w in walls),
            xi=spec.pz[i][0], yi=spec.pz[i][1], zi=spec.pz[i][2])
    else:
        raise TypeError(kind)
    return _push_state(gc, _new_block(spec, par, i, True, dtype, device))


def add_velocity_bound(spec: ProblemSpec, model, gc: GameConstraints,
                       v_max, v_min) -> GameConstraints:
    """Speed bounds: for each player i with a finite bound, a state bound on
    i's velocity index is added to every player (p blocks per such i)."""
    v_max = np.asarray(v_max, np.float64)
    v_min = np.asarray(v_min, np.float64)
    if not v_max.shape == v_min.shape == (spec.p,):
        raise ValueError("v_max and v_min need one entry per player")
    for i in range(spec.p):
        if np.isinf(v_max[i]) and np.isinf(v_min[i]):
            continue
        x_max = np.full((spec.n,), np.inf)
        x_min = np.full((spec.n,), -np.inf)
        vi = model.velocity_index(i)
        x_max[vi], x_min[vi] = v_max[i], v_min[i]
        for j in range(spec.p):
            gc = add_state_bound(spec, gc, j, x_max, x_min)
    return gc


def block_inputs(block: ConBlock, traj):
    """States x_1..x_{N-1} or controls u_0..u_{N-2}, [B, K, dim]."""
    return traj.x[:, 1:] if block.is_state else traj.u


def block_values(block: ConBlock, traj) -> torch.Tensor:
    return kernels.evaluate(block.params, block_inputs(block, traj))


def block_jacobian(block: ConBlock, traj) -> torch.Tensor:
    return kernels.jacobian(block.params, block_inputs(block, traj))


def block_violation(c: torch.Tensor, sense: str) -> torch.Tensor:
    """Row violations of a block's values: |c| (eq), max(0, c) (else)."""
    return c.abs() if sense == "eq" else torch.clamp(c, min=0.0)


def block_violation_max(c: torch.Tensor, sense: str) -> torch.Tensor:
    """Per-lane max violation of a block, [B]."""
    return block_violation(c, sense).amax(dim=(1, 2))


def al_expansion_full(block: ConBlock, traj):
    """AL gradient [B, K, dim], Gauss-Newton Hessian [B, K, dim, dim] and
    values [B, K, C] of a block at every applied knot:
    ``grad = J'(lam + Irho c)``, ``hess = J' diag(Irho) J``."""
    c = block_values(block, traj)
    J = block_jacobian(block, traj)
    irho = al_irho(block, c)
    w = block.lam + irho * c
    if J.shape[-2] == 1:
        grad = J[..., 0, :] * w[..., 0, None]
        hess = (J[..., 0, :, None] * J[..., 0, None, :]) * irho[..., 0, None,
                                                               None]
    else:
        grad = torch.einsum('...cd,...c->...d', J, w)
        hess = torch.einsum('...cd,...c,...ce->...de', J, irho, J)
    return grad, hess, c


def al_expansion(block: ConBlock, traj):
    """(grad, hess) of :func:`al_expansion_full`."""
    grad, hess, _ = al_expansion_full(block, traj)
    return grad, hess


def al_irho(block: ConBlock, c: torch.Tensor) -> torch.Tensor:
    """The rows' penalty weights Irho: mu on equality rows, and on the
    others mu where c >= 0 or lam > 0, else 0."""
    if block.sense == "eq":
        return block.mu
    return torch.where((c >= 0.0) | (block.lam > 0.0), block.mu,
                       torch.zeros((), dtype=c.dtype, device=c.device))


def soc_projection(v: torch.Tensor) -> torch.Tensor:
    """Projection of rows [..., C] onto the second-order cone
    {(x, t): |x| <= t}, the cone axis t in the last component."""
    x, t = v[..., :-1], v[..., -1]
    nx = torch.linalg.vector_norm(x, dim=-1)
    scale = torch.clamp((nx + t) / torch.clamp(2.0 * nx, min=1e-30), 0.0, 1.0)
    inside, below = nx <= t, nx <= -t
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    x_p = torch.where(inside[..., None], x,
                      torch.where(below[..., None], zero, scale[..., None] * x))
    t_p = torch.where(inside, t, torch.where(below, zero, scale * nx))
    return torch.cat([x_p, t_p[..., None]], dim=-1)


def dual_update(gc: GameConstraints, traj) -> GameConstraints:
    """Dual ascent on every block: per-player state step ``alphax_dual[i]``,
    shared control step ``alpha_dual``; each block projected onto its cone
    (ineq: [0, lam_max]; eq: [-lam_max, lam_max]; soc: proj_soc of
    lam - alpha mu c).  A player past the steps ``Options.alphax_dual``
    gives (ten by default) takes the last, as the reference package's
    clamped index does."""
    last = gc.alphax_dual.shape[0] - 1
    def upd(block: ConBlock, alpha):
        c = block_values(block, traj)
        if block.sense == "soc":
            lam = soc_projection(block.lam - alpha * block.mu * c)
        elif block.sense == "eq":
            lam = torch.minimum(torch.maximum(block.lam + alpha * block.mu * c,
                                              -gc.lam_max), gc.lam_max)
        else:
            lam = torch.minimum(
                torch.clamp(block.lam + alpha * block.mu * c, min=0.0),
                gc.lam_max)
        return dataclasses.replace(block, lam=lam)
    return dataclasses.replace(
        gc,
        state_blocks=tuple(upd(b, gc.alphax_dual[min(b.owner, last)])
                           for b in gc.state_blocks),
        control_blocks=tuple(upd(b, gc.alpha_dual)
                             for b in gc.control_blocks))


def update_active_set(gc: GameConstraints, traj) -> GameConstraints:
    """Recompute the active flags at ``traj``: ``(c >= -active_tol) |
    (lam > 0)``, and every row of an equality block."""
    def upd(block: ConBlock):
        c = block_values(block, traj)
        if block.sense == "eq":
            act = torch.ones(c.shape, dtype=torch.bool, device=c.device)
        else:
            act = (c >= -gc.active_tol) | (block.lam > 0.0)
        return dataclasses.replace(block, active=act)
    return map_blocks(gc, upd)


def penalty_update(gc: GameConstraints) -> GameConstraints:
    """``mu <- min(phi * mu, mu_max)``."""
    return map_blocks(gc, lambda b: dataclasses.replace(
        b, mu=torch.minimum(b.mu * gc.phi, gc.mu_max)))


def _lane_copy(a: torch.Tensor, B: int) -> torch.Tensor:
    """Unbatched [K, C] state copied to B lanes; per-lane state as it is."""
    if a.dim() == 3:
        if a.shape[0] != B:
            raise ValueError(f"AL state of {a.shape[0]} lanes, want {B}")
        return a
    return a.expand((B,) + tuple(a.shape)).contiguous()


def reset_constraints(gc: GameConstraints, B: int) -> GameConstraints:
    """Zero duals and reset penalties to mu0, as per-lane [B, K, C] state;
    the active flags are kept, per lane."""
    def upd(b: ConBlock):
        shape = (B,) + tuple(b.lam.shape[-2:])
        return dataclasses.replace(
            b, lam=b.lam.new_zeros(shape),
            mu=b.mu.new_zeros(shape) + gc.mu0,
            active=_lane_copy(b.active, B))
    return map_blocks(gc, upd)


def per_lane(gc: GameConstraints, B: int) -> GameConstraints:
    """The AL state and active flags as per-lane [B, K, C] tensors:
    unbatched [K, C] state is copied to every lane, per-lane state is kept
    as it is."""
    return map_blocks(gc, lambda b: dataclasses.replace(
        b, lam=_lane_copy(b.lam, B), mu=_lane_copy(b.mu, B),
        active=_lane_copy(b.active, B)))


def reset_penalties(gc: GameConstraints) -> GameConstraints:
    """Reset penalties to mu0 and keep the duals (the MPC dual warm start:
    carried multipliers, a fresh penalty schedule), per lane [B, K, C] or
    unbatched [K, C] as given."""
    return map_blocks(gc, lambda b: dataclasses.replace(
        b, mu=b.mu.new_zeros(b.mu.shape) + gc.mu0))


def reset_constraint_duals(gc: GameConstraints) -> GameConstraints:
    """Zero the duals and keep the penalties, at the state's own shape."""
    return map_blocks(gc, lambda b: dataclasses.replace(
        b, lam=b.lam.new_zeros(b.lam.shape)))


def state_violation(gc: GameConstraints, traj) -> torch.Tensor:
    """Max state-constraint violation per knot, [B, N] (0 at knot 0)."""
    vio = traj.x.new_zeros(traj.x.shape[:2])
    for b in gc.state_blocks:
        cv = block_violation(block_values(b, traj), b.sense).amax(dim=-1)
        vio[:, 1:] = torch.maximum(vio[:, 1:], cv)
    return vio


def dynamics_violation_vector(model, spec: ProblemSpec, traj) -> torch.Tensor:
    """Max-abs RK2 dynamics defect per interval, [B, T]."""
    from ..problem.residual import dynamics_residual
    return dynamics_residual(model, spec, traj).abs().amax(dim=-1)


def control_violation(gc: GameConstraints, traj) -> torch.Tensor:
    """Max control-constraint violation per interval, [B, T]."""
    vio = traj.u.new_zeros(traj.u.shape[:2])
    for b in gc.control_blocks:
        vio = torch.maximum(
            vio, block_violation(block_values(b, traj), b.sense).amax(dim=-1))
    return vio
