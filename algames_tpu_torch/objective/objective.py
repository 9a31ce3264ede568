"""Per-player game objectives: diagonal LQR costs plus smooth collision
repulsion (counterpart of ``algames_tpu/objective/objective.py``).

Per-player costs on the player's own state/control slice are embedded into
full-dimension diagonals.  Stage gradients/Hessians are scaled by ``dt``,
the terminal knot is not, and the terminal control cost is zero.  A
CollisionCost term is an ordered player pair (i, j) with weight ``mu`` and
radius ``r`` that repels player i from player j.  The objective is shared by
every lane of a batch: its leaves carry no batch axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual

# Regularisation of the pair-gradient direction (reference expressions).
_PAIR_EPS = 1e-10


@dataclasses.dataclass
class GameObjective:
    """Stacked per-player quadratic costs and the collision-cost pairs
    (shared by all lanes).

      Qd [p, n]  embedded state-cost diagonal
      Rd [p, m]  embedded control-cost diagonal
      xf [p, n]  embedded state target
      uf [p, m]  embedded control target
      mu, r [n_pairs]  collision-cost weight and radius per pair
      pair_i, pair_j   owner / other player of each pair
      pxi, pxj         their position indices
    """
    Qd: torch.Tensor
    Rd: torch.Tensor
    xf: torch.Tensor
    uf: torch.Tensor
    mu: torch.Tensor
    r: torch.Tensor
    pair_i: Tuple[int, ...] = ()
    pair_j: Tuple[int, ...] = ()
    pxi: Tuple[Tuple[int, ...], ...] = ()
    pxj: Tuple[Tuple[int, ...], ...] = ()


def expand_vector(v, inds, size, dtype, device):
    """Embed per-player vector ``v`` at ``inds`` of a zero vector."""
    out = torch.zeros((size,), dtype=dtype, device=device)
    out[list(inds)] = torch.as_tensor(v, dtype=dtype, device=device)
    return out


def game_objective(spec: ProblemSpec, Q, R, xf, uf, dtype,
                   device) -> GameObjective:
    """``Q[i]`` is a length-ni diagonal, ``R[i]`` length-mi, ``xf[i]`` /
    ``uf[i]`` the player's own targets; each is embedded at ``pz[i]`` /
    ``pu[i]``.  No collision-cost pairs."""
    def stack(vs, idx, size):
        return torch.stack([expand_vector(vs[i], idx[i], size, dtype, device)
                            for i in range(spec.p)])
    empty = torch.zeros((0,), dtype=dtype, device=device)
    return GameObjective(Qd=stack(Q, spec.pz, spec.n),
                         Rd=stack(R, spec.pu, spec.m),
                         xf=stack(xf, spec.pz, spec.n),
                         uf=stack(uf, spec.pu, spec.m), mu=empty, r=empty)


def add_collision_cost(spec: ProblemSpec, obj: GameObjective, radius,
                       mu) -> GameObjective:
    """Append one CollisionCost per ordered player pair (i, j != i) with
    player i's weight ``mu[i]`` and radius ``radius[i]``."""
    p = spec.p
    radius = np.asarray(radius, np.float64)
    mu = np.asarray(mu, np.float64)
    if not radius.shape == mu.shape == (p,):
        raise ValueError("radius and mu need one entry per player")
    pairs = [(i, j) for i in range(p) for j in range(p) if j != i]

    def vec(vals):
        return torch.as_tensor(np.asarray(vals, np.float64),
                               dtype=obj.Qd.dtype, device=obj.Qd.device)
    return dataclasses.replace(
        obj,
        mu=torch.cat([obj.mu, vec([mu[i] for i, _ in pairs])]),
        r=torch.cat([obj.r, vec([radius[i] for i, _ in pairs])]),
        pair_i=obj.pair_i + tuple(i for i, _ in pairs),
        pair_j=obj.pair_j + tuple(j for _, j in pairs),
        pxi=obj.pxi + tuple(spec.px[i] for i, _ in pairs),
        pxj=obj.pxj + tuple(spec.px[j] for _, j in pairs))


def _dt_scale(spec: ProblemSpec, dtype, device) -> torch.Tensor:
    """Per-knot expansion scale [N]: dt at stage knots, 1 at the terminal."""
    s = torch.full((spec.N,), spec.dt, dtype=dtype, device=device)
    s[-1] = 1.0
    return s


def _pair_terms(obj: GameObjective, idx: int, x: torch.Tensor, n: int,
                want_hess: bool):
    """Gradient g [B, N, d] and Hessian H [B, N, d, d] (or None) of pair
    ``idx`` with respect to player i's position, at every knot of ``x``
    [B, N, n]: the reference's epsilon-regularised expressions, active iff
    r - |delta| > 0,
      g = mu (r (eps + delta) / (eps_n + |delta|) - delta)
      H = mu (I - r I / |delta| + r delta delta^T / |delta|^3)
    with eps = 1e-10 and eps_n = eps sqrt(n)."""
    pxi, pxj = list(obj.pxi[idx]), list(obj.pxj[idx])
    mu, r = obj.mu[idx], obj.r[idx]
    eps_n = _PAIR_EPS * math.sqrt(n)
    delta = x[..., pxi] - x[..., pxj]                        # [B, N, d]
    dn = torch.linalg.vector_norm(delta, dim=-1)             # [B, N]
    active = (r - dn > 0.0).to(x.dtype)
    g = mu * (r * (_PAIR_EPS + delta) / (eps_n + dn)[..., None] - delta)
    g = g * active[..., None]
    if not want_hess:
        return g, None
    eye = torch.eye(len(pxi), dtype=x.dtype, device=x.device)
    dn_safe = torch.where(dn > 0, dn, torch.ones_like(dn))[..., None, None]
    H = mu * (eye - r * eye / dn_safe
              + r * delta[..., :, None] * delta[..., None, :] / dn_safe ** 3)
    return g, H * active[..., None, None]


def cost_gradient(spec: ProblemSpec, obj: GameObjective, traj: PrimalDual):
    """Per-player cost gradients: ``(qx [B, p, N, n], ru [B, p, T, m])``."""
    scale = _dt_scale(spec, traj.x.dtype, traj.x.device)
    qx = obj.Qd[:, None, :] * (traj.x[:, None] - obj.xf[:, None, :])
    qx = qx * scale[None, None, :, None]
    ru = obj.Rd[:, None, :] * (traj.u[:, None] - obj.uf[:, None, :]) * spec.dt
    for idx, i in enumerate(obj.pair_i):
        g, _ = _pair_terms(obj, idx, traj.x, spec.n, want_hess=False)
        g = g * scale[:, None]
        qi = qx[:, i]
        qi[..., list(obj.pxi[idx])] -= g
        qi[..., list(obj.pxj[idx])] += g
    return qx, ru


def cost_hessian(spec: ProblemSpec, obj: GameObjective, traj: PrimalDual):
    """Dense cost Hessians: ``(Qx [B, p, N, n, n], Ru [p, m, m])``, the
    state blocks per lane (the collision pairs depend on the trajectory),
    Ru shared by all lanes and the same at every stage knot."""
    n = spec.n
    dtype, device = traj.x.dtype, traj.x.device
    scale = _dt_scale(spec, dtype, device)
    eye = torch.eye(n, dtype=dtype, device=device)
    Qx = (obj.Qd[:, None, :] * scale[None, :, None])[..., None] * eye
    Qx = Qx.repeat(traj.x.shape[0], 1, 1, 1, 1)
    for idx, i in enumerate(obj.pair_i):
        _, H = _pair_terms(obj, idx, traj.x, n, want_hess=True)
        H = H * scale[:, None, None]
        # [[H, -H], [-H, H]] on the (pxi, pxj) rows and columns; the
        # targets are distinct, so the add is a plain gather + scatter.
        blk = torch.cat([torch.cat([H, -H], dim=-1),
                         torch.cat([-H, H], dim=-1)], dim=-2)
        k = torch.as_tensor(obj.pxi[idx] + obj.pxj[idx], device=device)
        Qi = Qx[:, i]
        Qi[:, :, k[:, None], k[None, :]] += blk
    Ru = torch.diag_embed(obj.Rd * spec.dt)
    return Qx, Ru


def cost_hessian_diag(spec: ProblemSpec, obj: GameObjective, dtype, device):
    """Diagonal cost Hessians of an objective without collision-cost pairs,
    shared by all lanes: ``(Qx [p, N, n], Ru [p, m, m])`` (Ru is the same
    at every stage knot)."""
    if obj.pair_i:
        raise ValueError("collision-cost pairs make the Hessian dense")
    scale = _dt_scale(spec, dtype, device)
    Qx = obj.Qd[:, None, :] * scale[None, :, None]
    Ru = torch.diag_embed(obj.Rd * spec.dt)
    return Qx, Ru


def collision_stage_cost(obj: GameObjective, idx: int, x: torch.Tensor):
    """Collision cost of pair ``idx`` at states ``x`` [..., n]:
    ``0.5 mu max(0, r - |x_i - x_j|)^2``."""
    dn = torch.linalg.vector_norm(x[..., list(obj.pxi[idx])]
                                  - x[..., list(obj.pxj[idx])], dim=-1)
    return 0.5 * obj.mu[idx] * torch.clamp(obj.r[idx] - dn, min=0.0) ** 2


def total_cost(spec: ProblemSpec, obj: GameObjective, traj: PrimalDual,
               i: int) -> torch.Tensor:
    """Player i's total objective per lane [B]: the stage costs
    0.5 (x - xf)' Q (x - xf) dt + 0.5 (u - uf)' R (u - uf) dt, the terminal
    0.5 (x - xf)' Q (x - xf), and the collision costs owned by player i,
    dt-scaled as the stage costs."""
    dx = traj.x - obj.xf[i]
    du = traj.u - obj.uf[i]
    stage_x = 0.5 * (dx * obj.Qd[i] * dx).sum(dim=-1)          # [B, N]
    stage_u = 0.5 * (du * obj.Rd[i] * du).sum(dim=-1)          # [B, T]
    scale = _dt_scale(spec, traj.x.dtype, traj.x.device)
    J = (stage_x * scale).sum(dim=-1) + stage_u.sum(dim=-1) * spec.dt
    for idx, owner in enumerate(obj.pair_i):
        if owner == i:
            J = J + (collision_stage_cost(obj, idx, traj.x) * scale).sum(
                dim=-1)
    return J
