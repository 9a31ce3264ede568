"""Constraint families of the unicycle games: pairwise collision avoidance,
static circular obstacles and box bounds on states or controls (counterpart
of ``algames_tpu/constraints/kernels.py``).

    evaluate(par, z)  -> vals [B, K, C]
    jacobian(par, z)  -> jac  [B, K, C, dim]

where ``z`` [B, K, dim] stacks the states (or controls) at the applied
knots.  All constraints are inequalities, feasible iff ``c <= 0``.  Family
parameters are shared by every lane and carry no batch axis.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CollisionParams:
    """c = r^2 - |x_i - x_j|^2  (C = 1)."""
    radius: torch.Tensor              # 0-d
    pxi: Tuple[int, ...]
    pxj: Tuple[int, ...]


def collision_evaluate(par: CollisionParams, xs: torch.Tensor) -> torch.Tensor:
    d = xs[..., list(par.pxi)] - xs[..., list(par.pxj)]          # [B, K, d]
    return par.radius ** 2 - (d * d).sum(dim=-1, keepdim=True)   # [B, K, 1]


def collision_jacobian(par: CollisionParams, xs: torch.Tensor) -> torch.Tensor:
    d = xs[..., list(par.pxi)] - xs[..., list(par.pxj)]
    jac = xs.new_zeros(xs.shape[:-1] + (1, xs.shape[-1]))
    jac[..., 0, list(par.pxi)] = -2.0 * d
    jac[..., 0, list(par.pxj)] = 2.0 * d
    return jac


@dataclasses.dataclass
class CircleParams:
    """c_j = r_j^2 - (x - xc_j)^2 - (y - yc_j)^2  (C = number of circles)."""
    xc: torch.Tensor                  # [C]
    yc: torch.Tensor                  # [C]
    radius: torch.Tensor              # [C]
    xi: int                           # state index of the x coordinate
    yi: int


def _circle_offsets(par: CircleParams, xs: torch.Tensor):
    return xs[..., par.xi, None] - par.xc, xs[..., par.yi, None] - par.yc


def circle_evaluate(par: CircleParams, xs: torch.Tensor) -> torch.Tensor:
    dx, dy = _circle_offsets(par, xs)
    return par.radius ** 2 - dx * dx - dy * dy


def circle_jacobian(par: CircleParams, xs: torch.Tensor) -> torch.Tensor:
    dx, dy = _circle_offsets(par, xs)
    jac = xs.new_zeros(dx.shape + (xs.shape[-1],))
    jac[..., par.xi] = -2.0 * dx
    jac[..., par.yi] = -2.0 * dy
    return jac


@dataclasses.dataclass
class BoundParams:
    """Box bound c = [z - z_max; z_min - z] with infinite rows masked out:
    masked rows evaluate to exactly 0 with a zero Jacobian, so they add
    nothing to AL gradients, duals or violations."""
    z_max: torch.Tensor               # [dim] (infinities replaced by 0)
    z_min: torch.Tensor               # [dim]
    mask: Tuple[bool, ...]            # [2*dim] finite-bound flags


def make_bound(z_max, z_min, dtype, device) -> BoundParams:
    z_max = np.asarray(z_max, dtype=np.float64)
    z_min = np.asarray(z_min, dtype=np.float64)
    if not np.all(z_max >= z_min):
        raise ValueError("upper bounds must be >= lower bounds")
    mask = tuple(bool(b) for b in np.isfinite(np.concatenate([z_max, z_min])))
    zmx = np.where(np.isfinite(z_max), z_max, 0.0)
    zmn = np.where(np.isfinite(z_min), z_min, 0.0)
    return BoundParams(z_max=torch.as_tensor(zmx, dtype=dtype, device=device),
                       z_min=torch.as_tensor(zmn, dtype=dtype, device=device),
                       mask=mask)


def bound_evaluate(par: BoundParams, zs: torch.Tensor) -> torch.Tensor:
    c = torch.cat([zs - par.z_max, par.z_min - zs], dim=-1)
    mask = torch.as_tensor(par.mask, device=zs.device)
    return torch.where(mask, c, torch.zeros((), dtype=c.dtype,
                                            device=c.device))


def bound_jacobian(par: BoundParams, zs: torch.Tensor) -> torch.Tensor:
    dim = zs.shape[-1]
    eye = torch.eye(dim, dtype=zs.dtype, device=zs.device)
    mask = torch.as_tensor(par.mask, dtype=zs.dtype, device=zs.device)
    J = torch.cat([eye, -eye], dim=0) * mask[:, None]
    return J.expand(zs.shape[:-1] + (2 * dim, dim))


EVALUATE = {CollisionParams: collision_evaluate,
            CircleParams: circle_evaluate, BoundParams: bound_evaluate}
JACOBIAN = {CollisionParams: collision_jacobian,
            CircleParams: circle_jacobian, BoundParams: bound_jacobian}


def evaluate(par, zs):
    return EVALUATE[type(par)](par, zs)


def jacobian(par, zs):
    return JACOBIAN[type(par)](par, zs)


def num_rows(par) -> int:
    """Static number of constraint rows C of a family instance."""
    if isinstance(par, CollisionParams):
        return 1
    if isinstance(par, CircleParams):
        return int(par.xc.shape[0])
    if isinstance(par, BoundParams):
        return 2 * int(par.z_max.shape[0])
    raise TypeError(type(par))
