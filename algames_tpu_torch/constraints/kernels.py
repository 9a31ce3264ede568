"""Constraint families: pairwise collision avoidance (planar or spherical),
static circular obstacles, 2D wall segments, 3D wall facets, axis-aligned
cylinders and box bounds on states or controls (counterpart of
``algames_tpu/constraints/kernels.py``).

    evaluate(par, z)  -> vals [B, K, C]
    jacobian(par, z)  -> jac  [B, K, C, dim]

where ``z`` [B, K, dim] stacks the states (or controls) at the applied
knots.  All constraints are inequalities, feasible iff ``c <= 0``.  Family
parameters are shared by every lane and carry no batch axis.  The wall and
cylinder families are gated: outside a strict gate (``> 0``, and ``< l``
along a cylinder's axis) a row's value and Jacobian are exactly 0.
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
class Wall2DParams:
    """c_j = (x - x1_j) xv_j + (y - y1_j) yv_j while (x, y) projects strictly
    inside segment j (p1_j, p2_j), else 0 (C = number of walls)."""
    x1: torch.Tensor                  # [C]
    y1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    xv: torch.Tensor
    yv: torch.Tensor
    xi: int
    yi: int


def _wall2d_terms(par: Wall2DParams, xs: torch.Tensor):
    x, y = xs[..., par.xi, None], xs[..., par.yi, None]
    left = ((x - par.x1) * (par.x2 - par.x1)
            + (y - par.y1) * (par.y2 - par.y1)) > 0
    right = ((x - par.x2) * (par.x1 - par.x2)
             + (y - par.y2) * (par.y1 - par.y2)) > 0
    return x, y, left & right


def wall2d_evaluate(par: Wall2DParams, xs: torch.Tensor) -> torch.Tensor:
    x, y, gate = _wall2d_terms(par, xs)
    return ((x - par.x1) * par.xv + (y - par.y1) * par.yv) * gate


def wall2d_jacobian(par: Wall2DParams, xs: torch.Tensor) -> torch.Tensor:
    x, _, gate = _wall2d_terms(par, xs)
    g = gate.to(xs.dtype)
    jac = xs.new_zeros(x.shape[:-1] + (par.x1.shape[0], xs.shape[-1]))
    jac[..., par.xi] = g * par.xv
    jac[..., par.yi] = g * par.yv
    return jac


@dataclasses.dataclass
class Wall3DParams:
    """c_j = (p - p1_j) . v_j while p lies strictly inside the facet's four
    edge gates (corners p1_j, p2_j, p3_j), else 0 (C = number of walls)."""
    x1: torch.Tensor                  # [C]
    y1: torch.Tensor
    z1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    z2: torch.Tensor
    x3: torch.Tensor
    y3: torch.Tensor
    z3: torch.Tensor
    xv: torch.Tensor
    yv: torch.Tensor
    zv: torch.Tensor
    xi: int
    yi: int
    zi: int


def _wall3d_terms(par: Wall3DParams, xs: torch.Tensor):
    x, y, z = (xs[..., par.xi, None], xs[..., par.yi, None],
               xs[..., par.zi, None])

    def side(a, b):        # (p - a) . (b - a) > 0
        ax, ay, az = a
        bx, by, bz = b
        return ((x - ax) * (bx - ax) + (y - ay) * (by - ay)
                + (z - az) * (bz - az)) > 0
    p1 = (par.x1, par.y1, par.z1)
    p2 = (par.x2, par.y2, par.z2)
    p3 = (par.x3, par.y3, par.z3)
    gate = side(p1, p2) & side(p2, p1) & side(p3, p2) & side(p2, p3)
    return x, y, z, gate


def wall3d_evaluate(par: Wall3DParams, xs: torch.Tensor) -> torch.Tensor:
    x, y, z, gate = _wall3d_terms(par, xs)
    out = (x - par.x1) * par.xv + (y - par.y1) * par.yv + (z - par.z1) * par.zv
    return out * gate


def wall3d_jacobian(par: Wall3DParams, xs: torch.Tensor) -> torch.Tensor:
    x, _, _, gate = _wall3d_terms(par, xs)
    g = gate.to(xs.dtype)
    jac = xs.new_zeros(x.shape[:-1] + (par.x1.shape[0], xs.shape[-1]))
    jac[..., par.xi] = g * par.xv
    jac[..., par.yi] = g * par.yv
    jac[..., par.zi] = g * par.zv
    return jac


@dataclasses.dataclass
class CylinderParams:
    """Axis-aligned finite cylinder j (base (p1, p2, p3)_j, length l_j,
    radius r_j, ``axis[j]`` 0/1/2 for x/y/z): c_j = r_j^2 minus the squared
    distance to the axis while the position along the axis lies strictly in
    (0, l_j), else 0 (C = number of cylinders)."""
    p1: torch.Tensor                  # [C]
    p2: torch.Tensor
    p3: torch.Tensor
    l: torch.Tensor
    r: torch.Tensor
    axis: Tuple[int, ...]
    xi: int
    yi: int
    zi: int


def _cylinder_terms(par: CylinderParams, xs: torch.Tensor):
    t0 = (xs[..., par.xi, None] - par.p1, xs[..., par.yi, None] - par.p2,
          xs[..., par.zi, None] - par.p3)
    ax = torch.as_tensor(par.axis, device=xs.device)
    is_ax = tuple((ax == a).to(xs.dtype) for a in range(3))
    valid = torch.zeros(t0[0].shape, dtype=torch.bool, device=xs.device)
    for a in range(3):
        valid = valid | ((ax == a) & (t0[a] > 0.0) & (t0[a] < par.l))
    return t0, is_ax, valid


def cylinder_evaluate(par: CylinderParams, xs: torch.Tensor) -> torch.Tensor:
    t0, is_ax, valid = _cylinder_terms(par, xs)
    out = par.r ** 2 - t0[0] ** 2 - t0[1] ** 2 - t0[2] ** 2
    for a in range(3):
        out = out + is_ax[a] * t0[a] ** 2
    return out * valid


def cylinder_jacobian(par: CylinderParams, xs: torch.Tensor) -> torch.Tensor:
    t0, is_ax, valid = _cylinder_terms(par, xs)
    v = valid.to(xs.dtype)
    jac = xs.new_zeros(t0[0].shape + (xs.shape[-1],))
    for a, idx in enumerate((par.xi, par.yi, par.zi)):
        jac[..., idx] = -v * 2.0 * t0[a] * (1.0 - is_ax[a])
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
            CircleParams: circle_evaluate, Wall2DParams: wall2d_evaluate,
            Wall3DParams: wall3d_evaluate, CylinderParams: cylinder_evaluate,
            BoundParams: bound_evaluate}
JACOBIAN = {CollisionParams: collision_jacobian,
            CircleParams: circle_jacobian, Wall2DParams: wall2d_jacobian,
            Wall3DParams: wall3d_jacobian, CylinderParams: cylinder_jacobian,
            BoundParams: bound_jacobian}


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
    if isinstance(par, (Wall2DParams, Wall3DParams)):
        return int(par.x1.shape[0])
    if isinstance(par, CylinderParams):
        return int(par.p1.shape[0])
    if isinstance(par, BoundParams):
        return 2 * int(par.z_max.shape[0])
    raise TypeError(type(par))
