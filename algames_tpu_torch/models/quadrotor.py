"""p-player quadrotor game with MRP attitude (counterpart of
``algames_tpu/models/quadrotor.py``).

Per-player state ``[x, y, z, mrp1..3, vx..vz, wx..wz]``, control the four
rotor speeds, both interleaved across players (component c of player i at
c p + i).  Rotor thrust ``F = max(0, kf w)``, or ``softplus(beta kf w) /
beta`` with ``thrust_smoothing = beta > 0``.  The clamp is ``torch.maximum``
because its derivative at the kink (kf w == 0, where a solve from the zero
initial controls starts) is 0.5, as in the reference package; ``clamp`` and
``relu`` give 1 and 0 there.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .base import GameModel, interleaved_indices


def _skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix: v [..., 3] -> [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def mrp_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a Modified Rodrigues Parameter vector q [..., 3]:
    ``R = I + (8 S^2 + 4 (1 - |q|^2) S) / (1 + |q|^2)^2``, S = skew(q)."""
    s = _skew(q)
    n2 = (q * q).sum(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(s.shape)
    return eye + (8.0 * (s @ s) + 4.0 * (1.0 - n2) * s) / (1.0 + n2) ** 2


def mrp_kinematics(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """MRP attitude kinematics
    ``qdot = 0.25 ((1 - q'q) I + 2 skew(q) + 2 q q') w`` on the last axis."""
    n2 = (q * q).sum(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    mat = 0.25 * ((1.0 - n2) * eye + 2.0 * _skew(q)
                  + 2.0 * q[..., :, None] * q[..., None, :])
    return (mat @ w[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class QuadrotorGame(GameModel):
    mass: float = 0.5
    J: Tuple[float, float, float] = (0.0023, 0.0023, 0.004)
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    motor_dist: float = 0.1750
    kf: float = 1.245
    km: float = 1.0
    thrust_smoothing: float = 0.0

    def dynamics(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p = self.p
        lead = x.shape[:-1]
        xs = x.reshape(lead + (12, p)).transpose(-1, -2)      # [..., p, 12]
        us = u.reshape(lead + (4, p)).transpose(-1, -2)       # [..., p, 4]
        q, v, w = xs[..., 3:6], xs[..., 6:9], xs[..., 9:12]
        J = torch.as_tensor(self.J, dtype=x.dtype, device=x.device)
        g = torch.as_tensor(self.gravity, dtype=x.dtype, device=x.device)
        if self.thrust_smoothing > 0.0:
            beta = self.thrust_smoothing
            F_rot = torch.logaddexp(beta * self.kf * us,
                                    torch.zeros_like(us)) / beta
        else:
            F_rot = torch.maximum(torch.zeros_like(us), self.kf * us)
        zero = torch.zeros_like(F_rot[..., 0])
        F_body = torch.stack([zero, zero, F_rot.sum(dim=-1)], dim=-1)
        M_rot = self.km * us
        L = self.motor_dist
        tau = torch.stack([
            L * (F_rot[..., 1] - F_rot[..., 3]),
            L * (F_rot[..., 2] - F_rot[..., 0]),
            M_rot[..., 0] - M_rot[..., 1] + M_rot[..., 2] - M_rot[..., 3],
        ], dim=-1)
        R = mrp_rotation_matrix(q)
        f_world = self.mass * g + (R @ F_body[..., None])[..., 0]
        qdot = mrp_kinematics(q, w)
        vdot = f_world / self.mass
        wdot = (tau - torch.linalg.cross(w, J * w, dim=-1)) / J
        ds = torch.cat([v, qdot, vdot, wdot], dim=-1)          # [..., p, 12]
        return ds.transpose(-1, -2).reshape(lead + (12 * p,))


def quadrotor_game(p: int = 2, mass: float = 0.5,
                   thrust_smoothing: float = 0.0) -> QuadrotorGame:
    return QuadrotorGame(
        n=12 * p, m=4 * p, p=p,
        ni=(12,) * p, mi=(4,) * p,
        pu=interleaved_indices(p, 4),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 12),
        mass=mass, thrust_smoothing=thrust_smoothing,
    )
