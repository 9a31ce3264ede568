"""p-player d-dimensional double integrator game (counterpart of
``algames_tpu/models/double_integrator.py``).

State = [positions (d p, interleaved); velocities (d p)], control =
accelerations (d p); ``xdot = [x[m:], u]`` on the last axis.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import GameModel, interleaved_indices


@dataclasses.dataclass(frozen=True)
class DoubleIntegratorGame(GameModel):
    d: int = 2

    def dynamics(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., self.m:], u], dim=-1)


def double_integrator_game(p: int = 2, d: int = 2) -> DoubleIntegratorGame:
    return DoubleIntegratorGame(
        n=2 * d * p, m=d * p, p=p,
        ni=(2 * d,) * p, mi=(d,) * p,
        pu=interleaved_indices(p, d),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 2 * d),
        d=d,
    )
