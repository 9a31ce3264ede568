"""p-player kinematic bicycle game (counterpart of
``algames_tpu/models/bicycle.py``).

Per-player state ``[x, y, v, psi]``, control ``[a, delta]``, interleaved
across players; slip angle ``beta = atan2(lr tan(delta), lr + lf)``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import GameModel, interleaved_indices


@dataclasses.dataclass(frozen=True)
class BicycleGame(GameModel):
    lf: float = 0.05
    lr: float = 0.05

    def dynamics(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p = self.p
        v = x[..., 2 * p:3 * p]
        psi = x[..., 3 * p:4 * p]
        a = u[..., :p]
        delta = u[..., p:2 * p]
        beta = torch.atan2(self.lr * torch.tan(delta),
                           torch.full_like(delta, self.lr + self.lf))
        return torch.cat([v * torch.cos(beta + psi), v * torch.sin(beta + psi),
                          a, v * torch.sin(beta) / self.lr], dim=-1)

    def velocity_index(self, i: int) -> int:
        """State index of player i's speed."""
        return self.pz[i][2]


def bicycle_game(p: int = 2, lf: float = 0.05, lr: float = 0.05) -> BicycleGame:
    return BicycleGame(
        n=4 * p, m=2 * p, p=p,
        ni=(4,) * p, mi=(2,) * p,
        pu=interleaved_indices(p, 2),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 4),
        lf=lf, lr=lr,
    )
