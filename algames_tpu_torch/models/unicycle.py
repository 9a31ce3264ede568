"""p-player unicycle game (counterpart of ``algames_tpu/models/unicycle.py``).

Per-player state ``[x, y, theta, v]`` interleaved across players; control
``[omega, a]``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import GameModel, interleaved_indices


@dataclasses.dataclass(frozen=True)
class UnicycleGame(GameModel):

    def dynamics(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        p = self.p
        th = x[..., 2 * p:3 * p]
        v = x[..., 3 * p:4 * p]
        # xd_i = cos(theta_i) v_i, yd_i = sin(theta_i) v_i, (thd, vd) = u
        return torch.cat([torch.cos(th) * v, torch.sin(th) * v, u], dim=-1)

    def velocity_index(self, i: int) -> int:
        """State index of player i's speed."""
        return self.pz[i][3]


def unicycle_game(p: int = 2) -> UnicycleGame:
    return UnicycleGame(
        n=4 * p, m=2 * p, p=p,
        ni=(4,) * p, mi=(2,) * p,
        pu=interleaved_indices(p, 2),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 4),
    )
