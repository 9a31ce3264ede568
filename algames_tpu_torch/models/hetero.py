"""Heterogeneous-dimension double-integrator game (counterpart of
``algames_tpu/models/hetero.py``).

Player i is a d-dimensional double integrator that actuates only its FIRST
``mi[i]`` acceleration components (``mi[i] <= d``); the rest coast.  The
layout is player-blocked: player i's state is ``[pos (d); vel (d)]`` at
``2 d i .. 2 d (i+1) - 1`` and its controls are packed
``[u_0 (mi_0) | u_1 (mi_1) | ...]``.  With unequal ``mi`` the spec is not
homogeneous: the KKT sweep pads every player's controls to ``max(mi)``
(``problem/linear_solver.py``, ``ops/thomas.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .base import GameModel


@dataclasses.dataclass(frozen=True)
class HeteroDoubleIntegratorGame(GameModel):
    d: int = 2

    def dynamics(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        d = self.d
        parts = []
        for i in range(self.p):
            zi = x[..., 2 * d * i:2 * d * (i + 1)]
            ui = u[..., list(self.pu[i])]
            acc = torch.cat([ui, ui.new_zeros(ui.shape[:-1]
                                              + (d - self.mi[i],))], dim=-1)
            parts.append(torch.cat([zi[..., d:], acc], dim=-1))
        return torch.cat(parts, dim=-1)


def hetero_double_integrator_game(mi: Tuple[int, ...] = (2, 1),
                                  d: int = 2) -> HeteroDoubleIntegratorGame:
    """p = len(mi) players; player i actuates ``mi[i] <= d`` dimensions."""
    p = len(mi)
    if not all(1 <= k <= d for k in mi):
        raise ValueError("every player needs 1 <= mi <= d")
    offs = [sum(mi[:i]) for i in range(p)]
    return HeteroDoubleIntegratorGame(
        n=2 * d * p, m=sum(mi), p=p,
        ni=(2 * d,) * p, mi=tuple(mi),
        pu=tuple(tuple(range(offs[i], offs[i] + mi[i])) for i in range(p)),
        px=tuple(tuple(range(2 * d * i, 2 * d * i + 2)) for i in range(p)),
        pz=tuple(tuple(range(2 * d * i, 2 * d * (i + 1))) for i in range(p)),
        d=d,
    )
