"""Problem-shape specification (counterpart of ``algames_tpu/core/spec.py``).

Layout conventions (0-based, horizon T = N-1), identical to the reference
package:

Flat primal-dual vector, per knot k in 0..T-1::

    [ x_{k+1} (n) | u_k (m) | lam_{0,k} (n) ... lam_{p-1,k} (n) ]

``S = n*p*T + m*T + n*T`` and the per-knot KKT block width is
``W = n + m + p*n``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static problem shape (hashable)."""

    N: int                      # number of knot points
    n: int                      # full state dimension
    m: int                      # full control dimension
    p: int                      # number of players
    ni: Tuple[int, ...]         # per-player state dims
    mi: Tuple[int, ...]         # per-player control dims
    pu: Tuple[Tuple[int, ...], ...]  # per-player control indices into 0..m-1
    px: Tuple[Tuple[int, ...], ...]  # per-player position indices into 0..n-1
    pz: Tuple[Tuple[int, ...], ...]  # per-player state indices into 0..n-1
    dt: float                   # uniform time step

    @property
    def T(self) -> int:
        """Horizon: number of dynamics intervals (N-1)."""
        return self.N - 1

    @property
    def S(self) -> int:
        """Primal-dual vector size."""
        return self.n * self.p * self.T + self.m * self.T + self.n * self.T

    @property
    def W(self) -> int:
        """Per-knot KKT block width: [x_{k+1}; u_k; lam_{0..p-1,k}]."""
        return self.n + self.m + self.p * self.n

    @property
    def homogeneous(self) -> bool:
        return len(set(self.ni)) == 1 and len(set(self.mi)) == 1

    # Flat column offsets in knot block k (0..T-1): x_{k+1} at 0, u_k at n,
    # lam_{i,k} at n + m + i n.
    def col_x(self, k: int) -> int:
        return k * self.W

    def col_u(self, k: int) -> int:
        return k * self.W + self.n

    def col_lam(self, i: int, k: int) -> int:
        return k * self.W + self.n + self.m + i * self.n

    # Flat row offsets of the reference's row order: player-major (per knot
    # the n statx rows, then the player's mi statu rows), then the dynamics.
    def _player_row_base(self, i: int) -> int:
        return sum((self.n + self.mi[j]) * self.T for j in range(i))

    def row_stat_x(self, i: int, k: int) -> int:
        return self._player_row_base(i) + k * (self.n + self.mi[i])

    def row_stat_u(self, i: int, k: int) -> int:
        return self.row_stat_x(i, k) + self.n

    def row_dyn(self, k: int) -> int:
        return self._player_row_base(self.p) + k * self.n

    def __post_init__(self):
        if self.N < 2:
            raise ValueError("need at least one dynamics interval")
        if not (self.p == len(self.ni) == len(self.mi) == len(self.pu)
                == len(self.px) == len(self.pz)):
            raise ValueError("per-player index tuples must have p entries")
        if sum(self.mi) != self.m:
            raise ValueError("sum(mi) must equal m")


def spec_from_model(model, N: int, dt: float) -> ProblemSpec:
    """Build a ProblemSpec from a game model."""
    return ProblemSpec(
        N=N, n=model.n, m=model.m, p=model.p,
        ni=tuple(model.ni), mi=tuple(model.mi),
        pu=tuple(tuple(ix) for ix in model.pu),
        px=tuple(tuple(ix) for ix in model.px),
        pz=tuple(tuple(ix) for ix in model.pz),
        dt=float(dt),
    )


def owner_map_u(spec: ProblemSpec) -> Tuple[int, ...]:
    """owner[j] = player owning control index j."""
    owner = [0] * spec.m
    for i in range(spec.p):
        for j in spec.pu[i]:
            owner[j] = i
    return tuple(owner)
