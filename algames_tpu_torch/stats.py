"""Per-lane solver statistics (counterpart of ``algames_tpu/stats.py``).

A fixed-capacity record per lane (capacity = the iteration budget + 1);
``iter`` [B] counts each lane's valid rows, and each record writes at its
own lane's row.
"""
from __future__ import annotations

import dataclasses

import torch

_COLS = ("res", "delta", "alpha", "dyn_vio", "con_vio", "sta_vio", "opt_vio")


@dataclasses.dataclass
class Statistics:
    iter: torch.Tensor      # [B] int32: number of valid records
    outer: torch.Tensor     # [B, M] outer-iteration index of each record
    data: torch.Tensor      # [B, M, 7] float columns, see _COLS

    def column(self, name: str) -> torch.Tensor:
        """[B, M] view of one float column."""
        return self.data[..., _COLS.index(name)]

    @property
    def res(self):
        return self.column("res")

    @property
    def dyn_vio(self):
        return self.column("dyn_vio")

    @property
    def con_vio(self):
        return self.column("con_vio")

    @property
    def sta_vio(self):
        return self.column("sta_vio")

    @property
    def opt_vio(self):
        return self.column("opt_vio")


def init_stats(B: int, capacity: int, dtype, device) -> Statistics:
    return Statistics(
        iter=torch.zeros((B,), dtype=torch.int32, device=device),
        outer=torch.zeros((B, capacity), dtype=torch.int32, device=device),
        data=torch.zeros((B, capacity, len(_COLS)), dtype=dtype,
                         device=device))


def print_stats(stats: Statistics, lane: int = 0, header: bool = True) -> None:
    """Console table of one lane's recorded iterations (reference
    ``display_solver_header/data``, ``src/utils.jl:37-61``), in the JAX
    package's columns and format."""
    from .utils import scn

    it = int(stats.iter[lane])
    outer = stats.outer[lane].tolist()
    data = stats.data[lane].double().tolist()
    if header:
        print(f"{'out':<4} {'res':<9} {'Δ':<9} {'dyn':<9} {'con':<9} "
              f"{'sta':<9} {'opt':<9}")
    for i in range(it):
        row = data[i]
        print(f"{outer[i]:<4} {scn(row[0]):<9} {scn(row[1]):<9} "
              f"{scn(row[3]):<9} {scn(row[4]):<9} {scn(row[5]):<9} "
              f"{scn(row[6]):<9}")


def record(stats: Statistics, active, outer, res, delta, alpha,
           dyn_vio, con_vio, sta_vio, opt_vio) -> Statistics:
    """Append one record on the lanes where ``active`` [B] holds.  Every
    value is [B] (or a scalar).  At capacity the last row keeps being
    overwritten and ``iter`` saturates."""
    B, cap, _ = stats.data.shape
    i = torch.clamp(stats.iter, max=cap - 1)
    row = torch.stack([torch.as_tensor(v, dtype=stats.data.dtype,
                                       device=stats.data.device).expand(B)
                       for v in (res, delta, alpha, dyn_vio, con_vio,
                                 sta_vio, opt_vio)], dim=1)      # [B, 7]
    active = torch.as_tensor(active, device=stats.data.device).expand(B)
    hit = ((torch.arange(cap, device=stats.data.device)[None, :] == i[:, None])
           & active[:, None])                                   # [B, cap]
    outer = torch.as_tensor(outer, dtype=torch.int32,
                            device=stats.data.device).expand(B)
    return Statistics(
        iter=torch.where(active, torch.clamp(stats.iter + 1, max=cap),
                         stats.iter),
        outer=torch.where(hit, outer[:, None], stats.outer),
        data=torch.where(hit[:, :, None], row[:, None, :], stats.data))
