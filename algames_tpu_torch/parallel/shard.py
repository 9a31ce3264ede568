"""Scenario sharding over the ranks of a ``torch.distributed`` world
(counterpart of ``algames_tpu/parallel/shard.py``).

The Monte-Carlo scenario axis is split over a 2D device mesh of the
launched world (``parallel.ranks.run_ranks`` starts one): each rank solves
its rows locally (no traffic while it solves) and only the summary
statistics cross ranks, SUM for the counts and MAX for the worst dynamics
violation, as the JAX package's ``psum``/``pmax``.

Mesh axes:
  dp: scenario data parallelism (the throughput axis)
  mc: a second scenario axis kept apart so that a scheduler can map it to
      another link dimension; logically both are batch.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..problem.problem import GameProblem
from .batch import convergence_mask, divergence_mask, solve_many


def mesh_shape(nd: int) -> Tuple[int, int]:
    """(dp, mc) with nd = dp * mc: mc the largest divisor of nd up to
    sqrt(nd), dp as large as that leaves it."""
    mc = 1
    for cand in range(math.isqrt(nd), 0, -1):
        if nd % cand == 0:
            mc = cand
            break
    return nd // mc, mc


def make_mesh(n_devices: int | None = None,
              axes: Tuple[str, str] = ("dp", "mc"), device_type="cuda"):
    """A 2D ``DeviceMesh`` (dp-major) over the launched world, whose
    process group must exist.  ``n_devices`` and ``axes`` are kept for
    parity with the JAX package's ``make_mesh(n_devices, axes)``: the mesh
    always spans the whole world, so ``n_devices`` may only name its size
    (anything else raises)."""
    from torch.distributed.device_mesh import init_device_mesh
    nd = dist.get_world_size()
    if n_devices is not None and n_devices != nd:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a world "
                         f"of {nd} ranks")
    return init_device_mesh(device_type, mesh_shape(nd), mesh_dim_names=axes)


def _reduce(t: torch.Tensor, op, mesh) -> torch.Tensor:
    """``t`` reduced with ``op`` over every axis of ``mesh``."""
    for name in mesh.mesh_dim_names:
        dist.all_reduce(t, op=op, group=mesh.get_group(name))
    return t


def sharded_monte_carlo(prob: GameProblem, mesh, x0s: torch.Tensor,
                        method="thomas", chunk: int | None = None):
    """Solve a batch of scenarios split over ``mesh`` and reduce the
    summary statistics over all its axes.

    ``x0s`` [B, n], the same on every rank, with B divisible by the mesh
    size; each rank solves its rows (dp-major order) with ``solve_many``
    (``chunk`` lanes at a time).  Returns, on every rank, (trajectories
    [B, N, n], summary): ``converged_frac``, ``worst_dyn_vio``,
    ``divergence_frac``, ``mean_iters`` as 0-d tensors (the counts in f32,
    as the JAX package's).
    """
    nd = mesh.mesh.numel()
    Bsz = x0s.shape[0]
    if Bsz % nd:
        raise ValueError(f"{Bsz} scenarios do not split over {nd} ranks")
    ranks = mesh.mesh.flatten().tolist()
    pos = ranks.index(dist.get_rank())
    Bl = Bsz // nd
    res = solve_many(prob, x0s[pos * Bl:(pos + 1) * Bl], method=method,
                     chunk=chunk)
    opts = prob.opts
    ok = convergence_mask(res, opts)
    # Failure detection: non-finite lanes are counted, never fatal.
    bad = divergence_mask(res)
    it = torch.clamp(res.stats.iter.long() - 1, min=0)[:, None]
    dyn = res.stats.dyn_vio.gather(1, it)[:, 0]
    f32 = dict(dtype=torch.float32, device=x0s.device)
    n_ok = _reduce(ok.to(torch.float32).sum(), dist.ReduceOp.SUM, mesh)
    n_tot = _reduce(torch.tensor(float(Bl), **f32), dist.ReduceOp.SUM, mesh)
    n_bad = _reduce(bad.to(torch.float32).sum(), dist.ReduceOp.SUM, mesh)
    worst_dyn = _reduce(dyn.max(), dist.ReduceOp.MAX, mesh)
    n_iter = _reduce(res.stats.iter.to(torch.float32).sum(),
                     dist.ReduceOp.SUM, mesh)
    summary = {"converged_frac": n_ok / n_tot, "worst_dyn_vio": worst_dyn,
               "divergence_frac": n_bad / n_tot, "mean_iters": n_iter / n_tot}
    x = res.traj.x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    trajs = torch.cat([parts[r] for r in ranks])
    return trajs, summary
