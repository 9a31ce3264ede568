"""Rank functions of the port's distributed tests (``test_torch_horizon.py``,
``test_torch_shard.py``), run by ``parallel.run_ranks`` in spawned gloo
processes on the CPU.  This module imports no JAX: each rank imports it
alone.  Every function takes (rank, device, ...) and returns what the test
compares, on every rank."""
import torch.distributed as dist

from algames_tpu_torch.parallel import (make_mesh, sharded_monte_carlo,
                                        solve_tridiagonal_sharded,
                                        spike_kkt_method)
from algames_tpu_torch.problem.solver import newton_solve


def spike_world(rank, device, spec, systems, bad, prob):
    """``solve_tridiagonal_sharded`` on each (D, U, L, b) of ``systems``
    over groups of 1 and 2 ranks and over the world (every rank creates
    every group; a rank outside a group gives None for it); whether the
    system ``bad`` = (spec, D, U, L, b), whose T does not split over the
    world, raises ValueError; and ``spike_newton`` of ``prob``."""
    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]),
              dist.get_world_size(): None}
    out = {}
    for size, group in groups.items():
        if group is not None and rank >= size:
            out[size] = None
            continue
        out[size] = [solve_tridiagonal_sharded(spec, D, U, L, b, group)
                     for D, U, L, b in systems]
    try:
        solve_tridiagonal_sharded(*bad)
        out["raised"] = False
    except ValueError:
        out["raised"] = True
    out["newton"] = spike_newton(rank, device, prob)
    return out


def spike_newton(rank, device, prob):
    """``newton_solve`` of ``prob`` through the horizon-split KKT step over
    the world: (x, stats rows per lane)."""
    res = newton_solve(prob, method=spike_kkt_method())
    return res.traj.x, res.stats.iter


def shard_monte_carlo(rank, device, prob, x0s, method):
    """``sharded_monte_carlo`` of ``x0s`` over a mesh of the world: (mesh
    shape, trajectories, summary)."""
    mesh = make_mesh(device_type=device.type)
    trajs, summary = sharded_monte_carlo(prob, mesh, x0s.to(device), method)
    return tuple(mesh.mesh.shape), trajs, summary
