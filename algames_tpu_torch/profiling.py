"""Device profiling helpers (counterpart of ``algames_tpu/profiling.py``):
wall timers around synchronised device work, a ``torch.profiler`` trace
context, and the per-trip timed solve (the reference's
``Statistics.t_elap``, ``src/problem/solver_methods.jl:40-41``)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

from .utils import tree_leaves


def _synchronize(out) -> None:
    """Wait for the cards that hold a tensor of ``out``."""
    for dev in {a.device for a in tree_leaves(out) if a.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed work with ``torch.profiler`` (the CPU, and the
    card's kernels where CUDA is available) and write a Chrome trace,
    ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_blocked(fn: Callable, *args, reps: int = 10, warmup: int = 1,
                 **kwargs) -> float:
    """Median wall seconds of ``fn(*args)``, each call synchronised on the
    devices of its outputs."""
    for _ in range(warmup):
        _synchronize(fn(*args, **kwargs))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def phase_profile(phases: Dict[str, Callable], reps: int = 10) -> Dict[str, float]:
    """Time a dict of thunks; returns {name: median_seconds}."""
    return {name: time_blocked(fn, reps=reps) for name, fn in phases.items()}


def timed_solve(prob, x0s=None, method="thomas",
                generator: torch.Generator | None = None):
    """``newton_solve`` with one wall time per trip of its loop (one inner
    iteration of every active lane): the same ``solver.solve_start``,
    ``solve_trip`` and ``solve_finalize``, each trip synchronised on the
    card, so the result is bitwise ``newton_solve``'s.  One host sync per
    trip: for diagnostics, not throughput.  Returns ``(SolveResult,
    t_elap)``, ``t_elap`` a list of seconds, one per trip."""
    from .problem.solver import solve_finalize, solve_start, solve_trip
    kkt, w_owner, c = solve_start(prob, x0s, method, generator=generator)
    _synchronize(c)
    t_elap = []
    while True:
        t0 = time.perf_counter()
        new = solve_trip(prob, kkt, w_owner, c)
        if new is None:
            break
        _synchronize(new.traj)
        t_elap.append(time.perf_counter() - t0)
        c = new
    return solve_finalize(prob, c), t_elap
