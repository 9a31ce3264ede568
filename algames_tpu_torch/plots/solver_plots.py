"""Trajectory and convergence plots (counterpart of
``algames_tpu/plots/solver_plots.py``, after the reference's Plots.jl
recipes, ``src/plots/solver_plots.jl:18-120``): XY trajectories per player
and the log10 violation history shaded per AL outer epoch, of one lane of
a batched result, copied to numpy for display.  matplotlib is imported when
a plot is drawn (display and export only, never on the solve path); the
Axes are returned so that callers can save or show them.
"""
from __future__ import annotations

import numpy as np


def plot_trajectory(spec, traj, ax=None, labels=True, lane: int = 0):
    """XY position traces per player of ``traj``'s lane ``lane`` (reference
    ``recipe_traj``, ``solver_plots.jl:18-35``).  Returns the Axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    X = traj.x[lane].detach().cpu().numpy()
    for i in range(spec.p):
        px = np.asarray(spec.px[i])
        ax.plot(X[:, px[0]], X[:, px[1]], marker="o", ms=3,
                label=f"player {i}" if labels else None)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_aspect("equal", adjustable="datalim")
    if labels:
        ax.legend()
    return ax


def plot_violations(stats, ax=None, lane: int = 0):
    """log10 of the four violation maxima of lane ``lane`` vs inner
    iteration, with outer epochs shaded (reference ``recipe_violation``,
    ``solver_plots.jl:83-120``).  Returns the Axes."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    it = int(stats.iter[lane])
    eps = 1e-20
    xs = np.arange(it)
    for name in ("dyn_vio", "con_vio", "sta_vio", "opt_vio"):
        series = getattr(stats, name)[lane].detach().cpu().numpy()
        ax.plot(xs, np.log10(series[:it] + eps), label=name[:3])
    outer = stats.outer[lane].cpu().numpy()[:it]
    for k in np.unique(outer):
        sel = np.where(outer == k)[0]
        if len(sel) and k % 2 == 0:
            ax.axvspan(sel[0] - 0.5, sel[-1] + 0.5, alpha=0.08, color="gray")
    ax.set_xlabel("inner iteration")
    ax.set_ylabel("log10 violation")
    ax.legend()
    return ax
