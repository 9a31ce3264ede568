"""Trajectory and convergence plots, and the procedural quadrotor mesh;
matplotlib is imported only when a plot is drawn."""
from .solver_plots import plot_trajectory, plot_violations

__all__ = ["plot_trajectory", "plot_violations"]
