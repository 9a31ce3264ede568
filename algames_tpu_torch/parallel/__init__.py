"""Scenario-batch solving, scenario sharding and the horizon-split KKT
solve over a world of ranks (``ranks.run_ranks``)."""
from .batch import (convergence_fraction, convergence_mask, divergence_mask,
                    solve_batch, solve_many)
from .horizon import solve_tridiagonal_sharded, spike_kkt_method
from .ranks import run_ranks
from .shard import make_mesh, sharded_monte_carlo

__all__ = ["convergence_fraction", "convergence_mask", "divergence_mask",
           "make_mesh", "run_ranks", "sharded_monte_carlo", "solve_batch",
           "solve_many", "solve_tridiagonal_sharded", "spike_kkt_method"]
