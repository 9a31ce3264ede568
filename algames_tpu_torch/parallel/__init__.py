"""Scenario-batch solving."""
from .batch import (convergence_fraction, convergence_mask, divergence_mask,
                    solve_batch, solve_many)

__all__ = ["convergence_fraction", "convergence_mask", "divergence_mask",
           "solve_batch", "solve_many"]
