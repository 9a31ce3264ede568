"""Solver options (counterpart of ``algames_tpu/problem/options.py``).

The TPU compiler knobs of the reference package (``loop_unroll``,
``flat_loop``) have no counterpart: the port always runs the flat (k, l)
machine with a host loop.  ``ls_parallel`` > 1, ``adaptive_penalty``,
``regularize=False`` and ``dual_reset=False`` are not ported yet (the
flagship runs none of them); the port always regularizes and always resets
the AL state at the start of a solve.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Options:
    # Regularization: reg = reg_0 * l^4 on the primal diagonals.
    reg_0: float = 1e-3

    # Backtracking line search.
    alpha_0: float = 1.0
    alpha_decrease: float = 0.5
    beta: float = 0.01
    ls_iter: int = 25
    delta_min: float = 1e-9
    # Evaluate line-search trials with the fused trial kernel
    # (ops/trial.py) where the problem lies inside its specialization.
    ls_fused: bool = False

    # Augmented Lagrangian penalty schedule.
    rho_0: float = 1.0
    rho_increase: float = 10.0
    rho_max: float = 1e7
    lam_max: float = 1e7
    alpha_dual: float = 1.0
    alphax_dual: Tuple[float, ...] = (1.0,) * 10

    # Convergence criteria.
    eps_dyn: float = 1e-3
    eps_sta: float = 1e-3
    eps_con: float = 1e-3
    eps_opt: float = 1e-3

    # Iteration caps.
    outer_iter: int = 7
    inner_iter: int = 20


@dataclasses.dataclass(frozen=True)
class IBROptions:
    """Iterative-best-response options: at most ``ibr_iter`` Gauss-Seidel
    rounds over the players in ``ordering`` (indices >= p are dropped), a
    lane stopping once no player's latest solve moved by ``delta_min`` or
    more."""
    ibr_iter: int = 100
    ordering: Tuple[int, ...] = tuple(range(100))
    delta_min: float = 1e-9
