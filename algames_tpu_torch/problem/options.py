"""Solver options (counterpart of ``algames_tpu/problem/options.py``).

The fields of the reference package's ``Options`` that the port acts on,
with the same defaults.  Left out: the TPU compiler knobs ``flat_loop``
(the port always runs the flat (k, l) machine, as a host loop) and
``loop_unroll`` (iterations per while-loop trip), and the fields that no
solver path reads (``theta``, ``alpha_increase``, ``rho_trial``,
``gamma``, ``inner_print``, ``outer_print``, ``seed``), which
``convert.problem_from_reference`` drops at any value.  ``Regularizer``
and ``Penalty`` are the reference's records of the same names, for users
who drive iterations by hand; the solver carries its own schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Options:
    # Amplitude of the random primal-dual init (solves given a generator).
    amplitude_init: float = 1e-8
    # Knots the warm start is shifted by (MPC uses 1).
    shift: int = 2 ** 10

    # Regularization: reg = reg_0 * l^4 on the primal diagonals and in the
    # line-search trials; none with regularize=False.
    regularize: bool = True
    reg_0: float = 1e-3

    # Backtracking line search.
    alpha_0: float = 1.0
    alpha_decrease: float = 0.5
    beta: float = 0.01
    ls_iter: int = 25
    delta_min: float = 1e-9
    # Evaluate the first ls_parallel trials for every lane and accept the
    # first that passes; deeper trials run sequentially.  The accept
    # decisions are those of ls_parallel=1.
    ls_parallel: int = 1
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
    # A row is active where c >= -active_set_tolerance or lam > 0
    # (constraints.sets.update_active_set; the active-set analysis).
    active_set_tolerance: float = 1e-4

    # Convergence criteria.
    eps_dyn: float = 1e-3
    eps_sta: float = 1e-3
    eps_con: float = 1e-3
    eps_opt: float = 1e-3

    # Iteration caps.
    outer_iter: int = 7
    inner_iter: int = 20

    # Adaptive penalty safeguard (not in the ALGAMES reference): raise the
    # penalties only when the constraint violation failed to shrink by
    # adaptive_ratio since the last update, else take the dual step alone.
    adaptive_penalty: bool = False
    adaptive_ratio: float = 0.25

    # MPC: replans of mpc_solve, RK3 plant substeps per control interval.
    mpc_horizon: int = 20
    upsampling: int = 2

    # Reset the AL state (duals to 0, penalties to mu0) at the start of a
    # solve; with False the given AL state is used as it is.
    dual_reset: bool = True


@dataclasses.dataclass(frozen=True)
class IBROptions:
    """Iterative-best-response options: at most ``ibr_iter`` Gauss-Seidel
    rounds over the players in ``ordering`` (indices >= p are dropped), a
    lane stopping once no player's latest solve moved by ``delta_min`` or
    more."""
    ibr_iter: int = 100
    ordering: Tuple[int, ...] = tuple(range(100))
    delta_min: float = 1e-9


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """Per-variable-kind Tikhonov coefficients (the reference's
    ``Regularizer``).  The solver carries the scalar schedule ``reg = reg_0
    l^4`` itself; this record is for users who drive iterations by hand."""
    x: float = 0.0
    u: float = 0.0
    lam: float = 0.0

    def set(self, rho: float) -> "Regularizer":
        """Every coefficient set to ``rho``."""
        return Regularizer(x=rho, u=rho, lam=rho)

    def mult(self, gamma: float) -> "Regularizer":
        """Every coefficient times ``gamma``."""
        return Regularizer(x=self.x * gamma, u=self.u * gamma,
                           lam=self.lam * gamma)


@dataclasses.dataclass(frozen=True)
class Penalty:
    """An AL penalty pair (the reference's ``Penalty``).  The live penalty
    evolves in the solver and is returned as ``SolveResult.rho``."""
    rho: float = 1.0
    rho_trial: float = 1.0
