"""PyTorch port of ``algames_tpu`` for NVIDIA Hopper GPUs.

Batch-first: every solver tensor carries a leading scenario axis.  The
kernels are hand-written CUDA (``csrc/``), built with ``nvcc`` at first use:
the block-Thomas KKT sweep with structured or dense Hessian blocks
(``ops.thomas``; also the padded sweep of heterogeneous games and the p=1
player sweep of iterative best response) and the fused line-search trial
(``ops.trial``).  ``mpc_solve`` runs receding-horizon MPC over a batch of
scenarios.  The KKT step also has the plain solves of the ladder
(``method="schur"``, ``"tridiag"``, ``"dense"``, ``"cr"``), and
``active_set`` the equilibrium-subspace analysis.  ``parallel`` splits a
scenario batch over a world of ranks (``sharded_monte_carlo``) and the
KKT solve over the horizon (``spike_kkt_method``); ``checkpoint``,
``profiling`` and ``plots`` save, time and draw solves.  On CPU tensors
each wrapper runs its plain PyTorch version.
"""
from .constraints.sets import (add_circle_constraint, add_collision_avoidance,
                               add_control_bound, control_violation,
                               dual_update, dynamics_violation_vector,
                               game_constraints, penalty_update,
                               reset_constraint_duals, reset_penalties,
                               set_constraint_params, state_violation,
                               update_active_set)
from .core.spec import ProblemSpec, spec_from_model
from .core.traj import PrimalDual, reset_duals
from .models.hetero import (HeteroDoubleIntegratorGame,
                            hetero_double_integrator_game)
from .models.unicycle import UnicycleGame, unicycle_game
from .objective.objective import GameObjective, game_objective, total_cost
from .problem.ibr import ibr_newton_solve, ibr_newton_solve_player
from .mpc import MPCResult, mpc_solve
from .problem.options import IBROptions, Options
from .problem.problem import GameProblem, game_problem
from .problem.solver import SolveResult, newton_solve
from .stats import print_stats
from .utils import scn
from . import active_set, checkpoint, parallel, profiling

__all__ = [
    "IBROptions", "MPCResult", "Options", "GameProblem", "GameObjective",
    "HeteroDoubleIntegratorGame", "PrimalDual", "ProblemSpec",
    "SolveResult", "UnicycleGame", "active_set", "add_circle_constraint",
    "checkpoint", "print_stats", "profiling", "scn",
    "add_collision_avoidance", "add_control_bound", "control_violation",
    "dual_update", "dynamics_violation_vector", "game_constraints",
    "game_objective", "game_problem", "hetero_double_integrator_game",
    "ibr_newton_solve", "ibr_newton_solve_player", "mpc_solve",
    "newton_solve", "parallel", "penalty_update", "reset_constraint_duals",
    "reset_duals", "reset_penalties", "set_constraint_params",
    "spec_from_model", "state_violation", "total_cost", "unicycle_game",
    "update_active_set",
]
