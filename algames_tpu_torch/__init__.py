"""PyTorch port of ``algames_tpu`` for NVIDIA Hopper GPUs.

Batch-first: every solver tensor carries a leading scenario axis.  The
kernels are hand-written CUDA (``csrc/``), built with ``nvcc`` at first use:
the block-Thomas KKT sweep with structured or dense Hessian blocks
(``ops.thomas``; also the padded sweep of heterogeneous games and the p=1
player sweep of iterative best response) and the fused line-search trial
(``ops.trial``).  ``mpc_solve`` runs receding-horizon MPC over a batch of
scenarios.  On CPU tensors each wrapper runs its plain PyTorch
version.
"""
from .constraints.sets import (add_collision_avoidance, add_control_bound,
                               game_constraints, reset_constraint_duals,
                               reset_penalties)
from .core.spec import ProblemSpec, spec_from_model
from .core.traj import PrimalDual
from .models.hetero import (HeteroDoubleIntegratorGame,
                            hetero_double_integrator_game)
from .models.unicycle import UnicycleGame, unicycle_game
from .objective.objective import GameObjective, game_objective
from .problem.ibr import ibr_newton_solve, ibr_newton_solve_player
from .mpc import MPCResult, mpc_solve
from .problem.options import IBROptions, Options
from .problem.problem import GameProblem, game_problem
from .problem.solver import SolveResult, newton_solve
from . import parallel

__all__ = [
    "IBROptions", "MPCResult", "Options", "GameProblem", "GameObjective",
    "HeteroDoubleIntegratorGame", "PrimalDual", "ProblemSpec",
    "SolveResult", "UnicycleGame", "add_collision_avoidance",
    "add_control_bound", "game_constraints", "game_objective",
    "game_problem", "hetero_double_integrator_game", "ibr_newton_solve",
    "ibr_newton_solve_player", "mpc_solve", "newton_solve", "parallel",
    "reset_constraint_duals", "reset_penalties", "spec_from_model",
    "unicycle_game",
]
