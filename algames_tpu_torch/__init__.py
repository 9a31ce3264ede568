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

The root exports the names of the reference package's root but its
``jax.jit`` wrappers (``newton_solve_jit``, ``ibr_newton_solve_jit``,
``mpc_solve_jit``): the port is eager.
"""
from .constraints.sets import (ConBlock, CylinderWall, GameConstraints, Wall,
                               Wall3D, add_circle_constraint,
                               add_collision_avoidance, add_control_bound,
                               add_spherical_collision_avoidance,
                               add_state_bound, add_velocity_bound,
                               add_wall_constraint, control_violation,
                               dual_update, dynamics_violation_vector,
                               game_constraints, penalty_update,
                               reset_constraint_duals, reset_constraints,
                               reset_penalties, set_constraint_params,
                               state_violation, update_active_set)
from .core.spec import ProblemSpec, spec_from_model
from .core.traj import (PrimalDual, delta_step, init_traj, pack_traj,
                        reset_duals, unpack_step, update_traj, zero_traj)
from .models import (BicycleGame, DoubleIntegratorGame, GameModel,
                     HeteroDoubleIntegratorGame, QuadrotorGame, UnicycleGame,
                     bicycle_game, double_integrator_game,
                     hetero_double_integrator_game, quadrotor_game, rk2_step,
                     rk3_step, rollout_rk3, step_jacobians, unicycle_game)
from .objective.objective import (GameObjective, add_collision_cost,
                                  cost_gradient, cost_hessian, expand_vector,
                                  game_objective, total_cost)
from .problem.ibr import (ibr_newton_solve, ibr_newton_solve_player,
                          player_violations)
from .mpc import MPCResult, mpc_solve
from .problem.options import IBROptions, Options, Penalty, Regularizer
from .problem.problem import GameProblem, game_problem
from .problem.solver import SolveResult, newton_solve
from .stats import Statistics, print_stats
from .utils import scn
from . import active_set, checkpoint, parallel, presets, profiling

__all__ = [
    "BicycleGame", "ConBlock", "CylinderWall", "DoubleIntegratorGame",
    "GameConstraints", "GameModel", "GameObjective", "GameProblem",
    "HeteroDoubleIntegratorGame", "IBROptions", "MPCResult", "Options",
    "Penalty", "PrimalDual", "ProblemSpec", "QuadrotorGame", "Regularizer",
    "SolveResult", "Statistics", "UnicycleGame", "Wall", "Wall3D",
    "active_set", "add_circle_constraint", "add_collision_avoidance",
    "add_collision_cost", "add_control_bound",
    "add_spherical_collision_avoidance", "add_state_bound",
    "add_velocity_bound", "add_wall_constraint", "bicycle_game",
    "checkpoint", "control_violation", "cost_gradient", "cost_hessian",
    "delta_step", "double_integrator_game", "dual_update",
    "dynamics_violation_vector", "expand_vector", "game_constraints",
    "game_objective", "game_problem", "hetero_double_integrator_game",
    "ibr_newton_solve", "ibr_newton_solve_player", "init_traj", "mpc_solve",
    "newton_solve", "pack_traj", "parallel", "penalty_update",
    "player_violations", "presets", "print_stats", "profiling",
    "quadrotor_game", "reset_constraint_duals", "reset_constraints",
    "reset_duals", "reset_penalties", "rk2_step", "rk3_step",
    "rollout_rk3", "scn", "set_constraint_params", "spec_from_model",
    "state_violation", "step_jacobians", "total_cost", "unicycle_game",
    "unpack_step", "update_active_set", "update_traj", "zero_traj",
]
