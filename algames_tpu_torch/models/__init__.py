"""Game dynamics models and integrators."""
from .base import GameModel, interleaved_indices
from .bicycle import BicycleGame, bicycle_game
from .double_integrator import DoubleIntegratorGame, double_integrator_game
from .hetero import HeteroDoubleIntegratorGame, hetero_double_integrator_game
from .integration import (rk2_step, rk3_step, rollout_rk3, step_jacobians,
                          step_jacobians_traj)
from .quadrotor import (QuadrotorGame, mrp_kinematics, mrp_rotation_matrix,
                        quadrotor_game)
from .unicycle import UnicycleGame, unicycle_game

__all__ = [
    "GameModel", "interleaved_indices",
    "DoubleIntegratorGame", "double_integrator_game",
    "HeteroDoubleIntegratorGame", "hetero_double_integrator_game",
    "UnicycleGame", "unicycle_game",
    "BicycleGame", "bicycle_game",
    "QuadrotorGame", "quadrotor_game",
    "mrp_kinematics", "mrp_rotation_matrix",
    "rk2_step", "rk3_step", "rollout_rk3",
    "step_jacobians", "step_jacobians_traj",
]
