"""Problem configurations built natively (counterparts of
``algames_tpu/presets.py``; ``PRESETS`` has the same five keys).  Each
builder returns ``(GameProblem, ProblemSpec)`` on ``device`` (the card
unless the caller asks for the CPU).  f32 gates stationarity at 1e-2 (the
f32 floor of the AL terms with mu up to 1e7), f64 at 1e-3."""
from __future__ import annotations

import numpy as np
import torch

from .constraints.sets import (CylinderWall, Wall, Wall3D,
                               add_circle_constraint, add_collision_avoidance,
                               add_control_bound,
                               add_spherical_collision_avoidance,
                               add_state_bound, add_velocity_bound,
                               add_wall_constraint, game_constraints)
from .core.spec import spec_from_model
from .models.bicycle import bicycle_game
from .models.double_integrator import double_integrator_game
from .models.quadrotor import quadrotor_game
from .models.unicycle import unicycle_game
from .objective.objective import add_collision_cost, game_objective
from .problem.options import Options
from .problem.problem import game_problem


def _options(dtype, outer, inner) -> Options:
    return Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=1e-2 if dtype == torch.float32 else 1e-3)


def intro_di(device="cuda", dtype=torch.float64, outer: int = 7,
             inner: int = 20):
    """2-player planar double integrator, N=10: a lane swap with pairwise
    collision avoidance (r = 0.2, active at the equilibrium) and control
    bounds of +-2."""
    p, N, dt = 2, 10, 0.1
    model = double_integrator_game(p=p, d=2)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([1.0, 0.4 * (p - 1 - i), 0.0, 0.0]) for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    gc = game_constraints(spec, dtype=dtype, device=device)
    gc = add_collision_avoidance(spec, gc, 0.2)
    gc = add_control_bound(spec, gc, 2 * np.ones(2 * p), -2 * np.ones(2 * p))
    x0 = torch.as_tensor(np.concatenate([np.zeros(p), 0.4 * np.arange(p),
                                         np.zeros(2 * p)]),
                         dtype=dtype, device=device)
    return game_problem(N, dt, x0, model, _options(dtype, outer, inner), obj,
                        gc), spec


def flagship_unicycle(device="cuda", dtype=torch.float64, outer: int = 7,
                      inner: int = 20, p: int = 3, N: int = 20):
    """3-player unicycle merge, N=20, with pairwise collision avoidance
    (r = 0.08) and control bounds of +-2."""
    dt = 0.1
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([2.0, 0.4 * i, 0.0, 0.3]) for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    gc = game_constraints(spec, dtype=dtype, device=device)
    gc = add_collision_avoidance(spec, gc, 0.08)
    gc = add_control_bound(spec, gc, 2 * np.ones(2 * p), -2 * np.ones(2 * p))
    x0 = torch.as_tensor(
        np.concatenate([np.zeros(p), 0.4 * np.arange(p), np.zeros(p),
                        0.5 * np.ones(p)]), dtype=dtype, device=device)
    return game_problem(N, dt, x0, model, _options(dtype, outer, inner), obj,
                        gc), spec


def intro_bicycle(device="cuda", dtype=torch.float64, outer: int = 7,
                  inner: int = 20):
    """3-player kinematic bicycle, N=20, with the full constraint stack: a
    collision cost (radius 1, mu 5), pairwise collision avoidance (r =
    0.08), control bounds of +-5, a +-5 bound on every state owned by
    player 0, one 2D wall per player and three circle obstacles per
    player."""
    p, N, dt = 3, 20, 0.1
    model = bicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec, Q=[10 * np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray(v, np.float64) for v in
            ([2, +0.4, 0, 0], [2, 0.0, 0, 0], [3, -0.4, 0, 0])],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    obj = add_collision_cost(spec, obj, radius=np.ones(p), mu=5.0 * np.ones(p))
    gc = game_constraints(spec, dtype=dtype, device=device)
    gc = add_collision_avoidance(spec, gc, 0.08)
    gc = add_control_bound(spec, gc, 5 * np.ones(spec.m), -5 * np.ones(spec.m))
    gc = add_state_bound(spec, gc, 0, 5 * np.ones(spec.n), -5 * np.ones(spec.n))
    gc = add_wall_constraint(spec, gc,
                             [Wall([0.0, -0.4], [1.0, -0.4], [0.0, -1.0])])
    gc = add_circle_constraint(spec, gc, [1.0, 2.0, 3.0], [1.0, 2.0, 3.0],
                               [0.1, 0.2, 0.3])
    x0 = torch.as_tensor([0.1, 0.0, 0.5, -0.4, 0.0, 0.7,
                          0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=dtype,
                         device=device)
    return game_problem(N, dt, x0, model, _options(dtype, outer, inner), obj,
                        gc), spec


def roundabout(device="cuda", dtype=torch.float64, outer: int = 10,
               inner: int = 16):
    """4-player unicycle roundabout, N=40: players enter from the four
    sides (goal permutation [3, 2, 0, 1]) around a central island circle
    (r = 0.3), with pairwise collision constraints (r = 0.08), a smooth
    collision cost (radius 0.4, mu 5), speed bounds [-0.2, 1.5], control
    bounds of +-3 and entry speeds 0.3 + 0.1 i."""
    p, N, dt = 4, 40, 0.1
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    starts = np.array([[-1.5, 0.0], [1.5, 0.0], [0.0, -1.5], [0.0, 1.5]])
    order = [3, 2, 0, 1]
    goals = np.array([-starts[order[i]] for i in range(p)])
    headings = np.arctan2(-starts[:, 1], -starts[:, 0])
    obj = game_objective(
        spec, Q=[np.asarray([5.0, 5.0, 0.2, 0.2])] * p,
        R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([goals[i, 0], goals[i, 1], headings[i], 0.3])
            for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    obj = add_collision_cost(spec, obj, radius=0.4 * np.ones(p),
                             mu=5.0 * np.ones(p))
    gc = game_constraints(spec, dtype=dtype, device=device)
    gc = add_collision_avoidance(spec, gc, 0.08)
    gc = add_circle_constraint(spec, gc, [0.0], [0.0], [0.3])
    gc = add_velocity_bound(spec, model, gc, 1.5 * np.ones(p),
                            -0.2 * np.ones(p))
    gc = add_control_bound(spec, gc, 3 * np.ones(spec.m),
                           -3 * np.ones(spec.m))
    x0 = np.zeros(spec.n)
    for i in range(p):
        x0[list(spec.px[i])] = starts[i]
        x0[spec.pz[i][2]] = headings[i]
        x0[spec.pz[i][3]] = 0.3 + 0.1 * i
    return game_problem(N, dt, torch.as_tensor(x0, dtype=dtype, device=device),
                        model, _options(dtype, outer, inner), obj, gc), spec


def quadrotor3d(device="cuda", dtype=torch.float64, outer: int = 6,
                inner: int = 12, p: int = 2):
    """2-player 3D quadrotor game, N=15: spherical collision avoidance (r =
    0.1 each), a floor facet at z = 0.2 and a z-axis cylinder (r = 0.2) per
    player, and one-sided thrust bounds [0, 3]; targets at hover.  With
    ``p`` = 3 its reduced KKT systems (d = 48) lie beyond K1's register
    size classes (``chip_smoke.py``'s ``K1-wide``)."""
    N, dt = 15, 0.1
    model = quadrotor_game(p=p)
    spec = spec_from_model(model, N, dt)
    hover = 0.5 * 9.81 / 4.0 / model.kf
    obj = game_objective(
        spec, Q=[np.asarray([10, 10, 10, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                            np.float64)] * p,
        R=[0.1 * np.ones(4)] * p,
        xf=[np.concatenate([[1.5, 0.3 * i, 1.0], np.zeros(9)])
            for i in range(p)],
        uf=[np.full((4,), hover)] * p, dtype=dtype, device=device)
    gc = game_constraints(spec, dtype=dtype, device=device)
    gc = add_spherical_collision_avoidance(spec, gc, 0.1)
    gc = add_wall_constraint(spec, gc, [
        Wall3D([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
               [0.0, 0.0, -1.0])])
    gc = add_wall_constraint(spec, gc, [
        CylinderWall([0.75, 0.15, 0.0], "z", 2.0, 0.2)])
    gc = add_control_bound(spec, gc, 3 * np.ones(spec.m), np.zeros(spec.m))
    x0 = np.zeros(spec.n)
    x0[[spec.pz[i][2] for i in range(p)]] = 1.0
    x0[[spec.pz[i][1] for i in range(p)]] = 0.3 * np.arange(p)
    return game_problem(N, dt, torch.as_tensor(x0, dtype=dtype, device=device),
                        model, _options(dtype, outer, inner), obj, gc), spec


PRESETS = {
    "di2_N10": intro_di,
    "uni3_N20": flagship_unicycle,
    "bike3_N20": intro_bicycle,
    "round4_N40": roundabout,
    "quad2_N15": quadrotor3d,
}
