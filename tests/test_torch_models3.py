"""The double-integrator, bicycle and quadrotor models of the PyTorch port
against the JAX package: dynamics, the RK2 and RK3 steps, the step
Jacobians and the RK2 dual pulls (A^T lam, B^T lam), and the quadrotor's
MRP helpers.

Inputs are drawn from numpy seeds; f64 throughout, relative and absolute
tolerance 1e-12 (the same functions, only the order of floating-point
operations may differ).  The quadrotor cases include lanes whose rotor
speeds are exactly 0: a solve from the zero initial controls starts on the
thrust clamp's kink, where both packages take the derivative of
max(0, kf w) as 1/2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.models import integration as jint
from algames_tpu.models import quadrotor as jquad

from algames_tpu_torch.models import integration as tint
from algames_tpu_torch.models import quadrotor as tquad
from algames_tpu_torch.models.bicycle import bicycle_game
from algames_tpu_torch.models.double_integrator import double_integrator_game
from algames_tpu_torch.models.quadrotor import quadrotor_game

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)
B, K, DT = 3, 5, 0.1

MODELS = {
    "di2": (lambda: ag.double_integrator_game(p=2, d=2),
            lambda: double_integrator_game(p=2, d=2)),
    "di3": (lambda: ag.double_integrator_game(p=3, d=3),
            lambda: double_integrator_game(p=3, d=3)),
    "bicycle": (lambda: ag.bicycle_game(p=3, lf=0.06, lr=0.04),
                lambda: bicycle_game(p=3, lf=0.06, lr=0.04)),
    "quadrotor": (lambda: ag.quadrotor_game(p=2),
                  lambda: quadrotor_game(p=2)),
    "quadrotor_smooth": (lambda: ag.quadrotor_game(p=2, mass=0.7,
                                                   thrust_smoothing=100.0),
                         lambda: quadrotor_game(p=2, mass=0.7,
                                                thrust_smoothing=100.0)),
}


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def draw(model, seed):
    """States, controls and per-player cotangents [B, K, ...]; for the
    quadrotor the first lane's controls are exactly 0 and some of the
    others are negative (rotors below the clamp)."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, K, model.n))
    u = 0.5 * rng.standard_normal((B, K, model.m))
    if isinstance(model, ag.QuadrotorGame):
        u[0] = 0.0
        u[1] = np.abs(u[1]) * np.sign(rng.standard_normal(u[1].shape))
    lam = rng.standard_normal((B, K, model.p, model.n))
    return x, u, lam


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_parity(name):
    """Fields, dynamics, RK2/RK3 steps, step Jacobians and RK2 pulls."""
    jm, tm = (f() for f in MODELS[name])
    for f in ("n", "m", "p", "ni", "mi", "pu", "px", "pz"):
        assert getattr(tm, f) == getattr(jm, f), f
    x, u, lam = draw(jm, seed=sorted(MODELS).index(name))
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    close(tm.dynamics(tx, tu),
          jax.jit(jax.vmap(jax.vmap(jm.dynamics)))(jx, ju))
    for jf, tf in ((jint.rk2_step, tint.rk2_step),
                   (jint.rk3_step, tint.rk3_step)):
        step = jax.jit(jax.vmap(jax.vmap(lambda a, b: jf(jm, a, b, DT))))
        close(tf(tm, tx, tu, DT), step(jx, ju))
    A, Bm = jax.jit(jax.vmap(
        lambda a, b: jint.step_jacobians_traj(jm, a, b, DT)))(jx, ju)
    tA, tB = tint.step_jacobians(tm, tx, tu, DT)
    close(tA, A)
    close(tB, Bm)
    gx, gu = tint.rk2_vjp(tm, tx, tu, torch.as_tensor(lam), DT)
    close(gx, np.einsum("bkca,bkpc->bkpa", np.asarray(A), lam))
    close(gu, np.einsum("bkcm,bkpc->bkpm", np.asarray(Bm), lam))


def test_quadrotor_kink_derivative():
    """At u = 0 the thrust's derivative is kf / 2 in both packages: the
    step Jacobian B at zero controls equals the mean of the one-sided
    Jacobians (all rotors just on, all just off)."""
    jm, tm = ag.quadrotor_game(p=2), quadrotor_game(p=2)
    rng = np.random.default_rng(7)
    x = 0.3 * rng.standard_normal((jm.n,))
    u0 = np.zeros(jm.m)
    _, Bref = jax.jit(lambda a, b: jint.step_jacobians(jm, a, b, DT))(
        jnp.asarray(x), jnp.asarray(u0))
    _, B0 = tint.step_jacobians(tm, torch.as_tensor(x)[None],
                                torch.as_tensor(u0)[None], DT)
    close(B0[0], Bref)
    eps = 1e-300
    _, Bon = tint.step_jacobians(tm, torch.as_tensor(x)[None],
                                 torch.full((1, jm.m), eps,
                                            dtype=torch.float64), DT)
    _, Boff = tint.step_jacobians(tm, torch.as_tensor(x)[None],
                                  torch.full((1, jm.m), -eps,
                                             dtype=torch.float64), DT)
    close(B0[0], 0.5 * (Bon[0] + Boff[0]))
    assert not torch.allclose(Bon, Boff)


def test_mrp_helpers():
    """_skew, mrp_rotation_matrix and mrp_kinematics on batched inputs;
    the rotation matrix is orthonormal."""
    rng = np.random.default_rng(11)
    q = 0.6 * rng.standard_normal((4, 3))
    w = rng.standard_normal((4, 3))
    tq, tw = torch.as_tensor(q), torch.as_tensor(w)
    close(tquad._skew(tq), jquad._skew(jnp.asarray(q)))
    R = tquad.mrp_rotation_matrix(tq)
    close(R, jquad.mrp_rotation_matrix(jnp.asarray(q)))
    close(tquad.mrp_kinematics(tq, tw),
          jquad.mrp_kinematics(jnp.asarray(q), jnp.asarray(w)))
    close(R @ R.transpose(-1, -2), np.broadcast_to(np.eye(3), (4, 3, 3)))
