"""The port's receding-horizon MPC against the reference package's, f64 on
CPU (the KKT wrappers run their plain versions): the closed loop on a small
highway (``benchmarks/bench_mpc.py``'s game cut to N=10) with the duals
carried across replans or reset.  ``tests/test_torch_warm.py`` holds the
warm start itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.mpc import mpc_solve as j_mpc_solve

import algames_tpu_torch as agt
from algames_tpu_torch.convert import problem_from_reference

torch.set_num_threads(1)
CPU = torch.device("cpu")
# The highway's players squeezed together, so that collision rows and their
# duals are active in the first replans; three starts around it.
SQUEEZED = np.asarray([0.0, -0.15, -0.3, 0.2, 0.25, 0.3, 0.0, 0.0, 0.0,
                       1.4, 1.1, 0.8])
B, H = 3, 4


def _highway(dual_reset, N=10):
    """``benchmarks/bench_mpc.py::make_problem`` with N knots, built with
    the reference package."""
    p = 3
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, 0.1)
    obj = ag.game_objective(
        spec, Q=[jnp.asarray([0.0, 5.0, 1.0, 2.0])] * p,
        R=[0.1 * jnp.ones(2)] * p,
        xf=[jnp.asarray([10.0, 0.4 * i, 0.0, 0.8 + 0.3 * i])
            for i in range(p)],
        uf=[jnp.zeros(2)] * p, dtype=jnp.float64)
    gc = ag.add_collision_avoidance(spec, ag.game_constraints(spec), 0.1)
    gc = ag.add_control_bound(spec, gc, 3.0 * jnp.ones(2 * p),
                              -3.0 * jnp.ones(2 * p))
    opts = ag.Options(outer_iter=3, inner_iter=8, shift=1,
                      dual_reset=dual_reset)
    return ag.game_problem(N, 0.1, jnp.asarray(SQUEEZED), model, opts, obj,
                           gc), spec


def _starts(spec):
    rng = np.random.default_rng(0)
    return SQUEEZED[None] + 0.05 * rng.standard_normal((B, spec.n))


@pytest.mark.parametrize("dual_reset", [False, True])
def test_mpc_matches_reference(dual_reset):
    """B=3 scenarios, H=4 replans, against the reference's ``mpc_solve``
    vmapped: stats rows per replan equal; states, controls, violations and
    the last plan within 1e-8.  With the duals carried the loop differs
    from the reset one."""
    prob, spec = _highway(dual_reset)
    x0s = _starts(spec)
    ref = jax.jit(jax.vmap(lambda x: j_mpc_solve(
        dataclasses.replace(prob, x0=x), horizon=H, method="schur")))(
        jnp.asarray(x0s))
    tprob = problem_from_reference(prob, CPU, torch.float64)
    out = agt.mpc_solve(tprob, torch.as_tensor(x0s), horizon=H)
    assert out.states.shape == (B, H + 1, spec.n)
    assert out.controls.shape == (B, H, spec.m)
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(ref.iters))
    for a, r in ((out.states, ref.states), (out.controls, ref.controls),
                 (out.dyn_vio, ref.dyn_vio), (out.opt_vio, ref.opt_vio),
                 (out.traj.x, ref.traj.x), (out.traj.u, ref.traj.u),
                 (out.traj.lam, ref.traj.lam)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
    other = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, dual_reset=not dual_reset))
    flip = agt.mpc_solve(other, torch.as_tensor(x0s), horizon=H)
    assert not torch.equal(flip.iters, out.iters)
