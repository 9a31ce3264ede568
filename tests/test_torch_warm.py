"""The warm start of the port's MPC against the reference package's, f64 on
CPU: one warm replan with the duals carried from a reference solve, and
the shift of ``init_traj`` (x, u and the dynamics duals), with and without
a random draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.core.traj import init_traj as j_init_traj

import algames_tpu_torch as agt
from algames_tpu_torch.convert import (constraints_from_reference,
                                       problem_from_reference,
                                       traj_from_reference)
from algames_tpu_torch.core.traj import init_traj
from test_torch_mpc import B, _highway, _starts

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_warm_replan_with_carried_duals_matches_reference():
    """A reference solve's plan and AL state (per lane, penalties reset)
    carried into the port: the warm replan from the next states equals the
    reference's ``newton_solve(..., warm=...)`` with the same carried
    state.  The reference's cold solve is its warm solve from a zero plan
    (the shift of zeros is zeros), so one compiled function does both."""
    prob, spec = _highway(False)
    x0s = jnp.asarray(_starts(spec))
    replan = jax.jit(jax.vmap(lambda x, warm, gc: ag.newton_solve(
        dataclasses.replace(prob, x0=x, gc=gc), method="schur", warm=warm)))
    lanes = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prob.gc)
    zero = ag.PrimalDual(x=jnp.zeros((B, spec.N, spec.n)),
                         u=jnp.zeros((B, spec.T, spec.m)),
                         lam=jnp.zeros((B, spec.p, spec.T, spec.n)))
    cold = replan(x0s, zero, lanes)
    gc1 = jax.vmap(ag.reset_penalties)(cold.gc)
    assert max(float(jnp.abs(b.lam).max()) for b in
               gc1.state_blocks + gc1.control_blocks) > 0
    x1s = cold.traj.x[:, 1]
    ref = replan(x1s, cold.traj, gc1)

    tprob = problem_from_reference(prob, CPU, torch.float64)
    tprob = dataclasses.replace(tprob, gc=constraints_from_reference(
        gc1, CPU, torch.float64, lanes=True))
    out = agt.newton_solve(tprob, torch.as_tensor(np.array(x1s)),
                           warm=traj_from_reference(cold.traj, CPU,
                                                    torch.float64))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    for a, r in ((out.traj.x, ref.traj.x), (out.traj.u, ref.traj.u)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
    for a, r in zip(out.gc.state_blocks + out.gc.control_blocks,
                    ref.gc.state_blocks + ref.gc.control_blocks):
        np.testing.assert_allclose(a.lam.numpy(), np.asarray(r.lam), rtol=0,
                                   atol=1e-8)


def _random_plan(spec, rng, lanes=None):
    shape = () if lanes is None else (lanes,)
    return ag.PrimalDual(
        x=jnp.asarray(rng.standard_normal(shape + (spec.N, spec.n))),
        u=jnp.asarray(rng.standard_normal(shape + (spec.T, spec.m))),
        lam=jnp.asarray(rng.standard_normal(shape + (spec.p, spec.T,
                                                     spec.n))))


@pytest.mark.parametrize("shift", ["1", "T-1", "T", "2**10"])
def test_init_traj_shift_matches_reference(shift):
    """The shifted warm start (x, u and the dynamics duals along T) equals
    the reference's with ``key=None``, lane by lane, with x[:, 0] pinned."""
    _, spec = _highway(False)
    s = {"1": 1, "T-1": spec.T - 1, "T": spec.T, "2**10": 2 ** 10}[shift]
    rng = np.random.default_rng(5)
    prev = _random_plan(spec, rng, lanes=2)
    x0s = rng.standard_normal((2, spec.n))
    out = init_traj(spec, torch.as_tensor(x0s), shift=s,
                    prev=traj_from_reference(prev, CPU, torch.float64))
    for k in range(2):
        ref = j_init_traj(spec, jnp.asarray(x0s[k]), key=None, shift=s,
                          prev=jax.tree_util.tree_map(lambda a: a[k], prev))
        for a, r in ((out.x, ref.x), (out.u, ref.u), (out.lam, ref.lam)):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(r))
    np.testing.assert_array_equal(out.x[:, 0].numpy(), x0s)


def test_init_traj_draws_from_the_generator():
    """With a generator: fresh entries uniform in [0, amplitude), drawn
    anew per call, reproducible from the seed, x[:, 0] pinned; a shifted
    plan keeps the previous plan's entries."""
    _, spec = _highway(False)
    x0s = torch.randn((4, spec.n), dtype=torch.float64)
    amp = 1e-3

    def draw(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return init_traj(spec, x0s, generator=gen, amplitude=amp, **kw)
    a, b = draw(3), draw(3)
    for leaf_a, leaf_b in ((a.x[:, 1:], b.x[:, 1:]), (a.u, b.u),
                           (a.lam, b.lam)):
        assert torch.equal(leaf_a, leaf_b)
        assert float(leaf_a.min()) >= 0.0 and float(leaf_a.max()) < amp
        assert float(leaf_a.std()) > 0.1 * amp
    assert torch.equal(a.x[:, 0], x0s)
    assert not torch.equal(draw(4).u, a.u)
    warm = draw(5, prev=a, shift=1)
    assert torch.equal(warm.u[:, :-1], a.u[:, 1:])
    assert torch.equal(warm.lam[:, :, :-1], a.lam[:, :, 1:])
    assert not torch.equal(warm.u[:, -1], a.u[:, -1])
    assert torch.equal(warm.x[:, 0], x0s)


def test_ibr_carries_the_al_state_as_the_reference():
    """Iterative best response with ``dual_reset=False`` (each player's AL
    solve starts from the duals and penalties the last one left) and
    ``regularize=False``: three lanes of ``tests/test_torch_ibr.py``'s
    game against the reference's vmapped ``schur`` IBR, stats rows and
    their outer column equal, x within 1e-8."""
    from algames_tpu.problem import ibr as jibr
    from algames_tpu.problem.options import IBROptions
    from test_torch_ibr import _unicycle2
    prob = _unicycle2()
    prob = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, dual_reset=False, regularize=False))
    rng = np.random.default_rng(0)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((3, 8))
    ref = jax.jit(jax.vmap(lambda x: jibr.ibr_newton_solve(
        dataclasses.replace(prob, x0=x), IBROptions(ibr_iter=3),
        method="schur")))(jnp.asarray(x0s))
    out = agt.ibr_newton_solve(problem_from_reference(prob, CPU,
                                                      torch.float64),
                               agt.IBROptions(ibr_iter=3),
                               x0s=torch.as_tensor(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    np.testing.assert_array_equal(out.stats.outer.numpy(),
                                  np.asarray(ref.stats.outer))
    np.testing.assert_allclose(out.traj.x.numpy(), np.asarray(ref.traj.x),
                               rtol=0, atol=1e-8)
