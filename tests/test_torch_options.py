"""The rest of ``Options`` in the port against the reference package, f64 on
CPU (the kernel wrappers run their plain versions): the K-trial line-search
window, the adaptive penalty schedule, ``regularize=False``, the AL reset
helpers, the converter's options and refusals, and the double-integrator
tracking case of ``tests/test_mpc.py`` through the port's ``mpc_solve``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.constraints import sets as jsets
from algames_tpu.mpc import mpc_solve as j_mpc_solve
from algames_tpu.parallel import batch as jbatch
from algames_tpu.presets import flagship_unicycle
from algames_tpu.problem.options import Options as JOptions

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.convert import (constraints_from_reference,
                                       problem_from_reference)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _with(prob, **kw):
    return dataclasses.replace(prob, opts=dataclasses.replace(prob.opts, **kw))


@functools.lru_cache(maxsize=None)
def _deep_ls_problem():
    """``tests/test_ls_parallel.py``'s game at N=10: a head-on start inside
    the collision radius, tight control bounds and beta 0.9, so that many
    line searches go past 3 trials; three starts."""
    model = ag.unicycle_game(p=2)
    spec = ag.spec_from_model(model, 10, 0.1)
    obj = ag.game_objective(
        spec, Q=[10 * jnp.ones(4)] * 2, R=[0.1 * jnp.ones(2)] * 2,
        xf=[jnp.asarray([2.0, 0.0, 0.0, 0.0]),
            jnp.asarray([-2.0, 0.0, jnp.pi, 0.0])],
        uf=[jnp.zeros(2)] * 2, dtype=jnp.float64)
    gc = ag.add_collision_avoidance(spec, ag.game_constraints(spec), 0.5)
    gc = ag.add_control_bound(spec, gc, u_min=-1.0, u_max=1.0)
    opts = ag.Options(outer_iter=4, inner_iter=8, beta=0.9, ls_iter=25)
    x0 = jnp.asarray([0.2, -0.2, 0.0, 0.0, 0.0, jnp.pi, 0.8, 0.8])
    prob = ag.game_problem(10, 0.1, x0, model, opts, obj, gc)
    rng = np.random.default_rng(7)
    x0s = np.asarray(x0)[None] + 0.05 * rng.standard_normal((3, spec.n))
    return prob, x0s


@functools.lru_cache(maxsize=None)
def _port_ls(K):
    prob, x0s = _deep_ls_problem()
    tprob = problem_from_reference(_with(prob, ls_parallel=K), CPU,
                                   torch.float64)
    return agt.newton_solve(tprob, torch.as_tensor(x0s))


@pytest.mark.parametrize("K", [2, 3])
def test_ls_parallel_matches_sequential_and_reference(K):
    """The first K trials evaluated for every lane: accepted step sizes and
    stats rows identical to K=1, lane by lane (including searches deeper
    than K, which continue sequentially), iterates within 1e-10; and equal
    to the reference's at the same K."""
    prob, x0s = _deep_ls_problem()
    one, out = _port_ls(1), _port_ls(K)
    alpha = out.stats.column("alpha").numpy()
    depth = np.round(1 - np.log2(alpha[alpha > 0])).astype(int)
    assert depth.max() > 3 and (depth > 1).any()
    np.testing.assert_array_equal(alpha, one.stats.column("alpha").numpy())
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  one.stats.iter.numpy())
    for a, r in ((out.traj.x, one.traj.x), (out.traj.u, one.traj.u),
                 (out.traj.lam, one.traj.lam), (out.stats.res,
                                                one.stats.res)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=1e-10)
    ref = jax.jit(jax.vmap(lambda x: ag.newton_solve(dataclasses.replace(
        prob, x0=x, opts=dataclasses.replace(prob.opts, ls_parallel=K)))))(
        jnp.asarray(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    np.testing.assert_array_equal(alpha, np.asarray(ref.stats.alpha))
    np.testing.assert_allclose(out.traj.x.numpy(), np.asarray(ref.traj.x),
                               rtol=0, atol=1e-8)


def test_adaptive_penalty_matches_reference():
    """``tests/test_constraints.py``'s crossing game at N=10 with the
    adaptive schedule: the same stats rows, x within 1e-8; both of its
    branches (dual step alone, penalty step alone) are taken."""
    p, N = 3, 10
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, 0.1)
    obj = ag.game_objective(
        spec, Q=[10 * jnp.ones(4)] * p, R=[0.1 * jnp.ones(2)] * p,
        xf=[jnp.asarray([2.0, -0.4 * (i - 1), 0.0, 0.0]) for i in range(p)],
        uf=[jnp.zeros(2)] * p, dtype=jnp.float64)
    gc = ag.add_collision_avoidance(spec, ag.game_constraints(spec), 0.1)
    x0 = jnp.asarray([0., 0., 0., -0.4, 0., 0.4, 0., 0., 0., .5, .5, .5])
    opts = ag.Options(reg_0=1e-7, adaptive_penalty=True, outer_iter=12)
    prob = ag.game_problem(N, 0.1, x0, model, opts, obj, gc)
    ref = ag.newton_solve_jit(prob)
    out = agt.newton_solve(problem_from_reference(prob, CPU, torch.float64))
    it = int(ref.stats.iter)
    assert int(out.stats.iter[0]) == it
    np.testing.assert_allclose(out.traj.x[0].numpy(), np.asarray(ref.traj.x),
                               rtol=0, atol=1e-8)
    outer = out.stats.outer[0, :it].numpy()
    mu = out.gc.state_blocks[0].mu
    assert outer.max() > 2 and float(out.rho[0]) == float(ref.rho)
    assert 1.0 < float(ref.rho) < 10.0 ** (outer.max() - 1)
    assert float(mu.max()) == float(ref.rho)


@functools.lru_cache(maxsize=None)
def _unregularized():
    """A B=2 flagship batch at outer 2 x inner 4 without regularization and
    the reference's solve of it."""
    prob, spec = flagship_unicycle(outer=2, inner=4)
    prob = _with(prob, regularize=False)
    rng = np.random.default_rng(1)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((2, spec.n))
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s))
    return prob, x0s, ref


@pytest.mark.parametrize("ls_fused", [False, True])
def test_regularize_false_matches_reference(ls_fused):
    """``regularize=False`` through the eager trial and through the fused
    trial's wrapper: the reference's stats rows, x within 1e-8; it differs
    from the regularized solve."""
    prob, x0s, ref = _unregularized()
    tprob = _with(problem_from_reference(prob, CPU, torch.float64),
                  ls_fused=ls_fused)
    out = agt.newton_solve(tprob, torch.as_tensor(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    np.testing.assert_allclose(out.traj.x.numpy(), np.asarray(ref.traj.x),
                               rtol=0, atol=1e-8)
    reg = agt.newton_solve(_with(tprob, regularize=True),
                           torch.as_tensor(x0s))
    assert not torch.equal(reg.traj.x, out.traj.x)


@pytest.mark.parametrize("name", ["reset_penalties",
                                  "reset_constraint_duals"])
def test_reset_helpers_match_reference(name):
    """Each reset helper on unbatched AL state and on per-lane state (kept
    at its shape) equals the reference's; the unbatched result copied to
    every lane by ``per_lane``."""
    prob, spec = flagship_unicycle(p=2, N=5)
    rng = np.random.default_rng(2)
    Bsz = 3

    def rand(a, lanes=()):
        return jnp.asarray(rng.random(lanes + a.shape) + 0.5)
    gc = jsets._replace(
        prob.gc,
        state_blocks=tuple(jsets._replace(b, lam=rand(b.lam), mu=rand(b.mu))
                           for b in prob.gc.state_blocks),
        control_blocks=tuple(jsets._replace(b, lam=rand(b.lam),
                                            mu=rand(b.mu))
                             for b in prob.gc.control_blocks))
    lanes = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (Bsz,) + a.shape), gc)
    lanes = jsets._replace(
        lanes,
        state_blocks=tuple(jsets._replace(b, lam=rand(b.lam[0], (Bsz,)))
                           for b in lanes.state_blocks),
        control_blocks=tuple(jsets._replace(b, mu=rand(b.mu[0], (Bsz,)))
                             for b in lanes.control_blocks))
    j_fn, t_fn = getattr(jsets, name), getattr(tsets, name)
    cases = [(tsets.per_lane(t_fn(constraints_from_reference(
        gc, CPU, torch.float64)), Bsz), jax.vmap(lambda _: j_fn(gc))(
        jnp.arange(Bsz))),
             (t_fn(constraints_from_reference(lanes, CPU, torch.float64,
                                              lanes=True)),
              jax.vmap(j_fn)(lanes))]
    for out, ref in cases:
        for a, r in zip(out.state_blocks + out.control_blocks,
                        ref.state_blocks + ref.control_blocks):
            assert a.lam.shape == a.mu.shape == (Bsz,) + a.lam.shape[1:]
            np.testing.assert_array_equal(a.lam.numpy(), np.asarray(r.lam))
            np.testing.assert_array_equal(a.mu.numpy(), np.asarray(r.mu))


def _non_default(f):
    v = f.default
    if isinstance(v, bool):
        return not v
    if isinstance(v, int):
        return v + 3
    if isinstance(v, tuple):
        return tuple(0.5 + 0.1 * i for i in range(len(v)))
    return 0.5 * v + 0.25


# Reference options that no solver path reads: the converter refuses them
# away from their defaults.  The compiler knobs are dropped.
UNREAD = ("theta", "alpha_increase", "rho_trial", "gamma", "inner_print",
          "outer_print", "seed")
KNOBS = ("flat_loop", "loop_unroll")


def test_convert_carries_every_option():
    """Every field of the port's ``Options`` is one of the reference's with
    the same default, and the reference's fields are the port's, the unread
    ones and the TPU compiler knobs; each port field set away from its
    default arrives in the port, the compiler knobs set away from theirs
    are dropped."""
    jfields = {f.name: f for f in dataclasses.fields(JOptions)}
    tfields = {f.name: f for f in dataclasses.fields(agt.Options)}
    assert set(jfields) == set(tfields) | set(UNREAD) | set(KNOBS)
    assert not set(tfields) & set(UNREAD + KNOBS)
    for name, f in tfields.items():
        assert f.default == jfields[name].default, name
    jopts = JOptions(**{k: _non_default(jfields[k])
                        for k in tuple(tfields) + KNOBS})
    prob, _ = flagship_unicycle(p=2, N=5)
    tprob = problem_from_reference(dataclasses.replace(prob, opts=jopts),
                                   CPU, torch.float64)
    for name in tfields:
        assert getattr(tprob.opts, name) == getattr(jopts, name), name


@pytest.mark.parametrize("name", UNREAD)
def test_convert_refuses_unread_options(name):
    """A reference option that no solver path of the reference reads, set
    away from its default, is not refused: the reference solves such a
    problem exactly as with the default, and the converter drops the field,
    giving the default problem's options (``tests/test_torch_api.py``
    checks that any other unread field still raises)."""
    f = {f.name: f for f in dataclasses.fields(JOptions)}[name]
    prob, _ = flagship_unicycle(p=2, N=5)
    jopts = dataclasses.replace(prob.opts, **{name: _non_default(f)})
    assert getattr(jopts, name) != f.default
    tprob = problem_from_reference(dataclasses.replace(prob, opts=jopts),
                                   CPU, torch.float64)
    assert tprob.opts == problem_from_reference(prob, CPU,
                                                torch.float64).opts


@pytest.mark.parametrize("sense", ["eq", "soc"])
def test_convert_carries_senses(sense):
    """Blocks of every sense convert: each block's sense and active flags,
    the constraint set's active-set tolerance and the option it comes
    from arrive in the port, unbatched and per lane."""
    prob, spec = flagship_unicycle(p=2, N=5)
    opts = dataclasses.replace(prob.opts, active_set_tolerance=3e-3)
    gc = jsets.set_constraint_params(prob.gc, opts)
    gc = jsets._replace(gc, control_blocks=(jsets._replace(
        gc.control_blocks[0], sense=sense),))
    x = 0.3 * np.random.default_rng(2).standard_normal((spec.N, spec.n))
    traj = ag.PrimalDual(x=jnp.asarray(x), u=0.5 * jnp.ones((spec.T, spec.m)),
                         lam=jnp.zeros((spec.p, spec.T, spec.n)))
    gc = ag.update_active_set(gc, traj)
    tprob = problem_from_reference(dataclasses.replace(prob, gc=gc,
                                                       opts=opts), CPU,
                                   torch.float64)
    assert tprob.opts.active_set_tolerance == 3e-3
    assert float(tprob.gc.active_tol) == 3e-3
    for a, r in zip(tprob.gc.state_blocks + tprob.gc.control_blocks,
                    gc.state_blocks + gc.control_blocks):
        assert a.sense == r.sense
        np.testing.assert_array_equal(a.active.numpy(), np.asarray(r.active))
    assert tprob.gc.control_blocks[0].sense == sense
    assert any(bool(np.asarray(b.active).any()) for b in gc.state_blocks
               + gc.control_blocks)
    lanes = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), gc)
    tgc = constraints_from_reference(lanes, CPU, torch.float64, lanes=True)
    for a, r in zip(tgc.state_blocks + tgc.control_blocks,
                    gc.state_blocks + gc.control_blocks):
        assert a.active.shape == (2,) + np.asarray(r.active).shape
        assert a.sense == r.sense


def test_mpc_tracks_target():
    """``tests/test_mpc.py``'s double-integrator case through the port:
    the reference's closed loop (stats rows equal, states within 1e-8),
    and the players close half their distance to the targets."""
    p = 2
    model = ag.double_integrator_game(p=p)
    spec = ag.spec_from_model(model, 10, 0.1)
    xf = [jnp.array([1.0, 1.0, 0.0, 0.0]), jnp.array([-1.0, -1.0, 0.0, 0.0])]
    obj = ag.game_objective(spec, [10.0 * jnp.ones(4)] * p,
                            [0.1 * jnp.ones(2)] * p, xf,
                            [jnp.zeros(2)] * p, dtype=jnp.float64)
    opts = ag.Options(outer_iter=1, inner_iter=3, reg_0=1e-7, shift=1,
                      mpc_horizon=12, upsampling=2)
    prob = ag.game_problem(10, 0.1, jnp.zeros(8), model, opts, obj,
                           ag.game_constraints(spec))
    ref = jax.jit(j_mpc_solve)(prob)
    out = agt.mpc_solve(problem_from_reference(prob, CPU, torch.float64))
    assert out.states.shape == (1, 13, 8) and out.controls.shape == (1, 12, 4)
    np.testing.assert_array_equal(out.iters[0].numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(out.states[0].numpy(), np.asarray(ref.states),
                               rtol=0, atol=1e-8)
    tgt = np.zeros(8)
    for i in range(p):
        tgt[np.asarray(spec.pz[i])] = np.asarray(xf[i])
    end_err = np.linalg.norm(out.states[0, -1].numpy() - tgt)
    assert end_err < 0.5 * np.linalg.norm(tgt)
    assert bool(torch.isfinite(out.dyn_vio).all())


def test_solve_many_draws_the_init_chunk_by_chunk():
    """With a generator the fresh init is drawn chunk after chunk: equal to
    each chunk solved with the generator in turn; without one the init is
    zero, as before."""
    from algames_tpu_torch.presets import flagship_unicycle as t_flagship
    prob, spec = t_flagship(CPU, torch.float64, outer=1, inner=2, p=2, N=5)
    x0s = prob.x0[None] + 0.05 * torch.randn(
        (3, spec.n), generator=torch.Generator().manual_seed(0),
        dtype=torch.float64)
    out = agt.parallel.solve_many(prob, x0s, chunk=2,
                                  generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    pad = torch.cat([x0s, x0s[:1]])
    parts = [agt.newton_solve(prob, pad[i:i + 2], generator=gen)
             for i in (0, 2)]
    for leaf in ("x", "u", "lam"):
        want = torch.cat([getattr(p.traj, leaf) for p in parts])[:3]
        assert torch.equal(getattr(out.traj, leaf), want)
    zero = agt.parallel.solve_many(prob, x0s, chunk=2)
    assert not torch.equal(zero.traj.lam, out.traj.lam)
    torch.testing.assert_close(zero.traj.x, out.traj.x, rtol=0, atol=1e-6)
