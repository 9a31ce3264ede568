"""The 4-player roundabout in the PyTorch port against the JAX package.

Module parity for what the roundabout adds to the flagship (circle
obstacles, state and velocity bounds, collision-cost pairs, the dense
Hessian assembly), the native preset against the reference's, and the
slice as a whole: the port's f64 CPU solve against the frozen
``round4_N40`` equilibrium and a small batch against the JAX ``schur``
solve.  The module checks run on a shortened roundabout (N=10) with inputs
made from numpy seeds; f64 throughout, with the tolerance at each call.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.constraints import sets as jsets
from algames_tpu.objective import objective as jobj
from algames_tpu.parallel import batch as jbatch
from algames_tpu.presets import PRESETS
from algames_tpu.problem import residual as JR

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.objective import objective as tobj
from algames_tpu_torch.presets import roundabout
from algames_tpu_torch.problem import residual as TR
from algames_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
HERE = os.path.dirname(os.path.abspath(__file__))
B = 3


def jax_roundabout(N, outer=10, inner=16):
    """The reference package's roundabout (``presets.roundabout``) with N
    knots, built through its public builders."""
    p, dt = 4, 0.1
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    starts = np.array([[-1.5, 0.0], [1.5, 0.0], [0.0, -1.5], [0.0, 1.5]])
    goals = np.array([-starts[o] for o in [3, 2, 0, 1]])
    headings = np.arctan2(-starts[:, 1], -starts[:, 0])
    obj = ag.game_objective(
        spec, Q=[jnp.asarray([5.0, 5.0, 0.2, 0.2])] * p,
        R=[0.1 * jnp.ones(2)] * p,
        xf=[jnp.asarray([goals[i, 0], goals[i, 1], headings[i], 0.3])
            for i in range(p)], uf=[jnp.zeros(2)] * p)
    obj = jobj.add_collision_cost(spec, obj, radius=0.4 * jnp.ones(p),
                                  mu=5.0 * jnp.ones(p))
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, 0.08)
    gc = jsets.add_circle_constraint(spec, gc, jnp.asarray([0.0]),
                                     jnp.asarray([0.0]), jnp.asarray([0.3]))
    gc = jsets.add_velocity_bound(spec, model, gc, 1.5 * np.ones(p),
                                  -0.2 * np.ones(p))
    gc = ag.add_control_bound(spec, gc, 3 * jnp.ones(spec.m),
                              -3 * jnp.ones(spec.m))
    x0 = np.zeros(spec.n)
    for i in range(p):
        x0[np.asarray(spec.px[i])] = starts[i]
        x0[spec.pz[i][2]] = headings[i]
        x0[spec.pz[i][3]] = 0.3 + 0.1 * i
    return ag.game_problem(N, dt, jnp.asarray(x0), model,
                           ag.Options(outer_iter=outer, inner_iter=inner),
                           obj, gc), spec


def crowded_arrays(spec, B, rng):
    """Iterates with the players crowded around the island (so collision
    costs and constraints, the circle and the speed bounds are active in
    many knots), as numpy arrays."""
    x = 0.3 * rng.standard_normal((B, spec.N, spec.n))
    sp = [spec.pz[i][3] for i in range(spec.p)]
    x[:, :, sp] = 0.7 + 0.8 * rng.standard_normal((B, spec.N, spec.p))
    return dict(x=x, u=0.5 * rng.standard_normal((B, spec.T, spec.m)),
                lam=0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n)))


def random_al_state(jgc, tgc, B, rng):
    """The same per-lane AL state on both sides: half the rows with
    positive duals, penalties from 1 to 1e7."""
    out = {}
    for kind in ("state_blocks", "control_blocks"):
        jb, tb = [], []
        for b_j, b_t in zip(getattr(jgc, kind), getattr(tgc, kind)):
            shape = (B,) + tuple(np.asarray(b_j.lam).shape)
            lam = 0.2 * rng.random(shape) * (rng.random(shape) < 0.5)
            mu = 10.0 ** rng.integers(0, 8, size=shape)
            jb.append(dataclasses.replace(b_j, lam=jnp.asarray(lam),
                                          mu=jnp.asarray(mu)))
            tb.append(dataclasses.replace(b_t, lam=torch.as_tensor(lam),
                                          mu=torch.as_tensor(mu)))
        out[kind] = (tuple(jb), tuple(tb))
    return (dataclasses.replace(jgc, **{k: v[0] for k, v in out.items()}),
            dataclasses.replace(tgc, **{k: v[1] for k, v in out.items()}))


def gc_axes(jgc):
    return jax.tree_util.tree_map(lambda a: 0 if a.ndim == 3 else None, jgc)


def close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def small():
    prob, spec = jax_roundabout(N=10)
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(3)
    arrs = crowded_arrays(spec, B, rng)
    jtr = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in arrs.items()})
    ttr = ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    jgc, tgc = random_al_state(prob.gc, tprob.gc, B, rng)
    return dict(prob=prob, spec=spec, tprob=tprob, jtr=jtr, ttr=ttr, jgc=jgc,
                tgc=tgc)


def test_circle_state_and_velocity_blocks(small):
    """Values, Jacobians, violations, dual and penalty updates of every
    block (collision, circle, velocity-bound state blocks, control bound)
    <= 1e-12; the native builders give the reference's blocks."""
    spec, jtr, ttr, jgc, tgc = (small[k] for k in
                                ("spec", "jtr", "ttr", "jgc", "tgc"))
    kinds = [type(b.params).__name__ for b in tgc.state_blocks]
    assert kinds == (["CollisionParams"] * 12 + ["CircleParams"] * 4
                     + ["BoundParams"] * 16)
    for jb, tb in zip(jgc.state_blocks + jgc.control_blocks,
                      tgc.state_blocks + tgc.control_blocks):
        cj = jax.vmap(lambda tr: jsets.block_values(jb, tr))(jtr)
        close(tsets.block_values(tb, ttr), cj, 1e-12)
        close(tsets.block_jacobian(tb, ttr),
              jax.vmap(lambda tr: jsets.block_jacobian(jb, tr))(jtr), 1e-12)
        close(tsets.block_violation_max(tsets.block_values(tb, ttr), tb.sense),
              jax.vmap(lambda c: jsets.block_violation_max(jb, c))(cj), 1e-12)
    axes = gc_axes(jgc)
    jd = jax.vmap(jsets.dual_update, in_axes=(axes, 0), out_axes=axes)(
        jgc, jtr)
    jp = jax.vmap(jsets.penalty_update, in_axes=(axes,), out_axes=axes)(jgc)
    for port, ref in ((tsets.dual_update(tgc, ttr), jd),
                      (tsets.penalty_update(tgc), jp)):
        for a, r in zip(port.state_blocks + port.control_blocks,
                        ref.state_blocks + ref.control_blocks):
            close(a.lam, r.lam, 1e-12)
            close(a.mu, r.mu, 1e-12)
    tspec, model = small["tprob"].spec, small["tprob"].model
    g = tsets.game_constraints(tspec, F64, CPU)
    g = tsets.add_circle_constraint(tspec, g, [0.0, 1.0], [0.5, 0.0],
                                    [0.3, 0.2], i=2)
    g = tsets.add_velocity_bound(tspec, model, g, [1.5, np.inf, 1.0, 2.0],
                                 [-0.2, -np.inf, -1.0, -2.0])
    g = tsets.add_state_bound(tspec, g, 1, 5.0, -5.0)
    r = ag.game_constraints(spec)
    r = jsets.add_circle_constraint(spec, r, jnp.asarray([0.0, 1.0]),
                                    jnp.asarray([0.5, 0.0]),
                                    jnp.asarray([0.3, 0.2]), i=2)
    r = jsets.add_velocity_bound(spec, small["prob"].model, r,
                                 np.asarray([1.5, np.inf, 1.0, 2.0]),
                                 np.asarray([-0.2, -np.inf, -1.0, -2.0]))
    r = jsets.add_state_bound(spec, r, 1, 5.0, -5.0)
    assert len(g.state_blocks) == len(r.state_blocks) == 1 + 12 + 1
    for a, b in zip(g.state_blocks, r.state_blocks):
        assert (a.owner, a.is_state, type(a.params).__name__) == (
            b.owner, b.is_state, type(b.params).__name__)
        assert tuple(a.lam.shape) == tuple(np.asarray(b.lam).shape)
        for f in dataclasses.fields(a.params):
            va, vb = getattr(a.params, f.name), getattr(b.params, f.name)
            if isinstance(va, torch.Tensor):
                close(va, vb, 0)
            else:
                assert tuple(np.atleast_1d(va)) == tuple(np.atleast_1d(vb))
    assert model.velocity_index(3) == small["prob"].model.velocity_index(3)


def test_collision_cost_gradient_and_hessian(small):
    """cost_gradient and the dense cost_hessian with the 12 collision-cost
    pairs, <= 1e-12; the pairs carried over and rebuilt natively agree."""
    prob, spec, tprob, jtr, ttr = (small[k] for k in
                                   ("prob", "spec", "tprob", "jtr", "ttr"))
    qx, ru = jax.vmap(lambda tr: jobj.cost_gradient(spec, prob.obj, tr))(jtr)
    tqx, tru = tobj.cost_gradient(spec, tprob.obj, ttr)
    close(tqx, qx, 1e-12)
    close(tru, ru, 1e-12)
    Qx, Ru = jax.vmap(lambda tr: jobj.cost_hessian(spec, prob.obj, tr))(jtr)
    tQx, tRu = tobj.cost_hessian(spec, tprob.obj, ttr)
    close(tQx, Qx, 1e-12)
    close(tRu[None, :, None].expand(B, spec.p, spec.T, spec.m, spec.m), Ru,
          0)
    # Some pairs are active and their Hessians are not diagonal.
    off = tQx - torch.diag_embed(torch.diagonal(tQx, dim1=-2, dim2=-1))
    assert bool((off.abs() > 1e-3).any())
    native = tobj.add_collision_cost(
        tprob.spec, tobj.game_objective(
            tprob.spec, Q=[np.ones(4)] * 4, R=[np.ones(2)] * 4,
            xf=[np.zeros(4)] * 4, uf=[np.zeros(2)] * 4, dtype=F64,
            device=CPU), radius=0.4 * np.ones(4), mu=5.0 * np.ones(4))
    for f in ("pair_i", "pair_j", "pxi", "pxj"):
        assert getattr(native, f) == getattr(tprob.obj, f)
    close(native.mu, prob.obj.mu, 0)
    close(native.r, prob.obj.r, 0)


def test_dense_assembly(small):
    """assemble_from_point (residual, dense JacBlocks, violations) at p=4,
    N=10 against the reference, <= 1e-10; the structured form is refused
    for the roundabout and kept for the flagship."""
    prob, spec, tprob, jtr, ttr, jgc, tgc = (small[k] for k in (
        "prob", "spec", "tprob", "jtr", "ttr", "jgc", "tgc"))
    reg = np.array([1e-3, 0.5, 7.0])

    def ref(tr, g, r):
        pd = JR.point_data(prob.model, spec, prob.obj, g, tr)
        return JR.assemble_from_point(spec, prob.obj, g, tr, pd, reg=r)
    res, jb, sv, cv = jax.jit(jax.vmap(ref, in_axes=(0, gc_axes(jgc), 0)))(
        jtr, jgc, jnp.asarray(reg))
    tpd = TR.point_data(tprob.model, spec, tprob.obj, tgc, ttr)
    tres, tjb, tsv, tcv = TR.assemble_from_point(
        spec, tprob.obj, tgc, ttr, tpd, reg=torch.as_tensor(reg))
    for a, r in ((tres.rx, res.rx), (tres.ru, res.ru), (tres.rd, res.rd),
                 (tjb.Qblk, jb.Qblk), (tjb.Ublk, jb.Ublk), (tjb.A, jb.A),
                 (tjb.B, jb.B), (tsv, sv), (tcv, cv)):
        close(a, r, 1e-10)
    assert not TR.structured_q_supported(spec, tprob.obj, tgc)
    assert not JR.structured_q_supported(spec, prob.obj, prob.gc)
    flag = problem_from_reference(PRESETS["uni3_N20"]()[0], CPU, F64)
    assert TR.structured_q_supported(flag.spec, flag.obj, flag.gc)


def test_preset_matches_reference():
    """The port's native roundabout builder gives the reference's problem,
    carried over by problem_from_reference (circle and state-bound blocks,
    the collision-cost pairs)."""
    ref = problem_from_reference(PRESETS["round4_N40"]()[0], CPU, F64)
    prob, spec = roundabout(CPU, F64)
    assert spec == ref.spec and prob.opts == ref.opts
    assert prob.model == ref.model
    for f in ("pair_i", "pair_j", "pxi", "pxj"):
        assert getattr(prob.obj, f) == getattr(ref.obj, f)
    for a, r in zip(tree_leaves((prob.x0, prob.obj, prob.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc))):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-15,
                                   atol=1e-15)
    for a, r in zip(prob.gc.state_blocks + prob.gc.control_blocks,
                    ref.gc.state_blocks + ref.gc.control_blocks):
        assert (a.owner, a.is_state, type(a.params)) == (
            r.owner, r.is_state, type(r.params))
        if hasattr(a.params, "mask"):
            assert a.params.mask == r.params.mask
    p32, _ = roundabout(CPU, torch.float32)
    assert p32.opts.eps_opt == 1e-2 and prob.opts.eps_opt == 1e-3


@pytest.mark.parametrize("ls_fused", [False, True])
def test_golden_round4_N40(ls_fused):
    """The port's f64 CPU solve reproduces the frozen equilibrium:
    iteration 37, x and u within 1e-8."""
    gold = np.load(os.path.join(HERE, "golden", "round4_N40.npz"))
    prob, _ = roundabout(CPU, F64)
    prob = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, ls_fused=ls_fused))
    out = agt.newton_solve(prob)
    it = int(out.stats.iter[0])
    assert it == int(gold["iter"]) == 37
    np.testing.assert_allclose(out.traj.x[0].numpy(), gold["x"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out.traj.u[0].numpy(), gold["u"], rtol=0,
                               atol=1e-8)
    vio = {k: float(getattr(out.stats, k)[0, it - 1])
           for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
    assert all(v < 1e-3 for v in vio.values()), vio


def test_batch_matches_reference_schur():
    """B=2 roundabout solves at outer 2 x inner 4 against the JAX schur
    solve: equal per-lane iteration counts, trajectories within 1e-8."""
    prob, spec = PRESETS["round4_N40"](outer=2, inner=4)
    rng = np.random.default_rng(0)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((2, spec.n))
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s))
    tprob = problem_from_reference(prob, CPU, F64)
    out = agt.parallel.solve_batch(tprob, torch.as_tensor(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    for a, r in ((out.traj.x, ref.traj.x), (out.traj.u, ref.traj.u)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
