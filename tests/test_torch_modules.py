"""Module-by-module parity of the PyTorch port against the JAX package.

The same inputs (numpy seeds, the reference problem carried over by
``algames_tpu_torch.convert.problem_from_reference``) go through each JAX
function (vmapped over a small batch) and its batch-first counterpart in the
port; every comparison runs in f64 with the tolerance stated at the call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.constraints import sets as jsets
from algames_tpu.core import traj as jtraj
from algames_tpu.models import integration as jint
from algames_tpu.objective import objective as jobj
from algames_tpu.parallel import batch as jbatch
from algames_tpu.presets import flagship_unicycle
from algames_tpu.problem import residual as JR
from algames_tpu import stats as jstats

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.core.spec import spec_from_model
from algames_tpu_torch.models import integration as tint
from algames_tpu_torch.objective import objective as tobj
from algames_tpu_torch.problem import residual as TR
from algames_tpu_torch import stats as tstats
from algames_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
B = 3
EXACT = dict(rtol=1e-13, atol=1e-13)     # same math, possibly other op order


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or EXACT))


@pytest.fixture(scope="module")
def setup():
    prob, spec = flagship_unicycle(p=3, N=8, outer=2, inner=3)
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(0)
    x = (np.asarray(prob.x0)[None, None]
         + 0.3 * rng.standard_normal((B, spec.N, spec.n)))
    u = 0.3 * rng.standard_normal((B, spec.T, spec.m))
    lam = 0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n))
    jtr = ag.PrimalDual(x=jnp.asarray(x), u=jnp.asarray(u),
                        lam=jnp.asarray(lam))
    ttr = ttraj.PrimalDual(x=T(x), u=T(u), lam=T(lam))
    # Per-lane AL state: some rows penalized, penalties from 1 to 1e7.
    def al(b):
        shape = (B,) + tuple(np.asarray(b.lam).shape)
        lam_b = 0.2 * rng.random(shape) * (rng.random(shape) < 0.5)
        mu_b = 10.0 ** rng.integers(0, 8, size=shape)
        return lam_b, mu_b
    jblocks, tblocks = {}, {}
    for kind in ("state_blocks", "control_blocks"):
        jb, tb = [], []
        for b_j, b_t in zip(getattr(prob.gc, kind), getattr(tprob.gc, kind)):
            lam_b, mu_b = al(b_j)
            jb.append(dataclasses.replace(b_j, lam=jnp.asarray(lam_b),
                                          mu=jnp.asarray(mu_b)))
            tb.append(dataclasses.replace(b_t, lam=T(lam_b), mu=T(mu_b)))
        jblocks[kind], tblocks[kind] = tuple(jb), tuple(tb)
    jgc = dataclasses.replace(prob.gc, **jblocks)
    tgc = dataclasses.replace(tprob.gc, **tblocks)
    gc_axes = jax.tree_util.tree_map(lambda a: 0 if a.ndim == 3 else None,
                                     jgc)
    return dict(prob=prob, spec=spec, tprob=tprob, jtr=jtr, ttr=ttr,
                jgc=jgc, tgc=tgc, gc_axes=gc_axes, rng=rng)


def test_spec_and_model_carried_over(setup):
    prob, tprob = setup["prob"], setup["tprob"]
    for f in ("N", "n", "m", "p", "ni", "mi", "pu", "px", "pz", "dt", "T",
              "S", "W", "homogeneous"):
        assert getattr(tprob.spec, f) == getattr(prob.spec, f), f
    assert spec_from_model(tprob.model, prob.spec.N, prob.spec.dt) \
        == tprob.spec
    assert tprob.opts.outer_iter == 2 and tprob.opts.inner_iter == 3
    np.testing.assert_array_equal(tprob.x0.numpy(), np.asarray(prob.x0))


def test_traj_ops(setup):
    spec, jtr, ttr = setup["spec"], setup["jtr"], setup["ttr"]
    rng = setup["rng"]
    flat = rng.standard_normal((B, spec.S))
    jd = jax.vmap(lambda f: jtraj.unpack_step(spec, f))(jnp.asarray(flat))
    td = ttraj.unpack_step(spec, T(flat))
    for a, r in zip((td.x, td.u, td.lam), (jd.x, jd.u, jd.lam)):
        close(a, r, rtol=0, atol=0)
    close(ttraj.pack_traj(spec, td), flat, rtol=0, atol=0)
    alpha = rng.random(B)
    ju = jax.vmap(jtraj.update_traj)(jtr, jnp.asarray(alpha), jd)
    tu = ttraj.update_traj(ttr, T(alpha), td)
    for a, r in zip((tu.x, tu.u, tu.lam), (ju.x, ju.u, ju.lam)):
        close(a, r, rtol=0, atol=0)
    close(ttraj.delta_step(td, T(alpha)),
          jax.vmap(jtraj.delta_step)(jd, jnp.asarray(alpha)))
    # key=None init and the MPC shift semantics.
    x0 = np.asarray(jtr.x[:, 0])
    for shift in (2, 2 ** 10):
        ji = jax.vmap(lambda x, p: jtraj.init_traj(spec, x, shift=shift,
                                                   prev=p))(jnp.asarray(x0),
                                                            jtr)
        ti = ttraj.init_traj(spec, T(x0), shift=shift, prev=ttr)
        for a, r in zip((ti.x, ti.u, ti.lam), (ji.x, ji.u, ji.lam)):
            close(a, r, rtol=0, atol=0)


def test_integrators_and_jacobians(setup):
    prob, spec, tprob, jtr, ttr = (setup[k] for k in
                                   ("prob", "spec", "tprob", "jtr", "ttr"))
    jm, tm, dt = prob.model, tprob.model, spec.dt
    xs, us = jtr.x[:, :-1], jtr.u
    for jf, tf in ((jint.rk2_step, tint.rk2_step),
                   (jint.rk3_step, tint.rk3_step)):
        ref = jax.vmap(jax.vmap(lambda x, u: jf(jm, x, u, dt)))(xs, us)
        close(tf(tm, ttr.x[:, :-1], ttr.u, dt), ref)
    ref = jax.vmap(lambda x0, u: jint.rollout_rk3(jm, x0, u, dt))(
        jtr.x[:, 0], us)
    close(tint.rollout_rk3(tm, ttr.x[:, 0], ttr.u, dt), ref)
    A, Bm = jax.vmap(lambda x, u: jint.step_jacobians_traj(jm, x, u, dt))(
        xs, us)
    tA, tB = tint.step_jacobians(tm, ttr.x[:, :-1], ttr.u, dt)
    close(tA, A)
    close(tB, Bm)
    # VJP dual pulls A^T lam, B^T lam against the Jacobians.
    lam_t = ttr.lam.permute(0, 2, 1, 3)
    gx, gu = tint.rk2_vjp(tm, ttr.x[:, :-1], ttr.u, lam_t, dt)
    close(gx, np.einsum('btca,btpc->btpa', np.asarray(A), lam_t.numpy()))
    close(gu, np.einsum('btcm,btpc->btpm', np.asarray(Bm), lam_t.numpy()))


def test_objective(setup):
    prob, spec, tprob, jtr, ttr = (setup[k] for k in
                                   ("prob", "spec", "tprob", "jtr", "ttr"))
    qx, ru = jax.vmap(lambda tr: jobj.cost_gradient(spec, prob.obj, tr))(jtr)
    tqx, tru = tobj.cost_gradient(spec, tprob.obj, ttr)
    close(tqx, qx)
    close(tru, ru)
    Qx, Ru = jobj.cost_hessian_diag(spec, prob.obj, jtr)
    tQx, tRu = tobj.cost_hessian_diag(spec, tprob.obj, F64, CPU)
    close(tQx, Qx, rtol=0, atol=0)
    close(tRu[:, None].expand(spec.p, spec.T, spec.m, spec.m), Ru, rtol=0,
          atol=0)
    obj = tobj.game_objective(
        spec, Q=[np.ones(4)] * 3, R=[0.1 * np.ones(2)] * 3,
        xf=[np.asarray([2.0, 0.4 * i, 0.0, 0.3]) for i in range(3)],
        uf=[np.zeros(2)] * 3, dtype=F64, device=CPU)
    for f in ("Qd", "Rd", "xf", "uf"):
        close(getattr(obj, f), getattr(prob.obj, f), rtol=0, atol=0)


def test_constraints_and_al_updates(setup):
    spec, jtr, ttr, jgc, tgc, axes = (setup[k] for k in (
        "spec", "jtr", "ttr", "jgc", "tgc", "gc_axes"))
    for jb, tb in zip(jgc.state_blocks + jgc.control_blocks,
                      tgc.state_blocks + tgc.control_blocks):
        cj = jax.vmap(lambda tr: jsets.block_values(jb, tr))(jtr)
        close(tsets.block_values(tb, ttr), cj)
        close(tsets.block_jacobian(tb, ttr),
              jax.vmap(lambda tr: jsets.block_jacobian(jb, tr))(jtr))
        close(tsets.block_violation_max(tsets.block_values(tb, ttr), tb.sense),
              jax.vmap(lambda c: jsets.block_violation_max(jb, c))(cj))
    jd = jax.vmap(jsets.dual_update, in_axes=(axes, 0), out_axes=axes)(
        jgc, jtr)
    jp = jax.vmap(jsets.penalty_update, in_axes=(axes,), out_axes=axes)(jgc)
    for port, ref in ((tsets.dual_update(tgc, ttr), jd),
                      (tsets.penalty_update(tgc), jp)):
        for a, r in zip(port.state_blocks + port.control_blocks,
                        ref.state_blocks + ref.control_blocks):
            close(a.lam, r.lam, rtol=0, atol=0)
            close(a.mu, r.mu, rtol=0, atol=0)
    rs = tsets.reset_constraints(tgc, B)
    jr = jsets.reset_constraints(jgc)
    for a, r in zip(rs.state_blocks, jr.state_blocks):
        assert a.lam.shape == (B,) + tuple(r.lam.shape[-2:])
        close(a.lam, np.zeros(a.lam.shape), rtol=0, atol=0)
        close(a.mu, np.broadcast_to(np.asarray(r.mu), a.mu.shape), rtol=0,
              atol=0)
    # The builders give the reference's blocks.
    tspec, prob = setup["tprob"].spec, setup["prob"]
    g = tsets.game_constraints(tspec, F64, CPU)
    g = tsets.add_control_bound(tspec, tsets.add_collision_avoidance(
        tspec, g, 0.08), 2 * np.ones(tspec.m), -2 * np.ones(tspec.m))
    for a, r in zip(g.state_blocks, prob.gc.state_blocks):
        assert (a.owner, a.params.pxi, a.params.pxj) == (
            r.owner, r.params.pxi, r.params.pxj)
        close(a.params.radius, r.params.radius, rtol=0, atol=0)
    assert g.control_blocks[0].params.mask == \
        prob.gc.control_blocks[0].params.mask


def test_point_data_structured_q_and_residual(setup):
    prob, spec, tprob, jtr, ttr, jgc, tgc, axes = (setup[k] for k in (
        "prob", "spec", "tprob", "jtr", "ttr", "jgc", "tgc", "gc_axes"))
    reg = np.array([1e-3, 0.5, 7.0])

    def ref(tr, g, r):
        pd = JR.point_data(prob.model, spec, prob.obj, g, tr)
        res, sq, sv, cv = JR.assemble_structured_from_point(
            spec, prob.obj, g, tr, pd, reg=r)
        res2 = JR.residual_from_point(spec, g, pd)
        return (pd, res, sq, sv, cv, res2, JR.residual_norm(spec, res),
                JR.dynamics_violation(res), JR.optimality_violation(res),
                JR.residual_knot_blocks(spec, res), JR.point_violations(g, pd))
    (pd, res, sq, sv, cv, res2, rn, dv, ov, kb, (psv, pcv)) = jax.vmap(
        ref, in_axes=(0, axes, 0))(jtr, jgc, jnp.asarray(reg))

    tpd = TR.point_data(tprob.model, spec, tprob.obj, tgc, ttr)
    tres, tsq, tsv, tcv = TR.assemble_structured_from_point(
        spec, tprob.obj, tgc, ttr, tpd, reg=T(reg))
    # PointData leaf by leaf (bound-block Jacobians are empty placeholders).
    for a, r in zip(tree_leaves(tpd), jax.tree_util.tree_leaves(pd)):
        if a.numel():
            close(a, r)
    for f in ("qdiag", "wv", "Ublk", "A", "B"):
        close(getattr(tsq, f), getattr(sq, f))
    for port, r in ((tres, res), (TR.residual_from_point(spec, tgc, tpd),
                                  res2)):
        close(port.rx, r.rx)
        close(port.ru, r.ru)
        close(port.rd, r.rd)
    close(tsv, sv)
    close(tcv, cv)
    tpsv, tpcv = TR.point_violations(tgc, tpd)
    close(tpsv, psv)
    close(tpcv, pcv)
    close(TR.residual_norm(spec, tres), rn)
    close(TR.dynamics_violation(tres), dv)
    close(TR.optimality_violation(tres), ov)
    close(TR.residual_knot_blocks(spec, tres), kb)
    assert TR.structured_w_owner(tgc) == JR.structured_w_owner(prob.gc)


def test_stats_record(setup):
    rng = setup["rng"]
    cap = 5
    js = jax.vmap(lambda _: jstats.init_stats(cap, jnp.float64))(jnp.arange(B))
    ts = tstats.init_stats(B, cap, F64, CPU)
    for step in range(7):                         # past capacity
        active = rng.random(B) < 0.7
        vals = rng.standard_normal((7, B))
        js = jax.vmap(lambda s, a, *v: jstats.record(s, a, step, *v))(
            js, jnp.asarray(active), *[jnp.asarray(v) for v in vals])
        ts = tstats.record(ts, torch.as_tensor(active), step,
                           *[T(v) for v in vals])
    close(ts.iter, js.iter, rtol=0, atol=0)
    close(ts.outer, js.outer, rtol=0, atol=0)
    close(ts.data, js.data, rtol=0, atol=0)


def test_solve_many_padding_and_reduce():
    """N=5 scenarios in chunks of 2 (one padded lane), with and without a
    reduction, against the reference's solve_many."""
    prob, spec = flagship_unicycle(p=2, N=6, outer=2, inner=4)
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(1)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((5, spec.n))
    ref = jbatch.solve_many(prob, jnp.asarray(x0s), method="schur", chunk=2)
    out = agt.parallel.solve_many(tprob, T(x0s), chunk=2)
    close(out.stats.iter, ref.stats.iter, rtol=0, atol=0)
    close(out.traj.x, ref.traj.x, rtol=1e-9, atol=1e-9)
    close(out.traj.u, ref.traj.u, rtol=1e-9, atol=1e-9)
    close(out.rho, ref.rho, rtol=0, atol=0)
    assert out.gc.state_blocks[0].lam.shape[0] == 5
    close(agt.parallel.convergence_fraction(out, tprob.opts),
          jbatch.convergence_fraction(ref, prob.opts), rtol=0, atol=0)
    close(agt.parallel.divergence_mask(out), jbatch.divergence_mask(ref),
          rtol=0, atol=0)

    red_j = jbatch.solve_many(prob, jnp.asarray(x0s), method="schur",
                              chunk=2, reduce=lambda r: (r.traj.x,
                                                         r.stats.iter))
    red_t = agt.parallel.solve_many(tprob, T(x0s), chunk=2,
                                    reduce=lambda r: (r.traj.x, r.stats.iter))
    assert red_t[0].shape == (3, 2, spec.N, spec.n)       # pad lane kept
    close(red_t[1], red_j[1], rtol=0, atol=0)
    close(red_t[0], red_j[0], rtol=1e-9, atol=1e-9)
