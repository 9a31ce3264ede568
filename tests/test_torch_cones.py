"""The constraint cones in the PyTorch port against the JAX package: the
equality and second-order-cone senses, the active-set flags and the
violation vectors of ``constraints/sets.py``, the objective's
``total_cost``, the eager fused-trial version on equality and cone blocks
against the body the reference's fused trial kernel replays, and the
ring-road game (the flagship with an equality block) end to end.  Inputs
come from numpy seeds; f64 on CPU, with the tolerance at each call.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.constraints import sets as jsets
from algames_tpu.objective import objective as jobj
from algames_tpu.ops.trial_pallas import _trial_eval
from algames_tpu.parallel import batch as jbatch
from algames_tpu.presets import flagship_unicycle

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.objective import objective as tobj
from algames_tpu_torch.ops import trial as ttrial
from algames_tpu_torch.utils import tree_leaves

from test_torch_roundabout import close, gc_axes

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import onto_ring, ring3_eq_game  # noqa: E402
from reference_fractions import sweep_inputs  # noqa: E402
from torch_goldens import ring3_eq_problem  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
B = 3


def _game(sense, N=6):
    """The flagship (p=3) with two circle obstacles on player 1 and the
    shared control bound, both blocks turned to ``sense``; one
    collision-cost pair per ordered player pair."""
    prob, spec = flagship_unicycle(N=N)
    gc = ag.add_circle_constraint(spec, prob.gc, [0.2, 1.0], [0.3, 0.5],
                                  [0.3, 0.2], i=1)
    gc = dataclasses.replace(
        gc, state_blocks=gc.state_blocks[:-1] + (dataclasses.replace(
            gc.state_blocks[-1], sense=sense),),
        control_blocks=(dataclasses.replace(gc.control_blocks[0],
                                            sense=sense),))
    obj = jobj.add_collision_cost(spec, prob.obj, radius=0.3 * jnp.ones(3),
                                  mu=2.0 * jnp.ones(3))
    prob = dataclasses.replace(prob, obj=obj,
                               gc=ag.set_constraint_params(gc, prob.opts))
    return prob, spec


def _inputs(prob, spec, rng, mu_decades=8):
    """Random iterates around the start and per-lane AL state (duals of
    both signs, half of the rows zero; penalties 1 .. 10^(mu_decades-1))
    on both sides."""
    arrs = dict(
        x=np.asarray(prob.x0)[None, None]
        + 0.3 * rng.standard_normal((B, spec.N, spec.n)),
        u=0.8 * rng.standard_normal((B, spec.T, spec.m)),
        lam=0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n)))
    jtr = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in arrs.items()})
    ttr = ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    tprob = problem_from_reference(prob, CPU, F64)
    jb, tb = {}, {}
    for kind in ("state_blocks", "control_blocks"):
        js, ts = [], []
        for b_j, b_t in zip(getattr(prob.gc, kind), getattr(tprob.gc, kind)):
            shape = (B,) + tuple(np.asarray(b_j.lam).shape)
            lam = 0.4 * rng.standard_normal(shape) * (rng.random(shape) < 0.5)
            mu = 10.0 ** rng.integers(0, mu_decades, size=shape)
            js.append(dataclasses.replace(b_j, lam=jnp.asarray(lam),
                                          mu=jnp.asarray(mu)))
            ts.append(dataclasses.replace(b_t, lam=torch.as_tensor(lam),
                                          mu=torch.as_tensor(mu)))
        jb[kind], tb[kind] = tuple(js), tuple(ts)
    return (tprob, jtr, ttr, dataclasses.replace(prob.gc, **jb),
            dataclasses.replace(tprob.gc, **tb))


@pytest.mark.parametrize("sense", ["ineq", "eq", "soc"])
def test_sets_by_sense(sense):
    """Per block: the AL expansion (gradient, Hessian, values) and the
    violation maximum; the dual and penalty updates (eq: clipped to
    +-lam_max, soc: the cone projection of lam - alpha mu c); the active
    flags at the reference's tolerance; the state, control and dynamics
    violation vectors; all within 1e-13 (flags equal)."""
    prob, spec = _game(sense)
    tprob, jtr, ttr, jgc, tgc = _inputs(prob, spec, np.random.default_rng(5))
    axes = gc_axes(jgc)
    for jb, tb in zip(jgc.state_blocks + jgc.control_blocks,
                      tgc.state_blocks + tgc.control_blocks):
        assert tb.sense == jb.sense
        jexp = jax.jit(jax.vmap(lambda b, tr: jsets.al_expansion_full(b, tr),
                                in_axes=(gc_axes(jb), 0)))(jb, jtr)
        for a, r in zip(tsets.al_expansion_full(tb, ttr), jexp):
            close(a, r, 1e-13)
        close(tsets.block_violation_max(tsets.block_values(tb, ttr),
                                        tb.sense),
              jax.vmap(lambda c: jsets.block_violation_max(jb, c))(jexp[2]),
              1e-13)
    jd = jax.jit(jax.vmap(jsets.dual_update, in_axes=(axes, 0),
                          out_axes=axes))(jgc, jtr)
    jp = jax.jit(jax.vmap(jsets.penalty_update, in_axes=(axes,),
                          out_axes=axes))(jgc)
    ja = jax.jit(jax.vmap(jsets.update_active_set, in_axes=(axes, 0)))(
        jgc, jtr)
    td, tp = tsets.dual_update(tgc, ttr), tsets.penalty_update(tgc)
    ta = tsets.update_active_set(tgc, ttr)
    for port, ref in ((td, jd), (tp, jp)):
        for a, r in zip(port.state_blocks + port.control_blocks,
                        ref.state_blocks + ref.control_blocks):
            close(a.lam, r.lam, 1e-13)
            close(a.mu, r.mu, 1e-13)
    for a, r in zip(ta.state_blocks + ta.control_blocks,
                    ja.state_blocks + ja.control_blocks):
        np.testing.assert_array_equal(a.active.numpy(), np.asarray(r.active))
    assert float(tgc.active_tol) == prob.opts.active_set_tolerance
    close(tsets.state_violation(tgc, ttr),
          jax.vmap(jsets.state_violation, in_axes=(axes, 0))(jgc, jtr), 1e-13)
    close(tsets.control_violation(tgc, ttr),
          jax.vmap(jsets.control_violation, in_axes=(axes, 0))(jgc, jtr),
          1e-13)
    close(tsets.dynamics_violation_vector(tprob.model, spec, ttr),
          jax.jit(jax.vmap(lambda tr: jsets.dynamics_violation_vector(
              prob.model, spec, tr)))(jtr), 1e-13)
    if sense == "soc":
        v = np.random.default_rng(2).standard_normal((B, 7, 3))
        close(tsets.soc_projection(torch.as_tensor(v)),
              jax.vmap(jsets._soc_projection)(jnp.asarray(v)), 1e-13)


def test_total_cost_and_reset_duals():
    """Each player's total cost (stage, terminal and collision-cost terms)
    and each pair's collision stage cost per lane within 1e-13;
    ``reset_duals`` zeroes the multipliers only."""
    prob, spec = _game("ineq")
    tprob, jtr, ttr, _, _ = _inputs(prob, spec, np.random.default_rng(8))
    for i in range(spec.p):
        close(agt.total_cost(spec, tprob.obj, ttr, i),
              jax.vmap(lambda tr: jobj.total_cost(spec, prob.obj, tr, i))(jtr),
              1e-13)
    for idx in range(len(tprob.obj.pair_i)):
        close(tobj.collision_stage_cost(tprob.obj, idx, ttr.x),
              jax.vmap(jax.vmap(lambda x: jobj.collision_stage_cost(
                  prob.obj, idx, x)))(jtr.x), 1e-13)
    z = agt.reset_duals(ttr)
    assert z.x is ttr.x and z.u is ttr.u and not z.lam.any()


@pytest.mark.parametrize("sense", ["eq", "soc"])
def test_trial_plain_on_cones(sense):
    """The fused trial's plain version (what K4 computes) on equality and
    cone blocks against the body the reference's fused trial kernel
    replays (``trial_pallas._trial_eval``): tn and every carried leaf
    within 1e-12; the problem lies inside the kernel's specialization, and
    the kernel's table flags the equality blocks."""
    prob, spec = _game(sense)
    tprob, jtr, ttr, jgc, tgc = _inputs(prob, spec, np.random.default_rng(9))
    rng = np.random.default_rng(10)
    d = dict(x=0.05 * rng.standard_normal((B, spec.N, spec.n)),
             u=0.05 * rng.standard_normal((B, spec.T, spec.m)),
             lam=0.05 * rng.standard_normal((B, spec.p, spec.T, spec.n)))
    alpha, reg = np.array([1.0, 0.5, 0.125]), np.array([1e-3, 0.3, 7.0])
    ref = jax.jit(jax.vmap(
        lambda tr, dt, a, r, g: _trial_eval(prob.model, spec, prob.obj, g,
                                            tr, dt, a, r),
        in_axes=(0, 0, 0, 0, gc_axes(jgc))))(
        jtr, ag.PrimalDual(**{k: jnp.asarray(v) for k, v in d.items()}),
        jnp.asarray(alpha), jnp.asarray(reg), jgc)
    assert ttrial.trial_supported(tprob.model, spec, tprob.obj, tgc)
    tn, lite = ttrial.trial_eval(
        tprob.model, spec, tprob.obj, tgc, ttr,
        ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in d.items()}),
        torch.as_tensor(alpha), torch.as_tensor(reg))
    close(tn, ref[0], 1e-12)
    for a, r in zip(tree_leaves(lite), jax.tree_util.tree_leaves(ref[1])):
        close(a, r, 1e-12)
    meta, _, _, _ = ttrial._state_tables(tgc.state_blocks, F64, CPU)
    assert meta[11::12] == [int(b.sense == "eq") for b in tgc.state_blocks]


def test_ring3_eq_solve():
    """The ring-road game end to end: the port's native builder equals the
    reference's converted, and its sweep starts put player 0 on the ring;
    at N=10 the port's ``"thomas"`` path (plain
    versions, fused trial plain) against the reference's ``"schur"`` solve
    of three starts: stats rows equal, x within 1e-8; at N=20 the port
    reproduces the frozen ``ring3_eq_N20`` solution (58 stats rows, x and u
    within 1e-8), the four gates met."""
    prob, spec = ring3_eq_problem(N=10)
    tprob = problem_from_reference(prob, CPU, F64)
    native, _ = ring3_eq_game(CPU, F64, N=10)
    for a, r in zip(tree_leaves(native.gc), tree_leaves(tprob.gc)):
        assert torch.equal(a, r)
    assert [b.sense for b in native.gc.state_blocks] == [
        b.sense for b in tprob.gc.state_blocks]
    x0 = np.asarray(prob.x0)
    starts = onto_ring(x0[None] + 0.05 * np.random.default_rng(0)
                       .standard_normal((4096, spec.n)), spec.p)
    np.testing.assert_array_equal(
        starts[:8], sweep_inputs(x0, spec.n, 8, "ring3_eq_N20"))
    np.testing.assert_allclose(np.hypot(starts[:, 0], starts[:, spec.p] + 4),
                               4.0, atol=1e-12)
    rng = np.random.default_rng(4)
    x0s = np.asarray(prob.x0)[None] + 0.01 * rng.standard_normal((3, spec.n))
    x0s[:, [0, spec.p]] = np.asarray(prob.x0)[[0, spec.p]]
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s))
    res = agt.newton_solve(dataclasses.replace(
        tprob, opts=dataclasses.replace(tprob.opts, ls_fused=True)),
        torch.as_tensor(x0s))
    np.testing.assert_array_equal(res.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    close(res.traj.x, ref.traj.x, 1e-8)
    gold = np.load(os.path.join(HERE, "golden_torch", "ring3_eq_N20.npz"))
    full, _ = ring3_eq_game(CPU, F64)
    out = agt.newton_solve(full)
    it = int(out.stats.iter[0])
    assert it == int(gold["iter"]) == 58
    np.testing.assert_allclose(out.traj.x[0].numpy(), gold["x"], atol=1e-8)
    np.testing.assert_allclose(out.traj.u[0].numpy(), gold["u"], atol=1e-8)
    s = out.stats
    assert max(float(s.dyn_vio[0, it - 1]), float(s.con_vio[0, it - 1]),
               float(s.sta_vio[0, it - 1]),
               float(s.opt_vio[0, it - 1])) < 1e-3
