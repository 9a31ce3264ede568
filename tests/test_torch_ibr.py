"""Iterative best response in the PyTorch port against the JAX package: the
per-player helpers, the p=1 player sub-KKT solve (K3's plain version and
the CPU path of its wrapper), the reference's own IBR oracles
(``tests/test_ibr.py``), a batched Gauss-Seidel solve lane for lane, the
frozen solution ``tests/golden_torch/ibr_uni3_N20.npz`` that
``chip_smoke.py`` holds the kernel path to, and the quadrotor's IBR (its
player systems take K3's size classes for d <= 32 on the card) against the
JAX package's frozen ``ibr_quad2_N6.npz``.

Inputs come from numpy seeds; f64 throughout.  Tolerances: 0 for the step
scatter, 1e-12 for the other helpers (the same slices and sums of inputs
that the two packages assemble in another order), 1e-10 times the
solution's scale for the KKT solves, 1e-8 on solved trajectories with equal
stats row counts.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
from algames_tpu.problem import ibr as jibr
from algames_tpu.problem import residual as JR
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur
from algames_tpu.problem.options import IBROptions as JIBROptions

import algames_tpu_torch as agt
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.ops import thomas
from algames_tpu_torch.presets import flagship_unicycle
from algames_tpu_torch.problem import ibr as tibr
from algames_tpu_torch.problem import residual as TR
from algames_tpu_torch.problem.linear_solver import JacBlocks
from algames_tpu_torch.utils import tree_leaves

from test_ibr import _mk
from test_torch_roundabout import gc_axes, random_al_state

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
CPU, F64 = torch.device("cpu"), torch.float64
B = 2


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


def _unicycle2(outer=2, inner=4):
    """``tests/test_ibr.py``'s two-player unicycle with collision avoidance
    (r = 0.2)."""
    model = ag.unicycle_game(p=2)
    N, dt, obj, gc, opts = _mk(model, 2, outer_iter=outer, inner_iter=inner)
    gc = ag.add_collision_avoidance(ag.spec_from_model(model, N, dt), gc, 0.2)
    gc = ag.add_control_bound(ag.spec_from_model(model, N, dt), gc,
                              2 * jnp.ones(4), -2 * jnp.ones(4))
    x0 = jnp.array([0.0, 1.0, 0.0, 1.0, 0.0, jnp.pi, 0.4, 0.4])
    return ag.game_problem(N, dt, x0, model, opts, obj, gc)


@pytest.fixture(scope="module")
def case():
    """The two-player unicycle (N=20), the port's copy, B random iterates,
    per-lane AL states and the assembled point."""
    prob = _unicycle2()
    spec = prob.spec
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(51)
    arrs = dict(x=0.5 * rng.standard_normal((B, spec.N, spec.n)),
                u=0.3 * rng.standard_normal((B, spec.T, spec.m)),
                lam=0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n)))
    jtr = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in arrs.items()})
    ttr = ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    jgc, tgc = random_al_state(prob.gc, tprob.gc, B, rng)

    def one(tr, g):
        pd = JR.point_data(prob.model, spec, prob.obj, g, tr)
        res, jb, _, _ = JR.assemble_from_point(spec, prob.obj, g, tr, pd,
                                               reg=1e-3)
        return pd, res, jb
    jpd, jres, jjb = jax.jit(jax.vmap(one, in_axes=(0, gc_axes(jgc))))(
        jtr, jgc)
    tpd = TR.point_data(tprob.model, spec, tprob.obj, tgc, ttr)
    tres, tjb, _, _ = TR.assemble_from_point(spec, tprob.obj, tgc, ttr, tpd,
                                             reg=1e-3)
    return dict(prob=prob, spec=spec, tprob=tprob, rng=rng, jgc=jgc, tgc=tgc,
                jpd=jpd, jres=jres, jjb=jjb, tpd=tpd, tres=tres, tjb=tjb)


@pytest.mark.parametrize("i", [0, 1])
def test_player_helpers(case, i):
    """Residual rows and norm, violations, the step scatter and the player
    Jacobian slices of player i against the reference's, <= 1e-12; the
    player spec is a real p=1 spec with W = 2n + mi."""
    spec, jres, tres = case["spec"], case["jres"], case["tres"]
    assert tibr.player_block_width(spec, i) == jibr.player_block_width(spec,
                                                                       i)
    close(tibr.player_residual_blocks(spec, tres, i),
          jax.vmap(lambda r: jibr.player_residual_blocks(spec, r, i))(jres),
          1e-12)
    close(tibr.player_residual_norm(spec, tres, i),
          jax.vmap(lambda r: jibr.player_residual_norm(spec, r, i))(jres),
          1e-12)
    ref = jax.vmap(lambda g, pd, r: jibr.player_violations(spec, g, pd, r, i),
                   in_axes=(gc_axes(case["jgc"]), 0, 0))(
        case["jgc"], case["jpd"], jres)
    for a, r in zip(tibr.player_violations(spec, case["tgc"], case["tpd"],
                                           tres, i), ref):
        close(a, r, 1e-12)
    Wi = tibr.player_block_width(spec, i)
    flat = case["rng"].standard_normal((B, spec.T * Wi))
    step = tibr.unpack_player_step(spec, i, torch.as_tensor(flat))
    jstep = jax.vmap(lambda f: jibr.unpack_player_step(spec, i, f,
                                                       jnp.float64))(
        jnp.asarray(flat))
    for a, r in zip(tree_leaves(step), (jstep.x, jstep.u, jstep.lam)):
        close(a, r, 0.0)
    pj = tibr.player_jac_blocks(spec, case["tjb"], i)
    rj = jax.vmap(lambda j: jibr.player_jac_blocks(spec, j, i))(case["jjb"])
    for f in ("Qblk", "Ublk", "A", "B"):
        close(getattr(pj, f), getattr(rj, f), 1e-12)
        assert getattr(pj, f).is_contiguous()
    ps, js = tibr.player_spec(spec, i), jibr._PlayerSpec(spec, i)
    assert (ps.p, ps.m, ps.mi, ps.pu, ps.W, ps.T, ps.n) == (
        js.p, js.m, js.mi, js.pu, js.W, js.T, js.n)
    assert ps.homogeneous


@pytest.mark.parametrize("mu", [1.0, 1e7])
def test_player_kkt_solve(case, mu):
    """The player sub-KKT (p=1) through K3's plain version and the K3
    wrapper on CPU tensors against the reference's ``schur`` and Pallas
    (interpret mode) player solves, mu on the statx diagonals, <= 1e-10 x
    the solution's scale; no launch on CPU tensors."""
    spec = case["spec"]
    d = np.arange(spec.n)
    for i in range(spec.p):
        jspec = jibr._PlayerSpec(spec, i)
        jb = jax.vmap(lambda j: jibr.player_jac_blocks(spec, j, i))(
            case["jjb"])
        jb = dataclasses.replace(jb, Qblk=jb.Qblk.at[:, :, :, d, d].add(mu))
        b = -jax.vmap(lambda r: jibr.player_residual_blocks(spec, r, i))(
            case["jres"])
        y_sch = np.asarray(jax.jit(jax.vmap(
            lambda j, bb: solve_tridiagonal_schur(jspec, j, bb)))(jb, b))
        y_pal = np.asarray(jax.jit(lambda j, bb: solve_thomas_pallas(
            jspec, j, bb, block_lanes=B, interpret=True))(jb, b))
        scale = np.abs(y_sch).max()
        tjb = JacBlocks(*[torch.as_tensor(np.array(getattr(jb, f)))
                          for f in ("Qblk", "Ublk", "A", "B")])
        before = thomas.solve_thomas.launches
        y = thomas.kkt_solve(tibr.player_spec(spec, i), tjb,
                             torch.as_tensor(np.array(b)), ())
        assert thomas.solve_thomas.launches == before
        close(y.numpy(), y_sch, 1e-10 * scale)
        close(y.numpy(), y_pal, 1e-10 * scale)


def _final(out):
    it = out.stats.iter.long() - 1
    ix = torch.arange(it.shape[0])
    return (float(out.stats.res[ix, it].max()),
            float(out.stats.dyn_vio[ix, it].max()))


@pytest.mark.parametrize("name", ["p1_linear", "p1_nonlinear", "p2_linear"])
def test_reference_oracles(name):
    """``tests/test_ibr.py``'s oracles through the port: the p=1 linear
    double integrator in one iteration, the p=1 unicycle, and the p=2
    double integrator's IBR fixed point (not a Nash equilibrium: its
    residual is only below 5e-2)."""
    model = {"p1_linear": ag.double_integrator_game(p=1),
             "p1_nonlinear": ag.unicycle_game(p=1),
             "p2_linear": ag.double_integrator_game(p=2)}[name]
    budget = (7, 20) if name == "p1_nonlinear" else (1, 1)
    N, dt, obj, gc, opts = _mk(model, model.p, outer_iter=budget[0],
                               inner_iter=budget[1])
    x0 = (jnp.array([1.0, 1.0, 0.0, 0.9]) if model.p == 1
          else jnp.array([1.0, 2.0, 1.0, 2.0, 0.0, 0.0, 0.9, 0.9]))
    prob = problem_from_reference(
        ag.game_problem(N, dt, x0, model, opts, obj, gc), CPU, F64)
    if model.p == 1:
        res, dyn = _final(agt.ibr_newton_solve_player(prob, 0))
        assert res < 1e-6 and dyn < 1e-6, (res, dyn)
    else:
        res, dyn = _final(agt.ibr_newton_solve(prob, agt.IBROptions(
            ibr_iter=3)))
        assert res < 5e-2 and dyn < 1e-6, (res, dyn)


def test_batched_ibr_matches_reference():
    """Three lanes of the two-player unicycle with collision avoidance
    (x0 + 0.05 N(0, 1), numpy seed 0), ``ibr_iter=3``, outer 2 x 4,
    against the reference's vmapped ``schur`` IBR: stats rows, their outer
    column and residuals equal, x and u within 1e-8."""
    prob = _unicycle2()
    rng = np.random.default_rng(0)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((3, 8))
    ref = jax.jit(jax.vmap(lambda x: jibr.ibr_newton_solve(
        dataclasses.replace(prob, x0=x), JIBROptions(ibr_iter=3),
        method="schur")))(jnp.asarray(x0s))
    tprob = problem_from_reference(prob, CPU, F64)
    out = agt.ibr_newton_solve(tprob, agt.IBROptions(ibr_iter=3),
                               x0s=torch.as_tensor(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    np.testing.assert_array_equal(out.stats.outer.numpy(),
                                  np.asarray(ref.stats.outer))
    close(out.stats.res.numpy(), ref.stats.res, 1e-10)
    close(out.traj.x.numpy(), ref.traj.x, 1e-8)
    close(out.traj.u.numpy(), ref.traj.u, 1e-8)


def test_frozen_golden():
    """``tests/golden_torch/ibr_uni3_N20.npz`` is still the reference's
    flagship IBR solution, and the port's f64 CPU IBR through K3's plain
    version reproduces it: stats rows and round count equal, x and u within
    1e-8."""
    from torch_goldens import IBR_ITER, ibr_solution
    gold = np.load(os.path.join(HERE, "golden_torch", "ibr_uni3_N20.npz"))
    fresh = ibr_solution()
    assert int(fresh["iter"]) == int(gold["iter"])
    close(fresh["x"], gold["x"], 1e-12)
    close(fresh["u"], gold["u"], 1e-12)
    prob, _ = flagship_unicycle(CPU, F64, outer=3, inner=8)
    out = agt.ibr_newton_solve(prob, agt.IBROptions(ibr_iter=IBR_ITER))
    it = int(out.stats.iter[0])
    assert it == int(gold["iter"])
    assert int(out.stats.outer[0, it - 1]) == int(gold["q"])
    close(out.traj.x[0].numpy(), gold["x"], 1e-8)
    close(out.traj.u[0].numpy(), gold["u"], 1e-8)


def test_quadrotor_ibr_matches_frozen_reference():
    """The quadrotor game cut to N=6 (``torch_goldens.ibr_quad_problem``:
    outer 2 x 4 per player solve, one round), two lanes, f64, through the
    plain versions against the JAX package's vmapped ``schur`` IBR frozen
    in ``tests/golden_torch/ibr_quad2_N6.npz`` (``tests/torch_goldens.py
    ibr_quad``; tracing that IBR takes the JAX package about 70 s, so it is
    not rerun here): stats rows, their round column and residuals (1e-10)
    equal, x and u within 1e-8.  About 5 s."""
    from torch_goldens import ibr_quad_problem
    gold = np.load(os.path.join(HERE, "golden_torch", "ibr_quad2_N6.npz"))
    tprob = problem_from_reference(ibr_quad_problem(), CPU, F64)
    out = agt.ibr_newton_solve(tprob, agt.IBROptions(ibr_iter=1),
                               x0s=torch.as_tensor(gold["x0s"]))
    rows = gold["outer"].shape[1]
    np.testing.assert_array_equal(out.stats.iter.numpy(), gold["iter"])
    np.testing.assert_array_equal(out.stats.outer[:, :rows].numpy(),
                                  gold["outer"])
    close(out.stats.res[:, :rows].numpy(), gold["res"], 1e-10)
    close(out.traj.x.numpy(), gold["x"], 1e-8)
    close(out.traj.u.numpy(), gold["u"], 1e-8)
