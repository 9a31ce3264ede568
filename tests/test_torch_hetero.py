"""The heterogeneous double-integrator game (mi = (2, 1), player-blocked
layout) in the PyTorch port against the JAX package: the model, the
converter, assembly, the padded KKT solve (K3's plain version and the CPU
path of its wrapper), the fused trial's plain version and its
specialization predicate, a batched solve, and the frozen solution
``tests/golden_torch/hetero2_N8.npz`` that ``chip_smoke.py`` holds the
kernels to.

Inputs come from numpy seeds; f64 throughout.  Tolerances: 1e-12 where the
two packages evaluate the same functions in another order (model, assembly,
trial), 1e-10 times the solution's scale for the KKT solves (as
``tests/test_hetero.py`` holds the reference's own padded solves), 1e-8 on
the solved trajectories with equal iteration counts.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.models import integration as jint
from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
from algames_tpu.ops.trial_pallas import _trial_eval
from algames_tpu.problem import residual as JR
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur

import algames_tpu_torch as agt
import chip_smoke
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.models import integration as tint
from algames_tpu_torch.ops import thomas, trial
from algames_tpu_torch.problem import residual as TR
from algames_tpu_torch.problem.linear_solver import (JacBlocks,
                                                     solve_tridiagonal_schur
                                                     as t_schur)
from algames_tpu_torch.utils import tree_leaves

from test_hetero import _prob
from test_torch_roundabout import gc_axes, random_al_state

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
CPU, F64 = torch.device("cpu"), torch.float64
B = 2


def close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def case():
    """The reference's hetero problem, the port's copy, B random iterates
    and per-lane AL states."""
    prob, spec = _prob()
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(41)
    arrs = dict(x=0.3 * rng.standard_normal((B, spec.N, spec.n)),
                u=0.3 * rng.standard_normal((B, spec.T, spec.m)),
                lam=0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n)))
    jtr = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in arrs.items()})
    ttr = ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    jgc, tgc = random_al_state(prob.gc, tprob.gc, B, rng)
    return dict(prob=prob, spec=spec, tprob=tprob, rng=rng, jtr=jtr, ttr=ttr,
                jgc=jgc, tgc=tgc)


def test_model_and_converter(case):
    """Fields, dynamics (the unactuated axis coasts), RK2 step, step
    Jacobians and RK2 pulls <= 1e-12; the converter carries the model and
    spec; the native builder of ``chip_smoke.py`` gives the reference's
    problem."""
    prob, spec, tprob = case["prob"], case["spec"], case["tprob"]
    jm, tm = prob.model, tprob.model
    assert type(tm) is agt.HeteroDoubleIntegratorGame
    assert tm == agt.hetero_double_integrator_game(mi=(2, 1))
    for f in ("n", "m", "p", "ni", "mi", "pu", "px", "pz", "d"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert (dataclasses.asdict(tprob.spec) == dataclasses.asdict(spec)
            and not tprob.spec.homogeneous)
    rng = np.random.default_rng(43)
    x = rng.standard_normal((3, 4, spec.n))
    u = rng.standard_normal((3, 4, spec.m))
    lam = rng.standard_normal((3, 4, spec.p, spec.n))
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    xdot = tm.dynamics(tx, tu)
    close(xdot, jax.vmap(jax.vmap(jm.dynamics))(jx, ju), 1e-12)
    assert float(xdot[..., 7].abs().max()) == 0.0       # player 1's y axis
    close(tint.rk2_step(tm, tx, tu, 0.1),
          jax.vmap(jax.vmap(lambda a, b: jint.rk2_step(jm, a, b, 0.1)))(
              jx, ju), 1e-12)
    A, Bm = jax.jit(jax.vmap(
        lambda a, b: jint.step_jacobians_traj(jm, a, b, 0.1)))(jx, ju)
    tA, tB = tint.step_jacobians(tm, tx, tu, 0.1)
    close(tA, A, 1e-12)
    close(tB, Bm, 1e-12)
    gx, gu = tint.rk2_vjp(tm, tx, tu, torch.as_tensor(lam), 0.1)
    close(gx, np.einsum("bkca,bkpc->bkpa", np.asarray(A), lam), 1e-12)
    close(gu, np.einsum("bkcm,bkpc->bkpm", np.asarray(Bm), lam), 1e-12)
    native, nspec = chip_smoke.hetero_game(CPU, F64)
    assert (nspec == tprob.spec and native.model == tm
            and native.opts == tprob.opts)
    for a, r in zip(tree_leaves((native.x0, native.obj, native.gc)),
                    tree_leaves((tprob.x0, tprob.obj, tprob.gc))):
        close(a, r, 1e-15)


def _reference_kkt(case, reg=1e-3):
    """The reference's dense KKT ingredients and right-hand side at the
    case's iterates and AL states."""
    prob, spec = case["prob"], case["spec"]

    def one(tr, g):
        pd = JR.point_data(prob.model, spec, prob.obj, g, tr)
        return JR.assemble_from_point(spec, prob.obj, g, tr, pd, reg=reg)
    return jax.jit(jax.vmap(one, in_axes=(0, gc_axes(case["jgc"]))))(
        case["jtr"], case["jgc"])


def test_assembly(case):
    """Residual, dense JacBlocks and violations from the carried point data
    (blocked collision indices, ragged control-owner embedding, the
    control bound on m = 3) <= 1e-12; the structured form is not taken
    for a heterogeneous spec."""
    spec, tprob = case["spec"], case["tprob"]
    res, jb, sv, cv = _reference_kkt(case)
    pd = TR.point_data(tprob.model, spec, tprob.obj, case["tgc"], case["ttr"])
    tres, tjb, tsv, tcv = TR.assemble_from_point(
        spec, tprob.obj, case["tgc"], case["ttr"], pd, reg=1e-3)
    for a, r in ((tres.rx, res.rx), (tres.ru, res.ru), (tres.rd, res.rd),
                 (tjb.Qblk, jb.Qblk), (tjb.Ublk, jb.Ublk), (tjb.A, jb.A),
                 (tjb.B, jb.B), (tsv, sv), (tcv, cv)):
        close(a, r, 1e-12)
    # The solver's assembly choice: structured Q only for homogeneous specs.
    assert TR.structured_q_supported(spec, tprob.obj, tprob.gc)
    assert not spec.homogeneous


@pytest.mark.parametrize("mu", [1.0, 1e4, 1e7])
def test_padded_kkt_solve(case, mu):
    """K3's plain version on the heterogeneous spec (controls padded to
    p max(mi)) and the K3 wrapper on CPU tensors against the reference's
    padded ``solve_tridiagonal_schur`` and its Pallas kernel in interpret
    mode, mu added on the statx diagonals, <= 1e-10 x the solution's
    scale."""
    spec = case["spec"]
    res, jb, _, _ = _reference_kkt(case)
    d = np.arange(spec.n)
    jb = dataclasses.replace(jb, Qblk=jb.Qblk.at[:, :, :, d, d].add(mu))
    b = -jax.vmap(lambda r: JR.residual_knot_blocks(spec, r))(res)
    y_sch = np.asarray(jax.jit(jax.vmap(
        lambda j, bb: solve_tridiagonal_schur(spec, j, bb)))(jb, b))
    y_pal = np.asarray(jax.jit(lambda j, bb: solve_thomas_pallas(
        spec, j, bb, block_lanes=B, interpret=True))(jb, b))
    scale = np.abs(y_sch).max()
    tjb = JacBlocks(*[torch.as_tensor(np.array(getattr(jb, f)))
                      for f in ("Qblk", "Ublk", "A", "B")])
    tb = torch.as_tensor(np.array(b))
    before = thomas.solve_thomas.launches
    for y in (t_schur(spec, tjb, tb), thomas.solve_thomas(spec, tjb, tb),
              thomas.kkt_solve(spec, tjb, tb, ())):
        close(y.numpy(), y_sch, 1e-10 * scale)
        close(y.numpy(), y_pal, 1e-10 * scale)
    assert thomas.solve_thomas.launches == before


def test_trial_plain_and_predicate(case):
    """``trial_eval_plain`` on the hetero model against the reference's
    trial body (``trial_pallas._trial_eval``) <= 1e-12 on tn and every
    carried leaf; the fused trial's predicate admits the player-blocked
    model and refuses it with another layout."""
    prob, spec, tprob, rng = (case[k] for k in ("prob", "spec", "tprob",
                                                "rng"))
    steps = dict(x=0.05 * rng.standard_normal((B, spec.N, spec.n)),
                 u=0.05 * rng.standard_normal((B, spec.T, spec.m)),
                 lam=0.05 * rng.standard_normal((B, spec.p, spec.T, spec.n)))
    alpha = np.array([1.0, 0.25])
    reg = np.array([1e-3, 2.0])
    jd = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in steps.items()})
    tn, lite = jax.jit(jax.vmap(
        lambda t, dt_, a, r, g: _trial_eval(prob.model, spec, prob.obj, g, t,
                                            dt_, a, r),
        in_axes=(0, 0, 0, 0, gc_axes(case["jgc"]))))(
        case["jtr"], jd, jnp.asarray(alpha), jnp.asarray(reg), case["jgc"])
    td = ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in steps.items()})
    args = (tprob.model, spec, tprob.obj, case["tgc"], case["ttr"], td,
            torch.as_tensor(alpha), torch.as_tensor(reg))
    ttn, tlite = trial.trial_eval_plain(*args)
    close(ttn, tn, 1e-12)
    for a, r in zip(tree_leaves(tlite), jax.tree_util.tree_leaves(lite)):
        close(a, r, 1e-12)
    assert trial.trial_supported(*args[:4])
    assert trial.model_name(tprob.model) == "hdi2"
    assert trial.model_constants(tprob.model)[:3] == [0.0, 2.0, 3.0]
    before = trial.trial_eval.launches
    ktn, klite = trial.trial_eval(*args)
    assert trial.trial_eval.launches == before
    torch.testing.assert_close(ktn, ttn, rtol=0, atol=0)
    interleaved = dataclasses.replace(spec, pu=((0, 2), (1,)))
    assert not trial.trial_supported(tprob.model, interleaved, tprob.obj,
                                     tprob.gc)
    swapped = agt.hetero_double_integrator_game(mi=(1, 2))
    assert not trial.trial_supported(swapped, spec, tprob.obj, tprob.gc)


def test_batched_solve_matches_reference(case):
    """A B=2 solve of the hetero game (x0 perturbed from numpy seed 0),
    with the fused trial's plain version, against the reference's vmapped
    ``schur`` solve: iteration counts equal, x and u within 1e-8."""
    prob, spec, tprob = case["prob"], case["spec"], case["tprob"]
    rng = np.random.default_rng(0)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((B, spec.n))
    ref = jax.jit(jax.vmap(lambda x: ag.newton_solve(
        dataclasses.replace(prob, x0=x), method="schur")))(jnp.asarray(x0s))
    tp = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, ls_fused=True))
    out = agt.newton_solve(tp, torch.as_tensor(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    close(out.traj.x.numpy(), ref.traj.x, 1e-8)
    close(out.traj.u.numpy(), ref.traj.u, 1e-8)


def test_frozen_golden():
    """``tests/golden_torch/hetero2_N8.npz`` is still the reference's
    dense-oracle solution, and the port's f64 CPU solve through K3's padded
    plain version and the fused trial's plain version reproduces it:
    iteration count equal, x and u within 1e-8."""
    from torch_goldens import hetero_solution
    gold = np.load(os.path.join(HERE, "golden_torch", "hetero2_N8.npz"))
    fresh = hetero_solution()
    assert int(fresh["iter"]) == int(gold["iter"])
    close(fresh["x"], gold["x"], 1e-12)
    close(fresh["u"], gold["u"], 1e-12)
    prob, _ = chip_smoke.hetero_game(CPU, F64)
    prob = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, ls_fused=True))
    out = agt.newton_solve(prob)
    assert int(out.stats.iter[0]) == int(gold["iter"])
    close(out.traj.x[0].numpy(), gold["x"], 1e-8)
    close(out.traj.u[0].numpy(), gold["u"], 1e-8)
