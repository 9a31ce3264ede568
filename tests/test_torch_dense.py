"""Kernels K3 (dense-Q block-Thomas KKT sweep) and K4 (the fused trial
widened to the roundabout's families): their plain PyTorch versions against
the JAX package's Pallas kernels (interpret mode) and XLA twins, the widened
specialization predicate, and the K3 wrapper's CPU contract.

The inputs are a shortened roundabout (p=4, N=10) with the players crowded
around the island, built by ``test_torch_roundabout``'s helpers from numpy
seeds.  f64 throughout; worst per-lane relative error (max |a - ref| /
max |ref|) <= 1e-9 for the KKT solves (the AL penalty mu enters as
late-schedule curvature on the statx diagonals, as for K1) and <= 1e-12
for the trial, whose functions differ only in the order of operations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
from algames_tpu.ops.trial_pallas import _trial_eval, fused_trial_for_spec
from algames_tpu.problem import residual as JR
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur

from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.constraints.kernels import CollisionParams, make_bound
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core.traj import PrimalDual
from algames_tpu_torch.models.base import GameModel
from algames_tpu_torch.ops import thomas, trial
from algames_tpu_torch.problem.linear_solver import JacBlocks
from algames_tpu_torch.utils import tree_leaves

from test_torch_roundabout import (crowded_arrays, gc_axes, jax_roundabout,
                                   random_al_state)

torch.set_num_threads(1)
CPU = torch.device("cpu")
B = 2


def _rel(a, ref):
    a = np.asarray(a).reshape(B, -1)
    ref = np.asarray(ref).reshape(B, -1)
    scale = np.maximum(np.abs(ref).max(1), np.finfo(np.float64).tiny)
    return float((np.abs(a - ref).max(1) / scale).max())


@pytest.fixture(scope="module")
def case():
    prob, spec = jax_roundabout(N=10)
    tprob = problem_from_reference(prob, CPU, torch.float64)
    rng = np.random.default_rng(5)
    arrs = crowded_arrays(spec, B, rng)
    jtr = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in arrs.items()})
    jgc, tgc = random_al_state(prob.gc, tprob.gc, B, rng)

    def one(tr, g):
        pd = JR.point_data(prob.model, spec, prob.obj, g, tr)
        res, jb, _, _ = JR.assemble_from_point(spec, prob.obj, g, tr, pd,
                                               1e-3)
        return jb, -JR.residual_knot_blocks(spec, res)
    # The KKT systems at the initial AL state (every penalty 1); mu enters
    # per test on the statx diagonals.
    jb, b = jax.jit(jax.vmap(one, in_axes=(0, None)))(jtr, prob.gc)
    steps = dict(dx=0.05 * rng.standard_normal((B, spec.N, spec.n)),
                 du=0.05 * rng.standard_normal((B, spec.T, spec.m)),
                 dlam=0.05 * rng.standard_normal((B, spec.p, spec.T, spec.n)),
                 alpha=0.5 ** rng.integers(0, 6, size=B),
                 reg=1e-3 * (1.0 + rng.integers(0, 20, size=B)) ** 4)
    # The reference solvers, compiled once for every mu.
    pallas = jax.jit(lambda j, bb: solve_thomas_pallas(
        spec, j, bb, block_lanes=B, interpret=True))
    schur = jax.jit(jax.vmap(lambda j, bb: solve_tridiagonal_schur(
        spec, j, bb)))
    return dict(prob=prob, spec=spec, tprob=tprob, arrs=arrs, jtr=jtr,
                jgc=jgc, tgc=tgc, jb=jb, b=b, steps=steps, pallas=pallas,
                schur=schur)


def _port_jb(jb):
    return JacBlocks(*[torch.as_tensor(np.array(getattr(jb, f)))
                       for f in ("Qblk", "Ublk", "A", "B")])


@pytest.mark.parametrize("mu", [1.0, 1e3, 1e7])
def test_plain_matches_pallas_and_schur(case, mu):
    spec, tspec = case["spec"], case["tprob"].spec
    d = np.arange(spec.n)
    jb = dataclasses.replace(case["jb"],
                             Qblk=case["jb"].Qblk.at[:, :, :, d, d].add(mu))
    y_pal = case["pallas"](jb, case["b"])
    y_sch = case["schur"](jb, case["b"])
    y = thomas.solve_thomas(tspec, _port_jb(jb),
                            torch.as_tensor(np.array(case["b"]))).numpy()
    assert _rel(y, y_pal) <= 1e-9, _rel(y, y_pal)
    assert _rel(y, y_sch) <= 1e-9, _rel(y, y_sch)


def test_wrapper_cpu_contract(case):
    """CPU tensors take the plain version (the launch counter stays put);
    a heterogeneous spec is solved padded by K3's plain version and refused
    by K1; wrong shapes, types or layouts raise."""
    tspec = case["tprob"].spec
    jb, b = _port_jb(case["jb"]), torch.as_tensor(np.array(case["b"]))
    before = thomas.solve_thomas.launches
    y = thomas.solve_thomas(tspec, jb, b)
    assert thomas.solve_thomas.launches == before == 0
    np.testing.assert_array_equal(
        y.numpy(), thomas.solve_thomas_plain(tspec, jb, b).numpy())
    np.testing.assert_array_equal(
        y.numpy(), thomas.kkt_solve(tspec, jb, b, ()).numpy())
    hetero = dataclasses.replace(tspec, ni=(4, 4, 4, 4), mi=(1, 3, 2, 2),
                                 pu=((0,), (1, 2, 3), (4, 5), (6, 7)))
    np.testing.assert_array_equal(
        thomas.solve_thomas(hetero, jb, b).numpy(),
        thomas.solve_thomas_plain(hetero, jb, b).numpy())
    assert thomas.solve_thomas.launches == 0
    with pytest.raises(ValueError, match="homogeneous"):
        thomas.solve_thomas_structured(hetero, None, b, ())
    with pytest.raises(ValueError, match="shape"):
        thomas.solve_thomas(tspec, dataclasses.replace(
            jb, Qblk=jb.Qblk[:, :, :3].contiguous()), b)
    with pytest.raises(ValueError, match="shape"):
        thomas.solve_thomas(tspec, jb, b[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        thomas.solve_thomas(tspec, dataclasses.replace(
            jb, A=jb.A.transpose(-1, -2)), b)
    with pytest.raises(TypeError):
        thomas.solve_thomas(tspec, dataclasses.replace(jb, B=jb.B.float()),
                            b)


def _trial_args(case):
    tprob, a, s = case["tprob"], case["arrs"], case["steps"]
    t = {k: torch.as_tensor(v) for k, v in {**a, **s}.items()}
    return (tprob.model, tprob.spec, tprob.obj, case["tgc"],
            PrimalDual(x=t["x"], u=t["u"], lam=t["lam"]),
            PrimalDual(x=t["dx"], u=t["du"], lam=t["dlam"]), t["alpha"],
            t["reg"])


def _assert_same(port, ref):
    tn, lite = port
    tn_r, lite_r = ref
    assert _rel(tn.numpy(), tn_r) <= 1e-12
    leaves, leaves_r = tree_leaves(lite), jax.tree_util.tree_leaves(lite_r)
    assert len(leaves) == len(leaves_r) == 3 + 32 + 1
    for a, r in zip(leaves, leaves_r):
        assert tuple(a.shape) == tuple(np.asarray(r).shape)
        assert _rel(a.numpy(), r) <= 1e-12, _rel(a.numpy(), r)


def test_trial_plain_matches_fused_pallas_and_xla(case):
    """trial_eval (its plain version on CPU) against the generic fused
    trial kernel under vmap (interpret mode) and against ``_trial_eval``."""
    prob, spec, jgc = case["prob"], case["spec"], case["jgc"]
    s = case["steps"]
    jd = ag.PrimalDual(x=jnp.asarray(s["dx"]), u=jnp.asarray(s["du"]),
                       lam=jnp.asarray(s["dlam"]))
    jargs = (case["jtr"], jd, jnp.asarray(s["alpha"]), jnp.asarray(s["reg"]))
    axes = gc_axes(jgc)
    fused = fused_trial_for_spec(prob.model, spec, interpret=True)
    ref_k = jax.jit(jax.vmap(
        lambda g, t, d, a, r: fused(t, d, a, r, g, prob.obj),
        in_axes=(axes, 0, 0, 0, 0)))(jgc, *jargs)
    ref_x = jax.jit(jax.vmap(
        lambda g, t, d, a, r: _trial_eval(prob.model, spec, prob.obj, g, t,
                                          d, a, r),
        in_axes=(axes, 0, 0, 0, 0)))(jgc, *jargs)
    port = trial.trial_eval(*_trial_args(case))
    _assert_same(port, ref_k)
    _assert_same(port, ref_x)


def test_specialization_predicate(case):
    """The widened predicate, case by case."""
    model, spec, obj, gc = _trial_args(case)[:4]
    assert trial.trial_supported(model, spec, obj, gc)
    # Each family alone is inside.
    for keep in (slice(0, 12), slice(12, 16), slice(16, 32)):
        g = dataclasses.replace(gc, state_blocks=gc.state_blocks[keep])
        assert trial.trial_supported(model, spec, obj, g)
    # A collision block and a collision-cost pair on three coordinates are
    # inside; outside: both on four coordinates, a state block of another
    # shape used as a control block, another model, a heterogeneous layout;
    # inside again: any number of state blocks.
    coll3, coll4 = (tsets.ConBlock(
        params=CollisionParams(radius=torch.tensor(0.1, dtype=torch.float64),
                               pxi=tuple(range(k)),
                               pxj=tuple(range(k, 2 * k))),
        lam=torch.zeros(spec.T, 1), mu=torch.ones(spec.T, 1), owner=0,
        is_state=True) for k in (3, 4))
    assert trial.trial_supported(model, spec, obj, dataclasses.replace(
        gc, state_blocks=gc.state_blocks + (coll3,)))
    assert not trial.trial_supported(model, spec, obj, dataclasses.replace(
        gc, state_blocks=gc.state_blocks + (coll4,)))
    obj3 = dataclasses.replace(obj, pxi=obj.pxi[:-1] + ((0, 4, 8),),
                               pxj=obj.pxj[:-1] + ((1, 5, 9),))
    assert trial.trial_supported(model, spec, obj3, gc)
    obj4 = dataclasses.replace(obj, pxi=obj.pxi[:-1] + ((0, 4, 8, 12),),
                               pxj=obj.pxj[:-1] + ((1, 5, 9, 13),))
    assert not trial.trial_supported(model, spec, obj4, gc)
    circ_u = dataclasses.replace(gc.state_blocks[12], is_state=False,
                                 owner=-1)
    assert not trial.trial_supported(model, spec, obj, dataclasses.replace(
        gc, control_blocks=gc.control_blocks + (circ_u,)))
    other = GameModel(**{f.name: getattr(model, f.name)
                         for f in dataclasses.fields(model)})
    assert not trial.trial_supported(other, spec, obj, gc)
    shuffled = dataclasses.replace(spec, pu=tuple(
        (2 * i, 2 * i + 1) for i in range(spec.p)))
    assert not trial.trial_supported(model, shuffled, obj, gc)
    bound = tsets.ConBlock(
        params=make_bound(np.ones(spec.n), -np.ones(spec.n), torch.float64,
                          CPU),
        lam=torch.zeros(spec.T, 2 * spec.n), mu=torch.ones(spec.T, 2 * spec.n),
        owner=1, is_state=True)
    # Any number of state blocks: the kernel reads them from device memory
    # (64 was the by-value table's limit until the 9-player merge's 72).
    for k in (64, 65, 90):
        assert trial.trial_supported(model, spec, obj, dataclasses.replace(
            gc, state_blocks=(bound,) * k))
