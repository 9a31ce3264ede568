"""Kernel K2 (fused line-search trial): its plain PyTorch version against the
JAX package's hand-written Pallas trial kernel (interpret mode) and against
the XLA trial pass, on the flagship problem, and against the Pallas kernel
on the MPC highway of ``benchmarks/bench_mpc.py``; plus the specialization
predicate and the wrapper's CPU contract.

f64 throughout; every PointLite leaf and tn within a per-lane relative error
(max |a - ref| / max |ref|) of 1e-12: the functions are the same, only the
order of floating-point operations differs.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.core.traj import update_traj
from algames_tpu.ops.trial_kernel import _trial_eval_handwritten
from algames_tpu.presets import flagship_unicycle
from algames_tpu.problem import residual as JR

from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core.traj import PrimalDual
from algames_tpu_torch.ops import trial
from algames_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
TOL = 1e-12


def _xla_trial(model, spec, obj, gc, traj, dtraj, alpha, reg_eff):
    t = update_traj(traj, alpha, dtraj)
    lite, res_t = JR.point_lite_res(model, spec, obj, gc, t)
    rx = res_t.rx + (reg_eff * alpha) * dtraj.x[1:][:, None, :]
    ru = res_t.ru + (reg_eff * alpha) * dtraj.u
    return JR.residual_norm(spec, JR.Residual(rx=rx, ru=ru, rd=res_t.rd)), lite


def _case(prob, spec):
    """B lanes of trial inputs for ``prob`` from numpy seed 0, as the
    reference's arrays and the port's."""
    tprob = problem_from_reference(prob, torch.device("cpu"), torch.float64)
    rng = np.random.default_rng(0)

    def draw(scale, shape):
        return scale * rng.standard_normal(shape)
    x = np.asarray(prob.x0)[None, None] + draw(0.3, (B, spec.N, spec.n))
    arrs = dict(x=x, u=draw(0.3, (B, spec.T, spec.m)),
                lam=draw(0.3, (B, spec.p, spec.T, spec.n)),
                dx=draw(0.05, (B, spec.N, spec.n)),
                du=draw(0.05, (B, spec.T, spec.m)),
                dlam=draw(0.05, (B, spec.p, spec.T, spec.n)),
                alpha=0.5 ** rng.integers(0, 6, size=B),
                reg=1e-3 * (1.0 + rng.integers(0, 20, size=B)) ** 4)
    arrs["dx"][:, 0] = 0.0
    jgc, tgc = prob.gc, tprob.gc
    for kind in ("state_blocks", "control_blocks"):
        jb, tb = [], []
        for b_j, b_t in zip(getattr(jgc, kind), getattr(tgc, kind)):
            shape = (B,) + tuple(np.asarray(b_j.lam).shape)
            lam = 0.2 * rng.random(shape) * (rng.random(shape) < 0.5)
            mu = 10.0 ** rng.integers(0, 8, size=shape)
            jb.append(dataclasses.replace(b_j, lam=jnp.asarray(lam),
                                          mu=jnp.asarray(mu)))
            tb.append(dataclasses.replace(
                b_t, lam=torch.as_tensor(lam), mu=torch.as_tensor(mu)))
        jgc = dataclasses.replace(jgc, **{kind: tuple(jb)})
        tgc = dataclasses.replace(tgc, **{kind: tuple(tb)})
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    jtraj = ag.PrimalDual(x=j["x"], u=j["u"], lam=j["lam"])
    jd = ag.PrimalDual(x=j["dx"], u=j["du"], lam=j["dlam"])
    ttraj = PrimalDual(x=t["x"], u=t["u"], lam=t["lam"])
    td = PrimalDual(x=t["dx"], u=t["du"], lam=t["dlam"])
    targs = (tprob.model, tprob.spec, tprob.obj, tgc, ttraj, td, t["alpha"],
             t["reg"])
    jargs = (jtraj, jd, j["alpha"], j["reg"])
    return dict(prob=prob, spec=spec, tprob=tprob, jgc=jgc, tgc=tgc,
                targs=targs, jargs=jargs)


@pytest.fixture(scope="module")
def case():
    return _case(*flagship_unicycle())


@pytest.fixture(scope="module")
def highway():
    """BASELINE config 3's game, whose trials K2 takes in the MPC loop with
    the fused line search."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLATFORM", "cpu")
        mod = importlib.util.spec_from_file_location(
            "bench_mpc", os.path.join(REPO, "benchmarks", "bench_mpc.py"))
        bench = importlib.util.module_from_spec(mod)
        mod.loader.exec_module(bench)
    prob, spec = bench.make_problem(ag, jnp.float64)[:2]
    return _case(prob, spec)


def _rel(a, ref):
    a = np.asarray(a).reshape(B, -1)
    ref = np.asarray(ref).reshape(B, -1)
    scale = np.maximum(np.abs(ref).max(1), np.finfo(np.float64).tiny)
    return float((np.abs(a - ref).max(1) / scale).max())


def _assert_same(port, ref):
    tn, lite = port
    tn_r, lite_r = ref
    assert _rel(tn.numpy(), tn_r) <= TOL
    leaves, leaves_r = tree_leaves(lite), jax.tree_util.tree_leaves(lite_r)
    assert len(leaves) == len(leaves_r) == 3 + 6 + 1
    for a, r in zip(leaves, leaves_r):
        assert tuple(a.shape) == tuple(np.asarray(r).shape)
        assert _rel(a.numpy(), r) <= TOL, _rel(a.numpy(), r)


def test_plain_matches_pallas_trial_kernel(case):
    _pallas_matches(case)


def test_highway_plain_matches_pallas_trial_kernel(highway):
    assert trial.trial_supported(highway["tprob"].model, highway["spec"],
                                 highway["tprob"].obj, highway["tgc"])
    _pallas_matches(highway)


def _pallas_matches(case):
    prob, spec = case["prob"], case["spec"]
    ref = jax.jit(lambda *a: _trial_eval_handwritten(
        prob.model, spec, prob.obj, case["jgc"], *a, block_lanes=B,
        interpret=True))(*case["jargs"])
    _assert_same(trial.trial_eval(*case["targs"]), ref)


def test_plain_matches_xla_trial(case):
    prob, spec = case["prob"], case["spec"]
    axes = jax.tree_util.tree_map(lambda a: 0 if a.ndim == 3 else None,
                                  case["jgc"])
    ref = jax.jit(jax.vmap(
        lambda g, *a: _xla_trial(prob.model, spec, prob.obj, g, *a),
        in_axes=(axes, 0, 0, 0, 0)))(case["jgc"], *case["jargs"])
    _assert_same(trial.trial_eval(*case["targs"]), ref)


def test_wrapper_cpu_contract(case):
    before = trial.trial_eval.launches
    tn, _ = trial.trial_eval(*case["targs"])
    assert trial.trial_eval.launches == before == 0
    tn_p, _ = trial.trial_eval_plain(*case["targs"])
    np.testing.assert_array_equal(tn.numpy(), tn_p.numpy())
    model, spec, obj, gc, traj, dtraj, alpha, reg = case["targs"]
    bad = dataclasses.replace(traj, lam=traj.lam.transpose(1, 2))
    with pytest.raises(ValueError):
        trial.trial_eval(model, spec, obj, gc, bad, dtraj, alpha, reg)
    with pytest.raises(TypeError):
        trial.trial_eval(model, spec, obj, gc, traj, dtraj, alpha.float(),
                         reg)


def test_specialization_predicate(case):
    tprob, tgc = case["tprob"], case["tgc"]
    spec, obj = tprob.spec, tprob.obj
    assert trial.trial_supported(tprob.model, spec, obj, tgc)
    # A state bound lies inside the widened specialization ...
    from algames_tpu_torch.constraints.kernels import (CollisionParams,
                                                       make_bound)
    bound = tsets.ConBlock(
        params=make_bound(np.ones(spec.n), -np.ones(spec.n), torch.float64,
                          torch.device("cpu")),
        lam=torch.zeros(spec.T, 2 * spec.n), mu=torch.ones(spec.T, 2 * spec.n),
        owner=0, is_state=True)
    gc_b = dataclasses.replace(tgc, state_blocks=tgc.state_blocks + (bound,))
    assert trial.trial_supported(tprob.model, spec, obj, gc_b)
    # ... and so does a collision block on three coordinates; one on four
    # does not: the solver then takes the eager trial by an explicit branch.
    coll3, coll4 = (tsets.ConBlock(
        params=CollisionParams(radius=torch.tensor(0.1, dtype=torch.float64),
                               pxi=tuple(range(k)),
                               pxj=tuple(range(k, 2 * k))),
        lam=torch.zeros(spec.T, 1), mu=torch.ones(spec.T, 1), owner=0,
        is_state=True) for k in (3, 4))
    gc_3 = dataclasses.replace(tgc, state_blocks=tgc.state_blocks + (coll3,))
    assert trial.trial_supported(tprob.model, spec, obj, gc_3)
    gc_c = dataclasses.replace(tgc, state_blocks=tgc.state_blocks + (coll4,))
    assert not trial.trial_supported(tprob.model, spec, obj, gc_c)
    with pytest.raises(ValueError, match="specialization"):
        trial.trial_eval(tprob.model, spec, obj, gc_c, *case["targs"][4:])
