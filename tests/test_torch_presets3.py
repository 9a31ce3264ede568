"""The double-integrator, bicycle and quadrotor presets of the PyTorch port
against the JAX package: the native builders against the reference problems
carried over by ``problem_from_reference`` (models with their constants,
every constraint family), the converter's refusals, and the plain version
of the widened fused trial (K4) against the body the reference's generic
fused trial kernel replays per lane (``trial_pallas._trial_eval``, vmapped).

Inputs are drawn from numpy seeds; f64 throughout.  Preset leaves agree to
1e-15; the trial's tn and every carried leaf to a per-lane relative error
(max |a - ref| / max |ref|) of 1e-12, the same function in another order of
operations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.ops.trial_pallas import _trial_eval
from algames_tpu.presets import PRESETS

from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core.traj import PrimalDual
from algames_tpu_torch.ops import trial
from algames_tpu_torch.presets import PRESETS as T_PRESETS
from algames_tpu_torch.utils import tree_leaves

from test_torch_roundabout import gc_axes, random_al_state

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
KEYS = ["di2_N10", "bike3_N20", "quad2_N15"]
B = 4


@pytest.mark.parametrize("key", KEYS)
def test_native_preset_matches_reference(key):
    """The port's own builder gives the reference's problem: spec, options
    and budget, the model with its constants, objective and every block's
    family, owner, parameters and masks; f32 gates stationarity at 1e-2."""
    ref = problem_from_reference(PRESETS[key]()[0], CPU, F64)
    prob, spec = T_PRESETS[key](CPU, F64)
    assert spec == ref.spec and prob.opts == ref.opts
    assert prob.model == ref.model
    for f in ("pair_i", "pair_j", "pxi", "pxj"):
        assert getattr(prob.obj, f) == getattr(ref.obj, f)
    for a, r in zip(tree_leaves((prob.x0, prob.obj, prob.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc)), strict=True):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-15,
                                   atol=1e-15)
    for a, r in zip(prob.gc.state_blocks + prob.gc.control_blocks,
                    ref.gc.state_blocks + ref.gc.control_blocks, strict=True):
        assert (a.owner, a.is_state, type(a.params)) == (
            r.owner, r.is_state, type(r.params))
        for f in dataclasses.fields(a.params):
            if f.type != "torch.Tensor":
                assert getattr(a.params, f.name) == getattr(r.params, f.name)
    p32, _ = T_PRESETS[key](CPU, torch.float32)
    assert p32.opts.eps_opt == 1e-2 and prob.opts.eps_opt == 1e-3


def test_converter_carries_model_constants_and_refuses():
    """Non-default physical constants and the heterogeneous model's ragged
    index tuples survive the converter, and so does ``ls_parallel`` > 1;
    an equality block arrives as one."""
    cases = [
        ag.double_integrator_game(p=3, d=3),
        ag.bicycle_game(p=2, lf=0.07, lr=0.03),
        ag.quadrotor_game(p=2, mass=0.8, thrust_smoothing=50.0),
        ag.hetero_double_integrator_game(mi=(3, 1, 2), d=3),
    ]
    def problem(jm):
        spec = ag.spec_from_model(jm, 5, 0.1)
        obj = ag.game_objective(
            spec, Q=[jnp.ones(k) for k in jm.ni],
            R=[jnp.ones(k) for k in jm.mi], xf=[jnp.zeros(k) for k in jm.ni],
            uf=[jnp.zeros(k) for k in jm.mi])
        return ag.game_problem(5, 0.1, jnp.zeros(jm.n), jm, ag.Options(), obj,
                               ag.game_constraints(spec))
    for jm in cases:
        tm = problem_from_reference(problem(jm), CPU, F64).model
        assert type(tm).__name__ == type(jm).__name__
        for f in dataclasses.fields(jm):
            assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    parallel_ls = problem(ag.hetero_double_integrator_game(mi=(2, 1)))
    parallel_ls = dataclasses.replace(parallel_ls, opts=dataclasses.replace(
        parallel_ls.opts, ls_parallel=2))
    assert problem_from_reference(parallel_ls, CPU, F64).opts.ls_parallel == 2
    spec = parallel_ls.spec
    gc = ag.add_control_bound(spec, parallel_ls.gc, jnp.ones(spec.m),
                              -jnp.ones(spec.m))
    gc = dataclasses.replace(gc, control_blocks=(dataclasses.replace(
        gc.control_blocks[0], sense="eq"),))
    eq = problem_from_reference(dataclasses.replace(parallel_ls, gc=gc), CPU,
                                F64)
    assert eq.gc.control_blocks[0].sense == "eq"


def _rel(a, ref):
    a = np.asarray(a).reshape(a.shape[0], -1)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    scale = np.maximum(np.abs(ref).max(1), np.finfo(np.float64).tiny)
    return float((np.abs(a - ref).max(1) / scale).max())


@pytest.mark.parametrize("key", KEYS)
def test_trial_plain_matches_reference(key):
    """trial_eval (its plain version on CPU tensors) against the generic
    fused trial's per-lane body; the quadrotor's first lane sits on the
    thrust kink (controls and control steps exactly 0)."""
    prob, spec = PRESETS[key]()
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(KEYS.index(key))
    arrs = dict(
        x=np.asarray(prob.x0)[None, None]
        + 0.5 * rng.standard_normal((B, spec.N, spec.n)),
        u=0.5 * rng.standard_normal((B, spec.T, spec.m)),
        lam=0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n)),
        dx=0.05 * rng.standard_normal((B, spec.N, spec.n)),
        du=0.05 * rng.standard_normal((B, spec.T, spec.m)),
        dlam=0.05 * rng.standard_normal((B, spec.p, spec.T, spec.n)),
        alpha=0.5 ** rng.integers(0, 6, size=B),
        reg=1e-3 * (1.0 + rng.integers(0, 20, size=B)) ** 4)
    arrs["dx"][:, 0] = 0.0
    if key == "quad2_N15":
        arrs["u"][0] = arrs["du"][0] = 0.0
    jgc, tgc = random_al_state(prob.gc, tprob.gc, B, rng)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    ref = jax.jit(jax.vmap(
        lambda g, t, d, a, r: _trial_eval(prob.model, spec, prob.obj, g, t,
                                          d, a, r),
        in_axes=(gc_axes(jgc), 0, 0, 0, 0)))(
        jgc, ag.PrimalDual(x=j["x"], u=j["u"], lam=j["lam"]),
        ag.PrimalDual(x=j["dx"], u=j["du"], lam=j["dlam"]), j["alpha"],
        j["reg"])
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    args = (tprob.model, spec, tprob.obj, tgc,
            PrimalDual(x=t["x"], u=t["u"], lam=t["lam"]),
            PrimalDual(x=t["dx"], u=t["du"], lam=t["dlam"]), t["alpha"],
            t["reg"])
    assert trial.trial_supported(*args[:4])
    tn, lite = trial.trial_eval(*args)
    assert _rel(tn.numpy(), ref[0]) <= 1e-12
    leaves, leaves_r = tree_leaves(lite), jax.tree_util.tree_leaves(ref[1])
    assert len(leaves) == len(leaves_r) == 3 + len(tgc.state_blocks) + len(
        tgc.control_blocks)
    for a, r in zip(leaves, leaves_r):
        assert tuple(a.shape) == tuple(np.asarray(r).shape)
        assert _rel(a.numpy(), r) <= 1e-12, _rel(a.numpy(), r)
