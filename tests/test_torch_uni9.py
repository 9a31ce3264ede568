"""The 9-player flagship merge (``flagship_unicycle(p=9)``: n=36, m=18, 72
collision blocks, so reduced KKT systems of d=54 with R=325 right-hand
sides and NW=72 w vectors) on the CPU against the JAX package.  f64.

The JAX package's kernels take this game (K1 asserts only homogeneity and
lane-block divisibility, the hand-written trial has no size check); the
port's kernels once capped K1 at 64 w vectors and K2 at 32 states and 64
state blocks, and the wrappers applied those caps on the CPU too.

- The slice: the game at its full budget (N=20, outer 7 x inner 20) from
  x0 through the port's ``newton_solve`` (K1, and with ``ls_fused`` K2,
  their plain versions here) against the JAX package's ``schur`` solve
  frozen in ``tests/golden_torch/uni9_N20.npz``: iteration count equal, x
  and u within 1e-8.  The port's preset is the JAX package's, leaf for
  leaf (at N=6).
- Plain K1 on the game's structured KKT systems (N=4, T=3, B=2, mu = 1e3
  on the statx diagonals), assembled from the converter's carried-over
  problem, against the JAX package's ``solve_tridiagonal_schur``: worst
  per-lane relative error <= 1e-10.
- K2's plain trial against the JAX package's hand-written Pallas trial
  (interpret mode) and its XLA trial pass at N=4, three lanes: every leaf
  within 1e-10 relative.
- ``trial_supported`` and the K1 wrapper's checks at 9, 10 and 17 players
  (72, 90 and 272 w vectors and state blocks): silent on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algames_tpu.ops.trial_kernel import _trial_eval_handwritten
from algames_tpu.presets import flagship_unicycle as jax_flagship
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur
from algames_tpu.problem.residual import JacBlocks as JaxJacBlocks

import chip_smoke
import algames_tpu_torch as agt
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.ops import thomas, trial
from algames_tpu_torch.presets import flagship_unicycle
from algames_tpu_torch.problem.residual import structured_w_owner
from algames_tpu_torch.utils import tree_leaves
from test_torch_trial import _case, _xla_trial

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
P = 9
B_SHORT = 2


def rel(a, ref, lanes):
    a = np.asarray(a, np.float64).reshape(lanes, -1)
    ref = np.asarray(ref, np.float64).reshape(lanes, -1)
    scale = np.maximum(np.abs(ref).max(1), np.finfo(np.float64).tiny)
    return float((np.abs(a - ref).max(1) / scale).max())


@functools.lru_cache(maxsize=None)
def short_game(N):
    """The JAX package's 9-player flagship at horizon N (outer 1 x 2) and
    its conversion."""
    jprob, jspec = jax_flagship(jnp.float64, p=P, N=N, outer=1, inner=2)
    return jprob, jspec, problem_from_reference(jprob, CPU, F64)


def test_native_preset_is_the_reference_game():
    jprob, _, ref = short_game(6)
    prob, spec = flagship_unicycle(CPU, F64, outer=1, inner=2, p=P, N=6)
    assert (spec.n, spec.m, spec.p, spec.T) == (36, 18, 9, 5)
    assert len(prob.gc.state_blocks) == P * (P - 1)
    assert spec == ref.spec and prob.opts == ref.opts
    assert prob.model == ref.model
    for a, r in zip(tree_leaves((prob.x0, prob.obj, prob.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc))):
        np.testing.assert_array_equal(a.numpy(), r.numpy())


@pytest.mark.parametrize("ls_fused", [False, True])
def test_newton_solve_matches_the_frozen_reference(ls_fused):
    """The port's solve of the game at its full budget (N=20, outer 7 x
    inner 20) from x0 no longer raises at 72 w vectors, and takes the fused
    trial (its plain version here) when asked: the iteration count of the
    JAX package's ``schur`` solve frozen in
    ``tests/golden_torch/uni9_N20.npz`` (``tests/torch_goldens.py uni9``;
    tracing that solve takes about a minute, too long for this module), x
    and u within 1e-8."""
    gold = chip_smoke.load_golden("uni9_N20")
    prob, spec = flagship_unicycle(CPU, F64, p=P)
    np.testing.assert_array_equal(prob.x0.numpy(), gold["x0"])
    prob = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, ls_fused=ls_fused))
    assert trial.trial_supported(prob.model, spec, prob.obj, prob.gc)
    out = agt.newton_solve(prob)
    assert int(out.stats.iter[0]) == int(gold["iter"])
    np.testing.assert_allclose(out.traj.x[0].numpy(), gold["x"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out.traj.u[0].numpy(), gold["u"], rtol=0,
                               atol=1e-8)


def test_plain_k1_matches_the_jax_reference():
    jprob, jspec, tprob = short_game(4)
    spec, sq, b, w_owner = chip_smoke.k1_system(
        CPU, B_SHORT, 1e3, 19, preset=lambda dev, dtype: (tprob, tprob.spec))
    assert (spec.n + spec.m, spec.p * spec.n + 1, len(w_owner)) == (54, 325,
                                                                    72)
    dense = chip_smoke.dense_of(spec, sq, w_owner)
    jjb = JaxJacBlocks(*[getattr(dense, f).numpy()
                         for f in ("Qblk", "Ublk", "A", "B")])
    ref = jax.jit(jax.vmap(lambda j, bb: solve_tridiagonal_schur(
        jspec, j, bb)))(jjb, b.numpy())
    y = thomas.solve_thomas_structured(spec, sq, b, w_owner)
    err = rel(y.numpy(), ref, B_SHORT)
    assert err <= 1e-10, err
    y3 = thomas.solve_thomas(spec, dense, b)
    assert rel(y3.numpy(), ref, B_SHORT) <= 1e-10


def assert_same(port, ref, lanes, tol=1e-10):
    """tn and every PointLite leaf (3 residual parts, 72 state blocks, one
    control block) within ``tol`` per-lane relative error."""
    tn, lite = port
    assert rel(tn.numpy(), ref[0], lanes) <= tol
    leaves, leaves_r = tree_leaves(lite), jax.tree_util.tree_leaves(ref[1])
    assert len(leaves) == len(leaves_r) == 3 + P * (P - 1) + 1
    for a, r in zip(leaves, leaves_r):
        assert tuple(a.shape) == tuple(np.asarray(r).shape)
        assert rel(a.numpy(), r, lanes) <= tol, rel(a.numpy(), r, lanes)


@pytest.fixture(scope="module")
def trial_case():
    jprob, jspec, _ = short_game(4)
    return _case(jprob, jspec)


def test_plain_trial_matches_the_pallas_trial(trial_case):
    prob, spec, c = trial_case["prob"], trial_case["spec"], trial_case
    assert trial.trial_supported(c["tprob"].model, spec, c["tprob"].obj,
                                 c["tgc"])
    B = c["jargs"][2].shape[0]
    ref = jax.jit(lambda *a: _trial_eval_handwritten(
        prob.model, spec, prob.obj, c["jgc"], *a, block_lanes=B,
        interpret=True))(*c["jargs"])
    assert_same(trial.trial_eval(*c["targs"]), ref, B)


def test_plain_trial_matches_the_xla_trial(trial_case):
    prob, spec, c = trial_case["prob"], trial_case["spec"], trial_case
    axes = jax.tree_util.tree_map(lambda a: 0 if a.ndim == 3 else None,
                                  c["jgc"])
    ref = jax.jit(jax.vmap(
        lambda g, *a: _xla_trial(prob.model, spec, prob.obj, g, *a),
        in_axes=(axes, 0, 0, 0, 0)))(c["jgc"], *c["jargs"])
    assert_same(trial.trial_eval(*c["targs"]), ref, c["jargs"][2].shape[0])


@pytest.mark.parametrize("p", [9, 10, 17])
def test_caps_lifted_on_the_cpu(p):
    """At 9, 10 and 17 players (72, 90 and 272 w vectors, as many collision
    blocks, 36, 40 and 68 states, 18, 20 and 34 control rows) the trial
    lies inside the fused trial's specialization (the unicycle's wide
    instance) and K1's wrapper checks its
    operands and solves with the plain version, without a width cap."""
    prob, spec = flagship_unicycle(CPU, F64, outer=1, inner=1, p=p, N=3)
    w_owner = structured_w_owner(prob.gc)
    assert len(w_owner) == len(prob.gc.state_blocks) == p * (p - 1)
    assert trial.trial_supported(prob.model, spec, prob.obj, prob.gc)
    assert trial.instance_name(prob.model, spec) == "unicycle_wide"
    spec_, sq, b, w_owner = chip_smoke.k1_system(
        CPU, 1, 1e3, 3, preset=lambda dev, dtype: (prob, spec))
    y = thomas.solve_thomas_structured(spec_, sq, b, w_owner)
    ref = thomas.solve_thomas_structured_plain(spec_, sq, b, w_owner)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
