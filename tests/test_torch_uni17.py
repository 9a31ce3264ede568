"""The 17-player flagship merge (``flagship_unicycle(p=17)``: n=68, m=34,
272 collision blocks, so reduced KKT systems of d=102 with R=1157
right-hand sides and NW=272 w vectors) on the CPU against the JAX package.
f64.

The JAX package's kernels take this game (K1 asserts only homogeneity and
lane-block divisibility, the hand-written trial has no size check); the
port's kernels capped K1 at 32 control rows and K2 at 64 states and 32
control rows, and the port's dual update raised past ten players, where the
reference's index into its ten dual step sizes clamps.

- The slice: the game at its full budget (N=20, outer 7 x inner 20) from
  x0 through the port's ``newton_solve`` (K1, and with ``ls_fused`` K2,
  their plain versions here) against the JAX package's ``schur`` solve
  frozen in ``tests/golden_torch/uni17_N20.npz`` (``tests/torch_goldens.py
  uni17``; tracing that solve takes minutes): iteration count equal, x and
  u within 1e-8.  The port's preset is the JAX package's, leaf for leaf (at
  N=6).
- Plain K1 on the game's structured KKT systems (N=4, T=3, B=2, mu = 1e3
  on the statx diagonals), assembled from the converter's carried-over
  problem, against the JAX package's ``solve_tridiagonal_schur``: worst
  per-lane relative error <= 1e-10.
- K2's plain trial against the JAX package's hand-written Pallas trial
  (interpret mode) at N=4, three lanes: every leaf within 1e-10 relative;
  the Pallas trial's output is frozen in
  ``tests/golden_torch/uni17_trial_N4.npz`` (``tests/torch_goldens.py
  uni17_trial``: it takes about a minute in interpret mode here).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algames_tpu.presets import flagship_unicycle as jax_flagship
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur
from algames_tpu.problem.residual import JacBlocks as JaxJacBlocks

import chip_smoke
import algames_tpu_torch as agt
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.ops import thomas, trial
from algames_tpu_torch.presets import flagship_unicycle
from algames_tpu_torch.utils import tree_leaves
from test_torch_trial import _case
from test_torch_uni9 import rel

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
P = 17
B_SHORT = 2


@functools.lru_cache(maxsize=None)
def short_game(N):
    """The JAX package's 17-player flagship at horizon N (outer 1 x 2) and
    its conversion."""
    jprob, jspec = jax_flagship(jnp.float64, p=P, N=N, outer=1, inner=2)
    return jprob, jspec, problem_from_reference(jprob, CPU, F64)


def test_native_preset_is_the_reference_game():
    jprob, _, ref = short_game(6)
    prob, spec = flagship_unicycle(CPU, F64, outer=1, inner=2, p=P, N=6)
    assert (spec.n, spec.m, spec.p, spec.T) == (68, 34, 17, 5)
    assert len(prob.gc.state_blocks) == P * (P - 1)
    assert spec == ref.spec and prob.opts == ref.opts
    assert prob.model == ref.model
    for a, r in zip(tree_leaves((prob.x0, prob.obj, prob.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc))):
        np.testing.assert_array_equal(a.numpy(), r.numpy())


@pytest.mark.parametrize("ls_fused", [False, True])
def test_newton_solve_matches_the_frozen_reference(ls_fused):
    """The port's solve of the game at its full budget (N=20, outer 7 x
    inner 20) from x0: past 32 control rows and 64 states, and past the
    ten dual step sizes of ``Options.alphax_dual`` in the outer update
    (players 10 to 16 take the last, as the reference's clamped index
    does), with the fused trial (its plain version here) when asked: the
    iteration count of the JAX package's ``schur`` solve frozen in
    ``tests/golden_torch/uni17_N20.npz``, x and u within 1e-8."""
    gold = chip_smoke.load_golden("uni17_N20")
    prob, spec = flagship_unicycle(CPU, F64, p=P)
    np.testing.assert_array_equal(prob.x0.numpy(), gold["x0"])
    assert len(prob.opts.alphax_dual) < P
    prob = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, ls_fused=ls_fused))
    assert trial.trial_supported(prob.model, spec, prob.obj, prob.gc)
    assert trial.instance_name(prob.model, spec) == "unicycle_wide"
    out = agt.newton_solve(prob)
    assert int(out.stats.iter[0]) == int(gold["iter"])
    np.testing.assert_allclose(out.traj.x[0].numpy(), gold["x"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out.traj.u[0].numpy(), gold["u"], rtol=0,
                               atol=1e-8)


def test_plain_k1_matches_the_jax_reference():
    jprob, jspec, tprob = short_game(4)
    spec, sq, b, w_owner = chip_smoke.k1_system(
        CPU, B_SHORT, 1e3, 23, preset=lambda dev, dtype: (tprob, tprob.spec))
    assert (spec.n + spec.m, spec.m, spec.p * spec.n + 1,
            len(w_owner)) == (102, 34, 1157, 272)
    dense = chip_smoke.dense_of(spec, sq, w_owner)
    jjb = JaxJacBlocks(*[getattr(dense, f).numpy()
                         for f in ("Qblk", "Ublk", "A", "B")])
    ref = jax.jit(jax.vmap(lambda j, bb: solve_tridiagonal_schur(
        jspec, j, bb)))(jjb, b.numpy())
    y = thomas.solve_thomas_structured(spec, sq, b, w_owner)
    assert rel(y.numpy(), ref, B_SHORT) <= 1e-10
    y3 = thomas.solve_thomas(spec, dense, b)
    assert rel(y3.numpy(), ref, B_SHORT) <= 1e-10


def test_plain_trial_matches_the_pallas_trial():
    """tn and every PointLite leaf (3 residual parts, 272 state blocks, one
    control block) of the plain trial on ``_case``'s three lanes against
    the hand-written Pallas trial's, frozen."""
    jprob, jspec, _ = short_game(4)
    c = _case(jprob, jspec)
    assert trial.trial_supported(c["tprob"].model, jspec, c["tprob"].obj,
                                 c["tgc"])
    gold = chip_smoke.load_golden("uni17_trial_N4")
    B = c["jargs"][2].shape[0]
    tn, lite = trial.trial_eval(*c["targs"])
    assert rel(tn.numpy(), gold["tn"], B) <= 1e-10
    leaves = tree_leaves(lite)
    assert len(leaves) == len(gold.files) - 1 == 3 + P * (P - 1) + 1
    for k, a in enumerate(leaves):
        r = gold[f"leaf_{k:03d}"]
        assert tuple(a.shape) == r.shape
        assert rel(a.numpy(), r, B) <= 1e-10
