"""The double-integrator, bicycle and quadrotor games solved whole by the
PyTorch port against the reference: the frozen equilibria
``tests/golden/{di2_N10,bike3_N20,quad2_N15}.npz`` (the gates
``tests/test_golden.py`` holds the JAX methods to: the same iteration count,
x and u within 1e-8, or (5e-3, 5e-2) for the bicycle, whose equilibrium is
pinned only to its near-converged plateau; stationarity under 5e-2 for the
quadrotor, whose thrust clamp holds it near 3e-2) and B=2 batches against
the JAX ``schur`` solve.  f64 on CPU, with the fused trial, where the
kernel wrappers run their plain versions.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algames_tpu.parallel import batch as jbatch
from algames_tpu.presets import PRESETS

import algames_tpu_torch as agt
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.presets import PRESETS as T_PRESETS

torch.set_num_threads(1)
CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {"di2_N10": (30, 1e-8, 1e-8, 1e-3),
          "bike3_N20": (90, 5e-3, 5e-2, 1e-3),
          "quad2_N15": (52, 1e-8, 1e-8, 5e-2)}


def _fused(prob):
    return dataclasses.replace(prob, opts=dataclasses.replace(prob.opts,
                                                              ls_fused=True))


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_golden(key):
    it_gold, atol_x, atol_u, opt_gate = GOLDEN[key]
    gold = np.load(os.path.join(HERE, "golden", f"{key}.npz"))
    prob, _ = T_PRESETS[key](CPU, torch.float64)
    out = agt.newton_solve(_fused(prob))
    it = int(out.stats.iter[0])
    assert it == int(gold["iter"]) == it_gold
    np.testing.assert_allclose(out.traj.x[0].numpy(), gold["x"], rtol=0,
                               atol=atol_x)
    np.testing.assert_allclose(out.traj.u[0].numpy(), gold["u"], rtol=0,
                               atol=atol_u)
    vio = {k: float(getattr(out.stats, k)[0, it - 1])
           for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
    assert vio["opt_vio"] < opt_gate and all(
        vio[k] < 1e-3 for k in ("dyn_vio", "con_vio", "sta_vio")), vio


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_batch_matches_reference_schur(key):
    """B=2 solves at outer 2 x inner 4 through solve_many (chunk 1) against
    the JAX schur solve: equal per-lane iteration counts, trajectories
    within 1e-8."""
    prob, spec = PRESETS[key](outer=2, inner=4)
    rng = np.random.default_rng(0)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((2, spec.n))
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s))
    tprob = _fused(problem_from_reference(prob, CPU, torch.float64))
    out = agt.parallel.solve_many(tprob, torch.as_tensor(x0s),
                                  method="thomas", chunk=1)
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    for a, r in ((out.traj.x, ref.traj.x), (out.traj.u, ref.traj.u)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
