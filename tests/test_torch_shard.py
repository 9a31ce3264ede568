"""The port's scenario sharding over ``torch.distributed`` against the JAX
package's, on the CPU: ``make_mesh``'s factorization against the
reference's mesh shapes, and ``sharded_monte_carlo`` on 1, 2 and 4 gloo
ranks (one world per size, as the mesh spans the world) against the
reference's on a mesh of as many devices, on ``test_parallel.py``'s
problem: trajectories within 1e-8, the converged and divergence
fractions and the mean iteration count equal, the worst dynamics
violation within 1e-10 relative.  f64.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from algames_tpu.parallel import make_mesh as jax_make_mesh
from algames_tpu.parallel import sharded_monte_carlo as jax_sharded

from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.parallel import run_ranks
from algames_tpu_torch.parallel.shard import mesh_shape

import torch_ranks
from test_parallel import _prob

torch.set_num_threads(1)
CPU = torch.device("cpu")
BATCH = 8


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_mesh_shape_matches_reference(nd):
    assert mesh_shape(nd) == jax_make_mesh(nd).devices.shape


@functools.lru_cache(maxsize=None)
def _inputs():
    prob = _prob()
    rng = np.random.default_rng(1)
    x0s = (np.asarray(prob.x0)[None]
           + 0.01 * rng.standard_normal((BATCH, prob.spec.n)))
    return prob, x0s


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_sharded_monte_carlo_matches_reference(nd):
    prob, x0s = _inputs()
    shape, trajs, summary = run_ranks(
        torch_ranks.shard_monte_carlo, nd, "gloo", CPU,
        problem_from_reference(prob, CPU, torch.float64),
        torch.as_tensor(x0s), "thomas", timeout_s=120)[0]
    assert shape == mesh_shape(nd)
    mesh = jax_make_mesh(nd)
    jt, js = jax.jit(lambda x: jax_sharded(prob, mesh, x))(x0s)
    np.testing.assert_allclose(trajs.numpy(), np.asarray(jt), rtol=1e-8,
                               atol=1e-8)
    for key in ("converged_frac", "divergence_frac", "mean_iters"):
        assert float(summary[key]) == float(js[key]), key
    np.testing.assert_allclose(float(summary["worst_dyn_vio"]),
                               float(js["worst_dyn_vio"]), rtol=1e-10)
