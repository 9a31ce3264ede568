"""The port's horizon-split KKT solve (SPIKE over ``torch.distributed``)
against the JAX package's, on the CPU: ``solve_tridiagonal_sharded`` on
real KKT systems over 1, 2 and 4 gloo ranks against the reference's
sequential ``solve_tridiagonal`` and its ``solve_tridiagonal_sharded`` on
a mesh of the same size; ``newton_solve`` through ``spike_kkt_method`` on
4 ranks against the reference's ``"tridiag"`` solve; a T that does not
split over the ranks raises.  The ranks run ``tests/torch_ranks.py`` in
one world of 4 processes (``parallel.run_ranks``).  f64, tolerances at
each check.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch
from jax.sharding import Mesh

import algames_tpu as ag
from algames_tpu.parallel.horizon import \
    solve_tridiagonal_sharded as jax_sharded
from algames_tpu.problem.linear_solver import solve_tridiagonal as jax_thomas

from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core.spec import ProblemSpec
from algames_tpu_torch.parallel import run_ranks
from algames_tpu_torch.problem.linear_solver import solve_tridiagonal

import torch_ranks
from test_horizon import _kkt_system

torch.set_num_threads(1)
CPU = torch.device("cpu")
SIZES = (1, 2, 4)


def _port_spec(spec):
    return ProblemSpec(**{f: getattr(spec, f) for f in (
        "N", "n", "m", "p", "ni", "mi", "pu", "px", "pz", "dt")})


def _lanes(*arrays):
    """JAX arrays as port tensors with a batch axis of one."""
    return tuple(torch.as_tensor(np.array(a))[None] for a in arrays)


def _newton_problem():
    """The N=33 (T=32) two-player game of ``test_horizon.py``."""
    import jax.numpy as jnp
    p, N, dt = 2, 33, 0.05
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(spec, [jnp.ones(4)] * p, [0.5 * jnp.ones(2)] * p,
                            [jnp.asarray([1.5, 0.2 * i, 0.0, 0.2])
                             for i in range(p)],
                            [jnp.zeros(2)] * p, dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, 0.1)
    opts = ag.Options(outer_iter=2, inner_iter=6)
    x0 = jnp.asarray([0., 0., 0.2, 0.2, 0., 0., 0.4, 0.4], jnp.float64)
    return ag.game_problem(N, dt, x0, model, opts, obj, gc)


@functools.lru_cache(maxsize=None)
def _world():
    """The reference's systems and solutions, and the port's ranks' (one
    world of 4 gloo processes)."""
    systems = [_kkt_system(p=2, N=17)]
    spec = _port_spec(systems[0][0])
    jprob = _newton_problem()
    tsys = [_lanes(D, U, L, b) for _, _, D, U, L, b in systems]
    # The first 14 knots' system: T = 14 does not split over 4 ranks.
    D, U, L, b = tsys[0]
    bad = (dataclasses.replace(spec, N=15), D[:, :14], U[:, :13], L[:, :13],
           b[:, :14])
    out = run_ranks(
        torch_ranks.spike_world, 4, "gloo", CPU, spec, tsys, bad,
        problem_from_reference(jprob, CPU, torch.float64), timeout_s=120)
    return systems, tsys, jprob, out


def test_spike_matches_reference_every_group_size():
    """Every rank's solution at 1, 2 and 4 ranks within 1e-9 of the
    reference's sequential sweep and of its SPIKE on a mesh of as many
    devices; one rank within 1e-10 of the port's own block Thomas."""
    systems, tsys, _, out = _world()
    for k, (spec, _, D, U, L, b) in enumerate(systems):
        ref = np.asarray(jax_thomas(spec, D, U, L, b))
        for nd in SIZES:
            mesh = Mesh(np.asarray(jax.devices()[:nd]), ("hz",))
            jsh = np.asarray(jax.jit(lambda D, U, L, b: jax_sharded(
                spec, D, U, L, b, mesh))(D, U, L, b))
            for rank in range(nd):
                y = out[rank][nd][k][0].numpy()
                np.testing.assert_allclose(y, ref, rtol=1e-9, atol=1e-9)
                np.testing.assert_allclose(y, jsh, rtol=1e-9, atol=1e-9)
        own = solve_tridiagonal(_port_spec(spec), *tsys[k])
        np.testing.assert_allclose(out[0][1][k].numpy(), own.numpy(),
                                   rtol=1e-10, atol=1e-10)


def test_spike_newton_solve_matches_reference_tridiag():
    """N=33: the 4-rank horizon-split solve takes the reference's number of
    stats rows, x within 1e-8 of its ``"tridiag"`` solve, on every rank."""
    _, _, jprob, out = _world()
    ref = ag.newton_solve_jit(jprob, method="tridiag")
    for rank in range(4):
        x, iters = out[rank]["newton"]
        assert int(iters[0]) == int(ref.stats.iter)
        np.testing.assert_allclose(x[0].numpy(), np.asarray(ref.traj.x),
                                   rtol=1e-8, atol=1e-8)


def test_spike_rejects_horizon_not_divisible():
    _, _, _, out = _world()
    assert all(out[rank]["raised"] for rank in range(4))
