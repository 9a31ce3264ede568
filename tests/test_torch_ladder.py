"""The KKT-solver ladder in the PyTorch port against the JAX package: the
dense Jacobian ingredients and their block-tridiagonal and flat
(reference row order) forms, the residual, the four solves (dense, block
Thomas, block cyclic reduction, the Newton step) on the same systems with
T odd and even, and ``newton_solve`` through every method against the
reference's ``"tridiag"`` solve.  Inputs come from numpy seeds; f64 on
CPU, with the tolerance at each call.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.parallel import batch as jbatch
from algames_tpu.presets import flagship_unicycle
from algames_tpu.problem import linear_solver as JL
from algames_tpu.problem import residual as JR

import algames_tpu_torch as agt
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.problem import linear_solver as TL
from algames_tpu_torch.problem import residual as TR
from algames_tpu_torch.utils import tree_leaves

from test_torch_cones import _game, _inputs
from test_torch_roundabout import close, gc_axes

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


@functools.lru_cache(maxsize=None)
def _case(N):
    """The equality game of ``test_torch_cones`` (N knots, collision-cost
    pairs, circle and control-bound blocks) at random iterates and AL
    state (penalties 1 .. 100, so that the systems' condition leaves the
    solves 1e-10 to agree in), and the port's Jacobian ingredients,
    residual and block-tridiagonal system (D, U, L, b)."""
    prob, spec = _game("eq", N=N)
    tprob, jtr, ttr, jgc, tgc = _inputs(prob, spec,
                                        np.random.default_rng(N), 3)
    jb = TR.jacobian_blocks(tprob.model, spec, tprob.obj, tgc, ttr,
                            reg_x=1e-3, reg_u=1e-3)
    res = TR.residual(tprob.model, spec, tprob.obj, tgc, ttr)
    system = TR.build_tridiagonal(spec, jb) + (
        TR.residual_knot_blocks(spec, res),)
    return prob, spec, tprob, jtr, ttr, jgc, tgc, jb, res, system


def test_assembly_and_flattening():
    """``jacobian_blocks``, ``residual``, ``build_tridiagonal``,
    ``flatten_residual`` and ``flatten_jacobian`` within 1e-13 of the
    reference's (per lane); ``assemble`` gives the residual and the
    Jacobian ingredients regularized by its ``reg``."""
    prob, spec, tprob, jtr, ttr, jgc, tgc, jb, res, system = _case(6)

    def ref(tr, g):
        jb = JR.jacobian_blocks(prob.model, spec, prob.obj, g, tr,
                                reg_x=1e-3, reg_u=1e-3)
        res = JR.residual(prob.model, spec, prob.obj, g, tr)
        return (jb, res, JR.build_tridiagonal(spec, jb),
                JR.flatten_residual(spec, res), JR.flatten_jacobian(spec, jb))
    jout = jax.jit(jax.vmap(ref, in_axes=(0, gc_axes(jgc))))(jtr, jgc)
    tout = (jb, res, system[:3], TR.flatten_residual(spec, res),
            TR.flatten_jacobian(spec, jb))
    for a, r in zip(tree_leaves(tout), jax.tree_util.tree_leaves(jout)):
        close(a, r, 1e-13)
    ares, ajb, _, _ = TR.assemble(tprob.model, spec, tprob.obj, tgc, ttr,
                                  reg=1e-3)
    for a, r in zip(tree_leaves((ares, ajb)), tree_leaves((res, jb))):
        close(a, r, 1e-13)


@pytest.mark.parametrize("method", ["dense", "tridiag", "cr", "step"])
@pytest.mark.parametrize("N", [6, 7])
def test_solves(N, method):
    """Each solve on the same (D, U, L, b) as the reference's, T = N - 1
    odd and even, within 1e-10; each solves J y = b (the Newton step
    J y = -b) to 1e-10 against the flat Jacobian."""
    spec, jb, system = (_case(N)[k] for k in (1, 7, 9))
    D, U, L, b = (a.numpy() for a in system)
    if method == "step":
        port = TL.newton_step(spec, *system, method="tridiag")
        ref = jax.jit(jax.vmap(lambda *a: JL.newton_step(spec, *a)))(
            D, U, L, b)
        rhs = -system[3]
    else:
        fn = {"dense": "solve_dense", "tridiag": "solve_tridiagonal",
              "cr": "solve_cyclic_reduction"}[method]
        port = getattr(TL, fn)(spec, *system)
        ref = jax.jit(jax.vmap(lambda *a: getattr(JL, fn)(spec, *a)))(
            D, U, L, b)
        rhs = system[3]
    close(port, ref, 1e-10)
    # The flat Jacobian's rows are in the reference's order: so is the
    # right-hand side here.
    pn, m = spec.p * spec.n, spec.m
    flat = TR.flatten_residual(spec, TR.Residual(
        rx=rhs[:, :, :pn].reshape(rhs.shape[0], spec.T, spec.p, spec.n),
        ru=rhs[:, :, pn:pn + m], rd=rhs[:, :, pn + m:]))
    close(TR.flatten_jacobian(spec, jb) @ port[..., None], flat[..., None],
          1e-10)


@functools.lru_cache(maxsize=None)
def _reference_solve():
    """The flagship at N=8, outer 3 x 8, from three starts: the
    reference's jitted ``"tridiag"`` solve and the port's problem."""
    prob, spec = flagship_unicycle(N=8, outer=3, inner=8)
    rng = np.random.default_rng(1)
    x0s = np.asarray(prob.x0)[None] + 0.05 * rng.standard_normal((3, spec.n))
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="tridiag"))(
        jnp.asarray(x0s))
    return problem_from_reference(prob, CPU, F64), x0s, ref


@pytest.mark.parametrize("method", ["thomas", "schur", "tridiag", "dense",
                                    "cr"])
def test_methods_end_to_end(method):
    """``newton_solve`` through each method (``"thomas"``: the kernels'
    plain versions; the ladder's plain solves, and the fused trial, which
    only ``"thomas"`` takes) against the reference's ``"tridiag"`` solve:
    stats rows equal, x within 1e-8."""
    tprob, x0s, ref = _reference_solve()
    tprob = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, ls_fused=True))
    out = agt.newton_solve(tprob, torch.as_tensor(x0s), method=method)
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    close(out.traj.x, ref.traj.x, 1e-8)


def test_unknown_method_raises():
    tprob, x0s, _ = _reference_solve()
    with pytest.raises(ValueError, match="unknown linear-solver method"):
        agt.newton_solve(tprob, torch.as_tensor(x0s), method="pallas")
