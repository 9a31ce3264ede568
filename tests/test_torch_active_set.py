"""The active-set analysis in the PyTorch port against the JAX package:
the extended system's sizes and indices, residual and Jacobians (the
reference-ordered and the per-knot builders), the active masks and flags,
and the nullspace (host-driven and fixed-shape) by dimension and span,
planar and spherical.  Inputs come from numpy seeds; f64 on CPU, with the
tolerance at each call.
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu import active_set as jas
from algames_tpu.constraints import sets as jsets

import algames_tpu_torch as agt
from algames_tpu_torch import active_set as tas
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.utils import tree_leaves

from test_torch_roundabout import close

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import crossing_game, invariance_ratio  # noqa: E402
from reference_fractions import crossing_problem  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def _prob(p=3, N=6, radius=1.0, model=None, spherical=False):
    """``tests/test_active_set.py``'s game with its random weights drawn
    from a numpy seed: unicycles (or ``model``) with collision avoidance of
    ``radius`` (spherical on the first three state components with
    ``spherical``)."""
    model = model or ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, 0.1)
    rng = np.random.default_rng(p * 100 + N)
    ni, mi = model.ni[0], model.mi[0]
    obj = ag.game_objective(
        spec, Q=[jnp.asarray(rng.random(ni) + 0.1)] * p,
        R=[jnp.asarray(rng.random(mi) + 0.1)] * p,
        xf=[(i + 1.0) * jnp.ones(ni) for i in range(p)],
        uf=[2.0 * (i + 1) * jnp.ones(mi) for i in range(p)])
    gc = ag.game_constraints(spec)
    gc = (jsets.add_spherical_collision_avoidance(spec, gc, radius)
          if spherical else ag.add_collision_avoidance(spec, gc, radius))
    x0 = jnp.asarray(rng.random(spec.n))
    prob = ag.game_problem(N, 0.1, x0, model, ag.Options(), obj, gc)
    return prob, spec, problem_from_reference(prob, CPU, F64)


def _traj(spec, x, u=None):
    """The same trajectory (lanes [B, ...]) on both sides, zero duals."""
    B = x.shape[0]
    u = np.zeros((B, spec.T, spec.m)) if u is None else u
    lam = np.zeros((B, spec.p, spec.T, spec.n))
    return (ag.PrimalDual(x=jnp.asarray(x), u=jnp.asarray(u),
                          lam=jnp.asarray(lam)),
            agt.PrimalDual(x=torch.as_tensor(x), u=torch.as_tensor(u),
                           lam=torch.as_tensor(lam)))


def _lane(tree, k):
    return jax.tree_util.tree_map(lambda a: a[k], tree)


def test_sizes_and_indices():
    """Sizes, pair lists, appended row and column indices exact; the
    collision blocks resolve to the same owners and partners."""
    for p, N in ((2, 5), (3, 6), (4, 4)):
        prob, spec, tprob = _prob(p, N)
        assert tas.sizes(spec) == jas.sizes(spec)
        assert tas.unordered_pairs(p) == jas.unordered_pairs(p)
        assert tas.ordered_pairs(p) == jas.ordered_pairs(p)
        for k in range(1, spec.T + 1):
            for i, j in jas.unordered_pairs(p):
                assert tas.vrow(spec, i, j, k) == jas.vrow(spec, i, j, k)
            for i, j in jas.ordered_pairs(p):
                assert tas.hcol(spec, i, j, k) == jas.hcol(spec, i, j, k)
                a = tas.get_collision_block(tprob.gc, spec, i, j)
                r = jas.get_collision_block(prob.gc, spec, i, j)
                assert (a.owner, a.params.pxj) == (r.owner,
                                                   tuple(r.params.pxj))
        for k in range(spec.T):
            for i in range(p):
                assert tprob.spec.row_stat_x(i, k) == spec.row_stat_x(i, k)
                assert tprob.spec.row_stat_u(i, k) == spec.row_stat_u(i, k)
                assert tprob.spec.col_lam(i, k) == spec.col_lam(i, k)
            assert tprob.spec.row_dyn(k) == spec.row_dyn(k)
        with pytest.raises(ValueError):
            tas.vrow(spec, 1, 0, 1)


def test_extended_system():
    """The extended residual, the reference-ordered and the per-knot
    extended Jacobians of two lanes within 1e-12 of the reference's."""
    prob, spec, tprob = _prob(3, 6)
    rng = np.random.default_rng(11)
    jtr, ttr = _traj(spec, 0.05 * rng.standard_normal((2, spec.N, spec.n)),
                     0.1 * rng.standard_normal((2, spec.T, spec.m)))
    ref = jax.jit(jax.vmap(lambda tr: (
        jas.extended_residual(prob, tr), jas.extended_jacobian(prob, tr),
        jas.extended_jacobian_knotrows(prob, tr))))(jtr)
    port = (tas.extended_residual(tprob, ttr),
            tas.extended_jacobian(tprob, ttr),
            tas.extended_jacobian_knotrows(tprob, ttr))
    for a, r in zip(port, ref):
        close(a, r, 1e-12)


def test_extended_residual_appended_duals():
    """The appended duals enter the extended residual through the appended
    columns of the extended Jacobian: r(z, lam_col) - r(z, 0) equals
    J[:, :, S:] lam_col (knot-major, pair-minor) within 1e-12, two lanes."""
    prob, spec, tprob = _prob(3, 6)
    rng = np.random.default_rng(15)
    _, ttr = _traj(spec, 0.05 * rng.standard_normal((2, spec.N, spec.n)),
                   0.1 * rng.standard_normal((2, spec.T, spec.m)))
    lam_col = torch.as_tensor(rng.standard_normal(
        (2, spec.T, spec.p * (spec.p - 1))))
    J = tas.extended_jacobian(tprob, ttr)
    step = (tas.extended_residual(tprob, ttr, lam_col)
            - tas.extended_residual(tprob, ttr))
    close(step, (J[:, :, spec.S:] @ lam_col.reshape(2, -1, 1))[..., 0], 1e-12)


def test_active_flags_and_masks():
    """Active flags after ``update_active_set`` at a point with some pairs
    apart and some close (per lane), the host masks of each lane and the
    fixed-shape flags equal the reference's."""
    prob, spec, tprob = _prob(3, 6, radius=0.3)
    rng = np.random.default_rng(12)
    x = 0.3 * rng.standard_normal((3, spec.N, spec.n))
    jtr, ttr = _traj(spec, x)
    tgc = agt.update_active_set(tprob.gc, ttr)
    for k in range(3):
        jgc = ag.update_active_set(prob.gc, _lane(jtr, k))
        for a, r in zip(tgc.state_blocks, jgc.state_blocks):
            np.testing.assert_array_equal(a.active[k].numpy(),
                                          np.asarray(r.active))
        for i, j in jas.ordered_pairs(spec.p):
            for kk in range(1, spec.T + 1):
                assert (tas.active(tgc, spec, i, j, kk, lane=k)
                        == jas.active(jgc, spec, i, j, kk))
        for a, r in zip(tas.active_masks(tprob, tgc, lane=k),
                        jas.active_masks(prob, jgc)):
            np.testing.assert_array_equal(a, r)
        for a, r in zip(tas.pair_active_flags(tgc, spec),
                        jas.pair_active_flags(jgc, spec)):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(r))
    flags = [b.active for b in tgc.state_blocks]
    assert any(f.any() for f in flags) and not all(f.all() for f in flags)


def _span_gap(V, W):
    """max |(I - P_W) v| over the unit columns v of V, P_W the projector on
    the columns of W (both orthonormalized)."""
    Q = np.linalg.qr(W)[0]
    Vn = np.linalg.qr(V)[0]
    return float(np.abs(Vn - Q @ (Q.T @ Vn)).max())


@pytest.mark.parametrize("case", ["planar", "spherical"])
def test_nullspace_dimension_and_span(case):
    """``update_nullspace`` per lane and ``update_nullspace_masked`` over
    the lanes against the reference's: the same dimension ((N-1) p(p-1)/2
    with every pair active), the same span (the mean-abs normalization
    undone; 1e-6: two LAPACK SVDs differ by rounding over the gap below
    the smallest nonzero singular value, 7.5e-8 on the planar case), the
    masked vectors spanning the host basis (1e-6) and in the kernel of the
    active extended Jacobian (1e-7); planar unicycles and spherical blocks
    (a double integrator in three dimensions)."""
    if case == "planar":
        prob, spec, tprob = _prob(3, 6, radius=1.0)
    else:
        prob, spec, tprob = _prob(2, 5, radius=1.0, spherical=True,
                                  model=ag.double_integrator_game(p=2, d=3))
        assert tas.get_collision_block(tprob.gc, spec, 0, 1) is not None
    rng = np.random.default_rng(13)
    jtr, ttr = _traj(spec, 0.01 * rng.standard_normal((2, spec.N, spec.n)))
    expect = (spec.N - 1) * spec.p * (spec.p - 1) // 2
    masked = tas.update_nullspace_masked(tprob, ttr)
    jmasked = jax.jit(jax.vmap(lambda tr: jas.update_nullspace_masked(
        prob, tr)))(jtr)
    np.testing.assert_array_equal(masked.dim.numpy(), np.asarray(jmasked.dim))
    tgc = agt.update_active_set(tprob.gc, ttr)
    J = tas.extended_jacobian(dataclasses.replace(tprob, gc=tgc), ttr)
    for k in range(2):
        ns = tas.update_nullspace(tprob, ttr, lane=k)
        ref = jas.update_nullspace(prob, _lane(jtr, k))
        assert ns.mat.shape == ref.mat.shape == (tas.sizes(spec)[1], expect)
        assert int(masked.dim[k]) == expect
        assert _span_gap(ns.mat.numpy(), np.asarray(ref.mat)) < 1e-6
        vecs = masked.vec[k][masked.mask[k]].numpy()
        assert _span_gap(vecs.T, ns.vec.numpy().T) < 1e-6
        assert float((J[k] @ torch.as_tensor(vecs.T)).abs().max()) < 1e-7
        close(ns.dtraj, ns.vec[:, :spec.S], 0.0)


def test_nullspace_first_order_invariance():
    """At random small positions (every pair active): stepping eps = 1e-3
    along a nullspace vector changes the extended residual (with the
    appended duals' stationarity terms) at least 10x less than a random
    direction of equal norm."""
    prob, spec, tprob = _prob(3, 6, radius=1.0)
    rng = np.random.default_rng(14)
    _, ttr = _traj(spec, 0.01 * rng.standard_normal((1, spec.N, spec.n)))
    ns = tas.update_nullspace(tprob, ttr)
    for v in ns.vec[:3]:
        assert invariance_ratio(tprob, ttr, v, 1e-3, rng) >= 10.0


def test_crossing_game_builder():
    """``chip_smoke.py``'s native builder of the nullspace game equals the
    reference's converted (``examples/nullspace_example.py``'s game)."""
    prob, _ = crossing_problem()
    ref = problem_from_reference(prob, CPU, F64)
    native, _ = crossing_game(CPU, F64)
    assert native.spec == ref.spec and native.opts == ref.opts
    for a, r in zip(tree_leaves((native.x0, native.obj, native.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc))):
        assert torch.equal(a, r)
