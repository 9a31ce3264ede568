"""The constraint families the double-integrator, bicycle and quadrotor games
add to the port (2D walls, 3D wall facets, cylinders, spherical collision
avoidance, full state bounds) against the JAX package: values and
Jacobians with points on both sides of every gate, the builders, the AL
updates of every block of the bicycle and quadrotor presets, and the
structured (one w vector per row) and dense Hessian assemblies.

Inputs are drawn from numpy seeds; f64 throughout, with the tolerance at
each call (1e-12 for the families and the AL updates, the same function in
another order of operations; 1e-10 for the assemblies, as for the
roundabout's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.constraints import kernels as jk
from algames_tpu.constraints import sets as jsets
from algames_tpu.presets import PRESETS
from algames_tpu.problem import residual as JR

from algames_tpu_torch.constraints import kernels as tk
from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core import traj as ttraj
from algames_tpu_torch.problem import residual as TR

from test_torch_roundabout import close, gc_axes, random_al_state

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
B = 3


def _walls(kind):
    """Two walls of ``kind`` in both packages' builder records."""
    if kind == "wall2d":
        args = [([0.0, -0.4], [1.0, -0.4], [0.0, -1.0]),
                ([0.5, 0.0], [0.5, 1.0], [1.0, 0.0])]
        return [jsets.Wall(*a) for a in args], [tsets.Wall(*a) for a in args]
    if kind == "wall3d":
        args = [([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
                 [0.0, 0.0, -1.0]),
                ([0.0, 0.5, 0.0], [1.0, 0.5, 0.0], [1.0, 0.5, 1.0],
                 [0.0, 1.0, 0.0])]
        return ([jsets.Wall3D(*a) for a in args],
                [tsets.Wall3D(*a) for a in args])
    args = [([0.75, 0.15, 0.0], "z", 2.0, 0.2), ([0.0, 0.2, 0.5], "x", 1.0,
                                                  0.3),
            ([0.3, -0.5, 0.6], "y", 1.5, 0.25)]
    return ([jsets.CylinderWall(*a) for a in args],
            [tsets.CylinderWall(*a) for a in args])


def _gate_points(kind, rng, n_pts):
    """Positions [n_pts, 3] spread across every gate of the walls of
    ``kind``, plus points exactly on a gate's boundary."""
    pts = rng.uniform(-0.8, 2.8, (n_pts, 3))
    if kind == "wall2d":
        edge = [[0.0, -0.1, 0.0], [1.0, -0.7, 0.0], [0.5, 0.0, 0.0],
                [0.5, 1.0, 0.0]]
    elif kind == "wall3d":
        edge = [[0.0, 0.3, 0.5], [2.0, -0.2, 0.1], [1.0, 1.0, 0.3],
                [1.0, -1.0, 0.1], [0.0, 0.5, 0.5], [1.0, 0.5, 1.0]]
    else:
        edge = [[0.7, 0.1, 0.0], [0.8, 0.2, 2.0], [0.0, 0.3, 0.6],
                [1.0, 0.1, 0.4], [0.4, -0.5, 0.7], [0.2, 1.0, 0.5],
                [0.8, 0.2, 1.0], [0.5, 0.3, 0.6], [0.35, 0.4, 0.7]]
    pts[:len(edge)] = edge
    return pts


@pytest.mark.parametrize("kind", ["wall2d", "wall3d", "cylinder"])
def test_gated_family_parity(kind):
    """evaluate / jacobian / num_rows of one gated family against the
    reference <= 1e-12, on positions inside and outside every gate and on
    its boundaries (strict comparisons: exactly 0 there)."""
    model = ag.quadrotor_game(p=2)
    spec = ag.spec_from_model(model, 4, 0.1)
    jw, tw = _walls(kind)
    jg = jsets.add_wall_constraint(spec, ag.game_constraints(spec), jw, i=1)
    tg = tsets.add_wall_constraint(spec, tsets.game_constraints(spec, F64,
                                                                CPU), tw, i=1)
    jpar, tpar = jg.state_blocks[0].params, tg.state_blocks[0].params
    assert type(tpar).__name__ == type(jpar).__name__
    assert tk.num_rows(tpar) == jk.num_rows(jpar) == len(jw)
    rng = np.random.default_rng(["wall2d", "wall3d", "cylinder"].index(kind))
    xs = rng.standard_normal((B, 16, spec.n))
    pos = _gate_points(kind, rng, B * 16).reshape(B, 16, 3)
    xs[..., list(spec.pz[1][:3])] = pos
    vals = jax.vmap(lambda z: jk.evaluate(jpar, z))(jnp.asarray(xs))
    close(tk.evaluate(tpar, torch.as_tensor(xs)), vals, 1e-12)
    close(tk.jacobian(tpar, torch.as_tensor(xs)),
          jax.vmap(lambda z: jk.jacobian(jpar, z))(jnp.asarray(xs)), 1e-12)
    vals = np.asarray(vals)
    assert (vals == 0).any() and (vals > 0).any() and (vals < 0).any()


def test_spherical_collision_and_state_bound_builders():
    """add_spherical_collision_avoidance (3-index collision blocks),
    add_state_bound on the full state and add_wall_constraint for every
    player give the reference's blocks; the 3-index collision values and
    Jacobians match <= 1e-12."""
    jm = ag.quadrotor_game(p=3)
    spec = ag.spec_from_model(jm, 4, 0.1)
    r = [0.1, 0.2, 0.15]
    jg = jsets.add_spherical_collision_avoidance(
        spec, ag.game_constraints(spec), r)
    jg = jsets.add_state_bound(spec, jg, 2, 5.0 * np.ones(spec.n),
                               np.r_[-np.inf, -5.0 * np.ones(spec.n - 1)])
    tg = tsets.add_spherical_collision_avoidance(
        spec, tsets.game_constraints(spec, F64, CPU), r)
    tg = tsets.add_state_bound(spec, tg, 2, 5.0 * np.ones(spec.n),
                               np.r_[-np.inf, -5.0 * np.ones(spec.n - 1)])
    for kind in ("wall2d", "wall3d", "cylinder"):
        jw, tw = _walls(kind)
        jg = jsets.add_wall_constraint(spec, jg, jw)
        tg = tsets.add_wall_constraint(spec, tg, tw)
    assert len(tg.state_blocks) == len(jg.state_blocks) == 6 + 1 + 9
    for a, b in zip(tg.state_blocks, jg.state_blocks):
        assert (a.owner, a.is_state, type(a.params).__name__) == (
            b.owner, b.is_state, type(b.params).__name__)
        assert tuple(a.lam.shape) == tuple(np.asarray(b.lam).shape)
        for f in dataclasses.fields(a.params):
            va, vb = getattr(a.params, f.name), getattr(b.params, f.name)
            if isinstance(va, torch.Tensor):
                close(va, vb, 0)
            else:
                assert tuple(np.atleast_1d(va)) == tuple(np.atleast_1d(vb))
    rng = np.random.default_rng(3)
    xs = 0.2 * rng.standard_normal((B, 8, spec.n))
    for a, b in zip(tg.state_blocks[:6], jg.state_blocks[:6]):
        assert len(a.params.pxi) == len(a.params.pxj) == 3
        close(tk.evaluate(a.params, torch.as_tensor(xs)),
              jax.vmap(lambda z: jk.evaluate(b.params, z))(jnp.asarray(xs)),
              1e-12)
        close(tk.jacobian(a.params, torch.as_tensor(xs)),
              jax.vmap(lambda z: jk.jacobian(b.params, z))(jnp.asarray(xs)),
              1e-12)


def _case(key, seed):
    """The reference preset, the port's copy, random iterates around its
    start (positions spread so that the gated families switch on and off)
    and the same random AL state on both sides."""
    prob, spec = PRESETS[key]()
    tprob = problem_from_reference(prob, CPU, F64)
    rng = np.random.default_rng(seed)
    x = (np.asarray(prob.x0)[None, None]
         + 0.6 * rng.standard_normal((B, spec.N, spec.n)))
    arrs = dict(x=x, u=0.5 * rng.standard_normal((B, spec.T, spec.m)),
                lam=0.3 * rng.standard_normal((B, spec.p, spec.T, spec.n)))
    jtr = ag.PrimalDual(**{k: jnp.asarray(v) for k, v in arrs.items()})
    ttr = ttraj.PrimalDual(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    jgc, tgc = random_al_state(prob.gc, tprob.gc, B, rng)
    return prob, spec, tprob, jtr, ttr, jgc, tgc


@pytest.mark.parametrize("key", ["bike3_N20", "quad2_N15"])
def test_blocks_and_al_updates(key):
    """Values, Jacobians and violations of every block of the preset
    (collision, state bound, walls, circles; spherical collision, 3D wall,
    cylinder, control bound), and the dual and penalty updates, <= 1e-12."""
    prob, spec, tprob, jtr, ttr, jgc, tgc = _case(key, 21)
    for jb, tb in zip(jgc.state_blocks + jgc.control_blocks,
                      tgc.state_blocks + tgc.control_blocks):
        cj = jax.vmap(lambda tr: jsets.block_values(jb, tr))(jtr)
        close(tsets.block_values(tb, ttr), cj, 1e-12)
        close(tsets.block_jacobian(tb, ttr),
              jax.vmap(lambda tr: jsets.block_jacobian(jb, tr))(jtr), 1e-12)
        close(tsets.block_violation_max(tsets.block_values(tb, ttr), tb.sense),
              jax.vmap(lambda c: jsets.block_violation_max(jb, c))(cj), 1e-12)
    axes = gc_axes(jgc)
    jd = jax.vmap(jsets.dual_update, in_axes=(axes, 0), out_axes=axes)(
        jgc, jtr)
    jp = jax.vmap(jsets.penalty_update, in_axes=(axes,), out_axes=axes)(jgc)
    for port, ref in ((tsets.dual_update(tgc, ttr), jd),
                      (tsets.penalty_update(tgc), jp)):
        for a, r in zip(port.state_blocks + port.control_blocks,
                        ref.state_blocks + ref.control_blocks):
            close(a.lam, r.lam, 1e-12)
            close(a.mu, r.mu, 1e-12)


@pytest.mark.parametrize("key", ["di2_N10", "quad2_N15", "bike3_N20"])
def test_assembly(key):
    """The solver's assembly of each preset against the reference <=
    1e-10: structured (diagonal + one w vector per row of every collision,
    wall, 3D-wall and cylinder block; the same w owners) for the double
    integrator and the quadrotor, dense (collision-cost pairs) for the
    bicycle."""
    prob, spec, tprob, jtr, ttr, jgc, tgc = _case(key, 31)
    reg = np.array([1e-3, 0.5, 7.0])
    structured = key != "bike3_N20"
    assert TR.structured_q_supported(spec, tprob.obj, tgc) == structured
    assert JR.structured_q_supported(spec, prob.obj, prob.gc) == structured
    jasm = (JR.assemble_structured_from_point if structured
            else JR.assemble_from_point)
    tasm = (TR.assemble_structured_from_point if structured
            else TR.assemble_from_point)

    def ref(tr, g, r):
        pd = JR.point_data(prob.model, spec, prob.obj, g, tr)
        return jasm(spec, prob.obj, g, tr, pd, reg=r)
    res, blocks, sv, cv = jax.jit(jax.vmap(
        ref, in_axes=(0, gc_axes(jgc), 0)))(jtr, jgc, jnp.asarray(reg))
    tpd = TR.point_data(tprob.model, spec, tprob.obj, tgc, ttr)
    tres, tblocks, tsv, tcv = tasm(spec, tprob.obj, tgc, ttr, tpd,
                                   reg=torch.as_tensor(reg))
    for a, r in ((tres.rx, res.rx), (tres.ru, res.ru), (tres.rd, res.rd),
                 (tsv, sv), (tcv, cv)):
        close(a, r, 1e-10)
    for f in dataclasses.fields(tblocks):
        close(getattr(tblocks, f.name), getattr(blocks, f.name), 1e-10)
    if structured:
        owners = TR.structured_w_owner(tgc)
        assert owners == JR.structured_w_owner(prob.gc)
        assert len(owners) == tblocks.wv.shape[2] == sum(
            b.lam.shape[-1] for b in tgc.state_blocks
            if not isinstance(b.params, tk.BoundParams))
