"""Frozen reference solutions for the PyTorch port's chip checks, computed
by the JAX package in f64 on the CPU.  Not a test module (pytest does not
collect it); ``chip_smoke.py`` reads its files and never imports JAX.

    JAX_PLATFORMS=cpu python tests/torch_goldens.py [hetero] [ibr] [ring3_eq]
        [ibr_quad] [uni9] [uni17] [uni17_trial]

writes, under ``tests/golden_torch/``:

- ``hetero2_N8.npz``: the heterogeneous double-integrator game of
  ``tests/test_hetero.py`` (``_prob``: mi = (2, 1), N=8, outer 7 x 20)
  solved by the dense oracle (``method="dense"``): x, u, the iteration
  count ``iter`` and the final violations;
- ``ibr_uni3_N20.npz``: iterative best response on the flagship
  (``flagship_unicycle``, outer 3 x inner 8 per player solve,
  ``IBROptions(ibr_iter=10)``, the configuration of
  ``benchmarks/bench_ibr.py``) through ``method="schur"``: x, u, ``iter``
  (stats rows) and the Gauss-Seidel round count ``q``;
- ``ring3_eq_N20.npz``: the flagship (``flagship_unicycle``, outer 7 x
  inner 20) with player 0 held on a ring road by an equality block
  (``ring3_eq_problem``) through ``newton_solve_jit``: x, u, ``iter`` and
  the final violations;
- ``ibr_quad2_N6.npz``: iterative best response on the quadrotor game of
  ``presets.quadrotor3d`` cut to N=6 (``ibr_quad_problem``: outer 2 x
  inner 4 per player solve, one round) from two starts x0 + 0.05 N(0, 1)
  (numpy seed 0), vmapped, through ``method="schur"``: the starts
  ``x0s``, x, u, and per lane the stats rows ``iter``, their ``outer``
  (round) column and residuals ``res``.  About 90 s, 70 of them tracing;
- ``uni9_N20.npz``: the 9-player flagship merge (``flagship_unicycle(p=9)``,
  outer 7 x inner 20) from its own x0 through ``method="schur"``: x0, x,
  u, ``iter`` and the final violations;
- ``uni17_N20.npz``: the same with 17 players (``flagship_unicycle(p=17)``:
  n = 68, m = 34, 272 collision blocks; about three minutes);
- ``uni17_trial_N4.npz``: the JAX package's hand-written trial
  (``_trial_eval_handwritten``, interpret mode; about a minute) on
  ``tests/test_torch_trial.py::_case``'s three lanes of the 17-player merge
  at N = 4 (outer 1 x 2): ``tn`` and every ``PointLite`` leaf in order
  (``leaf_000`` ...), for ``tests/test_torch_uni17.py``.

``test_torch_hetero.py``, ``test_torch_ibr.py`` and
``test_torch_cones.py`` check that the files still match the JAX package,
but for ``ibr_quad2_N6.npz`` (``test_torch_ibr.py`` holds the port to it;
the JAX package's IBR on the quadrotor takes too long to trace for a
tier-1 test).
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
OUT = os.path.join(HERE, "golden_torch")
IBR_ITER = 10


def hetero_solution():
    """The dense-oracle solve of ``test_hetero._prob`` (f64)."""
    import algames_tpu as ag
    from test_hetero import _prob
    prob, _ = _prob()
    res = ag.newton_solve_jit(prob, method="dense")
    it = int(res.stats.iter)
    out = {"x": np.asarray(res.traj.x), "u": np.asarray(res.traj.u),
           "iter": np.asarray(it)}
    for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio"):
        out[k] = np.asarray(getattr(res.stats, k)[it - 1])
    return out


def ibr_solution():
    """The flagship's f64 IBR solve through ``schur``."""
    import jax
    import jax.numpy as jnp
    from algames_tpu.presets import flagship_unicycle
    from algames_tpu.problem.ibr import ibr_newton_solve
    from algames_tpu.problem.options import IBROptions
    prob, _ = flagship_unicycle(dtype=jnp.float64, outer=3, inner=8)
    res = jax.jit(lambda pr: ibr_newton_solve(
        pr, IBROptions(ibr_iter=IBR_ITER), method="schur"))(prob)
    it = int(res.stats.iter)
    return {"x": np.asarray(res.traj.x), "u": np.asarray(res.traj.u),
            "iter": np.asarray(it),
            "q": np.asarray(int(res.stats.outer[it - 1])),
            "res": np.asarray(res.stats.res[it - 1])}


def ring3_eq_problem(dtype=None, N=20, outer=7, inner=20):
    """``ring3_eq_N{N}``: the flagship with player 0 held on a ring road,
    the circle of radius 4 centred at (0, -4) (through its start, tangent
    to its heading), an ``add_circle_constraint`` block turned to
    ``sense="eq"``."""
    import dataclasses
    import jax.numpy as jnp
    import algames_tpu as ag
    from algames_tpu.presets import flagship_unicycle
    dtype = jnp.float64 if dtype is None else dtype
    prob, spec = flagship_unicycle(dtype=dtype, N=N, outer=outer,
                                   inner=inner)
    gc = ag.add_circle_constraint(spec, prob.gc, [0.0], [-4.0], [4.0], i=0)
    ring = dataclasses.replace(gc.state_blocks[-1], sense="eq")
    gc = dataclasses.replace(gc, state_blocks=gc.state_blocks[:-1] + (ring,))
    gc = ag.set_constraint_params(gc, prob.opts)
    return dataclasses.replace(prob, gc=gc), spec


def ring3_eq_solution():
    """The f64 solve of ``ring3_eq_N20``."""
    import algames_tpu as ag
    prob, _ = ring3_eq_problem()
    res = ag.newton_solve_jit(prob)
    it = int(res.stats.iter)
    out = {"x": np.asarray(res.traj.x), "u": np.asarray(res.traj.u),
           "iter": np.asarray(it)}
    for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio"):
        out[k] = np.asarray(getattr(res.stats, k)[it - 1])
    return out


def ibr_quad_problem(N=6, outer=2, inner=4):
    """``presets.quadrotor3d`` (p=2, f64) at horizon N and budget outer x
    inner."""
    import jax.numpy as jnp
    import algames_tpu as ag
    from algames_tpu.constraints.sets import CylinderWall, Wall3D
    from algames_tpu.models.quadrotor import quadrotor_game
    p, dt, dtype = 2, 0.1, jnp.float64
    model = quadrotor_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    hover = 0.5 * 9.81 / 4.0 / model.kf
    obj = ag.game_objective(
        spec, Q=[jnp.asarray([10, 10, 10] + [1] * 9, dtype)] * p,
        R=[0.1 * jnp.ones(4, dtype)] * p,
        xf=[jnp.concatenate([jnp.asarray([1.5, 0.3 * i, 1.0], dtype),
                             jnp.zeros(9, dtype)]) for i in range(p)],
        uf=[jnp.full((4,), hover, dtype)] * p, dtype=dtype)
    gc = ag.game_constraints(spec, dtype=dtype)
    gc = ag.add_spherical_collision_avoidance(spec, gc, 0.1)
    gc = ag.add_wall_constraint(spec, gc, [
        Wall3D([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
               [0.0, 0.0, -1.0])])
    gc = ag.add_wall_constraint(spec, gc, [
        CylinderWall([0.75, 0.15, 0.0], "z", 2.0, 0.2)])
    gc = ag.add_control_bound(spec, gc, 3 * jnp.ones(spec.m, dtype),
                              jnp.zeros(spec.m, dtype))
    x0 = np.zeros(spec.n)
    x0[[spec.pz[i][2] for i in range(p)]] = 1.0
    x0[spec.pz[1][1]] = 0.3
    return ag.game_problem(N, dt, jnp.asarray(x0), model,
                           ag.Options(outer_iter=outer, inner_iter=inner),
                           obj, gc)


def ibr_quad_solution():
    """Two lanes of ``ibr_quad_problem``'s f64 IBR (one round) through
    ``schur``."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from algames_tpu.problem.ibr import ibr_newton_solve
    from algames_tpu.problem.options import IBROptions
    prob = ibr_quad_problem()
    x0s = (np.asarray(prob.x0)[None] + 0.05 * np.random.default_rng(0)
           .standard_normal((2, prob.spec.n)))
    res = jax.jit(jax.vmap(lambda x: ibr_newton_solve(
        dataclasses.replace(prob, x0=x), IBROptions(ibr_iter=1),
        method="schur")))(jnp.asarray(x0s))
    rows = int(np.asarray(res.stats.iter).max())
    return {"x0s": x0s, "x": np.asarray(res.traj.x),
            "u": np.asarray(res.traj.u), "iter": np.asarray(res.stats.iter),
            "outer": np.asarray(res.stats.outer)[:, :rows],
            "res": np.asarray(res.stats.res)[:, :rows]}


def uni9_solution(p=9):
    """The 9-player flagship merge (``flagship_unicycle(p=9)``: n = 36, 72
    collision blocks, outer 7 x inner 20, f64; or with ``p`` players) from
    its own x0 through ``schur``: x0, x, u, ``iter`` and the final
    violations."""
    import algames_tpu as ag
    from algames_tpu.presets import flagship_unicycle
    prob, _ = flagship_unicycle(p=p)
    res = ag.newton_solve_jit(prob, method="schur")
    it = int(res.stats.iter)
    out = {"x0": np.asarray(prob.x0), "x": np.asarray(res.traj.x),
           "u": np.asarray(res.traj.u), "iter": np.asarray(it)}
    for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio"):
        out[k] = np.asarray(getattr(res.stats, k)[it - 1])
    return out


def uni17_trial():
    """The hand-written trial on the 17-player merge's inputs of
    ``test_torch_trial._case`` at N = 4: tn and the PointLite leaves."""
    import jax
    import jax.numpy as jnp
    from algames_tpu.ops.trial_kernel import _trial_eval_handwritten
    from algames_tpu.presets import flagship_unicycle
    from test_torch_trial import _case
    prob, spec = flagship_unicycle(jnp.float64, p=17, N=4, outer=1, inner=2)
    c = _case(prob, spec)
    B = c["jargs"][2].shape[0]
    tn, lite = jax.jit(lambda *a: _trial_eval_handwritten(
        prob.model, spec, prob.obj, c["jgc"], *a, block_lanes=B,
        interpret=True))(*c["jargs"])
    out = {"tn": np.asarray(tn)}
    for k, leaf in enumerate(jax.tree_util.tree_leaves(lite)):
        out[f"leaf_{k:03d}"] = np.asarray(leaf)
    return out


GOLDENS = {"hetero": ("hetero2_N8", hetero_solution),
           "ibr": ("ibr_uni3_N20", ibr_solution),
           "ring3_eq": ("ring3_eq_N20", ring3_eq_solution),
           "ibr_quad": ("ibr_quad2_N6", ibr_quad_solution),
           "uni9": ("uni9_N20", uni9_solution),
           "uni17": ("uni17_N20", lambda: uni9_solution(17)),
           "uni17_trial": ("uni17_trial_N4", uni17_trial)}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(OUT, exist_ok=True)
    for key in sys.argv[1:] or list(GOLDENS):
        name, fn = GOLDENS[key]
        sol = fn()
        np.savez(os.path.join(OUT, f"{name}.npz"), **sol)
        print(name, {k: (v.tolist() if v.ndim == 0 else v.shape)
                     for k, v in sol.items()}, flush=True)
