"""CPU measurements behind the sweep gates of ``chip_smoke.py`` for the
double-integrator, bicycle, quadrotor and heterogeneous double-integrator
games and for the iterative-best-response sweep: the reference package's
own converged fraction (or IBR stopping share and final residual) on the
sweep's inputs and the port's agreement with it lane by lane.  Not a test
module (pytest does not collect it); it imports both packages, as the tests
do.

    JAX_PLATFORMS=cpu python tests/reference_fractions.py subset [KEY[@N] ...]
    JAX_PLATFORMS=cpu python tests/reference_fractions.py full [KEY[@A:B] ...]
    JAX_PLATFORMS=cpu python tests/reference_fractions.py f64 KEY LANE ...
    JAX_PLATFORMS=cpu python tests/reference_fractions.py ibr
    JAX_PLATFORMS=cpu python tests/reference_fractions.py ibr-quad
    JAX_PLATFORMS=cpu python tests/reference_fractions.py mpc
    JAX_PLATFORMS=cpu python tests/reference_fractions.py nullspace

``subset`` (minutes per game): the first 256 (or N) of
``chip_smoke.py``'s 4096 sweep scenarios of each game (x0 + 0.05 N(0, 1),
numpy seed 0), f32 at the
preset budget, through the reference (``schur``) and through the port's
plain versions with the fused trial; prints each converged and diverged
fraction under the sweep's gates (dyn, con, sta 1e-3; opt 1e-2, or 5e-2 for
the quadrotor, whose thrust clamp holds stationarity near 3e-2), the
feasible share (the dyn, con and sta gates alone), the iteration counts,
and the lanes whose counts differ.  KEY is one of
di2_N10, bike3_N20, quad2_N15 (default: all three), hetero2_N8 (the
heterogeneous game of ``tests/test_hetero.py`` at outer 7 x 20, as
``chip_smoke.py`` builds it) ring3_eq_N20 (the flagship at outer 7 x
20 with player 0 on a ring road, an equality block:
``tests/torch_goldens.py::ring3_eq_problem``; its starts put player 0
back on the ring, ``chip_smoke.py::onto_ring``) and quad4_N15 (the
quadrotor preset with 4 players at outer 2 x inner 5, ``jax_quadrotor``,
as ``chip_smoke.py``'s ``sweep-quad4`` runs it; about five minutes) and
uni9_N20 (the flagship merge with 9 players, ``flagship_unicycle(p=9)``
at outer 3 x inner 8, as ``chip_smoke.py``'s ``sweep-uni9`` runs it) and
uni17_N20 (the same with 17 players, ``sweep-uni17``'s).  Each
also prints the mean over lanes of the final residual norm.

``full``: the reference alone over all 4096 sweep scenarios (or lanes A
to B of them), in chunks of 256, printing the running converged and
diverged counts; its final fraction is the sweep gate's reference.  KEY
may also be round4_N40.  Tens of minutes for di2 and bike3; over half an
hour per 256 lanes for the quadrotor and the roundabout, and far longer
when several JAX processes share the CPU's cores.  Where many lanes sit
near the gates, f32 rounding flips a few per cent of them between two
implementations, so a fraction over 256 lanes is a coarse reference (one
lane is 0.004 of it).

``f64 KEY LANE ...``: the named subset lanes in f64 through both packages
(to tell rounding from a fault where the f32 iteration counts differ).

``ibr``: iterative best response on the flagship as ``chip_smoke.py``'s
IBR sweep runs it (outer 3 x inner 8 per player solve, ``ibr_iter=10``, f32)
on the first 128 of its 512 scenarios, through the reference
(``method="schur"``) and the port's plain versions: the share of lanes
whose Gauss-Seidel loop stopped before ``ibr_iter`` rounds and the mean
final residual (the quantity of ``benchmarks/bench_ibr.py``).
``ibr-quad``: the same on the quadrotor preset (p=2, N=15) as
``chip_smoke.py``'s ``sweep-ibr-quad2`` runs it: its 128 scenarios
(x0 + 0.05 N(0, 1), numpy seed 0), outer 3 x 8 per player solve,
``ibr_iter=1``, f32.  About three minutes.

``mpc``: receding-horizon MPC on the highway of
``benchmarks/bench_mpc.py::make_problem`` (BASELINE config 3) as
``chip_smoke.py``'s ``mpc`` phase runs it: f32, 30 replans, from the
problem's start and from 32 starts x0 + 0.05 N(0, 1) (numpy seed 0).  The
reference's ``mpc_solve`` vmapped (``method="schur"``), and the same loop
replan by replan (jitted, vmapped ``newton_solve`` with the shifted warm
start and the carried duals, as ``mpc_solve`` does it, to read each
replan's four final violations, which ``MPCResult`` does not keep); then
the port's ``mpc_solve`` through its plain versions.  Prints the share of
replans whose final violations meet all four gates (the ``mpc`` phase's
gate), the minimum executed pairwise distance and the largest applied
|u|.  A few minutes.

``nullspace``: the nullspace dimensions behind ``chip_smoke.py``'s
``nullspace`` phase (``REF_NULLSPACE``).  The game of
``examples/nullspace_example.py`` (``crossing_problem``: p=3, N=20,
r=0.25, crossing targets, ``Options()``), f64, from its start and 7
starts perturbed by 0.01 N(0, 1) (numpy seed 0), solved through
``"tridiag"`` by both packages (stats rows compared); per lane the
reference's ``update_nullspace`` dimension and ``update_nullspace_masked``
dimension, and the port's.  Then ``update_nullspace_masked`` at the
roundabout's scale (p=4, N=40, r=0.5, the zero trajectory) in both.  A
few minutes.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
CPU = torch.device("cpu")
N_SUBSET = 256
N_SWEEP = 4096
KEYS = ("di2_N10", "bike3_N20", "quad2_N15")
OPT_GATE = {"quad2_N15": 5e-2, "quad4_N15": 5e-2}
N_IBR, IBR_LANES, IBR_ITER = 512, 128, 10
# Per IBR game: its key, the scenarios drawn, the lanes measured, the
# rounds.
IBR_GAMES = {"ibr": ("uni3_N20", N_IBR, IBR_LANES, IBR_ITER),
             "ibr-quad": ("quad2_N15", 128, 128, 1)}


def jax_quadrotor(p, dtype, N=15, outer=2, inner=5):
    """The reference package's quadrotor preset (``quadrotor3d``) with ``p``
    players, as the port's ``presets.quadrotor3d(p=p)`` builds it: the same
    costs, blocks and thrust bounds, player i starting at y = 0.3 i; outer
    2 x inner 5 as ``chip_smoke.py``'s ``quad4_game``."""
    import jax.numpy as jnp
    import algames_tpu as ag
    from algames_tpu.presets import _default_eps_opt
    model = ag.quadrotor_game(p=p)
    spec = ag.spec_from_model(model, N, 0.1)
    hover = 0.5 * 9.81 / 4.0 / model.kf
    obj = ag.game_objective(
        spec,
        Q=[jnp.asarray([10, 10, 10, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype)] * p,
        R=[0.1 * jnp.ones(4, dtype)] * p,
        xf=[jnp.concatenate([jnp.asarray([1.5, 0.3 * i, 1.0], dtype),
                             jnp.zeros(9, dtype)]) for i in range(p)],
        uf=[jnp.full((4,), hover, dtype)] * p, dtype=dtype)
    gc = ag.game_constraints(spec, dtype=dtype)
    gc = ag.add_spherical_collision_avoidance(spec, gc, 0.1)
    gc = ag.add_wall_constraint(spec, gc, [
        ag.Wall3D([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
                  [0.0, 0.0, -1.0])])
    gc = ag.add_wall_constraint(spec, gc, [
        ag.CylinderWall([0.75, 0.15, 0.0], "z", 2.0, 0.2)])
    gc = ag.add_control_bound(spec, gc, 3 * jnp.ones(spec.m, dtype),
                              jnp.zeros(spec.m, dtype))
    x0 = np.zeros(spec.n)
    x0[[spec.pz[i][2] for i in range(p)]] = 1.0
    x0[[spec.pz[i][1] for i in range(p)]] = 0.3 * np.arange(p)
    opts = ag.Options(outer_iter=outer, inner_iter=inner,
                      eps_opt=_default_eps_opt(dtype, None))
    return ag.game_problem(N, 0.1, jnp.asarray(x0, dtype), model, opts, obj,
                           gc), spec


def jax_problem(key, dtype):
    """The reference package's problem of ``key``: a preset, the ring-road
    game, the 4-player quadrotor (``jax_quadrotor``), or the heterogeneous
    game (``tests/test_hetero.py``'s, with the f32 gates of the presets)."""
    import jax.numpy as jnp
    from algames_tpu.presets import PRESETS as JAX_PRESETS
    if key == "quad4_N15":
        return jax_quadrotor(4, dtype)
    if key in ("uni9_N20", "uni17_N20"):
        from algames_tpu.presets import flagship_unicycle
        return flagship_unicycle(dtype, p=int(key[3:-4]), outer=3, inner=8)
    if key == "ring3_eq_N20":
        from torch_goldens import ring3_eq_problem
        return ring3_eq_problem(dtype)
    if key != "hetero2_N8":
        return JAX_PRESETS[key](dtype=dtype)
    import algames_tpu as ag
    model = ag.hetero_double_integrator_game(mi=(2, 1))
    N, p = 8, 2
    spec = ag.spec_from_model(model, N, 0.1)
    obj = ag.game_objective(
        spec, Q=[jnp.ones(4, dtype)] * p,
        R=[0.1 * jnp.ones(k, dtype) for k in spec.mi],
        xf=[jnp.asarray([1.0, 0.4 * (p - 1 - i), 0.0, 0.0], dtype)
            for i in range(p)],
        uf=[jnp.zeros(k, dtype) for k in spec.mi], dtype=dtype)
    gc = ag.add_collision_avoidance(
        spec, ag.game_constraints(spec, dtype=dtype), 0.15)
    gc = ag.add_control_bound(spec, gc, 2 * jnp.ones(spec.m, dtype),
                              -2 * jnp.ones(spec.m, dtype))
    x0 = jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0], dtype)
    opts = ag.Options(outer_iter=7, inner_iter=20,
                      eps_opt=1e-2 if dtype == jnp.float32 else 1e-3)
    return ag.game_problem(N, 0.1, x0, model, opts, obj, gc), spec


def port_problem(key, prob, dtype):
    """The port's problem of ``key`` on the CPU: its preset, or the
    reference's heterogeneous or ring-road game carried over."""
    from algames_tpu_torch.convert import problem_from_reference
    from algames_tpu_torch.presets import PRESETS, quadrotor3d
    if key == "quad4_N15":
        return quadrotor3d(CPU, dtype, outer=2, inner=5, p=4)[0]
    if key in ("uni9_N20", "uni17_N20"):
        from algames_tpu_torch.presets import flagship_unicycle
        return flagship_unicycle(CPU, dtype, outer=3, inner=8,
                                 p=int(key[3:-4]))[0]
    if key in ("hetero2_N8", "ring3_eq_N20"):
        return problem_from_reference(prob, CPU, dtype)
    return PRESETS[key](CPU, dtype)[0]


def sweep_inputs(x0, n, lanes=N_SUBSET, key=None):
    rng = np.random.default_rng(0)
    x0s = np.asarray(x0, np.float64)[None] + 0.05 * rng.standard_normal(
        (N_SWEEP, n))
    if key == "ring3_eq_N20":
        from chip_smoke import onto_ring
        x0s = onto_ring(x0s, 3)
    return x0s[:lanes]


def final_mean(it, col):
    """The mean over lanes of a stats column's last record."""
    last = np.maximum(np.asarray(it) - 1, 0)
    return float(np.asarray(col)[np.arange(len(last)), last].mean())


def converged(key, opts, it, dyn, con, sta, opt):
    """Lanes whose final record meets the sweep's gates."""
    last = np.maximum(np.asarray(it) - 1, 0)

    def final(col):
        return np.asarray(col)[np.arange(len(last)), last]
    return ((final(dyn) < opts.eps_dyn) & (final(con) < opts.eps_con)
            & (final(sta) < opts.eps_sta)
            & (final(opt) < OPT_GATE.get(key, opts.eps_opt)))


def subset(keys):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from algames_tpu.parallel import batch as jbatch

    from algames_tpu_torch import parallel

    for arg in keys:
        key, _, lanes = arg.partition("@")
        lanes = int(lanes or N_SUBSET)
        prob, spec = jax_problem(key, jnp.float32)
        x0s = sweep_inputs(prob.x0, spec.n, lanes, key=key)
        out = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
            jnp.asarray(x0s, jnp.float32))
        s = out.stats
        it_ref = np.asarray(s.iter)
        conv_ref = converged(key, prob.opts, it_ref, s.dyn_vio, s.con_vio,
                             s.sta_vio, s.opt_vio)
        feas_ref = converged(key, prob.opts, it_ref, s.dyn_vio, s.con_vio,
                             s.sta_vio, np.zeros_like(s.opt_vio))
        print(f"{key} reference: converged {conv_ref.mean()} "
              f"({int(conv_ref.sum())}/{lanes}), feasible (dyn, con, sta "
              f"gates) {int(feas_ref.sum())}/{lanes}, diverged "
              f"{float(np.asarray(jbatch.divergence_mask(out)).mean())}, "
              f"unconverged lanes {np.nonzero(~conv_ref)[0].tolist()}, "
              f"iterations {it_ref.min()}..{it_ref.max()} (mean "
              f"{it_ref.mean():.2f}), mean final residual "
              f"{final_mean(it_ref, s.res)!r}", flush=True)

        tprob = port_problem(key, prob, torch.float32)
        tprob = dataclasses.replace(tprob, opts=dataclasses.replace(
            tprob.opts, ls_fused=True))
        tout = parallel.solve_many(
            tprob, torch.as_tensor(x0s, dtype=torch.float32),
            method="thomas", chunk=lanes)
        t = tout.stats
        it = t.iter.numpy()
        conv = converged(key, tprob.opts, it, t.dyn_vio.numpy(),
                         t.con_vio.numpy(), t.sta_vio.numpy(),
                         t.opt_vio.numpy())
        feas = converged(key, tprob.opts, it, t.dyn_vio.numpy(),
                         t.con_vio.numpy(), t.sta_vio.numpy(),
                         np.zeros_like(t.opt_vio.numpy()))
        diff = np.nonzero(it != it_ref)[0]
        print(f"{key} port (plain versions): converged {conv.mean()} "
              f"({int(conv.sum())}/{lanes}), feasible {int(feas.sum())}/"
              f"{lanes}, diverged "
              f"{float(parallel.divergence_mask(tout).float().mean())}, "
              f"unconverged lanes {np.nonzero(~conv)[0].tolist()}, mean "
              f"final residual {final_mean(it, t.res.numpy())!r}; "
              f"iteration counts equal on {lanes - len(diff)} of "
              f"{lanes}; differing lanes (port, reference): "
              f"{[(int(k), int(it[k]), int(it_ref[k])) for k in diff]}",
              flush=True)


def full(keys):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from algames_tpu.parallel import batch as jbatch

    for arg in keys:
        key, _, lanes = arg.partition("@")
        a, b = map(int, lanes.split(":")) if lanes else (0, N_SWEEP)
        prob, spec = jax_problem(key, jnp.float32)
        x0s = sweep_inputs(prob.x0, spec.n, N_SWEEP, key)
        solve = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))
        conv = div = 0
        for s in range(a, b, N_SUBSET):
            out = solve(jnp.asarray(x0s[s:s + N_SUBSET], jnp.float32))
            st = out.stats
            conv += int(converged(key, prob.opts, np.asarray(st.iter),
                                  st.dyn_vio, st.con_vio, st.sta_vio,
                                  st.opt_vio).sum())
            div += int(np.asarray(jbatch.divergence_mask(out)).sum())
            n = s + N_SUBSET - a
            print(f"{key} reference, lanes {a}..{s + N_SUBSET}: converged "
                  f"{conv}/{n} = {conv / n}, diverged {div}", flush=True)


def f64_lanes(key, lanes):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from algames_tpu.parallel import batch as jbatch

    import algames_tpu_torch as agt
    from algames_tpu_torch.convert import problem_from_reference

    prob, spec = jax_problem(key, jnp.float64)
    x0s = sweep_inputs(prob.x0, spec.n, key=key)[lanes]
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s))
    tprob = problem_from_reference(prob, CPU, torch.float64)
    tprob = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, ls_fused=True))
    out = agt.parallel.solve_batch(tprob, torch.as_tensor(x0s))
    dx = np.abs(out.traj.x.numpy() - np.asarray(ref.traj.x)).max()
    print(f"{key} f64 lanes {lanes}: iterations reference "
          f"{np.asarray(ref.stats.iter).tolist()}, port "
          f"{out.stats.iter.tolist()}; max |x - x_ref| {dx:.3e}")


def ibr(mode="ibr"):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from algames_tpu.presets import PRESETS as JAX_PRESETS
    from algames_tpu.problem.ibr import ibr_newton_solve
    from algames_tpu.problem.options import IBROptions

    import algames_tpu_torch as agt
    from algames_tpu_torch.presets import PRESETS

    key, draws, lanes, rounds = IBR_GAMES[mode]
    prob, spec = JAX_PRESETS[key](dtype=jnp.float32, outer=3, inner=8)
    rng = np.random.default_rng(0)
    x0s = (np.asarray(prob.x0, np.float64)[None]
           + 0.05 * rng.standard_normal((draws, spec.n)))[:lanes]

    def one(x0):
        return ibr_newton_solve(dataclasses.replace(prob, x0=x0),
                                IBROptions(ibr_iter=rounds),
                                method="schur")
    out = jax.jit(jax.vmap(one))(jnp.asarray(x0s, jnp.float32))
    tprob, _ = PRESETS[key](CPU, torch.float32, outer=3, inner=8)
    tout = agt.ibr_newton_solve(tprob, agt.IBROptions(ibr_iter=rounds),
                                x0s=torch.as_tensor(x0s, dtype=torch.float32))
    rows = {}
    for name, it, q, res in (
            ("reference", np.asarray(out.stats.iter), out.stats.outer,
             out.stats.res),
            ("port (plain versions)", tout.stats.iter.numpy(),
             tout.stats.outer.numpy(), tout.stats.res.numpy())):
        last = np.arange(lanes), it - 1
        q_fin = np.asarray(q)[last]
        res_fin = np.asarray(res, np.float64)[last]
        rows[name] = it
        print(f"ibr_{key} {name}: stopped before {rounds} rounds "
              f"{float((q_fin < rounds).mean())} "
              f"({int((q_fin < rounds).sum())}/{lanes}), mean final "
              f"residual {float(res_fin.mean())}, finite "
              f"{bool(np.isfinite(res_fin).all())}, rounds "
              f"{np.bincount(q_fin, minlength=rounds + 1).tolist()}",
              flush=True)
    it_ref, it = rows["reference"], rows["port (plain versions)"]
    print(f"ibr_{key}: stats rows equal on {int((it == it_ref).sum())} of "
          f"{lanes} lanes", flush=True)


def load_bench_mpc():
    """``benchmarks/bench_mpc.py`` as a module, without its cache set-up."""
    import importlib.util
    os.environ["PLATFORM"] = "cpu"
    spec = importlib.util.spec_from_file_location(
        "bench_mpc", os.path.join(REPO, "benchmarks", "bench_mpc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def closed_loop_numbers(px, X, U, V, eps):
    """(share of replans meeting the four gates, min pairwise executed
    distance, max |u|) of states X [B, H+1, n], controls U [B, H, m] and
    final violations V [B, H, 4]."""
    X = np.asarray(X, np.float64)
    dmin = min(float(np.linalg.norm(X[:, :, px[a]] - X[:, :, px[b]],
                                    axis=-1).min())
               for a in range(len(px)) for b in range(a + 1, len(px)))
    return (float((np.asarray(V) < eps).all(axis=-1).mean()), dmin,
            float(np.abs(np.asarray(U, np.float64)).max()))


def mpc(H=30, B=32):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import algames_tpu as ag
    from algames_tpu.models.integration import rk3_step
    from algames_tpu.mpc import mpc_solve

    import algames_tpu_torch.mpc as tmpc
    from algames_tpu_torch.convert import problem_from_reference

    prob, spec, model = load_bench_mpc().make_problem(ag, jnp.float32)
    opts = prob.opts
    eps = np.asarray([opts.eps_dyn, opts.eps_con, opts.eps_sta, opts.eps_opt])
    px = [list(ix) for ix in spec.px]
    x0 = np.asarray(prob.x0, np.float64)
    starts = {32: x0[None] + 0.05 * np.random.default_rng(0)
              .standard_normal((B, spec.n)), 1: x0[None]}

    def vio(out):
        it = jnp.maximum(out.stats.iter - 1, 0)
        return jnp.stack([out.stats.dyn_vio[it], out.stats.con_vio[it],
                          out.stats.sta_vio[it], out.stats.opt_vio[it]])

    def plant(x, u):
        for _ in range(opts.upsampling):
            x = rk3_step(model, x, u, spec.dt / opts.upsampling)
        return x

    def replan(x, warm, gc):
        out = ag.newton_solve(dataclasses.replace(prob, x0=x, gc=gc),
                              method="schur", warm=warm)
        return (plant(x, out.traj.u[0]), out.traj, ag.reset_penalties(out.gc),
                vio(out), out.traj.u[0], out.stats.iter)

    first = jax.jit(jax.vmap(lambda x: replan(x, None, prob.gc)))
    later = jax.jit(jax.vmap(replan))
    loop = jax.jit(jax.vmap(lambda x: mpc_solve(
        dataclasses.replace(prob, x0=x), horizon=H, method="schur")))
    tprob = problem_from_reference(prob, CPU, torch.float32)
    for nb in (B, 1):
        xs = jnp.asarray(starts[nb], jnp.float32)
        ref = loop(xs)
        ref_share = float(((np.asarray(ref.dyn_vio) < opts.eps_dyn)
                           & (np.asarray(ref.opt_vio) < opts.eps_opt)).mean())
        X, U, V, it = [np.asarray(xs)], [], [], []
        x, warm, gc = xs, None, None
        for h in range(H):
            x, warm, gc, v, u, n_it = (first(x) if h == 0
                                       else later(x, warm, gc))
            X.append(np.asarray(x))
            U.append(np.asarray(u))
            V.append(np.asarray(v))
            it.append(np.asarray(n_it))
        X, U, V = (np.stack(a, axis=1) for a in (X, U, V))
        it = np.stack(it, axis=1)
        share, dmin, umax = closed_loop_numbers(px, X, U, V, eps)
        print(f"highway_mpc reference, {nb} scenario(s), H={H}: mpc_solve "
              f"stats rows {int(np.asarray(ref.iters).min())}.."
              f"{int(np.asarray(ref.iters).max())} (mean "
              f"{float(np.asarray(ref.iters).mean()):.3f}), replans meeting "
              f"the dyn and opt gates {ref_share}; replan by replan: stats "
              f"rows equal to mpc_solve's on "
              f"{int((it == np.asarray(ref.iters)).sum())} of {nb * H}, max "
              f"|x - x_mpc_solve| "
              f"{float(np.abs(X - np.asarray(ref.states)).max()):.3e}; "
              f"replans meeting all four gates {share} "
              f"({int(round(share * nb * H))}/{nb * H}), min pairwise "
              f"distance {dmin}, max |u| {umax}", flush=True)

        solve, vios = tmpc.newton_solve, []

        def recorded(*args, **kw):
            out = solve(*args, **kw)
            vios.append(np.stack([np.asarray(c.gather(
                1, torch.clamp(out.stats.iter.long() - 1, min=0)[:, None])
                [:, 0]) for c in (out.stats.dyn_vio, out.stats.con_vio,
                                  out.stats.sta_vio, out.stats.opt_vio)],
                axis=1))
            return out
        tmpc.newton_solve = recorded
        try:
            tout = tmpc.mpc_solve(tprob, torch.as_tensor(
                starts[nb], dtype=torch.float32), horizon=H)
        finally:
            tmpc.newton_solve = solve
        share_t, dmin_t, umax_t = closed_loop_numbers(
            px, tout.states.numpy(), tout.controls.numpy(),
            np.stack(vios, axis=1), eps)
        it_t = tout.iters.numpy()
        print(f"highway_mpc port (plain versions), {nb} scenario(s): stats "
              f"rows equal to the reference's on {int((it_t == it).sum())} "
              f"of {nb * H}; replans meeting all four gates {share_t} "
              f"({int(round(share_t * nb * H))}/{nb * H}), min pairwise "
              f"distance {dmin_t}, max |u| {umax_t}", flush=True)


def crossing_problem(p=3, N=20, r=0.25, dtype=None):
    """The game of ``examples/nullspace_example.py``: unicycles with
    crossing targets, pairwise collision avoidance of radius ``r``,
    ``Options()``."""
    import jax.numpy as jnp
    import algames_tpu as ag
    dtype = jnp.float64 if dtype is None else dtype
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, 0.1)
    obj = ag.game_objective(
        spec, Q=[jnp.ones(4, dtype)] * p, R=[0.1 * jnp.ones(2, dtype)] * p,
        xf=[jnp.asarray([2.0, 0.4 * (p - 1 - i) - 0.4 * i, 0.0, 0.3], dtype)
            for i in range(p)],
        uf=[jnp.zeros(2, dtype)] * p, dtype=dtype)
    gc = ag.add_collision_avoidance(spec, ag.game_constraints(spec, dtype=dtype),
                                    r)
    x0 = jnp.asarray(np.concatenate([np.zeros(p), 0.4 * np.arange(p),
                                     np.zeros(p), 0.3 * np.ones(p)]), dtype)
    return ag.game_problem(N, 0.1, x0, model, ag.Options(), obj, gc), spec


def nullspace(lanes=8):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import algames_tpu as ag
    from algames_tpu import active_set as jas
    from algames_tpu.parallel import batch as jbatch

    import algames_tpu_torch as agt
    from algames_tpu_torch import active_set as tas
    from algames_tpu_torch.convert import problem_from_reference

    prob, spec = crossing_problem()
    rng = np.random.default_rng(0)
    x0s = np.repeat(np.asarray(prob.x0)[None], lanes, axis=0)
    x0s[1:] += 0.01 * rng.standard_normal((lanes - 1, spec.n))
    out = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="tridiag"))(
        jnp.asarray(x0s))
    it_ref = np.asarray(out.stats.iter)
    dims, mdims = [], []
    for k in range(lanes):
        pk = dataclasses.replace(prob, gc=jax.tree_util.tree_map(
            lambda a: a[k], out.gc))
        tk = jax.tree_util.tree_map(lambda a: a[k], out.traj)
        dims.append(int(jas.update_nullspace(pk, tk).mat.shape[1]))
        mdims.append(int(jax.jit(jas.update_nullspace_masked)(pk, tk).dim))
    print(f"crossing_p3_N20 reference: stats rows {it_ref.tolist()}; "
          f"update_nullspace dimensions {dims}; update_nullspace_masked "
          f"{mdims}", flush=True)

    tprob = problem_from_reference(prob, CPU, torch.float64)
    res = agt.newton_solve(tprob, torch.as_tensor(x0s), method="tridiag")
    it = res.stats.iter.numpy()
    tprob = dataclasses.replace(tprob, gc=res.gc)
    tdims = [int(tas.update_nullspace(tprob, res.traj, lane=k).mat.shape[1])
             for k in range(lanes)]
    masked = tas.update_nullspace_masked(tprob, res.traj)
    tm = masked.dim.tolist()
    dx = float(np.abs(res.traj.x.numpy() - np.asarray(out.traj.x)).max())
    print(f"crossing_p3_N20 port: stats rows equal on "
          f"{int((it == it_ref).sum())} of {lanes}, max |x - x_ref| "
          f"{dx:.3e}; update_nullspace dimensions {tdims}; "
          f"update_nullspace_masked {tm}", flush=True)
    # The masked system's singular values on each side of the host
    # dimension: the kernel's and the next larger.
    s = masked.svals.numpy()
    kern = max(float(s[k, -d]) for k, d in enumerate(tdims))
    nxt = min(float(s[k, -d - 1]) for k, d in enumerate(tdims))
    print(f"crossing_p3_N20 port, masked system: the host dimension's "
          f"smallest singular values <= {kern:.3e}, the next >= {nxt:.3e}; "
          f"update_nullspace_masked at atol 1e-8 "
          f"{tas.update_nullspace_masked(tprob, res.traj, 1e-8).dim.tolist()}",
          flush=True)

    big, bspec = crossing_problem(p=4, N=40, r=0.5)
    z = ag.zero_traj(bspec, jnp.float64)
    ref = int(jax.jit(jas.update_nullspace_masked)(big, z).dim)
    tbig = problem_from_reference(big, CPU, torch.float64)
    tz = agt.PrimalDual(x=torch.zeros((1, bspec.N, bspec.n), dtype=torch.float64),
                        u=torch.zeros((1, bspec.T, bspec.m), dtype=torch.float64),
                        lam=torch.zeros((1, bspec.p, bspec.T, bspec.n),
                                        dtype=torch.float64))
    port = int(tas.update_nullspace_masked(tbig, tz).dim[0])
    print(f"crossing_p4_N40 (zero trajectory, Sh {tas.sizes(bspec)[1]}): "
          f"update_nullspace_masked dimension reference {ref}, port {port}",
          flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    if sys.argv[1] in IBR_GAMES:
        ibr(sys.argv[1])
    elif sys.argv[1] == "mpc":
        mpc()
    elif sys.argv[1] == "nullspace":
        nullspace()
    elif sys.argv[1] == "f64":
        f64_lanes(sys.argv[2], [int(k) for k in sys.argv[3:]])
    elif sys.argv[1] == "full":
        full(sys.argv[2:] or KEYS)
    else:
        subset(sys.argv[2:] or KEYS)
