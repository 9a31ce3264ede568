"""CPU measurements behind the roundabout numbers in PERF.md that no chip run
gives: the reference package's own converged fraction on the sweep's
inputs, the port's agreement with it lane by lane, and the f32 accuracy of
the two column orders of the dense-Q Thomas sweep.  Not a test module
(pytest does not collect it); it imports both packages, as the tests do.

    JAX_PLATFORMS=cpu python tests/roundabout_reference.py subset
    JAX_PLATFORMS=cpu python tests/roundabout_reference.py pivot-order
    JAX_PLATFORMS=cpu python tests/roundabout_reference.py f64 128 203


``subset`` (a few minutes): the first 256 of ``chip_smoke.py``'s 4096
roundabout sweep scenarios (x0 + 0.05 N(0, 1), numpy seed 0), f32, outer 10
x inner 16, through the reference (``schur``) and through the port's plain
versions; prints each converged fraction and the lanes whose iteration
counts differ.  ``chip_smoke.py`` gates the sweep on the reference's
fraction.

``pivot-order`` (about a minute): ``chip_smoke.py``'s K3 systems at B=1024
over the AL penalty, solved in f32 by the plain version with the reduced
system's columns in its own order (x first) and permuted to u first (the
TPU kernel's order), each against the f64 solve.

``f64 LANE ...``: the named subset lanes in f64 through both packages (to
tell rounding from a fault where the f32 iteration counts differ).
"""
import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CPU = torch.device("cpu")
N_SUBSET = 256


def sweep_inputs(x0, n):
    rng = np.random.default_rng(0)
    x0s = np.asarray(x0, np.float64)[None] + 0.05 * rng.standard_normal(
        (4096, n))
    return x0s[:N_SUBSET]


def subset():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from algames_tpu.parallel import batch as jbatch
    from algames_tpu.presets import roundabout as jax_roundabout

    from algames_tpu_torch import parallel
    from algames_tpu_torch.presets import roundabout

    prob, spec = jax_roundabout(dtype=jnp.float32)
    x0s = sweep_inputs(prob.x0, spec.n)
    out = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s, jnp.float32))
    it_ref = np.asarray(out.stats.iter)
    last = np.maximum(it_ref - 1, 0)
    s, o = out.stats, prob.opts

    def final(col):
        return np.asarray(col)[np.arange(N_SUBSET), last]
    conv_ref = ((final(s.dyn_vio) < o.eps_dyn) & (final(s.con_vio) < o.eps_con)
                & (final(s.sta_vio) < o.eps_sta)
                & (final(s.opt_vio) < o.eps_opt))
    print(f"reference: converged {conv_ref.mean()} "
          f"({int(conv_ref.sum())}/{N_SUBSET}), diverged "
          f"{float(np.asarray(jbatch.divergence_mask(out)).mean())}, "
          f"unconverged lanes {np.nonzero(~conv_ref)[0].tolist()}",
          flush=True)

    tprob, _ = roundabout(CPU, torch.float32)
    tprob = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, ls_fused=True))
    tout = parallel.solve_many(
        tprob, torch.as_tensor(x0s, dtype=torch.float32), method="thomas",
        chunk=N_SUBSET)
    it = tout.stats.iter.numpy()
    diff = np.nonzero(it != it_ref)[0]
    print(f"port (plain versions): converged "
          f"{float(parallel.convergence_fraction(tout, tprob.opts))}, "
          f"diverged {float(parallel.divergence_mask(tout).float().mean())}; "
          f"iteration counts equal on {N_SUBSET - len(diff)} of {N_SUBSET}; "
          f"differing lanes (port, reference): "
          f"{[(int(k), int(it[k]), int(it_ref[k])) for k in diff]}")


def f64_lanes(lanes):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from algames_tpu.parallel import batch as jbatch
    from algames_tpu.presets import roundabout as jax_roundabout

    import algames_tpu_torch as agt
    from algames_tpu_torch.convert import problem_from_reference

    prob, spec = jax_roundabout(dtype=jnp.float64)
    x0s = sweep_inputs(prob.x0, spec.n)[lanes]
    ref = jax.jit(lambda x: jbatch.solve_batch(prob, x, method="schur"))(
        jnp.asarray(x0s))
    tprob = problem_from_reference(prob, CPU, torch.float64)
    tprob = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, ls_fused=True))
    out = agt.parallel.solve_batch(tprob, torch.as_tensor(x0s))
    dx = np.abs(out.traj.x.numpy() - np.asarray(ref.traj.x)).max()
    print(f"f64 lanes {lanes}: iterations reference "
          f"{np.asarray(ref.stats.iter).tolist()}, port "
          f"{out.stats.iter.tolist()}; max |x - x_ref| {dx:.3e}")


def pivot_order():
    import chip_smoke as cs
    from algames_tpu_torch.ops.thomas import solve_thomas_plain
    from algames_tpu_torch.utils import tree_map

    solve_ex = torch.linalg.solve_ex

    def u_first(n, m):
        perm = list(range(n, n + m)) + list(range(n))
        inv = [perm.index(i) for i in range(n + m)]

        def solve(K, RHS):
            sol, info = solve_ex(K[..., perm], RHS)
            return sol[..., inv, :], info
        return solve

    for i, mu in enumerate(cs.MUS):
        spec, jb, b = cs.k3_system(CPU, 1024, mu, 100 + i)
        ref = solve_thomas_plain(spec, jb, b)
        jb32, b32 = tree_map(lambda a: a.float(), jb), b.float()
        e_x = cs.rel_err(solve_thomas_plain(spec, jb32, b32), ref)
        torch.linalg.solve_ex = u_first(spec.n, spec.m)
        try:
            e_u = cs.rel_err(solve_thomas_plain(spec, jb32, b32), ref)
        finally:
            torch.linalg.solve_ex = solve_ex
        print(f"mu={mu:.0e}: f32 against f64, worst / median lane: x first "
              f"{float(e_x.max()):.3e} / {float(e_x.median()):.3e}; u first "
              f"{float(e_u.max()):.3e} / {float(e_u.median()):.3e}",
              flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    if sys.argv[1] == "f64":
        f64_lanes([int(k) for k in sys.argv[2:]])
    else:
        {"subset": subset, "pivot-order": pivot_order}[sys.argv[1]]()
