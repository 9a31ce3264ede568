"""The ring road's f32 sweep, path by path: which of K1 and K4 makes the
kernel path end feasible on more lanes than the plain versions.  Not a
test module (pytest does not collect it).

    python3 tests/ring_eq_paths.py [LANES] [cpu]

The first LANES (default 256) of ``chip_smoke.py``'s ``sweep-eq`` starts
(x0 + 0.05 N(0, 1), numpy seed 0, player 0 put back on the ring) of
``ring3_eq_N20`` at outer 7 x 20, solved as one batch through the plain
versions in f64 (``ops.thomas.kkt_solve_plain`` and the eager trial: the
lanes' outcome without f32 rounding), then in f32 through K1 + K4
(``"thomas"`` with ``ls_fused``, the sweep's path), K1 + the eager trial,
the plain KKT solve + K4, and both plain.  For each path: the feasible
share (the dyn, con and sta gates), the lanes whose feasibility agrees with
the f64 run's, the stats rows, the worst final |x - x_f64| on the lanes
feasible in both, and the kernels launched.  With ``cpu`` every path runs
on the CPU, where K1 and K4 are their plain versions: only the plain
paths are distinct there.
"""
import dataclasses
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(lanes=256, dev=torch.device("cuda:0")):
    import chip_smoke as cs
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (kkt_solve_plain,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        cs.phase_build()
    prob32, spec = cs.ring3_eq_game(dev, torch.float32)
    prob64, _ = cs.ring3_eq_game(dev, torch.float64)
    rng = np.random.default_rng(0)
    x0s = cs.onto_ring(np.asarray(prob32.x0.cpu(), np.float64)[None]
                       + 0.05 * rng.standard_normal((cs.N_SWEEP, spec.n)),
                       spec.p)[:lanes]
    feas_opts = dataclasses.replace(prob32.opts, eps_opt=float("inf"))
    counters = (solve_thomas_structured, trial_eval)

    def run(prob, dtype, method, fused):
        prob = dataclasses.replace(prob, opts=dataclasses.replace(
            prob.opts, ls_fused=fused))
        before = [c.launches for c in counters]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = parallel.solve_batch(
            prob, torch.as_tensor(x0s, dtype=dtype, device=dev), method=method)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ran = [c.launches - b for c, b in zip(counters, before)]
        return out, time.perf_counter() - t0, ran

    ref, el, _ = run(prob64, torch.float64, kkt_solve_plain, False)
    ok64 = parallel.convergence_mask(ref, feas_opts)
    print(f"ring3_eq_N20, {lanes} lanes, f64 plain KKT + eager trial: "
          f"feasible {float(ok64.float().mean()):.4f} "
          f"({int(ok64.sum())}/{lanes}), stats rows "
          f"{int(ref.stats.iter.min())}..{int(ref.stats.iter.max())}, "
          f"{el:.1f} s", flush=True)
    paths = [("K1 + K4", "thomas", True), ("K1 + eager trial", "thomas", False),
             ("plain KKT + K4", kkt_solve_plain, True),
             ("plain KKT + eager trial", kkt_solve_plain, False)]
    for label, method, fused in paths:
        out, el, ran = run(prob32, torch.float32, method, fused)
        ok = parallel.convergence_mask(out, feas_opts)
        both = ok & ok64
        dx = ((out.traj.x.double() - ref.traj.x).abs().flatten(1).amax(1)
              [both].max()) if bool(both.any()) else float("nan")
        print(f"f32 {label}: feasible {float(ok.float().mean()):.4f} "
              f"({int(ok.sum())}/{lanes}); feasibility as in f64 on "
              f"{int((ok == ok64).sum())}/{lanes} (feasible only in f32 "
              f"{int((ok & ~ok64).sum())}, only in f64 "
              f"{int((~ok & ok64).sum())}); stats rows "
              f"{int(out.stats.iter.min())}..{int(out.stats.iter.max())} "
              f"(mean {float(out.stats.iter.double().mean()):.2f}); worst "
              f"|x - x_f64| on lanes feasible in both {float(dx):.3e}; "
              f"launches K1 {ran[0]}, K4 {ran[1]}; {el:.1f} s", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    cpu = "cpu" in args
    if cpu:
        torch.set_num_threads(4)
    main(int(next((a for a in args if a.isdigit()), 256)),
         torch.device("cpu") if cpu else torch.device("cuda:0"))
