"""One sweep chunk of the flagship and of the roundabout through a source
tree, on one CUDA card: the solver loop's rate, for comparing two commits
in one call.  Not a test module (pytest does not collect it).

    python3 tests/sweep_compare.py TREE LABEL [REPS [REPS4]]

Imports ``chip_smoke.py`` and the port from TREE (a checkout, e.g.
``git archive`` of another commit unpacked in a git-ignored directory),
builds its kernels, and solves the first 1024 of ``chip_smoke.py``'s f32
sweep starts (x0 + 0.05 N(0, 1), numpy seed 0, ``ls_fused``) as one chunk:
the flagship at outer 3 x 8 (K1 + K2) REPS times (default 3) and the
roundabout at its preset budget (K3 + K4) REPS4 times (default 1), each
after an untimed warm-up.  Prints each run's wall time (card
synchronised) and solves/s, the stats rows summed over lanes and the
converged fraction, so that a change in the work done is told from a
change in the rate.  Run each tree
in its own process, parent / change / change / parent: the trees' packages
share a name.
"""
import dataclasses
import sys
import time
from pathlib import Path

import torch


def main(tree, label, reps=3, reps4=1):
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from algames_tpu_torch import parallel
    from algames_tpu_torch.presets import flagship_unicycle, roundabout
    if Path(cs.__file__).resolve().parent != tree:
        raise SystemExit(f"chip_smoke.py was not imported from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cs.phase_build()
    for name, preset, budget, n in (
            ("flagship", flagship_unicycle, {"outer": 3, "inner": 8}, reps),
            ("roundabout", roundabout, {}, reps4)):
        prob, x0s = cs.sweep_problem(preset, dev, **budget)
        x0s = x0s[:cs.CHUNK]
        parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
            prob.opts, outer_iter=1, inner_iter=2)), x0s[:64])   # warm-up
        for r in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = parallel.solve_batch(prob, x0s)
            torch.cuda.synchronize()
            el = time.perf_counter() - t0
            print(f"[{label}] {name} chunk of {x0s.shape[0]}, run {r}: "
                  f"{el:.4f} s, {x0s.shape[0] / el:.1f} solves/s, stats rows "
                  f"{int(out.stats.iter.sum())}, converged "
                  f"{float(parallel.convergence_fraction(out, prob.opts)):.4f}",
                  flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve(), sys.argv[2],
         *(int(a) for a in sys.argv[3:5]))
