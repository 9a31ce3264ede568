"""Where the host's time goes in one trip of the 9-player flagship merge's
f32 sweep (``chip_smoke.uni9_sweep_game``: 72 state blocks, outer 3 x 8,
fused trial), on one CUDA card.  Not a test module (pytest does not
collect it).

    python3 tests/uni9_host_profile.py [LANES]

Builds the kernels, warms one short solve, starts ``sweep-uni9``'s first
LANES (default 1024) scenarios, runs two trips, then profiles the third
with ``cProfile`` (the card synchronised before and after, so the trip's
wall holds its device work) and prints the trip's wall and the functions
that hold the most host time, by own time and by cumulative time.
"""
import cProfile
import pstats
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main(lanes):
    import torch
    import chip_smoke as cs
    from algames_tpu_torch import parallel
    from algames_tpu_torch.problem.solver import solve_start, solve_trip
    dev = torch.device("cuda:0")
    cs.phase_build()
    prob, x0s = cs.sweep_problem(cs.uni9_sweep_game, dev)
    x0s = x0s[:lanes]
    parallel.solve_batch(prob, x0s[:64])           # warm
    kkt, w_owner, c = solve_start(prob, x0s)
    for _ in range(2):
        c = solve_trip(prob, kkt, w_owner, c)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    c = solve_trip(prob, kkt, w_owner, c)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    print(f"[uni9-host] one trip (the third) of {lanes} f32 lanes: "
          f"{1e3 * wall:.1f} ms of wall under cProfile", flush=True)
    for key in ("tottime", "cumulative"):
        print(f"[uni9-host] by {key}:", flush=True)
        pstats.Stats(prof, stream=sys.stdout).sort_stats(key).print_stats(25)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
