"""SPIKE, the horizon-split KKT solve (``parallel.spike_kkt_method``), over
ranks on cards of their own, against one rank and the sequential solves,
in one call.  Not a test module (pytest does not collect it).

    python3 tests/spike_scaling.py [RANKS [BACKEND]]     (default: 4 nccl)

Needs RANKS CUDA cards (rank r on card r).  Prints the card's name and
power limit, builds K1, then runs ``chip_smoke.phase_spike`` over 1 rank
and over RANKS ranks on BACKEND: ``benchmarks/bench_spike.py``'s
long-horizon game, f64 at N=257 held to ``"tridiag"`` and ``"thomas"`` on
card 0 (equal stats rows, x within 1e-8), then f32, one scenario, at
N = 65, 257, 1025, each timed after a warm-up, with ``"thomas"`` (K1) and
``"tridiag"`` on card 0 at the same N: one line per method and N with
wall ms per solve, stats rows and final dyn_vio.
"""
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main(ranks=4, backend="nccl"):
    from algames_tpu_torch.ops import build
    if torch.cuda.device_count() < ranks:
        raise SystemExit(f"{ranks} ranks need {ranks} cards, "
                         f"{torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build.build("thomas_sq")
    worlds = ((1, backend),) + (((ranks, backend),) if ranks > 1 else ())
    cs.phase_spike(torch.device("cuda:0"), worlds)


if __name__ == "__main__":
    main(*(int(a) if i == 0 else a for i, a in enumerate(sys.argv[1:])))
