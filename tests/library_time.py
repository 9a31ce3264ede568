"""The library yardstick of K1 on a game's own KKT systems at a sweep's
batch: ``torch.linalg.solve`` on the dense [S, S] KKT matrices of B lanes,
in calls of LANES lanes (as ``chip_smoke.py``'s ``library_solve_ms``), f32,
mu = 1e3.  Not a test module (pytest does not collect it); needs a card.

    python3 tests/library_time.py GAME B LANES

GAME names a game function of ``chip_smoke.py`` (e.g. ``uni9_game``).  Prints
the card, the time for all B lanes and K1's device time on the same
operands (``chip_smoke.device_ms``), for the kernels table's library
column where ``chip_smoke.py`` leaves it out to stay in its time limit.
"""
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main(game, B, lanes):
    from algames_tpu_torch.ops.thomas import solve_thomas_structured
    from algames_tpu_torch.utils import tree_map
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    spec, sq, b, w_owner = cs.k1_system(dev, B, 1e3, 2299, False,
                                        getattr(cs, game),
                                        cs.flagship_iterates)
    sq32, b32 = tree_map(lambda a: a.float(), sq), b.float()
    del sq, b
    k1 = cs.device_ms(lambda: solve_thomas_structured(spec, sq32, b32,
                                                      w_owner),
                      3, ("thomas_sq_",), 2, f"{game} K1 f32 B={B}")
    ms, y_lib = cs.library_solve_ms(spec, cs.dense_of(spec, sq32, w_owner),
                                    b32, lanes)
    y = solve_thomas_structured(spec, sq32, b32, w_owner)
    print(f"{game}: f32 B={B}, S={spec.S}: library (torch.linalg.solve on "
          f"the dense KKT matrices, {lanes} lanes a call) {ms:.4f} ms, worst "
          f"relative deviation from K1 {float(cs.rel_err(y_lib, y).max()):.3e}"
          f"; K1 device time {k1:.4f} ms", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
