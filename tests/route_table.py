"""K1's and K3's forward route at the widths of the unicycle merges of 10
to 18 players (``flagship_unicycle(p)``: n = 4p, m = 2p, NW = p (p - 1)
w vectors), in f32 and f64, as a source tree's libraries say.  Not a test
module (pytest does not collect it); needs a card (the libraries are built
from TREE's sources).

    python3 tests/route_table.py TREE

Prints one line per width: the route numbers of ``thomas_sq_route_*`` and
``thomas_dense_route_*`` (0 register-tiled, 3 per-player blocked, 1
shared-memory, 2 device-memory, -1 none).  Run on a checkout of an older
commit (``git archive`` unpacked in a git-ignored directory) it shows which
widths that commit's kernels refused.
"""
import sys
from pathlib import Path


def main(tree):
    sys.path.insert(0, str(tree))
    from algames_tpu_torch.ops import build
    if Path(build.__file__).resolve().parents[2] != tree:
        raise SystemExit(f"the port was not imported from {tree}")
    sq, dense = build.load("thomas_sq"), build.load("thomas_dense")
    for p in range(10, 19):
        n, m, NW = 4 * p, 2 * p, p * (p - 1)
        row = []
        for sfx in ("f32", "f64"):
            k1 = build.bind(sq, f"thomas_sq_route_{sfx}", [build.I] * 4)
            k3 = build.bind(dense, f"thomas_dense_route_{sfx}",
                            [build.I] * 3)
            row.append(f"K1 {sfx} {k1(n, m, p, NW)}, K3 {sfx} {k3(n, m, p)}")
        print(f"{tree.name}: {p} players (n={n}, m={m}, d={n + m}, NW={NW}): "
              + "; ".join(row), flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve())
