"""The port's plain K1 and K3 on the 4-player quadrotor's KKT systems
(``tests/test_torch_quad4.py``'s: N=4, T=3, B=2, mu = 1e3, f64) against
the JAX package's Pallas kernels in interpret mode
(``solve_thomas_pallas_structured``, ``solve_thomas_pallas``): the worst
per-lane relative error, gated at 1e-10.  Not a test module (pytest does
not collect it): at d=64 each interpret-mode call takes over four minutes
on a CPU, beyond the test budget; the collected tests hold the same
systems to the JAX package's plain reference.

    JAX_PLATFORMS=cpu python tests/quad4_interpret.py
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import conftest  # noqa: E402,F401  (CPU, x64)
import jax  # noqa: E402

from algames_tpu.ops.thomas_pallas import (  # noqa: E402
    solve_thomas_pallas, solve_thomas_pallas_structured)
from algames_tpu.problem.residual import JacBlocks as JaxJacBlocks  # noqa
from algames_tpu.problem.residual import StructuredQ as JaxStructuredQ  # noqa

import chip_smoke  # noqa: E402
from algames_tpu_torch.ops import thomas  # noqa: E402
from test_torch_quad4 import B_SHORT, rel, short_systems  # noqa: E402


def main():
    jspec, spec, sq, b, w_owner = short_systems()
    jsq = JaxStructuredQ(*[getattr(sq, f).numpy() for f in
                           ("qdiag", "wv", "Ublk", "A", "B")])
    ref = jax.jit(lambda s, bb: solve_thomas_pallas_structured(
        jspec, s, bb, tuple(w_owner), block_lanes=B_SHORT,
        interpret=True))(jsq, b.numpy())
    e1 = rel(thomas.solve_thomas_structured(spec, sq, b, w_owner).numpy(),
             ref, B_SHORT)
    print(f"plain K1 vs solve_thomas_pallas_structured (interpret): {e1:.3e}",
          flush=True)
    jb = chip_smoke.dense_of(spec, sq, w_owner)
    jjb = JaxJacBlocks(*[getattr(jb, f).numpy()
                         for f in ("Qblk", "Ublk", "A", "B")])
    ref = jax.jit(lambda j, bb: solve_thomas_pallas(
        jspec, j, bb, block_lanes=B_SHORT, interpret=True))(jjb, b.numpy())
    e3 = rel(thomas.solve_thomas(spec, jb, b).numpy(), ref, B_SHORT)
    print(f"plain K3 vs solve_thomas_pallas (interpret): {e3:.3e}",
          flush=True)
    return 0 if max(e1, e3) <= 1e-10 else 1


if __name__ == "__main__":
    sys.exit(main())
