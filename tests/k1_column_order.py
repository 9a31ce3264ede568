"""K1's column order on quadrotor KKT systems, on one CUDA card: the
measurement behind K1's x-first elimination (PERF.md).  Not a test module
(pytest does not collect it).

    python3 tests/k1_column_order.py

K1 (``csrc/thomas_sq.cu``) eliminates each knot's reduced system x columns
first.  This script also builds it with the TPU kernel's u-first order (a
copy of ``thomas_common.cuh`` whose ``ColumnOrder`` puts the u columns
first, into a temporary directory) and runs the port's wrapper on either
library, both on K1's shared-memory forward kernel (the wide route, the
only one with a column order to change; it was every system's route when
this was measured).  For mu = 1 .. 1e7 it builds ``chip_smoke.py``'s quadrotor K1
systems (B=1024, around the frozen ``quad2_N15`` equilibrium) and solves them
in both orders, in f64 and f32, beside the f32 plain version: worst and
median per-lane relative error against the f64 plain version, and the worst
normwise backward error.  Then it runs the f32 quadrotor sweep (4096
scenarios, chunk 1024, stationarity gate 5e-2) through each order: converged
fraction, solves/s and the lanes whose iteration counts agree.
"""
import contextlib
import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
X_FIRST = "ColumnOrder(int n, int) : u0(n), x0(0) {}"
U_FIRST = "ColumnOrder(int n, int m) : u0(0), x0(m) {}"


def build_u_first(tmp):
    """K1's library compiled with the u columns first."""
    from algames_tpu_torch.ops import build
    for path in [build.CSRC_DIR / "thomas_sq.cu",
                 *build.CSRC_DIR.glob("*.cuh")]:
        shutil.copy(path, tmp / path.name)
    header = (tmp / "thomas_common.cuh").read_text()
    if X_FIRST not in header:
        raise SystemExit("ColumnOrder is not the expected x-first form")
    (tmp / "thomas_common.cuh").write_text(header.replace(X_FIRST, U_FIRST))
    so = tmp / "thomas_sq_u_first.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(tmp / "thomas_sq.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.thomas_sq_error_string.argtypes = [ctypes.c_int]
    lib.thomas_sq_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def order(lib_u, name):
    """K1's wrapper on its shared-memory forward kernel, from the u-first
    library while ``name`` is "u"."""
    from algames_tpu_torch.ops import thomas
    load, route = thomas.build.load, thomas._shape_route
    if name == "u":
        thomas.build.load = lambda lib: lib_u if lib == "thomas_sq" else \
            load(lib)
    thomas._shape_route = lambda *shape: "shared"
    thomas._sq_launch.cache_clear()
    try:
        yield
    finally:
        thomas.build.load, thomas._shape_route = load, route
        thomas._sq_launch.cache_clear()


def main():
    import chip_smoke as cs
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops import thomas
    from algames_tpu_torch.presets import quadrotor3d
    from algames_tpu_torch.utils import tree_map

    if not torch.cuda.is_available():
        print("k1_column_order: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        lib_u = build_u_first(Path(tmp))
        for i, mu in enumerate(cs.MUS):
            spec, sq, b, w = cs.k1_system(dev, cs.B_KERNEL, mu, 500 + i,
                                          False, quadrotor3d,
                                          cs.golden_iterates("quad2_N15"))
            ref = thomas.solve_thomas_structured_plain(spec, sq, b, w)
            sq32, b32 = tree_map(lambda a: a.float(), sq), b.float()
            ys = {"plain32": thomas.solve_thomas_structured_plain(
                spec, sq32, b32, w)}
            for name in ("u", "x"):
                with order(lib_u, name):
                    ys[name + "64"] = thomas.solve_thomas_structured(
                        spec, sq, b, w)
                    ys[name + "32"] = thomas.solve_thomas_structured(
                        spec, sq32, b32, w)
            bw = cs.backward_errors(spec, sq, w, b, list(ys.values()))
            parts = []
            for (name, y), e in zip(ys.items(), bw):
                fwd = cs.rel_err(y, ref)
                parts.append(f"{name} forward {float(fwd.max()):.3e} / "
                             f"median {float(fwd.median()):.3e}, backward "
                             f"{float(e.max()):.3e}")
            print(f"mu={mu:.0e}: " + "; ".join(parts), flush=True)

        prob, x0s = cs.sweep_problem(quadrotor3d, dev)
        conv_opts = dataclasses.replace(prob.opts, eps_opt=cs.QUAD_OPT_GATE)
        parallel.solve_batch(dataclasses.replace(
            prob, opts=dataclasses.replace(prob.opts, outer_iter=1,
                                           inner_iter=2)), x0s[:64])
        iters = {}
        for name in ("u", "x"):
            with order(lib_u, name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = parallel.solve_many(prob, x0s, method="thomas",
                                          chunk=cs.CHUNK)
                torch.cuda.synchronize()
                el = time.perf_counter() - t0
            iters[name] = out.stats.iter.cpu().numpy()
            frac = float(parallel.convergence_fraction(out, conv_opts))
            print(f"sweep, {name} first: converged {frac:.4f}, "
                  f"{cs.N_SWEEP / el:.1f} solves/s, diverged "
                  f"{float(parallel.divergence_mask(out).float().mean())}",
                  flush=True)
    same = int((iters["u"] == iters["x"]).sum())
    print(f"iteration counts equal on {same} of {cs.N_SWEEP} lanes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
