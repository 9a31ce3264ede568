"""Where the per-player blocked forward kernels (``csrc/thomas_blocked.cuh``:
K1's, and with ``--form dense`` K3's) spend their cycles, on one CUDA card.
Not a test module (pytest does not collect it).

    python3 tests/k1_blocked_clocks.py [--form dense] [OUT_DIR]
    python3 tests/k1_blocked_clocks.py [--form dense] --split
    python3 tests/k1_blocked_clocks.py --split uni9

Builds a copy of ``csrc/thomas_sq.cu`` (in OUT_DIR, default a temporary
directory) whose blocked kernel records ``clock64()`` at the phase
boundaries of every knot (threads 0 and 64 of lane 0, ``k1_phase_clocks``'s
marks): the wait for the knot's operands, u = y + G a, the fill-in F
with the y column, the products Pw, the build of K in registers, the LU
of K, the right-hand sides in pivot order, the forward and back
substitution, the stores.  It runs the copy on ``chip_smoke.py``'s
``K1-wide64`` systems of the 4-player quadrotor (d=64, R=193, NW=20; mu =
1e3) in f32 at B = 132 (one lane per SM) and B = 1024 (two), and in f64 at
B = 132, and prints the SM cycles per knot of each phase.  The marks add a
few registers and instructions, so the times are those of the copy, not of
the kernel.  With ``--split`` it times instead the package's own forward
kernels (the blocked route and the older routes on the same operands) and
backward kernel apart, a launch at a time (``split``).

``--form dense`` does the same for K3 (``csrc/thomas_dense.cu``, the Q form
``DenseForm``): its phases are the wait, u, the fill-in, the staging of
each player's Q_i (the waits and barriers of its slots, and the copy of the
next player's), the per-player products F_i Q_i and B^T Q_i, the rest of K
(the u columns and -I), the LU, the right-hand sides, the substitutions and
the stores, on ``chip_smoke.py``'s ``K3-big64`` systems (the same systems
turned dense); ``--split`` times K3's forward kernels (blocked and
device-memory routes) and backward kernel on ``sweep-quad4-dense``'s
systems of the 4-player quadrotor with collision-cost pairs at B = 1024 and
``K3-big64``'s at B = 64.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "tests"))
from k1_phase_clocks import MARK  # noqa: E402

PHASES = ("wait", "u", "fill-in", "Pw", "K", "LU", "right-hand sides",
          "substitution", "stores")
DENSE_PHASES = ("wait", "u", "fill-in", "Q staging", "F_i Q_i and B^T Q_i",
                "K", "LU", "right-hand sides", "substitution", "stores")
# (anchor, phase, where) in thomas_blocked.cuh: the mark goes right after or
# before the anchor's first occurrence; phase -1 starts the clock.
MARKS = (
    ("  issue_A(1);\n  thomas_core::cp_async_commit();\n", -1, "after"),
    ("    __syncthreads();                   // knot t's operands and the "
     "carry\n", 0, "after"),
    ("    // The fill-in F = -A_t G_{t-1}", 1, "before"),
    ("    __syncthreads();                   // F; A_t is dead\n", 2,
     "after"),
    ("    __syncthreads();                   // Pw\n", 3, "after"),
    ("    // LU of K in registers: at step s", 4, "before"),
    ("    // The right-hand sides in pivot order, block by block", 5,
     "before"),
    ("    __syncthreads();                   // the right-hand sides, "
     "L\\U\n", 6, "after"),
    ("    __syncthreads();                   // the solution, variable "
     "order\n", 7, "after"),
    ("      if (lane == 0) y_out[kt * d + v] = x[pn];\n    }\n", 8, "after"),
)
DENSE_MARKS = (
    ("  issue_A(1);\n  thomas_core::cp_async_commit();\n", -1, "after"),
    ("    __syncthreads();                   // knot t's operands and the "
     "carry\n", 0, "after"),
    ("    // The fill-in F = -A_t G_{t-1}", 1, "before"),
    ("    __syncthreads();                   // F; A_t is dead\n", 2,
     "after"),
    ("      const T* Qi = q + (i2 & 1) * sl;\n", 3, "before"),
    ("            for (int j = 0; j < kDT; ++j) kx[i][j] += av * qv[j];\n"
     "          }\n      }\n", 4, "after"),
    ("    // LU of K in registers: at step s", 5, "before"),
    ("    // The right-hand sides in pivot order, block by block", 6,
     "before"),
    ("    __syncthreads();                   // the right-hand sides, "
     "L\\U\n", 7, "after"),
    ("    __syncthreads();                   // the solution, variable "
     "order\n", 8, "after"),
    ("      if (lane == 0) y_out[kt * d + v] = x[pn];\n    }\n", 9, "after"),
)
# Per form: the library, its blocked export's pointer arguments, the phases
# and the marks.
FORMS = {"structured": ("thomas_sq", 10, PHASES, MARKS),
         "dense": ("thomas_dense", 8, DENSE_PHASES, DENSE_MARKS)}


def instrumented(out, form="structured"):
    """Write the marked copy of the sources to ``out``."""
    lib, _, _, marks = FORMS[form]
    csrc = HERE / "algames_tpu_torch" / "csrc"
    for src in csrc.iterdir():
        (out / src.name).write_text(src.read_text())
    text = (csrc / "thomas_blocked.cuh").read_text().replace(
        "#pragma once\n", '#pragma once\n#include "k1_mark.cuh"\n', 1)
    for anchor, phase, where in marks:
        if anchor not in text:
            raise SystemExit(f"no anchor for mark {phase}")
        mark = f"k1_mark({phase});\n"
        text = text.replace(
            anchor, anchor + mark if where == "after" else mark + anchor, 1)
    (out / "thomas_blocked.cuh").write_text(text)
    (out / "k1_mark.cuh").write_text(MARK)
    with open(out / f"{lib}.cu", "a") as f:
        f.write('\nextern "C" int k1_clocks_read(unsigned long long* out, '
                'int reset) {\n  int e = (int)cudaMemcpyFromSymbol(out, '
                'k1_clocks, sizeof(k1_clocks));\n  if (reset) {\n'
                '    unsigned long long zero[32] = {};\n'
                '    cudaMemcpyToSymbol(k1_clocks, zero, sizeof(zero));\n'
                '  }\n  return e;\n}\n')


def build_copy(out, form="structured"):
    """The marked library, built in ``out``."""
    sys.path.insert(0, str(HERE))
    from algames_tpu_torch.ops import build
    instrumented(out, form)
    lib = FORMS[form][0]
    so = out / f"{lib}_blocked_clocks.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(out / f"{lib}.cu")], check=True,
                   capture_output=True)
    return so


def measure(so, tag="", form="structured"):
    """Print the SM cycles per knot of each phase of the marked library
    ``so`` (f32 at B = 132 and 1024, f64 at B = 132)."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from algames_tpu_torch.core.spec import owner_map_u
    from algames_tpu_torch.ops import build
    from algames_tpu_torch.utils import tree_map
    name, nptr, phases, _ = FORMS[form]
    lib = ctypes.CDLL(str(so))
    read = lib.k1_clocks_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda:0")
    clocks = (ctypes.c_ulonglong * 32)()
    spec, sq64, b64, w_owner = cs.k1_system(
        dev, cs.B_KERNEL, 1e3, (950 if form == "structured" else 960) + 99,
        False, cs.quad4_game, cs.quad3_iterates)
    n, m, p, T, NW = spec.n, spec.m, spec.p, spec.T, len(w_owner)
    # The owner tables live on the card (the kernels read them there).
    own_dev = torch.tensor(owner_map_u(spec), dtype=torch.int32,
                           device=dev)
    own = ctypes.c_void_p(own_dev.data_ptr())
    w_dev = torch.tensor(w_owner, dtype=torch.int32, device=dev)
    w_own = ctypes.c_void_p(w_dev.data_ptr())
    if form == "dense":
        jb64 = cs.dense_of(spec, sq64, w_owner)
    for dtype, sfx, batches in ((torch.float32, "f32", (132, cs.B_KERNEL)),
                                (torch.float64, "f64", (132,))):
        b = b64.to(dtype)
        if form == "dense":
            jb = tree_map(lambda a: a.to(dtype), jb64)
            tables, ints = (own,), (T, n, m, p)
            operands = (jb.Qblk, jb.Ublk, jb.B, jb.A, b)
        else:
            sq = tree_map(lambda a: a.to(dtype), sq64)
            tables, ints = (own, w_own), (T, n, m, p, NW)
            operands = (sq.qdiag, sq.wv, sq.Ublk, sq.B, sq.A, b)
        fwd = getattr(lib, f"{name}_fwd_blocked_{sfx}")
        fwd.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * (
            len(ints) + 1) + [ctypes.c_void_p]
        for lanes in batches:
            ops = [a[:lanes].contiguous() for a in operands]
            G = torch.empty((lanes, T, n + m, p * n), device=dev, dtype=dtype)
            y = torch.empty((lanes, T, n + m), device=dev, dtype=dtype)
            for _ in range(3):              # the last of three runs
                read(clocks, 1)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                err = fwd(*[a.data_ptr() for a in ops], *tables,
                          G.data_ptr(), y.data_ptr(), lanes, *ints,
                          torch.cuda.current_stream().cuda_stream)
                stop.record()
                torch.cuda.synchronize()
                if err:
                    raise SystemExit(f"launch failed: {err}")
                read(clocks, 0)
            for thread, base in ((0, 0), (64, 16)):
                per = [clocks[base + k] / T for k in range(len(phases))]
                print(f"{'K1' if form == 'structured' else 'K3'} quad4 "
                      f"blocked{tag} {sfx} B={lanes}, "
                      f"{start.elapsed_time(stop):.4f} ms (marked copy, "
                      f"forward only), thread {thread}, SM cycles per knot: "
                      + ", ".join(f"{ph} {c:.0f}"
                                  for ph, c in zip(phases, per))
                      + f"; total {sum(per):.0f}", flush=True)


def split(reps=3, form="structured", game="quad4"):
    """Device ms a launch of K1's (``form`` "dense": K3's) forward kernel,
    on each route that holds the 4-player quadrotor's systems, and of its
    backward kernel, apart: the package's own library (no marks), CUDA
    events around each launch with the card idle before it; f32 at B =
    1024 (``sweep-quad4``'s systems; K3: ``sweep-quad4-dense``'s) and B =
    64, f64 at B = 64 (``K1-wide64``'s; K3: ``K3-big64``'s).  ``game``
    "uni9" (K1 only): the 9-player unicycle merge's systems (d=54, NW=72;
    ``K1-uni9``'s) on its blocked and device-memory routes, the same
    batches."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from algames_tpu_torch.ops import build
    from algames_tpu_torch.ops import thomas as TH
    from algames_tpu_torch.utils import tree_map
    dev = torch.device("cuda:0")
    times = {}

    def hook(f, args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = f(*args)
        stop.record()
        torch.cuda.synchronize()
        times.setdefault(f.__name__, []).append(start.elapsed_time(stop))
        return err
    if form == "dense":
        cases = (("f32", cs.CHUNK, 1210, ("blocked", "device")),
                 ("f32", cs.B_BEYOND, 960 + 99, ("blocked", "device")),
                 ("f64", cs.B_BEYOND, 960 + 99, ("blocked", "device")))
    elif game == "uni9":
        cases = (("f32", cs.CHUNK, 2290, ("blocked", "device")),
                 ("f32", cs.B_BEYOND, 2200 + 99, ("blocked", "device")),
                 ("f64", cs.B_BEYOND, 2200 + 99, ("blocked", "device")))
    else:
        cases = (("f32", cs.CHUNK, 990, ("blocked", "shared", "device")),
                 ("f32", cs.B_BEYOND, 950 + 99,
                  ("blocked", "shared", "device")),
                 ("f64", cs.B_BEYOND, 950 + 99, ("blocked", "device")))
    system_game, system_iterates = ((cs.uni9_game, cs.flagship_iterates)
                                    if game == "uni9" else
                                    (cs.quad4_game, cs.quad3_iterates))
    for name, lanes, seed, routes in cases:
        dtype = torch.float32 if name == "f32" else torch.float64
        if form == "dense" and lanes == cs.CHUNK:
            spec, jb, b = cs.k3_system(dev, lanes, 1e3, seed, False, None,
                                       cs.quad4_cost_game, cs.quad3_iterates)
            args = (tree_map(lambda a: a.to(dtype), jb), b.to(dtype))
        else:
            spec, sq, b, w_owner = cs.k1_system(dev, lanes, 1e3, seed, False,
                                                system_game, system_iterates)
            if form == "dense":
                args = (tree_map(lambda a: a.to(dtype),
                                 cs.dense_of(spec, sq, w_owner)),
                        b.to(dtype))
            else:
                args = (tree_map(lambda a: a.to(dtype), sq), b.to(dtype),
                        w_owner)

        def solve(route):
            if form == "dense":
                return TH.solve_thomas(spec, *args, route)
            return TH.solve_thomas_structured(spec, *args, route)
        for route in routes:
            solve(route)
            times.clear()
            build.launch_hook = hook
            try:
                for _ in range(reps):
                    solve(route)
            finally:
                build.launch_hook = None
            print(f"{'K1' if form == 'structured' else 'K3'} {game} {name} "
                  f"B={lanes} {route} route, device ms a "
                  f"launch (mean of {reps}): " + ", ".join(
                      f"{k} {sum(v) / len(v):.4f}"
                      for k, v in sorted(times.items())), flush=True)


def main(out, form):
    measure(build_copy(out, form), form=form)


if __name__ == "__main__":
    argv = sys.argv[1:]
    form = "structured"
    if argv[:2] == ["--form", "dense"]:
        form, argv = "dense", argv[2:]
    if argv[:1] == ["--split"]:
        split(form=form, game=argv[1] if len(argv) > 1 else "quad4")
    elif argv:
        target = Path(argv[0])
        target.mkdir(parents=True, exist_ok=True)
        main(target, form)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(Path(tmp), form)
