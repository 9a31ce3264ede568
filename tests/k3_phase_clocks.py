"""Where K3's register-tiled forward kernel spends its cycles, on one CUDA
card.  Not a test module (pytest does not collect it).

    python3 tests/k3_phase_clocks.py [OUT_DIR]

Builds a copy of ``csrc/thomas_dense.cu`` whose core
(``thomas_dense_core.cuh``) records ``clock64()`` at the phase boundaries
of every knot (threads 0 and 64 of lane 0: the owners of column 0 and of
the roundabout's y column), in OUT_DIR (default: a temporary directory),
and runs its forward kernel on ``chip_smoke.py``'s roundabout K3 systems
(mu = 1e3, f32) at B = 132 (one lane per SM) and B = 1024.  Prints the SM
cycles per knot of each phase: the wait for the knot's operands and the
carry, the fill-in, the build of the augmented system, the barrier after
it, the elimination, the scaling by 1 / piv and the stores.  The marks add
a few registers and instructions, so the times are those of the copy, not
of the kernel.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
PHASES = ("wait", "fill-in", "build", "barrier", "elimination", "scale",
          "stores")
MARKS = (
    ("    __syncthreads();                   // knot t's operands and the "
     "carry\n", 0, "after"),
    ("    __syncthreads();                   // F\n", 1, "after"),
    ("    __syncthreads();                   // F is dead: the step slots "
     "reuse it\n", 2, "before"),
    ("    __syncthreads();                   // F is dead: the step slots "
     "reuse it\n", 3, "after"),
    ("    // The unknowns: each pivot row's", 4, "before"),
    ("    // Outputs in (x, u) row order", 5, "before"),
    ("    slot = slot1;\n", 6, "before"),
)


def instrumented(out):
    """Write the marked copy of the sources to ``out``."""
    csrc = HERE / "algames_tpu_torch" / "csrc"
    core = (csrc / "thomas_dense_core.cuh").read_text()
    core = core.replace("namespace thomas_core {",
                        "__device__ unsigned long long k3_clocks[16];\n"
                        "namespace thomas_core {", 1)
    core = core.replace("  T tile[TR][TC];\n",
                        "  T tile[TR][TC];\n  long long clk = clock64();\n", 1)
    for anchor, phase, where in MARKS:
        mark = ("    if (blockIdx.x == 0 && (tid == 0 || tid == 64)) {\n"
                "      const long long now = clock64();\n"
                f"      atomicAdd(&k3_clocks[(tid == 64) * 8 + {phase}],\n"
                "                (unsigned long long)(now - clk));\n"
                "      clk = now;\n    }\n")
        if anchor not in core:
            raise SystemExit(f"no anchor for phase {PHASES[phase]}")
        core = core.replace(anchor, anchor + mark if where == "after"
                            else mark + anchor, 1)
    (out / "thomas_dense_core.cuh").write_text(core)
    (out / "thomas_common.cuh").write_text(
        (csrc / "thomas_common.cuh").read_text())
    (out / "thomas_dense.cu").write_text(
        (csrc / "thomas_dense.cu").read_text()
        + '\nextern "C" int k3_clocks_read(unsigned long long* out, int reset)'
          ' {\n  int e = (int)cudaMemcpyFromSymbol(out, k3_clocks, '
          '16 * sizeof(unsigned long long));\n  if (reset) {\n'
          '    unsigned long long zero[16] = {};\n'
          '    cudaMemcpyToSymbol(k3_clocks, zero, sizeof(zero));\n  }\n'
          '  return e;\n}\n')


def main(out):
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from algames_tpu_torch.core.spec import owner_map_u
    from algames_tpu_torch.ops import build
    from algames_tpu_torch.utils import tree_map
    instrumented(out)
    so = out / "k3_clocks.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(out / "thomas_dense.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fwd = lib.thomas_dense_fwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    read = lib.k3_clocks_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda:0")
    spec, jb, b = cs.k3_system(dev, cs.B_KERNEL, 1e3, 199)
    jb, b = tree_map(lambda a: a.float(), jb), b.float()
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    # The owner tables live on the card (the kernels read them there).
    own_dev = torch.tensor(owner_map_u(spec), dtype=torch.int32,
                           device=dev)
    own = ctypes.c_void_p(own_dev.data_ptr())
    clocks = (ctypes.c_ulonglong * 16)()
    for lanes in (132, cs.B_KERNEL):
        ops = [a[:lanes].contiguous() for a in (jb.Qblk, jb.Ublk, jb.B, jb.A,
                                                b)]
        G = torch.empty((lanes, T, n + m, p * n), device=dev)
        y = torch.empty((lanes, T, n + m), device=dev)
        for _ in range(3):                      # the last of three runs
            read(clocks, 1)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fwd(*[a.data_ptr() for a in ops], own, G.data_ptr(),
                      y.data_ptr(), lanes, T, n, m, p,
                      torch.cuda.current_stream().cuda_stream)
            stop.record()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"launch failed: {err}")
            read(clocks, 0)
        for thread, base in ((0, 0), (64, 8)):
            per = [clocks[base + k] / T for k in range(len(PHASES))]
            print(f"B={lanes}, {start.elapsed_time(stop):.4f} ms (marked "
                  f"copy), thread {thread}, SM cycles per knot: "
                  + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, per))
                  + f"; total {sum(per):.0f}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        target = Path(sys.argv[1])
        target.mkdir(parents=True, exist_ok=True)
        main(target)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(Path(tmp))
