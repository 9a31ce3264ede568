"""Where K1's two forward kernels spend their cycles, on one CUDA card.  Not
a test module (pytest does not collect it).

    python3 tests/k1_phase_clocks.py [OUT_DIR]

Builds a copy of ``csrc/thomas_sq.cu`` (in OUT_DIR, default a temporary
directory) whose two forward kernels record ``clock64()`` at the phase
boundaries of every knot (threads 0 and 64 of lane 0):

- the register-tiled kernel (``thomas_dense_core.cuh`` with K1's structured
  Q form): the wait for the knot's operands and the carry, the fill-in,
  the products Bw and Fw, the build of the augmented system, the barrier
  after it, the LU elimination, the back substitution, the scaling by
  1 / piv and the stores;
- the shared-memory kernel (``thomas_common.cuh``; the wide route now, and
  every K1 system's forward kernel before the register-tiled one, its
  source unchanged): the knot's loads, the fill-in, the products Fw, the
  build, the elimination, the back substitution and the stores.

It runs both on ``chip_smoke.py``'s K1 systems of the quadrotor and the
flagship (mu = 1e3, f32) at B = 132 (one lane per SM) and B = 1024, and
prints the SM cycles per knot of each phase.  The marks add a few
registers and instructions, so the times are those of the copy, not of the
kernels.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
MARK = """#pragma once
__device__ unsigned long long k1_clocks[32];
__device__ long long k1_last[128];
// Add the cycles since this thread's last mark to ``phase`` (< 0: only
// start the clock), for threads 0 and 64 of lane 0.
__device__ __forceinline__ void k1_mark(int phase) {
  const int tid = threadIdx.x;
  if (blockIdx.x != 0 || (tid != 0 && tid != 64)) return;
  const long long now = clock64();
  if (phase >= 0)
    atomicAdd(&k1_clocks[(tid == 64) * 16 + phase],
              (unsigned long long)(now - k1_last[tid]));
  k1_last[tid] = now;
}
"""
TILED = ("wait", "fill-in", "products", "build", "barrier", "elimination",
         "back substitution", "scale", "stores")
WIDE = ("loads", "fill-in", "products", "build", "elimination",
        "back substitution", "stores")
# (file, anchor, phase, where): the mark goes right after or before the
# anchor's first occurrence; phase -1 starts the clock.
MARKS = (
    ("thomas_dense_core.cuh", "  T tile[TR][TC];\n", -1, "after"),
    ("thomas_dense_core.cuh", "    __syncthreads();                   // knot "
     "t's operands and the carry\n", 0, "after"),
    ("thomas_dense_core.cuh", "    __syncthreads();                   // F\n",
     1, "after"),
    ("thomas_dense_core.cuh", "      __syncthreads();                 // the Q "
     "form's products\n", 2, "after"),
    ("thomas_dense_core.cuh", "    __syncthreads();                   // F is "
     "dead: the step slots reuse it\n", 3, "before"),
    ("thomas_dense_core.cuh", "    __syncthreads();                   // F is "
     "dead: the step slots reuse it\n", 4, "after"),
    ("thomas_dense_core.cuh", "    if constexpr (QForm::kLU) {\n      // Back "
     "substitution", 5, "before"),
    ("thomas_dense_core.cuh", "    // The unknowns: each pivot row's", 6,
     "before"),
    ("thomas_dense_core.cuh", "    // Outputs in (x, u) row order", 7,
     "before"),
    ("thomas_dense_core.cuh", "    slot = slot1;\n", 8, "before"),
    ("thomas_sq.cu", "  thomas::init_carry(S, owner);\n", -1, "after"),
    ("thomas_sq.cu", "    thomas::load_knot(S, Ub, Bm, A, bk, kt, t, Tn);\n"
     "    __syncthreads();\n", 0, "after"),
    ("thomas_sq.cu", "    thomas::fill_in(S);\n    __syncthreads();\n", 1,
     "after"),
    ("thomas_sq.cu", "    thomas::build_system(S, qf);\n", 2,
     "before"),
    ("thomas_sq.cu", "    thomas::build_system(S, qf);\n"
     "    __syncthreads();\n", 3, "after"),
    ("thomas_common.cuh", "  // Back substitution in variable order", 4,
     "before"),
    ("thomas_common.cuh", "  // Outputs in (x, u) row order; the carry", 5,
     "before"),
    ("thomas_common.cuh", "  for (int a = tid; a < n; a += nth) S.yx[a] = "
     "S.sol[(col.x0 + a) * R + pn];\n  __syncthreads();\n", 6, "after"),
)


def instrumented(out):
    """Write the marked copy of the sources to ``out``."""
    csrc = HERE / "algames_tpu_torch" / "csrc"
    text = {name: (csrc / name).read_text() for name in
            ("thomas_dense_core.cuh", "thomas_common.cuh", "thomas_sq.cu")}
    for name in ("thomas_dense_core.cuh", "thomas_common.cuh"):
        text[name] = text[name].replace(
            "#pragma once\n", '#pragma once\n#include "k1_mark.cuh"\n', 1)
    for name, anchor, phase, where in MARKS:
        if anchor not in text[name]:
            raise SystemExit(f"no anchor in {name} for mark {phase}")
        mark = f"k1_mark({phase});\n"
        text[name] = text[name].replace(
            anchor, anchor + mark if where == "after" else mark + anchor, 1)
    (out / "k1_mark.cuh").write_text(MARK)
    for name, body in text.items():
        (out / name).write_text(body)
    with open(out / "thomas_sq.cu", "a") as f:
        f.write('\nextern "C" int k1_clocks_read(unsigned long long* out, '
                'int reset) {\n  int e = (int)cudaMemcpyFromSymbol(out, '
                'k1_clocks, sizeof(k1_clocks));\n  if (reset) {\n'
                '    unsigned long long zero[32] = {};\n'
                '    cudaMemcpyToSymbol(k1_clocks, zero, sizeof(zero));\n'
                '  }\n  return e;\n}\n')


def main(out):
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from algames_tpu_torch.core.spec import owner_map_u
    from algames_tpu_torch.ops import build
    from algames_tpu_torch.presets import quadrotor3d
    from algames_tpu_torch.utils import tree_map
    instrumented(out)
    so = out / "k1_clocks.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(out / "thomas_sq.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    read = lib.k1_clocks_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda:0")
    games = (("quad2", dict(preset=quadrotor3d,
                            iterates=cs.golden_iterates("quad2_N15")), 500),
             ("uni3", {}, 0))
    clocks = (ctypes.c_ulonglong * 32)()
    for game, kw, seed0 in games:
        spec, sq, b, w_owner = cs.k1_system(
            dev, cs.B_KERNEL, 1e3, seed0 + 99, False, kw.get("preset"),
            kw.get("iterates", cs.flagship_iterates))
        sq, b = tree_map(lambda a: a.float(), sq), b.float()
        n, m, p, T, NW = spec.n, spec.m, spec.p, spec.T, len(w_owner)
        # The owner tables live on the card (the kernels read them there).
        own_dev = torch.tensor(owner_map_u(spec), dtype=torch.int32,
                               device=dev)
        own = ctypes.c_void_p(own_dev.data_ptr())
        w_dev = torch.tensor(w_owner, dtype=torch.int32, device=dev)
        w_own = ctypes.c_void_p(w_dev.data_ptr())
        for route, phases in (("", TILED), ("wide_", WIDE)):
            fwd = getattr(lib, f"thomas_sq_fwd_{route}f32")
            fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            for lanes in (132, cs.B_KERNEL):
                ops = [a[:lanes].contiguous() for a in (
                    sq.qdiag, sq.wv, sq.Ublk, sq.B, sq.A, b)]
                G = torch.empty((lanes, T, n + m, p * n), device=dev)
                y = torch.empty((lanes, T, n + m), device=dev)
                for _ in range(3):              # the last of three runs
                    read(clocks, 1)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    err = fwd(*[a.data_ptr() for a in ops], own, w_own,
                              G.data_ptr(), y.data_ptr(), lanes, T, n, m, p,
                              NW, torch.cuda.current_stream().cuda_stream)
                    stop.record()
                    torch.cuda.synchronize()
                    if err:
                        raise SystemExit(f"launch failed: {err}")
                    read(clocks, 0)
                kind = "register-tiled" if not route else "shared-memory"
                for thread, base in ((0, 0), (64, 16)):
                    per = [clocks[base + k] / T for k in range(len(phases))]
                    print(f"K1 {game} {kind} B={lanes}, "
                          f"{start.elapsed_time(stop):.4f} ms (marked copy), "
                          f"thread {thread}, SM cycles per knot: "
                          + ", ".join(f"{ph} {c:.0f}"
                                      for ph, c in zip(phases, per))
                          + f"; total {sum(per):.0f}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        target = Path(sys.argv[1])
        target.mkdir(parents=True, exist_ok=True)
        main(target)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(Path(tmp))
