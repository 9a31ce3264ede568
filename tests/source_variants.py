"""Source variants of the port's kernels: each a copy of the package (with
``chip_smoke.py`` and the frozen solutions it reads) whose CUDA sources have
a few lines edited, so that one design can be timed against another on the
same systems and in the same call, on one card.  Not a test module (pytest
does not collect it).

    python3 tests/source_variants.py build NAME...
    python3 tests/thomas_compare.py dump _scratch/variants/NAME NAME DIR
    python3 tests/trial_compare.py dump _scratch/variants/NAME NAME DIR

``build`` writes each named variant's tree under ``_scratch/variants``
(git-ignored), compiles its libraries there, all at once, and prints the
registers and spills of the kernels its edits touch (``-Xptxas -v``).  The
two compare scripts then time a tree's kernels and save their outputs, as
for a checkout of another commit; their ``compare`` shows the outputs
bitwise equal or not.  The variants (edits of the sources as they are):

- ``base``: none;
- ``k1-inline``: K1's structured Q form for the device-memory route,
  ``SqGlobalQ::x_columns``, left to the compiler's inlining (as before it
  was kept out of line);
- ``k1-owner-global``: besides, that route's right-hand sides read the
  control rows' owners from device memory, not from their copy in shared
  memory;
- ``k2-meta-in-loop``: K2/K4's control-bound blocks read their row flags'
  base and their sense inside the loop over controls (as before they were
  read once a block);
- ``k2-wide-staged``, ``k2-wide-unstaged``: the unicycle past 32 states
  with its trial multipliers staged in shared memory in both precisions
  (the f64 lane then does not fit a block at 17 players), or read from
  device memory in both.
"""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WIDE_LAM = "  static constexpr bool kStageLam = sizeof(T) == sizeof(float);\n"
WORK = ROOT / "_scratch" / "variants"
VARIANTS = {
    "base": [],
    "k1-inline": [("thomas_sq.cu", "  __device__ __noinline__ void x_columns(",
                   "  __device__ void x_columns(")],
    "k1-owner-global": [("thomas_sq.cu",
                         "  __device__ __noinline__ void x_columns(",
                         "  __device__ void x_columns("),
                        ("thomas_global.cuh", "own, n, m, pn);",
                         "owner, n, m, pn);")],
    "k2-meta-in-loop": [("trial_fused.cu", """\
    const unsigned char* cm = meta.c_mask + 2 * m * k;
    const bool eq = meta.c_eq[k];
    for (int j = q; j < m; j += TPK) {
      const T uj = L.U(t, j);
""", """\
    for (int j = q; j < m; j += TPK) {
      const T uj = L.U(t, j);
      const unsigned char* cm = meta.c_mask + 2 * m * k;
      const bool eq = meta.c_eq[k];
""")],
    "k2-wide-staged": [("trial_fused.cu", WIDE_LAM, WIDE_LAM.replace(
        "sizeof(T) == sizeof(float)", "true"))],
    "k2-wide-unstaged": [("trial_fused.cu", WIDE_LAM, WIDE_LAM.replace(
        "sizeof(T) == sizeof(float)", "false"))],
}
# The libraries a variant builds (those the compare script of its kernel
# loads) and the kernels whose registers ``build`` prints, by prefix.
LIBS = {"k1": ("thomas_sq", "thomas_dense"), "k2": ("trial_fused",),
        "base": ("thomas_sq", "thomas_dense", "trial_fused")}
KERNELS = {"k1": ("thomas_sq_global_kernel",), "k2": ("trial_fused_kernel",),
           "base": ("thomas_sq_global_kernel", "trial_fused_kernel")}


def make(name):
    """The variant's tree, with its edits."""
    tree = WORK / name
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / "algames_tpu_torch", tree / "algames_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    for folder in ("golden", "golden_torch"):
        shutil.copytree(ROOT / "tests" / folder, tree / "tests" / folder)
    for fname, old, new in VARIANTS[name]:
        src = tree / "algames_tpu_torch" / "csrc" / fname
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} not once in {fname}")
        src.write_text(text.replace(old, new))
    return tree


def build(names):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    code = ("import sys; from algames_tpu_torch.ops import build; "
            "build.build(sys.argv[1]); "
            "print(build.library_path(sys.argv[1]).with_suffix('.log')"
            ".read_text())")
    trees = {name: make(name) for name in names}
    procs = [(name, lib, subprocess.Popen(
                 [sys.executable, "-c", code, lib], cwd=trees[name],
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for name in names for lib in LIBS[name.split("-")[0]]]
    failed = False
    for name, lib, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            print(f"{name} {lib}: build failed\n{out}", flush=True)
            failed = True
            continue
        want = KERNELS[name.split("-")[0]]
        for kern, regs, spills in cs.ptxas_report(out):
            if kern.startswith(want):
                print(f"{name} {kern}: {regs} registers, {spills}",
                      flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    if sys.argv[1] != "build" or not set(sys.argv[2:]) <= VARIANTS.keys():
        raise SystemExit(__doc__)
    build(sys.argv[2:])
