"""The SASS of the kernel libraries (``thomas_sq``, ``thomas_dense``,
``trial_fused``) of two source trees, kernel by kernel: whether a change to
a shared header, the register-tiled core or the fused trial left a size
class's or a model instance's instructions as they were.  Not a
test module (pytest does not collect it); needs ``nvcc`` and ``cuobjdump``
(the CUDA toolkit), not a card.

    python3 tests/sass_compare.py TREE_A TREE_B OUT_DIR

builds ``algames_tpu_torch/csrc/<lib>.cu`` of each tree with the package's
own nvcc flags into OUT_DIR (all six builds started together), dumps each
library's SASS with ``cuobjdump -sass`` and, for every kernel both trees
compile (by mangled name), prints whether its instructions are equal once
addresses and encodings are stripped, else both instruction counts and the
number of differing lines; then the kernels whose parameters changed (the
same name and template arguments, a new trailing ``false`` argument aside)
likewise; then the kernels only one tree has.
"""
import concurrent.futures
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
LIBS = ("thomas_sq", "thomas_dense", "trial_fused")


def cuda_tool(name):
    found = shutil.which(name)
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME
        found = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", name)
    return found


def build(tag, tree, lib, out):
    from algames_tpu_torch.ops import build as B
    so = out / f"{tag}-{lib}.so"
    subprocess.run([cuda_tool("nvcc"), *B.NVCC_FLAGS, "-o", str(so),
                    str(tree / "algames_tpu_torch" / "csrc" / f"{lib}.cu")],
                   check=True, capture_output=True)
    return so


def sass(so):
    """{mangled kernel name: [instruction lines]}."""
    text = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(so)],
                          check=True, capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            # The anonymous namespace's name holds a hash of the source's
            # path: _ZN<len><namespace>...
            ns = re.match(r"_ZN(\d+)_GLOBAL__N_", name)
            if ns:
                name = "_ZN(anonymous)" + name[ns.end(1) + int(ns.group(1)):]
            out[name] = []
            continue
        if name is None:
            continue
        ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
        if ins and not ins.startswith("."):
            out[name].append(ins)
    return out


def main(tree_a, tree_b, out):
    out.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, t, lib) for tag, t in (("a", tree_a), ("b", tree_b))
            for lib in LIBS]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        sos = dict(zip(jobs, pool.map(lambda j: build(*j, out), jobs)))
    for lib in LIBS:
        a = sass(sos[("a", tree_a, lib)])
        b = sass(sos[("b", tree_b, lib)])
        for name in sorted(set(a) & set(b)):
            same = a[name] == b[name]
            diff = sum(x != y for x, y in zip(a[name], b[name])) + abs(
                len(a[name]) - len(b[name]))
            print(f"{lib} {name}: "
                  + ("SASS equal" if same else
                     f"SASS differs ({len(a[name])} against {len(b[name])} "
                     f"instructions, {diff} lines differ)")
                  + f" [{len(a[name])} instructions]", flush=True)
        only_a, only_b = set(a) - set(b), set(b) - set(a)
        # A kernel whose parameters changed keeps its name and template
        # arguments (a new trailing ``false`` argument aside): compared as
        # the same instance under another signature.
        by_base = {base(n): n for n in only_b}
        for name in sorted(only_a):
            other = by_base.get(base(name))
            if other is None:
                continue
            only_a.discard(name)
            only_b.discard(other)
            diff = sum(x != y for x, y in zip(a[name], b[other])) + abs(
                len(a[name]) - len(b[other]))
            print(f"{lib} {name} -> {other}: signature changed, SASS "
                  + ("equal" if a[name] == b[other] else
                     f"differs ({len(a[name])} against {len(b[other])} "
                     f"instructions, {diff} lines differ)"), flush=True)
        for tree, only in ((tree_a, only_a), (tree_b, only_b)):
            for name in sorted(only):
                print(f"{lib} {name}: only in {tree}", flush=True)


def base(name):
    """A kernel's mangled name up to its parameter list, a trailing
    ``false`` template argument dropped."""
    m = re.match(r"(.*?E)v", name)
    return (m.group(1) if m else name).replace("Lb0E", "")


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve(),
         Path(sys.argv[3]))
