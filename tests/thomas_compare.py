"""The block-Thomas KKT kernels K3 (dense Q) and K1 (structured Q) of two
source trees on the same inputs, on one CUDA card: device times, outputs
and occupancy.  Not a test module (pytest does not collect it).

    python3 tests/thomas_compare.py dump TREE NAME DIR [beyond]
    python3 tests/thomas_compare.py compare DIR NAME_A NAME_B

``dump`` imports ``chip_smoke.py`` and the port from TREE (a checkout, e.g.
``git archive`` of another commit unpacked in a git-ignored directory) and
builds ``chip_smoke.py``'s KKT inputs at B=1024 (mu = 1e3, the timed
systems of its phases, and mu = 1e7): K3 on the roundabout, the bicycle,
the padded heterogeneous game and the IBR player systems, K1 on the
flagship, the double integrator and the quadrotor, in f32 and f64; and, for
a tree whose ``chip_smoke.py`` builds them, K3 on the quadrotor's systems
turned dense and on IBR's quadrotor player systems and K1 on the 3-player
quadrotor's (each tree runs them on whichever forward kernel its own
routing picks); then, beyond the classes, K1 and K3 on the 4-player
quadrotor's systems, K1 on the 9-player merge's (B=1024, every route that
holds them) and on the 17-player merge's (B=64, the device-memory route),
each in f32 and f64 (with ``beyond``, only these).  It
prints, per input set, each kernel's worst relative error against the f64
plain version, and in f32 the device time per call (forward + backward;
the event reading of this repository's ``chip_smoke.device_ms``, so both
trees are timed alike); for the roundabout also K3's forward kernel alone at
B = 132, 924 and 1024, and for every input set the lanes per SM of the
forward kernel from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (the
tree's own ``thomas_dense_occupancy_*`` / ``thomas_sq_occupancy_*``
export, which for K1 also gives the registers and local memory a thread,
or for a tree without one a probe library compiled from its source).  The
outputs go to DIR/NAME-kkt.pt (``tests/trial_compare.py`` writes
DIR/NAME.pt).
``compare`` counts the unequal output elements of two dumps and their
largest difference, input set by input set.  Run each ``dump`` in its own
process: the two trees' packages share a name.
"""
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
FWD_BATCHES = (132, 924, 1024)


def _timing():
    """This repository's ``chip_smoke.py`` as a module of another name: its
    device timer serves both trees."""
    spec = importlib.util.spec_from_file_location("smoke_timing",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Per library: the shared-memory forward kernel and its Q operand scalars
# and extra scalars, in TREE's thomas_common.cuh terms.
_PROBES = {"thomas_dense": ("thomas_dense_fwd_kernel", "p * n * n", "0"),
           "thomas_sq": ("thomas_sq_fwd_kernel", "p * n + NW * n", "n * NW")}


def _occupancy_probe(tree, out_dir, lib_name):
    """A library compiled from TREE's ``<lib_name>.cu`` with one more
    export: its shared-memory forward kernel's lanes per SM (for trees
    without the library's occupancy export)."""
    from algames_tpu_torch.ops import build
    kernel, qs, ext = _PROBES[lib_name]
    src = out_dir / f"occupancy_probe_{lib_name}.cu"
    so = out_dir / f"occupancy_probe_{lib_name}.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    body = "\n".join(
        f"""extern "C" int probe_occupancy_{sfx}(int n, int m, int p, int NW) {{
  const size_t bytes = thomas::fwd_smem_bytes<{T}>(n, m, p, {qs}, {ext});
  if (thomas::set_smem((const void*){kernel}<{T}>, bytes)) return -1;
  int lanes = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &lanes, {kernel}<{T}>, thomas::kThreads, bytes);
  return lanes;
}}""" for sfx, T in (("f32", "float"), ("f64", "double")))
    src.write_text(f'#include "{tree}/algames_tpu_torch/csrc/{lib_name}.cu"'
                   f"\n{body}\n")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _route_name(route):
    """The forward route's name: a tree's occupancy export gives it, or
    (before the device-memory route) whether the kernel is register-tiled."""
    if isinstance(route, str):
        return route
    return "register-tiled" if route else "shared-memory"


def _occupancy(lib, lib_name, probes, tree, out_dir, n, m, p, sfx, NW=0):
    """The forward kernel's lanes per SM at these widths, as a string (K1
    with the tree's own export: also registers and local memory)."""
    from algames_tpu_torch.ops import thomas
    dtype = torch.float32 if sfx == "f32" else torch.float64
    if lib_name == "thomas_sq" and hasattr(lib, f"thomas_sq_occupancy_{sfx}"):
        route, lanes, regs, frame = thomas.structured_forward(n, m, p, NW,
                                                              dtype)
        return (f"{_route_name(route)}, {lanes} lanes per SM, {regs} "
                f"registers, {frame} B local")
    info = ()
    if lib_name == "thomas_dense" and hasattr(lib, f"{lib_name}_occupancy_"
                                                   f"{sfx}"):
        info = thomas.dense_forward(n, m, p, dtype)
    if len(info) == 4:                 # the tree's export gives registers
        route, lanes, regs, frame = info
        return (f"{_route_name(route)}, {lanes} lanes per SM, {regs} "
                f"registers, {frame} B local")
    if len(info) == 2:
        return f"{info[1]} lanes per SM"
    fn = getattr(lib, f"{lib_name}_occupancy_{sfx}", None)
    if fn is not None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        return f"{fn(n, m, p)} lanes per SM"
    if lib_name not in probes:
        probes[lib_name] = _occupancy_probe(tree, out_dir, lib_name)
    fn = getattr(probes[lib_name], f"probe_occupancy_{sfx}")
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return f"shared-memory, {fn(n, m, p, NW)} lanes per SM"


def _fwd_only(spec, jb, b, lanes):
    """A closure running K3's forward kernel alone on the first ``lanes``
    lanes (homogeneous specs); it binds the launcher on every call, so that
    ``device_ms`` sees the launch in either kind of tree."""
    from algames_tpu_torch.core.spec import owner_map_u
    from algames_tpu_torch.ops import build, thomas
    lib = build.load(thomas._LIB_DENSE)
    P, I = build.P, build.I
    ops = [a[:lanes].contiguous() for a in (jb.Qblk, jb.Ublk, jb.B, jb.A, b)]
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    G = torch.empty((lanes, T, n + m, p * n), device=b.device)
    yhat = torch.empty((lanes, T, n + m), device=b.device)
    # The owner table: an int32 device array since the libraries lost
    # their by-value tables, a host table before.
    own = (thomas.owner_table(owner_map_u(spec), b.device).data_ptr()
           if hasattr(thomas, "owner_table")
           else build.int_table(owner_map_u(spec)))

    def run():
        # A tree with ``build.launcher`` times launches through its hook, an
        # older one through ``build.bind``: looked up at every call, when
        # the timer may have replaced it.
        bind = getattr(build, "launcher", None) or build.bind
        fwd = bind(lib, "thomas_dense_fwd_f32", [P] * 8 + [I] * 5 + [P])
        build.check(lib, thomas._LIB_DENSE, fwd(
            *[a.data_ptr() for a in ops], own, G.data_ptr(), yhat.data_ptr(),
            lanes, T, n, m, p, torch.cuda.current_stream().cuda_stream))
    return run


def dump(tree, name, out_dir, only=None):
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from algames_tpu_torch.ops import build, thomas
    from algames_tpu_torch.presets import (flagship_unicycle, intro_bicycle,
                                           intro_di, quadrotor3d)
    from algames_tpu_torch.utils import tree_map
    if Path(cs.__file__).resolve().parent != tree:
        raise SystemExit(f"chip_smoke.py was not imported from {tree}")
    tm = _timing()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    k3 = [("round4", {}, 100),
          ("bike3", dict(preset=intro_bicycle,
                         iterates=cs.golden_iterates("bike3_N20")), 400),
          ("hetero", dict(preset=cs.hetero_game,
                          iterates=cs.golden_iterates("hetero2_N8")), 600),
          ("ibr", dict(preset=flagship_unicycle,
                       iterates=cs.flagship_iterates), 700)]
    k1 = [("K1 uni3", {}, 0),
          ("K1 di2", dict(preset=intro_di,
                          iterates=cs.golden_iterates("di2_N10")), 300),
          ("K1 quad2", dict(preset=quadrotor3d,
                            iterates=cs.golden_iterates("quad2_N15")), 500)]
    probes = {}
    lib = build.load(thomas._LIB_DENSE)
    lib_sq = build.load(thomas._LIB)
    res = {}
    t0 = time.perf_counter()
    systems = {"ibr": cs.ibr_player_system}
    if hasattr(cs, "quad_dense_system"):
        k3 += [("quad2 dense", {}, 800), ("ibr quad", {}, 1700)]
        k1 += [("K1 quad3", dict(preset=cs.quad3_game,
                                 iterates=cs.quad3_iterates), 900)]
    if only == "beyond":
        k3, k1 = [], []

        def quad(system):
            return lambda dev, B, mu, seed, *_: system(dev, B, mu, seed)
        systems.update({"quad2 dense": quad(cs.quad_dense_system),
                        "ibr quad": quad(cs.ibr_quad_system)})
    for tag, kw, seed0 in k3:
        print(f"{name} [{time.perf_counter() - t0:.1f} s] K3 {tag}",
              flush=True)
        system = systems.get(tag, cs.k3_system)
        for mu, seed in ((1e3, 99), (1e7, 7)):
            spec, jb, b = system(dev, cs.B_KERNEL, mu, seed0 + seed, False,
                                 (0.3, 1.5), kw.get("preset"),
                                 kw.get("iterates"))
            ref = thomas.solve_thomas_plain(spec, jb, b)
            for dtype in (torch.float64, torch.float32):
                jbt, bt = tree_map(lambda a: a.to(dtype), jb), b.to(dtype)
                y = thomas.solve_thomas(spec, jbt, bt)
                sfx = "f32" if dtype == torch.float32 else "f64"
                key = f"K3 {tag} mu={mu:.0e} {sfx}"
                res[key] = [y.cpu()]
                err = float(cs.rel_err(y, ref).max())
                line = f"{name} {key}: worst rel err vs f64 plain {err:.3e}"
                if mu == 1e3:
                    occ = _occupancy(lib, "thomas_dense", probes, tree,
                                     out_dir, spec.n, spec.p * max(spec.mi),
                                     spec.p, sfx)
                    line += f"; forward kernel {occ}"
                print(line, flush=True)
                if mu == 1e3 and dtype == torch.float32:
                    tm.device_ms(lambda: thomas.solve_thomas(spec, jbt, bt),
                                 20, ("thomas_dense_",), 2,
                                 f"{name} K3 {tag} f32 B={cs.B_KERNEL}")
                    if tag == "round4":
                        for lanes in FWD_BATCHES:
                            tm.device_ms(_fwd_only(spec, jbt, bt, lanes), 20,
                                         ("thomas_dense_",), 1,
                                         f"{name} K3 round4 forward only "
                                         f"f32 B={lanes}")
    for tag, kw, seed0 in k1:
        print(f"{name} [{time.perf_counter() - t0:.1f} s] {tag}", flush=True)
        spec, sq, b, w_owner = cs.k1_system(dev, cs.B_KERNEL, 1e3, seed0 + 99,
                                            False, kw.get("preset"),
                                            kw.get("iterates",
                                                   cs.flagship_iterates))
        ref = thomas.solve_thomas_structured_plain(spec, sq, b, w_owner)
        for dtype in (torch.float64, torch.float32):
            sqt, bt = tree_map(lambda a: a.to(dtype), sq), b.to(dtype)
            y = thomas.solve_thomas_structured(spec, sqt, bt, w_owner)
            res[f"{tag} {str(dtype)[-7:]}"] = [y.cpu()]
            sfx = "f32" if dtype == torch.float32 else "f64"
            occ = _occupancy(lib_sq, "thomas_sq", probes, tree, out_dir,
                             spec.n, spec.m, spec.p, sfx, len(w_owner))
            print(f"{name} {tag} mu=1e+03 {sfx}: worst rel err vs f64 plain "
                  f"{float(cs.rel_err(y, ref).max()):.3e}; forward kernel "
                  f"{occ}", flush=True)
            if dtype == torch.float32:
                tm.device_ms(lambda: thomas.solve_thomas_structured(
                    spec, sqt, bt, w_owner), 20, ("thomas_sq_",), 2,
                    f"{name} {tag} f32 B={cs.B_KERNEL}")
    # Beyond the classes: K1 and K3 on the 4-player quadrotor's systems
    # (d=64) and K1 on the 9-player merge's (d=54, NW=72), on every route
    # that holds them, B=1024; K1 on the 17-player merge's (d=102, NW=272,
    # m=34), on the device-memory route, B=64; f32 and f64.
    both, device = ("blocked", "device"), ("device",)
    beyond = []
    if hasattr(cs, "quad4_game"):
        beyond += [("quad4", cs.quad4_game, cs.quad3_iterates, 950, True,
                    cs.B_KERNEL, both),
                   ("quad4 dense", cs.quad4_game, cs.quad3_iterates, 960,
                    False, cs.B_KERNEL, both)]
    if hasattr(cs, "uni9_game"):
        beyond += [("uni9", cs.uni9_game, cs.flagship_iterates, 2200, True,
                    cs.B_KERNEL, both)]
    if hasattr(cs, "uni17_game"):
        beyond += [("uni17", cs.uni17_game, cs.flagship_iterates, 2600, True,
                    64, device)]
    for tag, game, its, seed0, structured, B, routes in beyond:
        print(f"{name} [{time.perf_counter() - t0:.1f} s] {tag}", flush=True)
        spec, sq, b, w_owner = cs.k1_system(dev, B, 1e3, seed0 + 99, False,
                                            game, its)
        if structured:
            def run(ops, bb, r):
                return thomas.solve_thomas_structured(spec, ops, bb, w_owner,
                                                      r)
            ops, ref = sq, thomas.solve_thomas_structured_plain(
                spec, sq, b, w_owner)
            kkt, names = "K1", ("thomas_sq_",)
        else:
            def run(ops, bb, r):
                return thomas.solve_thomas(spec, ops, bb, r)
            ops = cs.dense_of(spec, sq, w_owner)
            ref = thomas.solve_thomas_plain(spec, ops, b)
            kkt, names = "K3", ("thomas_dense_",)
        for dtype in (torch.float64, torch.float32):
            opt, bt = tree_map(lambda a: a.to(dtype), ops), b.to(dtype)
            sfx = "f32" if dtype == torch.float32 else "f64"
            for r in routes:
                y = run(opt, bt, r)
                key = f"{kkt} {tag} {r} {sfx}"
                res[key] = [y.cpu()]
                print(f"{name} {key}: worst rel err vs f64 plain "
                      f"{float(cs.rel_err(y, ref).max()):.3e}", flush=True)
                tm.device_ms(lambda: run(opt, bt, r), 10, names, 2,
                             f"{name} {key} B={B}")
        del sq, b, ops, ref
        torch.cuda.empty_cache()
    for lib_name in ("thomas_sq", "thomas_dense"):
        log = build.library_path(lib_name).with_suffix(".log")
        for kern, regs, spills in cs.ptxas_report(log.read_text()):
            print(f"{name} {lib_name}: {kern}: {regs} registers, {spills}",
                  flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(res, out_dir / f"{name}-kkt.pt")


def compare(out_dir, a_name, b_name):
    a = torch.load(out_dir / f"{a_name}-kkt.pt")
    b = torch.load(out_dir / f"{b_name}-kkt.pt")
    for key in a:
        if key not in b:
            continue
        unequal = sum(int((x != y).sum()) for x, y in zip(a[key], b[key]))
        worst = max(float((x.double() - y.double()).abs().max())
                    for x, y in zip(a[key], b[key]))
        print(f"{a_name} vs {b_name}, {key}: {unequal} unequal elements of "
              f"{sum(x.numel() for x in a[key])}, max |diff| {worst:.3e}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(Path(sys.argv[2]).resolve(), sys.argv[3], Path(sys.argv[4]),
             *sys.argv[5:])
    else:
        compare(Path(sys.argv[2]), sys.argv[3], sys.argv[4])
