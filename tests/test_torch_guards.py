"""Guards of the PyTorch port: it never imports JAX, it has no CPU fallback
for its kernels, and ``chip_smoke.py`` refuses to report without a card."""
import dataclasses
import inspect
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.ops.thomas import solve_thomas, solve_thomas_structured
from algames_tpu_torch.ops.trial import trial_eval, trial_supported
from algames_tpu_torch.ops import build
from algames_tpu_torch.presets import PRESETS, flagship_unicycle, roundabout

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "algames_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG],
                                                        "algames_tpu_torch."))


def test_imports_with_jax_blocked():
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "import algames_tpu_torch; "
            f"[importlib.import_module(m) for m in {_modules()!r}]; "
            "assert not any(k == 'jax' or k.startswith(('jax.', "
            "'algames_tpu.')) for k, v in sys.modules.items() "
            "if v is not None); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_sources():
    """No source of the package, nor ``chip_smoke.py``, the port's examples
    or the rank functions of its distributed tests, imports JAX or the
    JAX package."""
    pat = re.compile(r"^\s*(import\s+(jax|algames_tpu)\b"
                     r"|from\s+(jax|algames_tpu)[\s.])")
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_ranks.py")]
    for folder in (PKG, os.path.join(REPO, "examples_torch")):
        for root, _, files in os.walk(folder):
            paths += [os.path.join(root, f) for f in files
                      if f.endswith(".py")]
    assert os.path.join(PKG, "parallel", "horizon.py") in paths
    assert os.path.join(REPO, "examples_torch",
                        "long_horizon_example.py") in paths
    assert os.path.join(PKG, "problem", "ibr.py") in paths
    assert os.path.join(PKG, "models", "hetero.py") in paths
    assert os.path.join(PKG, "mpc.py") in paths
    offenders = []
    for path in paths:
        with open(path) as fh:
            offenders += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                          if pat.match(line)]
    assert not offenders, offenders


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (and, alone, no package beside it): non-zero exit, no ok."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout + out.stderr


def test_cpu_solve_launches_no_kernel():
    """CPU solves with the fused trial run the plain versions: no kernel's
    launch counter moves, on any preset (the flagship and the double
    integrator and quadrotor: K1, K2/K4; the roundabout and the bicycle: K3,
    K4)."""
    cpu = torch.device("cpu")
    problems = [flagship_unicycle(cpu, torch.float64, outer=1, inner=2, p=2,
                                  N=5)]
    problems += [PRESETS[k](cpu, torch.float64, outer=1, inner=2)
                 for k in ("round4_N40", "di2_N10", "bike3_N20", "quad2_N15")]
    counters = (solve_thomas_structured, solve_thomas, trial_eval)
    before = [c.launches for c in counters]
    for pr, sp in problems:
        pr = dataclasses.replace(pr, opts=dataclasses.replace(pr.opts,
                                                              ls_fused=True))
        assert trial_supported(pr.model, sp, pr.obj, pr.gc)
        out = agt.newton_solve(pr, pr.x0[None].repeat(2, 1))
        assert out.traj.x.shape == (2, sp.N, sp.n)
        assert bool(torch.isfinite(out.traj.x).all())
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_cpu_hetero_and_ibr_solves_launch_no_kernel():
    """A CPU solve of the heterogeneous game (padded K3 and the fused
    trial's player-blocked instance, both as plain versions) and a CPU IBR
    solve (K3 at p=1) move no kernel's launch counter."""
    from chip_smoke import hetero_game
    cpu = torch.device("cpu")
    counters = (solve_thomas_structured, solve_thomas, trial_eval)
    before = [c.launches for c in counters]
    prob, spec = hetero_game(cpu, torch.float64, outer=1, inner=3)
    prob = dataclasses.replace(prob, opts=dataclasses.replace(prob.opts,
                                                              ls_fused=True))
    assert trial_supported(prob.model, spec, prob.obj, prob.gc)
    out = agt.newton_solve(prob, prob.x0[None].repeat(2, 1))
    assert bool(torch.isfinite(out.traj.x).all())
    prob, spec = flagship_unicycle(cpu, torch.float64, outer=1, inner=2, p=2,
                                   N=5)
    out = agt.ibr_newton_solve(prob, agt.IBROptions(ibr_iter=2),
                               x0s=prob.x0[None].repeat(2, 1))
    assert out.traj.x.shape == (2, spec.N, spec.n)
    assert bool(torch.isfinite(out.traj.x).all())
    assert [c.launches for c in counters] == before == [0, 0, 0]


@pytest.mark.parametrize("ls_fused", [False, True])
def test_cpu_mpc_launches_no_kernel(ls_fused):
    """A CPU closed loop of the highway (cut to N=6, 2 scenarios, 2
    replans; K1, and the fused trial's unicycle instance with
    ``ls_fused``, both as plain versions) moves no kernel's launch
    counter."""
    from chip_smoke import highway_game
    prob, spec = highway_game(torch.device("cpu"), torch.float64, N=6)
    prob = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, ls_fused=ls_fused))
    assert trial_supported(prob.model, spec, prob.obj, prob.gc)
    counters = (solve_thomas_structured, solve_thomas, trial_eval)
    before = [c.launches for c in counters]
    out = agt.mpc_solve(prob, prob.x0[None].repeat(2, 1), horizon=2)
    assert out.states.shape == (2, 3, spec.n)
    assert bool(torch.isfinite(out.states).all())
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_highway_game_matches_reference(monkeypatch):
    """``chip_smoke.highway_game`` builds the problem of
    ``benchmarks/bench_mpc.py::make_problem`` (BASELINE config 3) at its
    published size: spec, model, options and every leaf equal to the
    reference's problem carried over."""
    import importlib.util
    import jax.numpy as jnp
    import algames_tpu
    from algames_tpu_torch.convert import problem_from_reference
    from algames_tpu_torch.utils import tree_leaves
    from chip_smoke import highway_game
    monkeypatch.setenv("PLATFORM", "cpu")
    mod = importlib.util.spec_from_file_location(
        "bench_mpc", os.path.join(REPO, "benchmarks", "bench_mpc.py"))
    bench = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(bench)
    cpu = torch.device("cpu")
    ref = problem_from_reference(
        bench.make_problem(algames_tpu, jnp.float64)[0], cpu, torch.float64)
    prob, spec = highway_game(cpu, torch.float64)
    assert (spec.N, spec.n, spec.m, spec.p) == (20, 12, 6, 3)
    assert spec == ref.spec and prob.opts == ref.opts
    assert prob.model == ref.model
    for a, r in zip(tree_leaves((prob.x0, prob.obj, prob.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc)), strict=True):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for a, r in zip(prob.gc.state_blocks + prob.gc.control_blocks,
                    ref.gc.state_blocks + ref.gc.control_blocks,
                    strict=True):
        assert (a.owner, a.is_state) == (r.owner, r.is_state)


def test_hetero_spec_takes_the_kernel_route(monkeypatch):
    """On a card tensor, K3's wrapper sends a heterogeneous spec to the
    kernel padded and never to its plain version.  Checked statically: the
    device route is forced to the kernel, the launch is replaced by the
    plain solver on the padded system (the unchanged kernel's contract:
    m = p max(mi) control rows owned r // max(mi)), and the plain version
    raises if called.  The wrapper's gathered result equals the plain
    version's padded solve of the original system."""
    from chip_smoke import hetero_game
    from algames_tpu_torch.constraints.sets import reset_constraints
    from algames_tpu_torch.core.spec import ProblemSpec
    from algames_tpu_torch.ops import thomas
    from algames_tpu_torch.problem import residual as R
    from algames_tpu_torch.problem.linear_solver import (
        JacBlocks, solve_tridiagonal_schur)
    cpu = torch.device("cpu")
    prob, spec = hetero_game(cpu, torch.float64)
    gen = torch.Generator().manual_seed(3)
    x = 0.3 * torch.randn((2, spec.N, spec.n), generator=gen,
                          dtype=torch.float64)
    traj = agt.PrimalDual(x=x, u=0.3 * torch.randn(
        (2, spec.T, spec.m), generator=gen, dtype=torch.float64),
        lam=0.3 * torch.randn((2, spec.p, spec.T, spec.n), generator=gen,
                              dtype=torch.float64))
    gc = reset_constraints(prob.gc, 2)
    pd = R.point_data(prob.model, spec, prob.obj, gc, traj)
    res, jb, _, _ = R.assemble_from_point(spec, prob.obj, gc, traj, pd, 1e-3)
    jb = JacBlocks(*[getattr(jb, f).contiguous()
                     for f in ("Qblk", "Ublk", "A", "B")])
    b = (-R.residual_knot_blocks(spec, res)).contiguous()
    want = solve_tridiagonal_schur(spec, jb, b)
    launched = []

    def fake_launch(Q, Ub, Bm, A, bk, owner, n, m, p):
        mm = m // p
        assert (m, list(owner)) == (4, [0, 0, 1, 1])
        assert Ub.shape[-1] == Bm.shape[-1] == m and bk.is_contiguous()
        padded = ProblemSpec(N=spec.N, n=n, m=m, p=p, ni=spec.ni,
                             mi=(mm,) * p, pu=((0, 1), (2, 3)), px=spec.px,
                             pz=spec.pz, dt=spec.dt)
        launched.append(m)
        return solve_tridiagonal_schur(padded, JacBlocks(Q, Ub, A, Bm),
                                       bk).reshape(bk.shape[0], spec.T, -1)

    def plain(*_):
        raise AssertionError("the plain version ran for a card tensor")
    monkeypatch.setattr(thomas, "_route", lambda t: "kernel")
    monkeypatch.setattr(thomas, "_launch_dense", fake_launch)
    monkeypatch.setattr(thomas, "solve_thomas_plain", plain)
    monkeypatch.setattr(thomas, "solve_tridiagonal_schur", plain)
    before = solve_thomas.launches
    y = thomas.solve_thomas(spec, jb, b)
    assert launched == [4] and solve_thomas.launches == before + 1
    torch.testing.assert_close(y, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="homogeneous"):
        thomas.solve_thomas_structured(spec, None, b, ())
    solve_thomas.launches = before


def test_k1_route_is_chosen_by_shape(monkeypatch):
    """On a card tensor, K1's wrapper picks its forward kernel by shape
    before the launch, as the library's ``thomas_sq_route`` says: the
    register-tiled one (0), the shared-memory one (1, counted by
    ``wide_launches``), the device-memory one (2, counted by
    ``global_launches``, with a workspace) or the per-player blocked one
    (3, counted by ``blocked_launches``); none (-1) raises.  It asks once
    per shape and dtype, keeps its launchers, never takes the plain
    version, and raises on a launch error.  ``forward="blocked"`` takes the
    blocked route without asking the library, in K3's library too.  Checked
    with a fake library whose launchers record their names and whose
    backward launcher writes the plain solution."""
    import contextlib
    import ctypes
    import types
    import chip_smoke
    from algames_tpu_torch.ops import thomas
    spec, sq, b, w_owner = chip_smoke.k1_system(torch.device("cpu"), 2, 1e3,
                                                7)
    want = {dt: thomas.solve_thomas_structured_plain(
        spec, type(sq)(*[getattr(sq, f).to(dt) for f in
                         ("qdiag", "wv", "Ublk", "A", "B")]), b.to(dt),
        w_owner) for dt in (torch.float64, torch.float32)}
    calls, state = [], {"route": 0, "err": 0, "dtype": torch.float64}

    class Export:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append(self.name)
            if "error_string" in self.name:
                return b"launch refused"
            if "_route_" in self.name:
                return state["route"]
            if "_bwd_" in self.name:
                y = want[state["dtype"]]
                ctypes.memmove(args[8], y.data_ptr(),
                               y.numel() * y.element_size())
            return state["err"] if "_fwd_" in self.name else 0

    class Library:
        def __getattr__(self, name):
            return Export(name)

    def plain(*_):
        raise AssertionError("the plain version ran for a card tensor")
    monkeypatch.setattr(thomas, "_route", lambda t: "kernel")
    monkeypatch.setattr(thomas.build, "load", lambda name: Library())
    monkeypatch.setattr(thomas, "solve_thomas_structured_plain", plain)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    thomas._shape_route.cache_clear()
    thomas._sq_launch.cache_clear()
    launches = solve_thomas_structured.launches
    wide = solve_thomas_structured.wide_launches
    dev_mem = solve_thomas_structured.global_launches
    blocked = solve_thomas_structured.blocked_launches
    sq32 = type(sq)(*[getattr(sq, f).float() for f in
                      ("qdiag", "wv", "Ublk", "A", "B")])
    try:
        for _ in range(2):
            y = thomas.solve_thomas_structured(spec, sq, b, w_owner)
            torch.testing.assert_close(y, want[torch.float64], rtol=0,
                                       atol=0)
        assert calls == ["thomas_sq_route_f64", "thomas_sq_fwd_f64",
                         "thomas_sq_bwd_f64", "thomas_sq_fwd_f64",
                         "thomas_sq_bwd_f64"]
        assert solve_thomas_structured.wide_launches == wide
        calls.clear()
        state.update(route=1, dtype=torch.float32)
        y = thomas.solve_thomas_structured(spec, sq32, b.float(), w_owner)
        torch.testing.assert_close(y, want[torch.float32], rtol=0, atol=0)
        assert calls == ["thomas_sq_route_f32",
                         "thomas_sq_fwd_wide_f32", "thomas_sq_bwd_f32"]
        assert solve_thomas_structured.wide_launches == wide + 1
        assert solve_thomas_structured.launches == launches + 3
        calls.clear()
        thomas._shape_route.cache_clear()
        thomas._sq_launch.cache_clear()
        state["route"] = 2
        y = thomas.solve_thomas_structured(spec, sq32, b.float(), w_owner)
        torch.testing.assert_close(y, want[torch.float32], rtol=0, atol=0)
        assert calls == ["thomas_sq_route_f32",
                         "thomas_sq_fwd_global_f32", "thomas_sq_bwd_f32"]
        assert solve_thomas_structured.global_launches == dev_mem + 1
        assert solve_thomas_structured.wide_launches == wide + 1
        assert solve_thomas_structured.blocked_launches == blocked
        calls.clear()
        thomas._shape_route.cache_clear()
        thomas._sq_launch.cache_clear()
        state["route"] = 3                   # the blocked route
        for dt, sys_ in ((torch.float32, (sq32, b.float())),
                         (torch.float64, (sq, b))):
            state["dtype"] = dt
            y = thomas.solve_thomas_structured(spec, *sys_, w_owner)
            torch.testing.assert_close(y, want[dt], rtol=0, atol=0)
        assert calls == ["thomas_sq_route_f32", "thomas_sq_fwd_blocked_f32",
                         "thomas_sq_bwd_f32", "thomas_sq_route_f64",
                         "thomas_sq_fwd_blocked_f64", "thomas_sq_bwd_f64"]
        assert solve_thomas_structured.blocked_launches == blocked + 2
        assert (solve_thomas_structured.wide_launches,
                solve_thomas_structured.global_launches) == (wide + 1,
                                                             dev_mem + 1)
        calls.clear()
        state.update(route=0, dtype=torch.float32)   # by name, not by shape
        y = thomas.solve_thomas_structured(spec, sq32, b.float(), w_owner,
                                           forward="blocked")
        torch.testing.assert_close(y, want[torch.float32], rtol=0, atol=0)
        assert calls == ["thomas_sq_fwd_blocked_f32", "thomas_sq_bwd_f32"]
        assert solve_thomas_structured.blocked_launches == blocked + 3
        assert solve_thomas_structured.launches == launches + 7
        with pytest.raises(ValueError, match="unknown forward route"):
            thomas.solve_thomas_structured(spec, sq32, b.float(), w_owner,
                                           forward="tiled")
        assert thomas._pick_route(thomas._LIB_DENSE, torch.float32,
                                  (spec.n, spec.m, spec.p),
                                  "blocked") == "blocked"
        thomas._shape_route.cache_clear()
        thomas._sq_launch.cache_clear()
        state["route"] = -1
        with pytest.raises(ValueError, match="no forward kernel"):
            thomas.solve_thomas_structured(spec, sq32, b.float(), w_owner)
        state["route"] = 0
        state["err"] = 700
        with pytest.raises(RuntimeError, match="launch refused"):
            thomas.solve_thomas_structured(spec, sq, b, w_owner)
    finally:
        thomas._shape_route.cache_clear()
        thomas._sq_launch.cache_clear()
        solve_thomas_structured.launches = launches
        solve_thomas_structured.wide_launches = wide
        solve_thomas_structured.global_launches = dev_mem
        solve_thomas_structured.blocked_launches = blocked


def test_k3_route_is_chosen_by_shape(monkeypatch):
    """On a card tensor, K3's wrapper picks its forward kernel by shape
    before the launch, as the library's ``thomas_dense_route`` says: the
    register-tiled one (0), the per-player blocked one (3, counted by
    ``blocked_launches``, no workspace), the shared-memory one (1, counted
    by ``big_launches``) or the device-memory one (2, counted by
    ``global_launches``, with a workspace); none (-1) raises.  It asks once
    per shape and dtype, never takes the plain version, and raises on a
    launch error; ``forward="blocked"`` takes the blocked route without
    asking.  Checked with a fake library whose launchers record their names
    and argument counts and whose backward launcher writes the plain
    solution."""
    import contextlib
    import ctypes
    import types
    import chip_smoke
    from algames_tpu_torch.ops import thomas
    spec, sq, b, w_owner = chip_smoke.k1_system(torch.device("cpu"), 2, 1e3,
                                                11)
    jb = chip_smoke.dense_of(spec, sq, w_owner)
    jbs = {torch.float64: (jb, b),
           torch.float32: (type(jb)(*[getattr(jb, f).float() for f in
                                      ("Qblk", "Ublk", "A", "B")]),
                           b.float())}
    want = {dt: thomas.solve_thomas_plain(spec, *sys_)
            for dt, sys_ in jbs.items()}
    calls, state = [], {"route": 3, "err": 0, "dtype": torch.float64}

    class Export:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            if "error_string" in self.name:
                return b"launch refused"
            calls.append((self.name, len(args)))
            if "_route_" in self.name:
                return state["route"]
            if "_bwd_" in self.name:
                y = want[state["dtype"]]
                ctypes.memmove(args[5], y.data_ptr(),
                               y.numel() * y.element_size())
            return state["err"] if "_fwd_" in self.name else 0

    class Library:
        def __getattr__(self, name):
            return Export(name)

    def plain(*_):
        raise AssertionError("the plain version ran for a card tensor")
    monkeypatch.setattr(thomas, "_route", lambda t: "kernel")
    monkeypatch.setattr(thomas.build, "load", lambda name: Library())
    monkeypatch.setattr(thomas, "solve_thomas_plain", plain)
    monkeypatch.setattr(thomas, "solve_tridiagonal_schur", plain)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    counts = ("launches", "blocked_launches", "big_launches",
              "global_launches")
    before = {c: getattr(solve_thomas, c) for c in counts}

    def took():
        return {c: getattr(solve_thomas, c) - before[c] for c in counts}

    def solve(dt, forward="auto"):
        state["dtype"] = dt
        y = thomas.solve_thomas(spec, *jbs[dt], forward)
        torch.testing.assert_close(y, want[dt], rtol=0, atol=0)
    thomas._shape_route.cache_clear()
    try:
        for dt in (torch.float64, torch.float32, torch.float64):
            solve(dt)
        assert calls == [
            ("thomas_dense_route_f64", 3), ("thomas_dense_fwd_blocked_f64", 14),
            ("thomas_dense_bwd_f64", 12), ("thomas_dense_route_f32", 3),
            ("thomas_dense_fwd_blocked_f32", 14), ("thomas_dense_bwd_f32", 12),
            ("thomas_dense_fwd_blocked_f64", 14), ("thomas_dense_bwd_f64", 12)]
        assert took() == {"launches": 3, "blocked_launches": 3,
                          "big_launches": 0, "global_launches": 0}
        calls.clear()
        thomas._shape_route.cache_clear()
        state["route"] = 0                   # by name, not by shape
        solve(torch.float32, "blocked")
        assert calls == [("thomas_dense_fwd_blocked_f32", 14),
                         ("thomas_dense_bwd_f32", 12)]
        solve(torch.float32)
        assert calls[2:] == [("thomas_dense_route_f32", 3),
                             ("thomas_dense_fwd_f32", 14),
                             ("thomas_dense_bwd_f32", 12)]
        assert took()["blocked_launches"] == 4
        calls.clear()
        for code, name, nargs, counter in ((1, "big_", 14, "big_launches"),
                                           (2, "global_", 15,
                                            "global_launches")):
            thomas._shape_route.cache_clear()
            state["route"] = code
            solve(torch.float64)
            assert calls == [("thomas_dense_route_f64", 3),
                             (f"thomas_dense_fwd_{name}f64", nargs),
                             ("thomas_dense_bwd_f64", 12)]
            assert took()[counter] == 1
            calls.clear()
        assert took() == {"launches": 7, "blocked_launches": 4,
                          "big_launches": 1, "global_launches": 1}
        thomas._shape_route.cache_clear()
        state["route"] = -1
        with pytest.raises(ValueError, match="no forward kernel"):
            solve(torch.float64)
        state.update(route=3, err=700)
        with pytest.raises(RuntimeError, match="launch refused"):
            solve(torch.float32, "blocked")
    finally:
        thomas._shape_route.cache_clear()
        for c, v in before.items():
            setattr(solve_thomas, c, v)


def test_presets_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU: every preset's device defaults to CUDA."""
    assert sorted(PRESETS) == ["bike3_N20", "di2_N10", "quad2_N15",
                               "round4_N40", "uni3_N20"]
    for fn in PRESETS.values():
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernel_libraries_have_sources():
    """Every library a wrapper loads is a source of ``csrc/`` with its own
    error-string export, and every source is loaded by some wrapper."""
    from algames_tpu_torch.ops import thomas, trial
    libs = {trial._LIB, *(v for k, v in vars(thomas).items()
                          if k.startswith("_LIB"))}
    sources = {p.stem for p in build.CSRC_DIR.glob("*.cu")}
    assert libs == sources == {"thomas_sq", "thomas_dense", "trial_fused"}
    for name in sources:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert f'extern "C" const char* {name}_error_string' in text


@pytest.mark.parametrize("p", [9, 10, 17])
def test_k1_owner_tables_come_from_the_spec(monkeypatch, p):
    """K1's wrapper builds its tables from the spec at any number of
    control rows and w vectors (the 9-, 10- and 17-player merges: 18, 20
    and 34 rows, 72, 90 and 272 vectors): the control rows' owners and the
    w vectors' owners as int32 arrays of lengths m and NW on the operands'
    device, built once per shape; no table of a fixed size bounds m or NW.
    Checked with a fake library."""
    from algames_tpu_torch.ops import thomas
    from algames_tpu_torch.problem.residual import structured_w_owner

    class Library:
        def __getattr__(self, name):
            return (lambda *a: 3) if "_route_" in name else (lambda *a: 0)
    monkeypatch.setattr(thomas.build, "load", lambda name: Library())
    monkeypatch.setattr(thomas.build, "bind",
                        lambda lib, fn, argtypes: getattr(lib, fn))
    thomas._shape_route.cache_clear()
    thomas._sq_launch.cache_clear()
    try:
        prob, spec = flagship_unicycle(torch.device("cpu"), torch.float64,
                                       outer=1, inner=1, p=p, N=3)
        w_owner = structured_w_owner(prob.gc)
        assert len(w_owner) == p * (p - 1)
        route, _, _, _, owner, w_own = thomas._sq_launch(
            spec, w_owner, torch.float32, torch.device("cpu"))
        assert route == "blocked"
        assert owner.dtype == torch.int32 and owner.device.type == "cpu"
        assert owner.tolist() == [r % p for r in range(spec.m)]
        assert w_own.dtype == torch.int32 and w_own.device.type == "cpu"
        assert w_own.tolist() == list(w_owner)
        assert sorted(set(w_own.tolist())) == list(range(p))
        again = thomas._sq_launch(spec, w_owner, torch.float32,
                                  torch.device("cpu"))
        assert again[4] is owner and again[5] is w_own
    finally:
        thomas._shape_route.cache_clear()
        thomas._sq_launch.cache_clear()


@pytest.mark.parametrize("p", [9, 10, 17])
def test_trial_tables_at_many_state_blocks(p):
    """The fused trial takes the 9-, 10- and 17-player merges (72, 90 and
    272 state blocks, 36, 40 and 68 states: the unicycle's wide
    instance), and its state-block table holds every block as the
    kernel's 32-byte ``SBlock`` record, in block order; with a state bound
    on all n states appended, the wide instance's: every row's flag after
    its z_max and z_min in the parameter array (past the 64 rows of the
    record's mask, and past the 128th row at 17 players), the mask 0; the
    unicycle's narrow instances' (``flags`` off): the mask, and no flags."""
    import numpy as np
    from algames_tpu_torch.constraints import sets as tsets
    from algames_tpu_torch.ops import trial
    prob, spec = flagship_unicycle(torch.device("cpu"), torch.float64,
                                   outer=1, inner=1, p=p, N=3)
    n = spec.n
    gc = tsets.add_state_bound(spec, prob.gc, 0, 5 * np.ones(n),
                               -5 * np.ones(n))
    assert trial.trial_supported(prob.model, spec, prob.obj, gc)
    assert trial.instance_name(prob.model, spec) == "unicycle_wide"
    assert "unicycle_wide" in trial._ROW_FLAGS
    sb = gc.state_blocks
    nsb = len(sb)
    assert nsb == p * (p - 1) + 1
    meta, masks, spar, rows = trial._state_tables(sb, torch.float64,
                                                  torch.device("cpu"), True)
    assert len(meta) == 12 * nsb and len(masks) == nsb
    assert rows == sum(b.lam.shape[-1] for b in sb) == p * (p - 1) + 2 * n
    rec = trial._sblock_table(meta, masks)
    assert rec.dtype.itemsize == 32 and rec.shape == (nsb,)
    for k, blk in enumerate(sb[:-1]):          # collision blocks
        par = blk.params
        assert (rec["kind"][k], rec["owner"][k], rec["row"][k],
                rec["cnt"][k], rec["eq"][k]) == (0, blk.owner, k, 2, 0)
        assert list(rec["a"][k]) == [*par.pxi, 0, *par.pxj, 0]
        assert rec["mask"][k] == 0
    assert rec["kind"][-1] == 2 and rec["row"][-1] == p * (p - 1)
    assert int(rec["mask"][-1]) == 0
    par = int(rec["par"][-1])
    assert par == p * (p - 1) and spar.numel() == par + 4 * n
    assert spar[par:].tolist() == [5.0] * n + [-5.0] * n + [1.0] * (2 * n)
    dev = trial._sblock_device(tuple(meta), tuple(masks),
                               torch.device("cpu"))
    assert dev.dtype == torch.uint8 and dev.numel() == 32 * nsb
    assert bytes(dev.numpy()) == rec.tobytes()
    # Without flags (the instances up to 32 states): the mask, at 8 players
    # (n = 32) all 64 bits, and z_max, z_min alone.
    prob8, spec8 = flagship_unicycle(torch.device("cpu"), torch.float64,
                                     outer=1, inner=1, p=8, N=3)
    gc8 = tsets.add_state_bound(spec8, prob8.gc, 0, 5 * np.ones(32),
                                -5 * np.ones(32))
    assert trial.instance_name(prob8.model, spec8) == "unicycle_spread"
    assert "unicycle_spread" not in trial._ROW_FLAGS
    meta, masks, spar, _ = trial._state_tables(
        gc8.state_blocks, torch.float64, torch.device("cpu"))
    rec = trial._sblock_table(meta, masks)
    assert int(rec["mask"][-1]) == (1 << 64) - 1
    assert spar.numel() == int(rec["par"][-1]) + 64


def test_trial_meta_table_layout():
    """The collision-cost pairs and control blocks reach the fused trial as
    ``csrc/trial_fused.cu``'s ``TrialMeta`` table of bytes: 8-byte ``Pair``
    records (owner, dimension, pxi then pxj, zero-padded to 3 each), each
    control block's 2m row flags, each control block's equality flag, zeros
    to the next 8 bytes (8 zero bytes for an empty table).  On the
    roundabout (collision-cost pairs, one control bound) and a made-up table
    of two control blocks, one of them equality rows, at 40 controls (past
    the 32 that the by-value table held)."""
    import numpy as np
    from algames_tpu_torch.ops import trial
    assert trial.PAIR.itemsize == 8
    assert list(trial._meta_table((), (), ())) == [0] * 8
    pairs = ((3, (0, 1), (4, 5)), (1, (2, 3, 6), (7, 8, 9)))
    m = 40
    mask = tuple([1] * m + [0] * m) + tuple([0, 1] * m)
    tab = trial._meta_table(pairs, mask, (0, 1))
    assert tab.dtype == np.uint8
    assert list(tab[:16]) == [3, 2, 0, 1, 0, 4, 5, 0, 1, 3, 2, 3, 6, 7, 8, 9]
    assert list(tab[16:16 + 4 * m]) == list(mask)
    assert list(tab[16 + 4 * m:18 + 4 * m]) == [0, 1]
    assert len(tab) == 184 and not tab[18 + 4 * m:].any()
    prob, spec = roundabout(torch.device("cpu"))
    args = trial._meta_args(prob.obj, prob.gc.control_blocks)
    npair, ncb = len(prob.obj.pair_i), len(prob.gc.control_blocks)
    assert len(args[0]) == npair > 0 and len(args[2]) == ncb == 1
    tab = trial._meta_table(*args)
    rec = np.frombuffer(tab[:8 * npair].tobytes(), trial.PAIR)
    assert rec["owner"].tolist() == list(prob.obj.pair_i)
    assert all(int(rec["dim"][k]) == len(prob.obj.pxi[k]) == 2
               for k in range(npair))
    flags = tab[8 * npair:8 * npair + 2 * spec.m]
    assert flags.tolist() == [int(f) for f in
                              prob.gc.control_blocks[0].params.mask]
    assert len(tab) % 8 == 0
