"""The port's auxiliary modules against the JAX package's on the same
inputs, on the CPU: ``utils.scn`` and the solver table rows,
``stats.print_stats`` (on the reference's stats carried across),
``checkpoint`` (``.npz`` trajectories crossing both ways bitwise, a
``SolveResult`` round trip bitwise), ``profiling`` (``timed_solve``
bitwise ``newton_solve``'s, one time per trip, within 1e-10 of the
reference's ``timed_solve``; ``phase_profile`` and ``device_trace``), the
quadrotor mesh and the plots on matplotlib's Agg backend.  f64.
"""
import contextlib
import functools
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu import checkpoint as jckpt
from algames_tpu import profiling as jprof
from algames_tpu import stats as jstats
from algames_tpu import utils as jutils
from algames_tpu.plots import mesh as jmesh
from algames_tpu.presets import PRESETS

import algames_tpu_torch as agt
from algames_tpu_torch import checkpoint as tckpt
from algames_tpu_torch import profiling as tprof
from algames_tpu_torch import stats as tstats
from algames_tpu_torch import utils as tutils
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.plots import mesh as tmesh
from algames_tpu_torch.utils import tree_leaves

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


@functools.lru_cache(maxsize=None)
def _di2():
    """The reference's di2_N10 preset (f64), its ``schur`` solve, and the
    problem carried into the port."""
    prob, _ = PRESETS["di2_N10"](dtype=jnp.float64)
    ref = ag.newton_solve_jit(prob, method="schur")
    return prob, ref, problem_from_reference(prob, CPU, torch.float64)


@functools.lru_cache(maxsize=None)
def _port_solve():
    return agt.newton_solve(_di2()[2])


@pytest.mark.parametrize("digits", [0, 1, 2, 3])
def test_scn_matches_reference(digits):
    for a in (0.0, 1.0, -1.0, 123.4, -0.00123, 9.99e-7, 1e-300, 1e300,
              -7.5e12, float("inf"), float("-inf"), float("nan"), 0.95,
              9.96, -9.95e-5, 5e-324):
        try:
            ref = jutils.scn(a, digits)
        except (ArithmeticError, ValueError) as e:   # the reference raises
            with pytest.raises(type(e)):
                tutils.scn(a, digits)
            continue
        assert tutils.scn(a, digits) == ref, (a, digits)


def test_display_rows_match_reference():
    assert (_printed(tutils.display_solver_header)
            == _printed(jutils.display_solver_header))
    for row in ((0, 1, 2, 1e-3, 0.5, 1e-7), (12, 19, 0, 0.0, 3.25e4, 2.0),
                (3, 0, 9, float("nan"), 1e-300, -1e-2)):
        assert (_printed(tutils.display_solver_data, *row)
                == _printed(jutils.display_solver_data, *row))


def test_print_stats_matches_reference():
    """The reference's stats of a solve, carried into the port's per-lane
    layout (as lane 1 of two), print the same text, with and without the
    header."""
    _, ref, _ = _di2()
    s = ref.stats
    data = torch.as_tensor(np.array(s.data))
    outer = torch.as_tensor(np.array(s.outer))
    stats = tstats.Statistics(
        iter=torch.as_tensor([0, int(s.iter)], dtype=torch.int32),
        outer=torch.stack([torch.zeros_like(outer), outer]),
        data=torch.stack([torch.zeros_like(data), data]))
    for header in (True, False):
        text = _printed(tstats.print_stats, stats, lane=1, header=header)
        assert text == _printed(jstats.print_stats, s, header=header)
        assert len(text.splitlines()) == int(s.iter) + header


def test_traj_npz_crosses_both_ways(tmp_path):
    """A trajectory file of either package loads bitwise in the other, and
    in the dtype asked for."""
    rng = np.random.default_rng(0)
    x, u, lam = (rng.standard_normal(s) for s in ((6, 8), (5, 4), (2, 5, 8)))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_traj(jpath, ag.PrimalDual(x=jnp.asarray(x), u=jnp.asarray(u),
                                         lam=jnp.asarray(lam)))
    back = tckpt.load_traj(jpath, device=CPU)
    for a, r in zip((back.x, back.u, back.lam), (x, u, lam)):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), r)
    assert tckpt.load_traj(jpath, dtype=torch.float32, device=CPU).x.dtype \
        == torch.float32
    tr = agt.PrimalDual(x=torch.as_tensor(x)[None], u=torch.as_tensor(u)[None],
                        lam=torch.as_tensor(lam)[None])
    tckpt.save_traj(tpath, tr)
    jback = jckpt.load_traj(tpath)
    for a, r in zip((jback.x, jback.u, jback.lam), (x, u, lam)):
        np.testing.assert_array_equal(np.asarray(a), r[None])


def test_solve_result_pytree_roundtrip(tmp_path):
    """A SolveResult written by ``save_pytree`` restores bitwise onto its
    own structure: every leaf, dtype and device; the file has the JAX
    fallback's ``leaf_{i}`` layout."""
    res = _port_solve()
    path = str(tmp_path / "res")
    tckpt.save_pytree(path, res)
    back = tckpt.restore_pytree(path, res)
    leaves, bleaves = tree_leaves(res), tree_leaves(back)
    assert len(leaves) == len(bleaves)
    for a, b in zip(leaves, bleaves):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    with np.load(path + ".npz") as z:
        assert sorted(z.files) == sorted(f"leaf_{i}"
                                         for i in range(len(leaves)))


def test_timed_solve_matches_newton_solve_and_reference():
    prob, ref, tprob = _di2()
    res = _port_solve()
    out, t_elap = tprof.timed_solve(tprob)
    for a, b in zip(tree_leaves(out), tree_leaves(res)):
        assert torch.equal(a, b)
    assert len(t_elap) == int(out.stats.iter[0]) - 1
    assert all(t > 0 for t in t_elap)
    jout, jt = jprof.timed_solve(prob, method="schur")
    assert int(out.stats.iter[0]) == int(jout.stats.iter) == int(ref.stats.iter)
    assert len(jt) == len(t_elap)
    np.testing.assert_allclose(out.traj.x[0].numpy(), np.asarray(jout.traj.x),
                               rtol=1e-10, atol=1e-10)


def test_phase_profile_and_device_trace(tmp_path):
    a = torch.ones((64, 64), dtype=torch.float64)
    res = tprof.phase_profile({"sum": lambda: a.sum(), "mm": lambda: a @ a},
                              reps=3)
    assert set(res) == {"sum", "mm"} and all(v >= 0.0 for v in res.values())
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        (a @ a).sum()
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


def test_quadrotor_mesh_matches_reference(tmp_path):
    v, f = tmesh.quadrotor_mesh()
    jv, jf = jmesh.quadrotor_mesh()
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    tpath = tmesh.write_obj(str(tmp_path / "t.obj"))
    jpath = jmesh.write_obj(str(tmp_path / "j.obj"))
    assert open(tpath).read() == open(jpath).read()


def test_video_to_gif_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    for mod in (tutils, jutils):
        with pytest.raises(FileNotFoundError):
            mod.convert_video_to_gif("in.mp4", str(tmp_path / "out.gif"))


def test_plots_match_reference():
    """On the Agg backend, the port's trajectory and violation plots of a
    solve draw the reference's lines (the same data through the JAX
    package's plots)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from algames_tpu.plots import plot_trajectory as jtraj
    from algames_tpu.plots import plot_violations as jvio
    from algames_tpu_torch.plots import plot_trajectory, plot_violations

    prob, _, tprob = _di2()
    res = _port_solve()
    jt = ag.PrimalDual(x=jnp.asarray(res.traj.x[0].numpy()),
                       u=jnp.asarray(res.traj.u[0].numpy()),
                       lam=jnp.asarray(res.traj.lam[0].numpy()))
    js = jstats.Statistics(iter=jnp.asarray(int(res.stats.iter[0])),
                           outer=jnp.asarray(res.stats.outer[0].numpy()),
                           data=jnp.asarray(res.stats.data[0].numpy()))
    for ours, theirs in ((plot_trajectory(tprob.spec, res.traj),
                          jtraj(prob.spec, jt)),
                         (plot_violations(res.stats), jvio(js))):
        assert len(ours.lines) == len(theirs.lines) > 0
        for a, b in zip(ours.lines, theirs.lines):
            assert a.get_label() == b.get_label()
            np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
        assert len(ours.patches) == len(theirs.patches)
    plt.close("all")
