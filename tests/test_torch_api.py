"""The port's package root against the JAX package's: every name the JAX
root imports resolves on ``algames_tpu_torch`` (but the ``jax.jit``
wrappers: the port is eager), the ``Regularizer`` and ``Penalty`` records
(the checks of ``tests/test_aux.py::test_regularizer_penalty_shims``),
``models.step_jacobians_traj`` against the JAX package's (f64, 1e-12
relative), and the converter: a reference ``Options`` field that no
solver path reads converts at any value, to the same problem and the same
solve; any other field the port does not read still raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.models.integration import \
    step_jacobians_traj as jax_step_jacobians_traj
from algames_tpu.presets import PRESETS as JAX_PRESETS

import algames_tpu_torch as agt
from algames_tpu_torch import convert
from algames_tpu_torch.models import step_jacobians_traj
from algames_tpu_torch.problem.options import Options

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_root_exports_the_reference_names():
    names = [n for n in dir(ag) if not n.startswith("_")]
    jit = sorted(n for n in names if n.endswith("_jit"))
    assert jit == ["ibr_newton_solve_jit", "mpc_solve_jit",
                   "newton_solve_jit"]
    missing = [n for n in names if n not in jit and not hasattr(agt, n)]
    assert not missing, missing
    assert all(hasattr(agt, n) for n in agt.__all__)
    assert not any(hasattr(agt, n) for n in jit)


def test_regularizer_penalty_records():
    r = agt.Regularizer().set(2.0)
    assert r.x == r.u == r.lam == 2.0
    r = r.mult(3.0)
    assert r.x == 6.0
    pen = agt.Penalty(rho=5.0)
    assert pen.rho == 5.0 and pen.rho_trial == 1.0
    for cls, ref in ((agt.Regularizer, ag.Regularizer),
                     (agt.Penalty, ag.Penalty)):
        assert [(f.name, f.default) for f in dataclasses.fields(cls)] == [
            (f.name, f.default) for f in dataclasses.fields(ref)]
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(cls(), dataclasses.fields(cls)[0].name, 1.0)


def test_step_jacobians_traj_matches_the_reference():
    rng = np.random.default_rng(4)
    jm, tm = ag.quadrotor_game(p=2), agt.quadrotor_game(p=2)
    T, dt = 6, 0.1
    xs = 0.2 * rng.standard_normal((T, jm.n))
    us = 1.5 + 0.3 * rng.standard_normal((T, jm.m))
    A_r, B_r = jax.jit(lambda x, u: jax_step_jacobians_traj(jm, x, u, dt))(
        jnp.asarray(xs), jnp.asarray(us))
    A, Bm = step_jacobians_traj(tm, torch.as_tensor(xs), torch.as_tensor(us),
                                dt)
    for a, ref in ((A, A_r), (Bm, B_r)):
        ref = np.asarray(ref)
        assert a.shape == ref.shape
        np.testing.assert_allclose(a.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    A2, _ = step_jacobians_traj(tm, torch.as_tensor(xs)[None].repeat(2, 1, 1),
                                torch.as_tensor(us)[None].repeat(2, 1, 1), dt)
    assert A2.shape == (2, T, jm.n, jm.n)
    torch.testing.assert_close(A2[1], A, rtol=0, atol=0)
    with pytest.raises(ValueError, match="knots"):
        step_jacobians_traj(tm, torch.as_tensor(xs),
                            torch.as_tensor(us[:-1]), dt)


UNREAD = {"theta": 0.5, "alpha_increase": 3.0, "rho_trial": 2.0,
          "gamma": 0.5, "inner_print": True, "outer_print": True, "seed": 7}


def test_unread_options_convert():
    """Each field that no solver path reads converts at a value away from
    its default, to the default problem's options; the converted solve
    (outer 1 x 2 here) equals the default one."""
    prob, _ = JAX_PRESETS["uni3_N20"]()
    base = convert.problem_from_reference(prob, CPU, torch.float64)
    defaults = {f.name: f.default for f in dataclasses.fields(ag.Options)}
    assert set(UNREAD) == set(convert._UNREAD_OPTIONS)
    assert set(defaults) == ({f.name for f in dataclasses.fields(Options)}
                             | set(UNREAD) | set(convert._COMPILER_KNOBS))
    for name, value in UNREAD.items():
        assert value != defaults[name]
        changed = dataclasses.replace(prob, opts=dataclasses.replace(
            prob.opts, **{name: value}))
        out = convert.problem_from_reference(changed, CPU, torch.float64)
        assert out.opts == base.opts, name
    short = dataclasses.replace(base, opts=dataclasses.replace(
        base.opts, outer_iter=1, inner_iter=2))
    seeded = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, seed=7, inner_print=True, theta=0.5))
    res_seeded = agt.newton_solve(dataclasses.replace(
        convert.problem_from_reference(seeded, CPU, torch.float64),
        opts=short.opts))
    res = agt.newton_solve(short)
    np.testing.assert_array_equal(res.traj.x.numpy(),
                                  res_seeded.traj.x.numpy())
    np.testing.assert_array_equal(res.stats.data.numpy(),
                                  res_seeded.stats.data.numpy())


def test_other_unread_options_still_raise():
    """A reference ``Options`` with a field the port does not read, beyond
    the compiler knobs and the unread fields, raises when it is set away
    from its default, and converts at its default."""
    Extra = dataclasses.make_dataclass(
        "Extra", [("new_knob", float, dataclasses.field(default=1.0))],
        bases=(ag.Options,), frozen=True)
    prob, _ = JAX_PRESETS["uni3_N20"]()
    ok = dataclasses.replace(prob, opts=Extra(**dataclasses.asdict(
        prob.opts)))
    convert.problem_from_reference(ok, CPU, torch.float64)
    bad = dataclasses.replace(ok, opts=dataclasses.replace(ok.opts,
                                                           new_knob=2.0))
    with pytest.raises(NotImplementedError, match="new_knob"):
        convert.problem_from_reference(bad, CPU, torch.float64)
