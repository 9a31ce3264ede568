"""Carry a reference ``GameProblem`` over into the port.

``problem_from_reference`` reads the attributes of the reference package's
``GameProblem`` / model (unicycle, double integrator, heterogeneous double
integrator, bicycle, quadrotor, with their physical constants and index
tuples) / ``GameObjective`` (with its CollisionCost
pairs) / ``GameConstraints`` / ``ConBlock`` (with its sense and active
flags) and every constraint family's parameters by name, and converts each
array leaf with ``np.asarray`` (which works on the reference's arrays
without importing its framework).  The static ``ProblemSpec`` is rebuilt
field by field, and ``Options`` with every field the port has; the TPU
compiler knobs ``flat_loop`` and ``loop_unroll`` and the fields that no
solver path of the reference reads (``theta``, ``alpha_increase``,
``rho_trial``, ``gamma``, ``inner_print``, ``outer_print``, ``seed``) are
dropped at any value.  It raises on any other reference option that the
port does not read, set away from its default.

``constraints_from_reference`` converts a constraint set alone, also the
per-lane AL state of a vmapped solve's result, and ``traj_from_reference``
a primal-dual trajectory, so that a reference solve's plan and duals can be
carried into the port as a warm start.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constraints import kernels as K
from .constraints.sets import ConBlock, GameConstraints
from .core.spec import ProblemSpec
from .core.traj import PrimalDual
from .models.bicycle import BicycleGame
from .models.double_integrator import DoubleIntegratorGame
from .models.hetero import HeteroDoubleIntegratorGame
from .models.quadrotor import QuadrotorGame
from .models.unicycle import UnicycleGame
from .objective.objective import GameObjective
from .problem.options import Options
from .problem.problem import GameProblem

_MODELS = {cls.__name__: cls for cls in (UnicycleGame, DoubleIntegratorGame,
                                         HeteroDoubleIntegratorGame,
                                         BicycleGame, QuadrotorGame)}
_FAMILIES = {cls.__name__: cls for cls in (
    K.CollisionParams, K.CircleParams, K.Wall2DParams, K.Wall3DParams,
    K.CylinderParams, K.BoundParams)}


# Reference options with no counterpart whose value changes no result: the
# TPU compiler's knobs, and the fields that no solver path of the reference
# reads (objective scaling, printing, the seed, the trial penalty and the
# line search's unused constants), taken at any value.
_COMPILER_KNOBS = ("flat_loop", "loop_unroll")
_UNREAD_OPTIONS = ("theta", "alpha_increase", "rho_trial", "gamma",
                   "inner_print", "outer_print", "seed")


def _fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _static(v):
    """A static field (int, float, index or flag tuple) as plain Python."""
    if isinstance(v, (tuple, list)):
        return tuple(_static(a) for a in v)
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return float(v)


def _tensor(device, dtype):
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype,
                               device=device)
    return t


def traj_from_reference(traj, device, dtype) -> PrimalDual:
    """A reference ``PrimalDual`` (batched [B, ...] leaves from a vmapped
    solve, or one scenario's) as the port's."""
    t = _tensor(device, dtype)
    return PrimalDual(x=t(traj.x), u=t(traj.u), lam=t(traj.lam))


def constraints_from_reference(g, device, dtype,
                               lanes: bool = False) -> GameConstraints:
    """A reference ``GameConstraints`` as the port's.  With ``lanes``, ``g``
    is the constraint set of a vmapped solve's result: its duals and
    penalties are per lane [B, K, C] and stay so; every other leaf is the
    problem's, repeated per lane, and lane 0's is taken.  The active
    flags follow the duals."""
    t0 = _tensor(device, dtype)

    def t(a):
        return t0(np.asarray(a)[0] if lanes else a)

    def block(b):
        kind = type(b.params).__name__
        if kind not in _FAMILIES:
            raise NotImplementedError(f"constraint family {kind} is not "
                                      "ported")
        cls = _FAMILIES[kind]
        par = cls(**{f.name: (t if f.type == "torch.Tensor" else _static)(
            getattr(b.params, f.name)) for f in dataclasses.fields(cls)})
        return ConBlock(params=par, lam=t0(b.lam), mu=t0(b.mu),
                        owner=int(b.owner), is_state=bool(b.is_state),
                        sense=str(b.sense),
                        active=torch.as_tensor(np.array(b.active, bool),
                                               device=device))

    return GameConstraints(
        state_blocks=tuple(block(b) for b in g.state_blocks),
        control_blocks=tuple(block(b) for b in g.control_blocks),
        alpha_dual=t(g.alpha_dual), alphax_dual=t(g.alphax_dual),
        phi=t(g.phi), mu0=t(g.mu0), mu_max=t(g.mu_max), lam_max=t(g.lam_max),
        active_tol=t(g.active_tol))


def _options_from_reference(opts) -> Options:
    """The reference's ``Options`` as the port's.  Raises on a field the
    port does not read, other than the compiler knobs and the fields the
    reference never reads, that is set away from the reference's
    default."""
    carried = set(_fields(Options))
    for f in dataclasses.fields(type(opts)):
        if (f.name in carried or f.name in _COMPILER_KNOBS
                or f.name in _UNREAD_OPTIONS):
            continue
        if getattr(opts, f.name) != f.default:
            raise NotImplementedError(f"option {f.name} is not read by the "
                                      "port; leave it at its default")
    return Options(**{f: getattr(opts, f) for f in carried})


def problem_from_reference(prob, device, dtype) -> GameProblem:
    t = _tensor(device, dtype)
    spec = ProblemSpec(**{f: getattr(prob.spec, f) for f in _fields(ProblemSpec)})
    name = type(prob.model).__name__
    if name not in _MODELS:
        raise NotImplementedError(f"model {name} is not ported")
    model = _MODELS[name](**{f: _static(getattr(prob.model, f))
                             for f in _fields(_MODELS[name])})
    opts = _options_from_reference(prob.opts)
    o = prob.obj
    obj = GameObjective(
        Qd=t(o.Qd), Rd=t(o.Rd), xf=t(o.xf), uf=t(o.uf), mu=t(o.mu), r=t(o.r),
        pair_i=tuple(int(i) for i in o.pair_i),
        pair_j=tuple(int(j) for j in o.pair_j),
        pxi=tuple(tuple(int(k) for k in ix) for ix in o.pxi),
        pxj=tuple(tuple(int(k) for k in ix) for ix in o.pxj))
    return GameProblem(spec=spec, model=model, opts=opts, x0=t(prob.x0),
                       obj=obj,
                       gc=constraints_from_reference(prob.gc, device, dtype))
