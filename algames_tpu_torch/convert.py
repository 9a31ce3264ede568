"""Carry a reference ``GameProblem`` over into the port.

``problem_from_reference`` reads the attributes of the reference package's
``GameProblem`` / model (unicycle, double integrator, heterogeneous double
integrator, bicycle, quadrotor, with their physical constants and index
tuples) / ``GameObjective`` (with its CollisionCost
pairs) / ``GameConstraints`` / ``ConBlock`` and every constraint family's
parameters by name, and converts each array leaf with ``np.asarray`` (which
works on the reference's arrays without importing its framework).  The
static ``ProblemSpec`` is rebuilt field by field.  It raises on anything the
port does not carry: non-inequality blocks and the options the port has not
ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constraints import kernels as K
from .constraints.sets import ConBlock, GameConstraints
from .core.spec import ProblemSpec
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


def problem_from_reference(prob, device, dtype) -> GameProblem:
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype,
                               device=device)

    spec = ProblemSpec(**{f: getattr(prob.spec, f) for f in _fields(ProblemSpec)})
    name = type(prob.model).__name__
    if name not in _MODELS:
        raise NotImplementedError(f"model {name} is not ported")
    model = _MODELS[name](**{f: _static(getattr(prob.model, f))
                             for f in _fields(_MODELS[name])})
    ro = prob.opts
    if (ro.ls_parallel > 1 or ro.adaptive_penalty or not ro.regularize
            or not ro.dual_reset):
        raise NotImplementedError("ls_parallel > 1, adaptive_penalty, "
                                  "regularize=False and dual_reset=False "
                                  "are not ported")
    opts = Options(**{f: getattr(ro, f) for f in _fields(Options)})
    o = prob.obj
    obj = GameObjective(
        Qd=t(o.Qd), Rd=t(o.Rd), xf=t(o.xf), uf=t(o.uf), mu=t(o.mu), r=t(o.r),
        pair_i=tuple(int(i) for i in o.pair_i),
        pair_j=tuple(int(j) for j in o.pair_j),
        pxi=tuple(tuple(int(k) for k in ix) for ix in o.pxi),
        pxj=tuple(tuple(int(k) for k in ix) for ix in o.pxj))

    def block(b):
        if getattr(b, "sense", "ineq") != "ineq":
            raise NotImplementedError("only inequality blocks are ported")
        kind = type(b.params).__name__
        if kind not in _FAMILIES:
            raise NotImplementedError(f"constraint family {kind} is not "
                                      "ported")
        cls = _FAMILIES[kind]
        par = cls(**{f.name: (t if f.type == "torch.Tensor" else _static)(
            getattr(b.params, f.name)) for f in dataclasses.fields(cls)})
        return ConBlock(params=par, lam=t(b.lam), mu=t(b.mu),
                        owner=int(b.owner), is_state=bool(b.is_state))

    g = prob.gc
    gc = GameConstraints(
        state_blocks=tuple(block(b) for b in g.state_blocks),
        control_blocks=tuple(block(b) for b in g.control_blocks),
        alpha_dual=t(g.alpha_dual), alphax_dual=t(g.alphax_dual),
        phi=t(g.phi), mu0=t(g.mu0), mu_max=t(g.mu_max), lam_max=t(g.lam_max))
    return GameProblem(spec=spec, model=model, opts=opts, x0=t(prob.x0),
                       obj=obj, gc=gc)
