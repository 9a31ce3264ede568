"""Explicit integrators and discrete dynamics Jacobians (counterpart of
``algames_tpu/models/integration.py``).

* ``rk2_step``  explicit midpoint; used inside the Newton residual.
* ``rk3_step``  Kutta third order; used only for the initial rollout.
* ``step_jacobians`` (A, B) of the RK2 step by ``torch.func.jacfwd``,
  vmapped over every leading axis; ``step_jacobians_traj`` the same over a
  trajectory's knots.
* ``rk2_vjp``   the dual pulls ``A^T lam`` / ``B^T lam`` as one VJP through
  the RK2 step per player cotangent.
* ``rollout_rk3`` forward simulation.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd, vjp, vmap


def rk2_step(model, x, u, dt):
    """Explicit midpoint step on the last axis."""
    k1 = model.dynamics(x, u) * dt
    k2 = model.dynamics(x + 0.5 * k1, u) * dt
    return x + k2


def rk3_step(model, x, u, dt):
    """Kutta third-order step on the last axis."""
    k1 = model.dynamics(x, u) * dt
    k2 = model.dynamics(x + 0.5 * k1, u) * dt
    k3 = model.dynamics(x - k1 + 2.0 * k2, u) * dt
    return x + (k1 + 4.0 * k2 + k3) / 6.0


def step_jacobians(model, xs, us, dt):
    """(A, B) = d rk2_step / d(x, u): xs [..., n], us [..., m] ->
    [..., n, n], [..., n, m]."""
    lead = xs.shape[:-1]
    n, m = xs.shape[-1], us.shape[-1]
    jac = vmap(jacfwd(lambda x, u: rk2_step(model, x, u, dt), argnums=(0, 1)))
    A, B = jac(xs.reshape(-1, n), us.reshape(-1, m))
    return A.reshape(lead + (n, n)), B.reshape(lead + (n, m))


def step_jacobians_traj(model, xs, us, dt):
    """(A, B) at every knot of a trajectory: xs [..., T, n], us [..., T, m]
    (batch-first; the reference's takes one scenario's [T, n], [T, m]) ->
    [..., T, n, n], [..., T, n, m]."""
    if xs.shape[:-1] != us.shape[:-1]:
        raise ValueError(f"xs {tuple(xs.shape)} and us {tuple(us.shape)} "
                         f"differ in their knots")
    return step_jacobians(model, xs, us, dt)


def rk2_vjp(model, xs, us, lams, dt):
    """Pull the cotangents ``lams`` [..., p, n] back through the RK2 step at
    (xs [..., n], us [..., m]): returns (A^T lam [..., p, n],
    B^T lam [..., p, m]).  The step acts on the last axis only, so one VJP
    over the expanded [..., p, ·] primals gives every player's pull."""
    p = lams.shape[-2]
    xe = xs.unsqueeze(-2).expand(xs.shape[:-1] + (p, xs.shape[-1]))
    ue = us.unsqueeze(-2).expand(us.shape[:-1] + (p, us.shape[-1]))
    _, pull = vjp(lambda x, u: rk2_step(model, x, u, dt), xe, ue)
    return pull(lams)


def rollout_rk3(model, x0, us, dt):
    """Forward-simulate from x0 [B, n] under us [B, T, m]; returns
    xs [B, T+1, n]."""
    xs = [x0]
    for t in range(us.shape[1]):
        xs.append(rk3_step(model, xs[-1], us[:, t], dt))
    return torch.stack(xs, dim=1)
