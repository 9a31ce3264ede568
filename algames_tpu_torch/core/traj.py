"""Batched primal-dual trajectory (counterpart of ``algames_tpu/core/traj.py``).

Every leaf carries a leading scenario axis:

* ``x``   [B, N, n]     states (``x[:, 0]`` is the fixed initial state)
* ``u``   [B, T, m]     controls, T = N-1
* ``lam`` [B, p, T, n]  each player's multiplier on the shared dynamics
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import lanes
from .spec import ProblemSpec


@dataclasses.dataclass
class PrimalDual:
    x: torch.Tensor
    u: torch.Tensor
    lam: torch.Tensor


def zero_traj(spec: ProblemSpec, B: int, dtype, device) -> PrimalDual:
    return PrimalDual(
        x=torch.zeros((B, spec.N, spec.n), dtype=dtype, device=device),
        u=torch.zeros((B, spec.T, spec.m), dtype=dtype, device=device),
        lam=torch.zeros((B, spec.p, spec.T, spec.n), dtype=dtype,
                        device=device))


def init_traj(spec: ProblemSpec, x0: torch.Tensor, shift: int = 2 ** 10,
              prev: PrimalDual | None = None,
              generator: torch.Generator | None = None,
              amplitude: float = 1e-8) -> PrimalDual:
    """Fresh init with MPC warm-start shift semantics, x0 [B, n].

    The fresh entries are drawn uniform in [0, amplitude) from
    ``generator`` (x, then u, then lam, on x0's device, where the generator
    must live), or are zeros without one.  Entry k is then taken from
    ``prev`` shifted by ``shift`` knots when ``k+shift`` is in range, else
    it stays fresh; finally ``x[:, 0]`` is pinned to x0.
    """
    B = x0.shape[0]
    if generator is None:
        fresh = zero_traj(spec, B, x0.dtype, x0.device)
    else:
        def draw(*shape):
            return amplitude * torch.rand(shape, generator=generator,
                                          dtype=x0.dtype, device=x0.device)
        fresh = PrimalDual(x=draw(B, spec.N, spec.n),
                           u=draw(B, spec.T, spec.m),
                           lam=draw(B, spec.p, spec.T, spec.n))
    if prev is not None and shift < spec.N:
        s = shift
        x = torch.cat([prev.x[:, s:], fresh.x[:, spec.N - s:]], dim=1)
        u = (torch.cat([prev.u[:, s:], fresh.u[:, spec.T - s:]], dim=1)
             if s < spec.T else fresh.u)
        lam = (torch.cat([prev.lam[:, :, s:], fresh.lam[:, :, spec.T - s:]],
                         dim=2) if s < spec.T else fresh.lam)
        fresh = PrimalDual(x=x, u=u, lam=lam)
    x = fresh.x.clone()
    x[:, 0] = x0
    return PrimalDual(x=x, u=fresh.u, lam=fresh.lam)


def update_traj(source: PrimalDual, alpha: torch.Tensor,
                delta: PrimalDual) -> PrimalDual:
    """``source + alpha * delta`` per lane (alpha [B])."""
    return PrimalDual(
        x=source.x + lanes(alpha, 3) * delta.x,
        u=source.u + lanes(alpha, 3) * delta.u,
        lam=source.lam + lanes(alpha, 4) * delta.lam,
    )


def delta_step(delta: PrimalDual, alpha: torch.Tensor) -> torch.Tensor:
    """Mean 1-norm of the primal step per lane [B]: sum of |x_{k+1}| and
    |u_k| times alpha, divided by T (n+m).  Duals excluded."""
    _, N, n = delta.x.shape
    _, T, m = delta.u.shape
    s = (delta.x[:, 1:].abs().sum(dim=(1, 2))
         + delta.u.abs().sum(dim=(1, 2)))
    return s * alpha / (T * (n + m))


def reset_duals(traj: PrimalDual) -> PrimalDual:
    """Zero the dynamics multipliers."""
    return PrimalDual(x=traj.x, u=traj.u, lam=torch.zeros_like(traj.lam))


def unpack_step(spec: ProblemSpec, flat: torch.Tensor) -> PrimalDual:
    """Scatter a flat Newton step [B, S] into a PrimalDual.
    ``x[:, 0]`` is zero: the knot-0 state is not a decision variable."""
    B = flat.shape[0]
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    blocks = flat.reshape(B, T, spec.W)
    x = torch.cat([flat.new_zeros((B, 1, n)), blocks[:, :, :n]], dim=1)
    u = blocks[:, :, n:n + m]
    lam = blocks[:, :, n + m:].reshape(B, T, p, n).permute(0, 2, 1, 3)
    return PrimalDual(x=x, u=u, lam=lam)


def pack_traj(spec: ProblemSpec, traj: PrimalDual) -> torch.Tensor:
    """Gather a PrimalDual into the flat [B, S] column order."""
    B = traj.x.shape[0]
    dl = traj.lam.permute(0, 2, 1, 3).reshape(B, spec.T, spec.p * spec.n)
    blocks = torch.cat([traj.x[:, 1:], traj.u, dl], dim=2)
    return blocks.reshape(B, -1)
