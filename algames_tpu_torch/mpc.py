"""Receding-horizon MPC, batch-first (counterpart of ``algames_tpu/mpc.py``).

Each control step re-solves the game of every scenario from its current
plant state, warm-started from the previous plan shifted by
``opts.shift`` knots (use ``Options(shift=1)``), applies the first control
and integrates the plant ``opts.upsampling`` RK3 substeps of
``dt / upsampling``.  With ``dual_reset=False`` the converged multipliers
are carried to the next replan with the penalties reset to mu0
(``reset_penalties``); otherwise every replan starts from ``prob.gc``.

The reference package runs the loop as one ``lax.scan``; here it is a host
loop over the replans, each one batch-first ``newton_solve`` over the B
scenarios on the device of the problem's tensors (the card for problems
built with the presets' defaults).
"""
from __future__ import annotations

import dataclasses

import torch

from .constraints import sets as gcm
from .core.traj import PrimalDual
from .models.integration import rk3_step
from .problem.problem import GameProblem
from .problem.solver import newton_solve


@dataclasses.dataclass
class MPCResult:
    states: torch.Tensor     # [B, H+1, n] closed-loop plant states
    controls: torch.Tensor   # [B, H, m]   applied controls
    dyn_vio: torch.Tensor    # [B, H] dynamics violation of each replan
    opt_vio: torch.Tensor    # [B, H] stationarity violation of each replan
    iters: torch.Tensor      # [B, H] stats rows of each replan
    traj: PrimalDual         # the last plan


def mpc_solve(prob: GameProblem, x0s: torch.Tensor | None = None,
              horizon: int | None = None, method="thomas") -> MPCResult:
    """Run the receding-horizon loop for ``horizon`` plant steps (default
    ``opts.mpc_horizon``) from each row of ``x0s`` [B, n] (default:
    ``prob.x0`` as a batch of one).  The first solve is cold, the others
    warm.  ``method`` is ``newton_solve``'s."""
    spec, model, opts = prob.spec, prob.model, prob.opts
    H = opts.mpc_horizon if horizon is None else horizon
    x = prob.x0[None] if x0s is None else x0s
    sub_dt = spec.dt / opts.upsampling
    gc, warm = prob.gc, None
    states, controls, dyn, opt, iters = [x], [], [], [], []
    for _ in range(H):
        out = newton_solve(dataclasses.replace(prob, gc=gc), x,
                           method=method, warm=warm)
        u0 = out.traj.u[:, 0]
        for _ in range(opts.upsampling):
            x = rk3_step(model, x, u0, sub_dt)
        last = torch.clamp(out.stats.iter.long() - 1, min=0)[:, None]
        states.append(x)
        controls.append(u0)
        dyn.append(out.stats.dyn_vio.gather(1, last)[:, 0])
        opt.append(out.stats.opt_vio.gather(1, last)[:, 0])
        iters.append(out.stats.iter)
        gc = prob.gc if opts.dual_reset else gcm.reset_penalties(out.gc)
        warm = out.traj
    return MPCResult(states=torch.stack(states, dim=1),
                     controls=torch.stack(controls, dim=1),
                     dyn_vio=torch.stack(dyn, dim=1),
                     opt_vio=torch.stack(opt, dim=1),
                     iters=torch.stack(iters, dim=1), traj=warm)
