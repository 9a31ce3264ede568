"""Scenario-batch solving (counterpart of ``algames_tpu/parallel/batch.py``).

The solver is batch-first, so a batch is one ``newton_solve`` over
``x0s`` [B, n]; ``solve_many`` bounds memory and straggler cost by solving
chunks of lanes one after the other.
"""
from __future__ import annotations

import torch

from ..problem.problem import GameProblem
from ..problem.solver import SolveResult, newton_solve
from ..utils import tree_map


def solve_batch(prob: GameProblem, x0s: torch.Tensor, method="thomas",
                generator: torch.Generator | None = None) -> SolveResult:
    """Solve one game per row of ``x0s`` [B, n]; ``generator`` draws each
    lane's fresh init (zeros without one)."""
    return newton_solve(prob, x0s, method=method, generator=generator)


def solve_many(prob: GameProblem, x0s: torch.Tensor, method="thomas",
               chunk: int | None = None, reduce=None,
               generator: torch.Generator | None = None):
    """Sweep ``x0s`` [N, n] in chunks of ``chunk`` lanes; the chunks draw
    their fresh inits from ``generator`` one after the other.

    N is padded to a multiple of ``chunk`` with copies of row 0 and the
    result is trimmed back to N lanes.  ``chunk=None`` (or >= N) is one
    ``solve_batch``.  With ``reduce``, only ``reduce(chunk_result)`` is kept
    per chunk, stacked with the CHUNK index as the leading axis
    ([ceil(N/chunk), ...]; 1 when unchunked).  There is no tail trimming
    there: the padded lanes of the last chunk ARE included in its
    reduction, so a lane-aggregating reduction must account for them (or
    choose ``chunk`` dividing N).
    """
    N = x0s.shape[0]
    if chunk is None or chunk >= N:
        out = solve_batch(prob, x0s, method=method, generator=generator)
        if reduce is not None:
            return tree_map(lambda a: a[None], reduce(out))
        return out
    C = -(-N // chunk)
    pad = C * chunk - N
    if pad:
        x0s = torch.cat([x0s, x0s[:1].expand(pad, -1)])
    outs = [solve_batch(prob, x0s[i * chunk:(i + 1) * chunk], method=method,
                        generator=generator) for i in range(C)]
    if reduce is not None:
        outs = [reduce(o) for o in outs]
        return tree_map(lambda a, *r: torch.stack((a,) + r), outs[0],
                        *outs[1:])

    def cat(a, *r):
        if all(x is a for x in r):       # shared leaf (radius, bounds, ...)
            return a
        return torch.cat((a,) + r)[:N]
    return tree_map(cat, outs[0], *outs[1:])


def _final(result: SolveResult, column: torch.Tensor) -> torch.Tensor:
    """Each lane's value of a stats column at its last valid record."""
    idx = torch.clamp(result.stats.iter.long() - 1, min=0)
    return column.gather(1, idx[:, None])[:, 0]


def divergence_mask(result: SolveResult) -> torch.Tensor:
    """True where the final residual or the trajectory is non-finite."""
    bad_res = ~torch.isfinite(_final(result, result.stats.res))
    bad_traj = ~torch.isfinite(result.traj.x).flatten(1).all(dim=1)
    return bad_res | bad_traj


def convergence_mask(result: SolveResult, opts) -> torch.Tensor:
    """True where the lane's final violations meet the tolerances."""
    s = result.stats
    return ((_final(result, s.dyn_vio) < opts.eps_dyn)
            & (_final(result, s.con_vio) < opts.eps_con)
            & (_final(result, s.sta_vio) < opts.eps_sta)
            & (_final(result, s.opt_vio) < opts.eps_opt))


def convergence_fraction(result: SolveResult, opts) -> torch.Tensor:
    """Fraction of lanes whose final violations meet the tolerances."""
    return convergence_mask(result, opts).to(torch.float32).mean()
