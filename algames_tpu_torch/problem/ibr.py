"""Iterative best response (IBR), batch-first (counterpart of
``algames_tpu/problem/ibr.py``).

Gauss-Seidel over the players: each player solves its own augmented-
Lagrangian problem with the other players' strategies frozen, until no
player's latest solve moves.  A player's subproblem is a p=1 game with
control width ``mi`` and per-knot unknowns ``[x_{t+1} (n) | u_i (mi) |
lam_i (n)]``, ``W_i = 2n + mi``, so its KKT step is the same Schur-condensed
block-Thomas sweep as the main solver's: kernel K3 (``ops.thomas
.solve_thomas``) on a :class:`~..core.spec.ProblemSpec` with p=1, fed the
player's slices of the dense Jacobian ingredients.

The reference writes the solver per scenario and batches it with ``vmap``
over nested ``while_loop``s (Gauss-Seidel rounds, each player's AL outer
loop, its Newton inner loop).  Here each is a host loop over the lanes that
are still running, and every update is a per-lane select, which is the
batched while loop's semantics: a lane whose loop has stopped keeps its
last state.  The line search is the eager trial with the player's residual
norm, as in the reference (never the fused trial).  The player's rows are
sliced from a full-spec assembly, as the reference does.

The reference's stopping flag in Algames.jl maxes over the whole step
history; like the JAX package, a lane here stops once the largest step of
every player's *latest* solve is below ``delta_min``.
"""
from __future__ import annotations

import torch

from ..constraints import sets as gcm
from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual, delta_step, init_traj, update_traj
from ..models.integration import rollout_rk3
from ..stats import init_stats, record
from ..utils import tree_map, where_tree
from . import residual as R
from .linear_solver import JacBlocks
from .options import IBROptions
from .problem import GameProblem
from .solver import SolveResult, _kkt_solver, line_search


def player_block_width(spec: ProblemSpec, i: int) -> int:
    return 2 * spec.n + spec.mi[i]


def player_residual_blocks(spec: ProblemSpec, res: R.Residual, i: int):
    """Player i's rows of the residual in per-knot order [B, T, W_i]:
    its statx rows, its control rows and the dynamics rows."""
    return torch.cat([res.rx[:, :, i], res.ru[:, :, list(spec.pu[i])],
                      res.rd], dim=2)


def player_residual_norm(spec: ProblemSpec, res: R.Residual, i: int):
    """Mean 1-norm over player i's rows, per lane [B]."""
    b = player_residual_blocks(spec, res, i)
    return b.abs().sum(dim=(1, 2)) / (b.shape[1] * b.shape[2])


def unpack_player_step(spec: ProblemSpec, i: int,
                       flat: torch.Tensor) -> PrimalDual:
    """Scatter the player's flat step [B, T W_i] into a full PrimalDual
    (zeros for the other players' controls and multipliers)."""
    Bsz = flat.shape[0]
    T, n, m, p, mi = spec.T, spec.n, spec.m, spec.p, spec.mi[i]
    blocks = flat.reshape(Bsz, T, player_block_width(spec, i))
    dx = torch.cat([flat.new_zeros((Bsz, 1, n)), blocks[:, :, :n]], dim=1)
    du = flat.new_zeros((Bsz, T, m))
    du[:, :, list(spec.pu[i])] = blocks[:, :, n:n + mi]
    dlam = flat.new_zeros((Bsz, p, T, n))
    dlam[:, i] = blocks[:, :, n + mi:]
    return PrimalDual(x=dx, u=du, lam=dlam)


def player_violations(spec: ProblemSpec, gc, pd: R.PointData,
                      res: R.Residual, i: int):
    """Player i's violation maxima per lane (dyn, con, sta, opt), from the
    carried constraint values: the dynamics rows of its own states, every
    control block, the state blocks it owns, and its stationarity rows."""
    pz, pu = list(spec.pz[i]), list(spec.pu[i])
    dyn_v = res.rd[:, :, pz].abs().amax(dim=(1, 2))
    opt_v = torch.maximum(res.rx[:, :, i].abs().amax(dim=(1, 2)),
                          res.ru[:, :, pu].abs().amax(dim=(1, 2)))
    sta_v = torch.zeros_like(dyn_v)
    for b, c in zip(gc.state_blocks, pd.state_c):
        if b.owner == i:
            sta_v = torch.maximum(sta_v, gcm.block_violation_max(c, b.sense))
    con_v = torch.zeros_like(dyn_v)
    for b, c in zip(gc.control_blocks, pd.control_c):
        con_v = torch.maximum(con_v, gcm.block_violation_max(c, b.sense))
    return dyn_v, con_v, sta_v, opt_v


def player_spec(spec: ProblemSpec, i: int) -> ProblemSpec:
    """Player i's subproblem as a p=1 spec with control width ``mi``:
    ``W = 2n + mi``, every control its own."""
    n, mi = spec.n, spec.mi[i]
    return ProblemSpec(N=spec.N, n=n, m=mi, p=1, ni=(n,), mi=(mi,),
                       pu=(tuple(range(mi)),), px=(spec.px[i],),
                       pz=(tuple(range(n)),), dt=spec.dt)


def player_jac_blocks(spec: ProblemSpec, jb: JacBlocks, i: int) -> JacBlocks:
    """Player i's slice of the dense Jacobian ingredients as the p=1
    subproblem's, contiguous for the kernel."""
    pu = list(spec.pu[i])
    return JacBlocks(Qblk=jb.Qblk[:, :, i:i + 1].contiguous(),
                     Ublk=jb.Ublk[:, :, pu][:, :, :, pu].contiguous(),
                     A=jb.A.contiguous(), B=jb.B[..., pu].contiguous())


def _ibr_player_solve(prob: GameProblem, kkt, traj: PrimalDual, gc, stats,
                      i: int, active: torch.Tensor):
    """Player i's AL solve with the others frozen, on the lanes where
    ``active`` [B] holds: the AL outer loop around the Newton inner loop,
    each a host loop over the lanes still in it.  With ``dual_reset`` the
    AL state is reset and the multipliers zeroed on every lane first.
    Stats rows record the player's AL epoch in the ``outer`` column and
    the running largest step in the ``delta`` column.  Returns (traj, gc, stats, max_delta [B])."""
    spec, model, opts, obj = prob.spec, prob.model, prob.opts, prob.obj
    Bsz, dtype, device = traj.x.shape[0], traj.x.dtype, traj.x.device
    spec_i = player_spec(spec, i)
    if opts.dual_reset:
        gc = gcm.reset_constraints(gc, Bsz)
        traj = PrimalDual(x=traj.x, u=traj.u, lam=torch.zeros_like(traj.lam))
    pd = R.point_data(model, spec, obj, gc, traj)

    def norm_i(spec_, res_):
        return player_residual_norm(spec_, res_, i)

    k = torch.zeros((Bsz,), dtype=torch.int32, device=device)
    done = ~active
    max_delta = torch.zeros((Bsz,), dtype=dtype, device=device)
    while True:
        orun = (k < opts.outer_iter) & ~done
        if not bool(orun.any()):
            break
        l = torch.zeros_like(k)
        stop = ~orun
        last_vio = torch.full((Bsz, 4), float("inf"), dtype=dtype,
                              device=device)
        while True:
            irun = (l < opts.inner_iter) & ~stop
            if not bool(irun.any()):
                break
            reg = opts.reg_0 * (l + 1).to(dtype) ** 4
            if not opts.regularize:
                reg = torch.zeros_like(reg)
            res, jb, _, _ = R.assemble_from_point(spec, obj, gc, traj, pd,
                                                  reg=reg)
            res_norm = player_residual_norm(spec, res, i)
            vio = player_violations(spec, gc, pd, res, i)
            stats = record(stats, irun, k + 1, res_norm, max_delta, 1.0,
                           *vio)
            stop_opt = vio[3] < opts.eps_opt
            b = player_residual_blocks(spec, res, i)
            dflat = kkt(spec_i, player_jac_blocks(spec, jb, i),
                        (-b).contiguous(), ())
            dtraj = unpack_player_step(spec, i, dflat)
            alpha, j, lite = line_search(model, spec, obj, gc, opts, traj,
                                         dtraj, res_norm, reg,
                                         live=irun & ~stop_opt,
                                         norm_fn=norm_i)
            delta = delta_step(dtraj, alpha)
            take = irun & ~stop_opt
            traj = where_tree(take, update_traj(traj, alpha, dtraj), traj)
            lite_old = R.PointLite(rx0=pd.rx0, ru0=pd.ru0, rd=pd.rd,
                                   state_c=pd.state_c,
                                   control_c=pd.control_c)
            pd = R.point_from_lite(model, spec, gc,
                                   where_tree(take, lite, lite_old), traj)
            max_delta = torch.where(take, torch.maximum(max_delta, delta),
                                    max_delta)
            last_vio = torch.where(irun[:, None], torch.stack(vio, dim=1),
                                   last_vio)
            stop = torch.where(irun, stop_opt | (j >= opts.ls_iter)
                               | (delta < opts.delta_min), stop)
            l = torch.where(irun, l + 1, l)
        converged = ((last_vio[:, 0] < opts.eps_dyn)
                     & (last_vio[:, 1] < opts.eps_con)
                     & (last_vio[:, 2] < opts.eps_sta)
                     & (last_vio[:, 3] < opts.eps_opt))
        done = done | (orun & converged)
        update = orun & ~converged & (k < opts.outer_iter - 1)
        if bool(update.any()):
            gc = where_tree(update, gcm.penalty_update(
                gcm.dual_update(gc, traj)), gc)
        k = torch.where(orun, k + 1, k)
    return traj, gc, stats, max_delta


def _ibr_init(prob: GameProblem, x0s, capacity: int):
    """Zero init + RK3 rollout, the AL state reset per lane, and a stats
    buffer of ``capacity`` rows."""
    spec, model = prob.spec, prob.model
    Bsz, dtype, device = x0s.shape[0], x0s.dtype, x0s.device
    traj0 = init_traj(spec, x0s)
    traj0 = PrimalDual(x=rollout_rk3(model, x0s, traj0.u, spec.dt),
                       u=traj0.u, lam=traj0.lam)
    gc0 = (gcm.reset_constraints(prob.gc, Bsz) if prob.opts.dual_reset
           else gcm.per_lane(prob.gc, Bsz))
    return traj0, gc0, init_stats(Bsz, capacity, dtype, device)


def _finalize(prob: GameProblem, traj, gc, stats, outer) -> SolveResult:
    """Final record at the solution from a fresh full evaluation: the whole
    game's residual norm, dynamics and stationarity violations, with
    ``outer`` in the outer column."""
    spec = prob.spec
    res = R.residual_from_point(
        spec, gc, R.point_data(prob.model, spec, prob.obj, gc, traj))
    stats = record(stats, True, outer, R.residual_norm(spec, res), 0.0, 1.0,
                   R.dynamics_violation(res), 0.0, 0.0,
                   R.optimality_violation(res))
    rho = torch.full(traj.x.shape[:1], prob.opts.rho_0,
                     dtype=traj.x.dtype, device=traj.x.device)
    return SolveResult(traj=traj, gc=gc, stats=stats, rho=rho)


def ibr_newton_solve_player(prob: GameProblem, i: int,
                            x0s: torch.Tensor | None = None,
                            method="thomas") -> SolveResult:
    """Solve only player i's problem, the others frozen at the initial
    guess, for each row of ``x0s`` [B, n] (default: ``prob.x0``).
    ``method``: ``"thomas"`` (kernel K3, its plain version on CPU tensors)
    or a callable KKT solver ``(spec, blocks, b, w_owner) -> [B, S]``, e.g.
    ``ops.thomas.kkt_solve_plain``."""
    opts = prob.opts
    x0s = prob.x0[None] if x0s is None else x0s
    traj, gc, stats = _ibr_init(prob, x0s,
                                opts.outer_iter * opts.inner_iter + 1)
    active = torch.ones((x0s.shape[0],), dtype=torch.bool,
                        device=x0s.device)
    traj, gc, stats, _ = _ibr_player_solve(prob, _kkt_solver(method), traj,
                                           gc, stats, i, active)
    return _finalize(prob, traj, gc, stats, opts.outer_iter)


def ibr_newton_solve(prob: GameProblem, ibr_opts: IBROptions = IBROptions(),
                     x0s: torch.Tensor | None = None,
                     method="thomas") -> SolveResult:
    """Gauss-Seidel IBR for each row of ``x0s`` [B, n] (default:
    ``prob.x0``): cycle the players in ``ibr_opts.ordering`` until no
    player's latest solve moved by ``delta_min`` or more, or for
    ``ibr_iter`` rounds.  ``method`` as for :func:`ibr_newton_solve_player`.
    The stats hold at most 4096 rows and saturate at the last; the final
    record carries the lane's round count in the outer column."""
    spec, opts = prob.spec, prob.opts
    kkt = _kkt_solver(method)
    x0s = prob.x0[None] if x0s is None else x0s
    ordering = [o for o in ibr_opts.ordering if o < spec.p][:spec.p]
    cap = min(ibr_opts.ibr_iter * spec.p * opts.outer_iter
              * opts.inner_iter + 1, 4096)
    traj, gc, stats = _ibr_init(prob, x0s, cap)
    Bsz, device = x0s.shape[0], x0s.device
    q = torch.zeros((Bsz,), dtype=torch.int32, device=device)
    done = torch.zeros((Bsz,), dtype=torch.bool, device=device)
    while True:
        run = (q < ibr_opts.ibr_iter) & ~done
        if not bool(run.any()):
            break
        t, g, st = traj, gc, stats
        moved = torch.zeros_like(done)
        for i in ordering:
            t, g, st, max_delta = _ibr_player_solve(prob, kkt, t, g, st, i,
                                                    run)
            moved = moved | (max_delta >= ibr_opts.delta_min)
        traj, gc, stats = where_tree(run, (t, g, st), (traj, gc, stats))
        done = done | (run & ~moved)
        q = torch.where(run, q + 1, q)
    return _finalize(prob, traj, gc, stats, q)
