"""ALGAMES Newton / augmented-Lagrangian solver, batch-first (counterpart of
``algames_tpu/problem/solver.py``).

The reference package writes the solver per scenario and batches it with
``vmap`` over masked ``lax.while_loop``s.  Here every tensor carries a
leading scenario axis, the per-lane loop state (``k``, ``l``, ``done``,
``stop``) is a [B] tensor, and the flat (k, l) machine runs as a host loop
``while active.any()``: each trip computes one iteration for every lane and
keeps it only on the lanes that are still active (``where_tree``), which is
exactly the per-lane semantics of the batched while loop.

Iterate-level control flow:

  outer k = 0..outer_iter-1
    inner l = 0..inner_iter-1 with reg = reg_0 * (l+1)^4
      rebuild residual + Jacobian from the carried point data (structured
      Hessians for diagonal objectives of homogeneous specs, dense ones
      with collision-cost pairs, unequal per-player control widths or a
      method of the KKT ladder), record stats, stop on opt_vio < eps_opt
      KKT step (``"thomas"``: kernel K1 on structured, K3 on dense
      Hessians; the ladder's ``"schur"``, ``"tridiag"``, ``"dense"``,
      ``"cr"``: plain PyTorch solves), backtracking line search (the fused
      trial kernel when ``opts.ls_fused``, on ``"thomas"`` only), update;
      stop on a failed line search or a step below delta_min
    convergence gate on 4 violations, dual ascent + penalty schedule
"""
from __future__ import annotations

import dataclasses

import torch

from ..constraints import sets as gcm
from ..core.traj import (PrimalDual, delta_step, init_traj, unpack_step,
                         update_traj)
from ..models.integration import rollout_rk3
from ..ops.thomas import kkt_solve
from ..ops.trial import trial_eval, trial_eval_plain, trial_supported
from ..stats import Statistics, init_stats, record
from ..utils import tree_map, where_tree
from . import residual as R
from .linear_solver import (newton_step, solve_cyclic_reduction,
                            solve_tridiagonal_schur)
from .problem import GameProblem


@dataclasses.dataclass
class SolveResult:
    traj: PrimalDual
    gc: gcm.GameConstraints     # final AL state (duals / penalties)
    stats: Statistics
    rho: torch.Tensor           # [B] final penalty schedule value


@dataclasses.dataclass
class _Carry:
    """Per-lane state of the flat (k, l) machine."""
    k: torch.Tensor             # [B] int32 outer index
    l: torch.Tensor             # [B] int32 inner index
    done: torch.Tensor          # [B] bool
    traj: PrimalDual
    pd: R.PointData
    gc: gcm.GameConstraints
    rho: torch.Tensor
    stats: Statistics
    last_vio: torch.Tensor      # [B, 4] dyn, con, sta, opt
    delta_prev: torch.Tensor
    alpha_prev: torch.Tensor
    prev_cvio: torch.Tensor     # [B] constraint violation at the last update
    delta_fin: torch.Tensor


# The KKT ladder's methods: dense Jacobian blocks, no fused trial.
LADDER = ("schur", "tridiag", "dense", "cr")


def _ladder_solve(method):
    """The plain-PyTorch solve of one of the ``LADDER`` methods on dense
    :class:`~.linear_solver.JacBlocks`: ``"schur"`` the Schur-condensed
    block Thomas, ``"cr"`` block cyclic reduction, ``"tridiag"`` block
    Thomas and ``"dense"`` one S x S solve, each on ``build_tridiagonal``'s
    blocks.  Marked ``dense_only``: the solver assembles dense blocks for
    it and runs the eager trial."""
    def solve(spec, jb, nb, w_owner):
        if method == "schur":
            return solve_tridiagonal_schur(spec, jb, nb)
        D, U, L = R.build_tridiagonal(spec, jb)
        if method == "cr":
            return solve_cyclic_reduction(spec, D, U, L, nb)
        return newton_step(spec, D, U, L, -nb, method=method)
    solve.dense_only = True
    return solve


def _kkt_solver(method):
    """``"thomas"``: kernel K1 or K3, by the form of the Hessian blocks
    (their plain versions on CPU tensors).  One of ``LADDER``: the plain
    PyTorch solves of :func:`_ladder_solve`.  A callable
    ``(spec, blocks, b, w_owner) -> [B, S]`` receives the
    :class:`~.residual.StructuredQ` or :class:`~.linear_solver.JacBlocks`
    blocks and is used as is, e.g. ``ops.thomas.kkt_solve_plain`` to run
    the plain versions on the card."""
    if method == "thomas":
        return kkt_solve
    if method in LADDER:
        return _ladder_solve(method)
    if callable(method):
        return method
    raise ValueError(f"unknown linear-solver method {method!r}; expected "
                     f"'thomas', one of {LADDER} or a callable")


def line_search(model, spec, obj, gc, opts, traj, dtraj, res_norm, reg,
                live, trial_fn=None, norm_fn=None):
    """Backtracking line search: accept alpha iff the trial mean residual
    (with the Tikhonov pull ``reg`` [B] toward the current iterate) is at
    most (1 - alpha beta) res_norm.  Returns (alpha, j, PointLite), each
    per lane; failed iff j == ls_iter.

    The first K = ``opts.ls_parallel`` trials (at most ls_iter - 1) are
    evaluated for every lane and the first that passes is accepted; the
    sequential continuation, from trial K+1, runs only on the ``live``
    lanes whose first K trials all failed (the other lanes' results are
    discarded by the caller).  The decisions are those of K = 1.  On a
    failed line search the step uses a final alpha that was never
    evaluated (alpha_0 decrease^ls_iter) while the returned point is from
    the last tested alpha, and the caller completes it with Jacobians at
    the final-alpha point: the rebuilt point data mixes two points about
    3e-8 |step| apart, exactly as the reference does.

    ``trial_fn`` (the fused trial: K launches for the window) and
    ``norm_fn`` (a custom residual norm for the eager trial) exclude each
    other.
    """
    if trial_fn is not None and norm_fn is not None:
        raise ValueError("trial_fn and norm_fn cannot both be given")
    dtype, device = res_norm.dtype, res_norm.device
    Bsz = res_norm.shape[0]
    if trial_fn is None:
        def trial_point(alpha):
            return trial_eval_plain(model, spec, obj, gc, traj, dtraj, alpha,
                                    reg, norm_fn=norm_fn or R.residual_norm)
    else:
        def trial_point(alpha):
            return trial_fn(model, spec, obj, gc, traj, dtraj, alpha, reg)

    K = max(1, min(int(opts.ls_parallel), opts.ls_iter - 1))
    alphas = opts.alpha_0 * opts.alpha_decrease ** torch.arange(
        K, dtype=dtype, device=device)
    any_ok = torch.zeros((Bsz,), dtype=torch.bool, device=device)
    alpha_par = alphas[K - 1].expand(Bsz)
    j_par = torch.full((Bsz,), K, dtype=torch.int32, device=device)
    pd_par = None
    for k in range(K):
        alpha_k = alphas[k].expand(Bsz).contiguous()
        tn, pd_k = trial_point(alpha_k)
        ok = tn <= (1.0 - alpha_k * opts.beta) * res_norm
        first = ok & ~any_ok
        alpha_par = torch.where(first, alpha_k, alpha_par)
        j_par = torch.where(first, k + 1, j_par)
        pd_par = pd_k if pd_par is None else where_tree(first, pd_k, pd_par)
        any_ok = any_ok | ok
    pd_last = pd_k

    j = torch.full((Bsz,), K + 1, dtype=torch.int32, device=device)
    alpha = torch.full((Bsz,), opts.alpha_0 * opts.alpha_decrease ** K,
                       dtype=dtype, device=device)
    pd_seq = pd_last
    run = live & ~any_ok & (j < opts.ls_iter)
    while bool(run.any()):
        tn, pd_t = trial_point(alpha)
        ok = tn <= (1.0 - alpha * opts.beta) * res_norm
        j = torch.where(run & ~ok, j + 1, j)
        alpha = torch.where(run & ~ok, alpha * opts.alpha_decrease, alpha)
        pd_seq = where_tree(run, pd_t, pd_seq)
        run = run & ~ok & (j < opts.ls_iter)

    alpha = torch.where(any_ok, alpha_par, alpha)
    j = torch.where(any_ok, j_par, j)
    return alpha, j, where_tree(any_ok, pd_par, pd_seq)


def _contiguous(tree):
    return tree_map(lambda a: a.contiguous(), tree)


def _iteration(prob: GameProblem, kkt, w_owner, c: _Carry, active):
    """One inner quasi-Newton iteration for every lane: assembly from the
    carried point data, KKT step, line search, masked update.  For a
    ``dense_only`` solve (the ``LADDER`` methods) the Hessians are dense
    and the trial is the eager one.  Returns (traj, pd, stats, last_vio,
    delta_rec, alpha_rec, stop_inner)."""
    spec, model, obj, opts = prob.spec, prob.model, prob.obj, prob.opts
    dense_only = getattr(kkt, "dense_only", False)
    gc, traj, pd = c.gc, c.traj, c.pd
    dtype = traj.x.dtype
    reg = opts.reg_0 * (c.l + 1).to(dtype) ** 4       # reference l^4 schedule
    if not opts.regularize:
        reg = torch.zeros_like(reg)
    if (not dense_only and spec.homogeneous
            and R.structured_q_supported(spec, obj, gc)):
        res, blocks, sta_v, con_v = R.assemble_structured_from_point(
            spec, obj, gc, traj, pd, reg=reg)
    else:
        res, blocks, sta_v, con_v = R.assemble_from_point(
            spec, obj, gc, traj, pd, reg=reg)
    res_norm = R.residual_norm(spec, res)
    dyn_v = R.dynamics_violation(res)
    opt_v = R.optimality_violation(res)
    stats = record(c.stats, active, c.k + 1, res_norm, c.delta_prev,
                   c.alpha_prev, dyn_v, con_v, sta_v, opt_v)
    last_vio = torch.stack([dyn_v, con_v, sta_v, opt_v], dim=1)
    stop_opt = opt_v < opts.eps_opt

    b = R.residual_knot_blocks(spec, res)
    dflat = kkt(spec, _contiguous(blocks), (-b).contiguous(), w_owner)
    dtraj = _contiguous(unpack_step(spec, dflat))

    # The fused trial where the problem lies inside its specialization;
    # otherwise the eager trial (an explicit branch, never a fallback on
    # error).
    trial_fn = (trial_eval if opts.ls_fused and not dense_only
                and trial_supported(model, spec, obj, gc) else None)
    alpha, j, lite = line_search(
        model, spec, obj, gc, opts, traj, dtraj, res_norm, reg,
        live=active & ~stop_opt, trial_fn=trial_fn)
    failed_ls = j >= opts.ls_iter
    traj_new = update_traj(traj, alpha, dtraj)
    delta = delta_step(dtraj, alpha)

    take = ~stop_opt
    traj = where_tree(take, traj_new, traj)
    # Select the carried PointLite first, then evaluate the Jacobians once
    # at the selected point.
    lite_old = R.PointLite(rx0=pd.rx0, ru0=pd.ru0, rd=pd.rd,
                           state_c=pd.state_c, control_c=pd.control_c)
    lite_sel = where_tree(take, lite, lite_old)
    pd = R.point_from_lite(model, spec, gc, lite_sel, traj)
    zero = torch.zeros((), dtype=dtype, device=delta.device)
    delta_rec = torch.where(take, delta, zero)
    alpha_rec = torch.where(take, alpha, zero)
    stop = stop_opt | failed_ls | (delta < opts.delta_min)
    return traj, pd, stats, last_vio, delta_rec, alpha_rec, stop


def _outer_update(opts, traj, gc, rho, last_vio, prev_cvio, active):
    """AL convergence gate + dual ascent + penalty schedule on the lanes
    where ``active`` holds; returns (converged, gc, rho, prev_cvio).  With
    ``opts.adaptive_penalty`` a lane takes the dual step when its constraint
    violation max(con, sta) fell to adaptive_ratio x ``prev_cvio`` or below,
    and the penalty step otherwise (never both)."""
    converged = ((last_vio[:, 0] < opts.eps_dyn)
                 & (last_vio[:, 1] < opts.eps_con)
                 & (last_vio[:, 2] < opts.eps_sta)
                 & (last_vio[:, 3] < opts.eps_opt))
    do_update = active & ~converged
    cvio = torch.maximum(last_vio[:, 1], last_vio[:, 2])
    if bool(do_update.any()):
        rho_up = torch.clamp(rho * opts.rho_increase, max=opts.rho_max)
        if opts.adaptive_penalty:
            improved = cvio <= opts.adaptive_ratio * prev_cvio
            gc = where_tree(do_update & improved, gcm.dual_update(gc, traj),
                            gc)
            gc = where_tree(do_update & ~improved, gcm.penalty_update(gc),
                            gc)
            rho = torch.where(do_update & ~improved, rho_up, rho)
        else:
            gc_new = gcm.penalty_update(gcm.dual_update(gc, traj))
            gc = where_tree(do_update, gc_new, gc)
            rho = torch.where(do_update, rho_up, rho)
    prev_cvio = torch.where(do_update, cvio, prev_cvio)
    return converged, gc, rho, prev_cvio


def _body(prob: GameProblem, kkt, w_owner, c: _Carry, active) -> _Carry:
    """One trip of the flat (k, l) machine, computed for every lane."""
    opts = prob.opts
    traj, pd, stats, last_vio, delta_rec, alpha_rec, stop_inner = _iteration(
        prob, kkt, w_owner, c, active)
    advance = stop_inner | (c.l + 1 >= opts.inner_iter)
    gc, rho, done, prev_cvio = c.gc, c.rho, c.done, c.prev_cvio
    if bool((advance & active).any()):
        converged, gc_o, rho_o, prev_o = _outer_update(
            opts, traj, c.gc, c.rho, last_vio, c.prev_cvio,
            active=advance & (c.k < opts.outer_iter - 1))
        done = done | (advance & converged)
        gc = where_tree(advance, gc_o, gc)
        rho = torch.where(advance, rho_o, rho)
        prev_cvio = torch.where(advance, prev_o, prev_cvio)
    dtype = traj.x.dtype
    zero = torch.zeros((), dtype=dtype, device=rho.device)
    one = torch.ones((), dtype=dtype, device=rho.device)
    return _Carry(
        k=torch.where(advance, c.k + 1, c.k),
        l=torch.where(advance, torch.zeros_like(c.l), c.l + 1),
        done=done, traj=traj, pd=pd, gc=gc, rho=rho, stats=stats,
        last_vio=last_vio,
        delta_prev=torch.where(advance, zero, delta_rec),
        alpha_prev=torch.where(advance, one, alpha_rec),
        prev_cvio=prev_cvio, delta_fin=delta_rec)


def solve_init(prob: GameProblem, x0s: torch.Tensor,
               warm: PrimalDual | None = None,
               generator: torch.Generator | None = None):
    """Per-lane setup: the primal-dual init (zeros, or a draw from
    ``generator``; the ``warm`` plan [B, ...] shifted by ``opts.shift``
    knots where given) + RK3 rollout, the AL state (reset; with
    ``dual_reset=False`` ``prob.gc`` as it is, per lane), stats buffer,
    penalty schedule, and the point data at the initial iterate."""
    spec, model, opts = prob.spec, prob.model, prob.opts
    B, dtype, device = x0s.shape[0], x0s.dtype, x0s.device
    traj0 = init_traj(spec, x0s, shift=opts.shift, prev=warm,
                      generator=generator, amplitude=opts.amplitude_init)
    traj0 = PrimalDual(x=rollout_rk3(model, x0s, traj0.u, spec.dt),
                       u=traj0.u, lam=traj0.lam)
    gc0 = (gcm.reset_constraints(prob.gc, B) if opts.dual_reset
           else gcm.per_lane(prob.gc, B))
    stats0 = init_stats(B, opts.outer_iter * opts.inner_iter + 1, dtype,
                        device)
    rho0 = torch.full((B,), opts.rho_0, dtype=dtype, device=device)
    pd0 = R.point_data(model, spec, prob.obj, gc0, traj0)
    return traj0, pd0, gc0, stats0, rho0


def solve_finalize(prob: GameProblem, c: _Carry) -> SolveResult:
    """Final record at the solution, rebuilt from the carried point data."""
    spec = prob.spec
    res = R.residual_from_point(spec, c.gc, c.pd)
    res_norm = R.residual_norm(spec, res)
    sta_v, con_v = R.point_violations(c.gc, c.pd)
    stats = record(c.stats, True, c.k, res_norm, c.delta_fin, 1.0,
                   R.dynamics_violation(res), con_v, sta_v,
                   R.optimality_violation(res))
    return SolveResult(traj=c.traj, gc=c.gc, stats=stats, rho=c.rho)


def solve_start(prob: GameProblem, x0s: torch.Tensor | None = None,
                method="thomas", warm: PrimalDual | None = None,
                generator: torch.Generator | None = None):
    """The KKT solve of ``method`` (:func:`_kkt_solver`), the w-vector owners
    and the initial carry of :func:`newton_solve`'s loop (arguments as
    there); each :func:`solve_trip` then advances the carry by one trip."""
    opts = prob.opts
    if x0s is None:
        x0s = prob.x0[None]
    kkt = _kkt_solver(method)
    w_owner = R.structured_w_owner(prob.gc)
    traj0, pd0, gc0, stats0, rho0 = solve_init(prob, x0s, warm, generator)
    B, dtype, device = x0s.shape[0], x0s.dtype, x0s.device
    izero = torch.zeros((B,), dtype=torch.int32, device=device)
    c = _Carry(k=izero, l=izero.clone(),
               done=torch.zeros((B,), dtype=torch.bool, device=device),
               traj=traj0, pd=pd0, gc=gc0, rho=rho0, stats=stats0,
               last_vio=torch.full((B, 4), float("inf"), dtype=dtype,
                                   device=device),
               delta_prev=torch.zeros((B,), dtype=dtype, device=device),
               alpha_prev=torch.ones((B,), dtype=dtype, device=device),
               prev_cvio=torch.full((B,), float("inf"), dtype=dtype,
                                    device=device),
               delta_fin=torch.zeros((B,), dtype=dtype, device=device))
    return kkt, w_owner, c


def solve_trip(prob: GameProblem, kkt, w_owner, c: _Carry):
    """One trip of the flat (k, l) machine on the lanes still active: the
    next carry, or None once no lane is."""
    active = (c.k < prob.opts.outer_iter) & ~c.done
    n_active = int(active.sum())
    if n_active == 0:
        return None
    new = _body(prob, kkt, w_owner, c, active)
    return new if n_active == c.k.shape[0] else where_tree(active, new, c)


def newton_solve(prob: GameProblem, x0s: torch.Tensor | None = None,
                 method="thomas", warm: PrimalDual | None = None,
                 generator: torch.Generator | None = None) -> SolveResult:
    """Full ALGAMES solve of one game per row of ``x0s`` [B, n] (default:
    ``prob.x0`` as a batch of one).  ``warm``: the MPC warm start, a
    previous plan [B, ...] shifted by ``opts.shift`` knots; ``generator``
    draws the fresh init (zeros without one); ``prob.gc`` may hold
    per-lane [B, K, C] AL state, which ``dual_reset=False`` uses as it is.
    ``method``: see :func:`_kkt_solver`.  Returns a batched SolveResult."""
    kkt, w_owner, c = solve_start(prob, x0s, method, warm, generator)
    while (new := solve_trip(prob, kkt, w_owner, c)) is not None:
        c = new
    return solve_finalize(prob, c)
