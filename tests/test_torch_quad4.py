"""The 4-player quadrotor (``quadrotor_game(p=4)``: n=48, m=16, so reduced
KKT systems of d=64 with R=193 right-hand sides), the configuration that
takes K1's and K3's device-memory forward route
(``algames_tpu_torch/csrc/thomas_global.cuh``) and K4's quadrotor instance
past 32 states, on the CPU against the JAX package.  f64 unless named.

- The port's preset ``quadrotor3d(p=4)`` is the JAX package's quadrotor
  preset with four players (``tests/reference_fractions.py::
  jax_quadrotor``), leaf for leaf.
- Plain K1 and K3 against the JAX package's plain reference of its Pallas
  KKT kernels (``solve_tridiagonal_schur``) on the game's KKT systems at
  N=4 (T=3), B=2, mu = 1e3 on the statx diagonals: worst per-lane relative
  error <= 1e-10, as ``tests/test_torch_k1_order.py`` holds its systems
  against the JAX package.  The Pallas kernels themselves in interpret
  mode take over four minutes a call at d=64 on a CPU:
  ``tests/quad4_interpret.py`` (not collected) holds the same systems
  against them.
- The plain trial against the generic fused trial kernel
  (``fused_trial_for_spec``, interpret mode) at N=4, B=2, random AL state:
  every output leaf within 1e-12 relative, as ``tests/test_torch_dense.py``
  holds the roundabout's; ``trial_supported`` on the 3- and 4-player
  quadrotors (K4's quadrotor instance takes 64 states) and not past 64; a
  state bound's rows flagged in the parameter array.
- The slice: two scenarios of the game at N=5, outer 1 x inner 4, through
  the port's ``method="thomas"`` with ``ls_fused`` (K1 and K4, their plain
  versions here) against the JAX package's ``"schur"`` solve: iteration
  counts equal, x and u within 1e-8.
- The device-memory route's arithmetic, emulated in numpy (``panel_lu``,
  in the order of the CUDA source) on full-size systems of the game (N=15,
  B=4, ``chip_smoke.py``'s ``K1-wide64`` and ``K3-big64`` systems), K1's
  structured form and K3's dense form: against the plain version, the
  normwise backward error (``chip_smoke.backward_errors``) f64 <= 1e-15
  and f32 <= 1e-7, each <= 10 x the plain version's in the same precision,
  and the f32 forward error <= 30 x the f32 plain version's (the gates of
  ``tests/test_torch_k1_order.py``'s quadrotor systems); against the JAX
  package's ``solve_tridiagonal_schur`` (mu = 1e3, f64): <= 1e-10.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import algames_tpu as ag
from algames_tpu.ops.trial_pallas import fused_trial_for_spec
from algames_tpu.parallel import batch as jbatch
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur
from algames_tpu.problem.residual import JacBlocks as JaxJacBlocks

import chip_smoke
import test_torch_k1_order as k1o
import test_torch_k3_order as k3o
import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as tsets
from algames_tpu_torch.constraints.kernels import make_bound
from algames_tpu_torch.core.spec import owner_map_u
from algames_tpu_torch.convert import problem_from_reference
from algames_tpu_torch.core.traj import PrimalDual
from algames_tpu_torch.objective.objective import add_collision_cost
from algames_tpu_torch.ops import thomas, trial
from algames_tpu_torch.presets import quadrotor3d
from algames_tpu_torch.utils import tree_leaves, tree_map
from reference_fractions import jax_quadrotor
from test_torch_roundabout import gc_axes, random_al_state

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
B_SHORT = 2
B = k1o.B                     # the emulation's lanes (its module's)


def rel(a, ref, lanes):
    a = np.asarray(a, np.float64).reshape(lanes, -1)
    ref = np.asarray(ref, np.float64).reshape(lanes, -1)
    scale = np.maximum(np.abs(ref).max(1), np.finfo(np.float64).tiny)
    return float((np.abs(a - ref).max(1) / scale).max())


@functools.lru_cache(maxsize=None)
def short_game(N):
    """The JAX package's 4-player quadrotor at horizon N (outer 1 x 4) and
    its conversion."""
    jprob, jspec = jax_quadrotor(4, jnp.float64, N=N, outer=1, inner=4)
    return jprob, jspec, problem_from_reference(jprob, CPU, F64)


def test_native_preset_is_the_reference_game():
    """``presets.quadrotor3d(p=4)`` is the JAX package's quadrotor preset
    with four players, as ``chip_smoke.py`` and the reference fractions
    build it."""
    jprob, _ = jax_quadrotor(4, jnp.float64)
    ref = problem_from_reference(jprob, CPU, F64)
    prob, spec = quadrotor3d(CPU, F64, outer=2, inner=5, p=4)
    assert (spec.n, spec.m, spec.p, spec.T) == (48, 16, 4, 14)
    assert spec == ref.spec and prob.opts == ref.opts
    assert prob.model == ref.model
    for a, r in zip(tree_leaves((prob.x0, prob.obj, prob.gc)),
                    tree_leaves((ref.x0, ref.obj, ref.gc))):
        np.testing.assert_array_equal(a.numpy(), r.numpy())


@functools.lru_cache(maxsize=None)
def short_systems():
    """B_SHORT lanes of the game's structured KKT systems at N=4 (T=3),
    assembled by the port around perturbed hover iterates, mu = 1e3 on the
    statx diagonals (``chip_smoke.k1_system``)."""
    jprob, jspec, tprob = short_game(4)
    return jspec, *chip_smoke.k1_system(
        CPU, B_SHORT, 1e3, 17, preset=lambda dev, dtype: (tprob, tprob.spec),
        iterates=chip_smoke.quad3_iterates)


def jax_reference(jspec, dense, b):
    """The JAX package's ``solve_tridiagonal_schur`` on dense blocks, the
    plain reference its tests hold its Pallas KKT kernels to."""
    jjb = JaxJacBlocks(*[getattr(dense, f).numpy()
                         for f in ("Qblk", "Ublk", "A", "B")])
    return jax.jit(jax.vmap(lambda j, bb: solve_tridiagonal_schur(
        jspec, j, bb)))(jjb, b.numpy())


def test_plain_k1_matches_the_jax_reference():
    jspec, spec, sq, b, w_owner = short_systems()
    assert (spec.n + spec.m, spec.p * spec.n + 1, spec.T) == (64, 193, 3)
    ref = jax_reference(jspec, chip_smoke.dense_of(spec, sq, w_owner), b)
    y = thomas.solve_thomas_structured(spec, sq, b, w_owner)
    err = rel(y.numpy(), ref, B_SHORT)
    assert err <= 1e-10, err


def test_plain_k3_matches_the_jax_reference():
    jspec, spec, sq, b, w_owner = short_systems()
    jb = chip_smoke.dense_of(spec, sq, w_owner)
    y = thomas.solve_thomas(spec, jb, b)
    err = rel(y.numpy(), jax_reference(jspec, jb, b), B_SHORT)
    assert err <= 1e-10, err


def test_plain_trial_matches_the_fused_pallas_trial():
    jprob, jspec, tprob = short_game(4)
    spec = tprob.spec
    rng = np.random.default_rng(23)
    hover = 0.5 * 9.81 / 4.0 / tprob.model.kf
    arrs = dict(
        x=np.asarray(jprob.x0)[None, None]
        + 0.1 * rng.standard_normal((B_SHORT, spec.N, spec.n)),
        u=hover + 0.3 * rng.standard_normal((B_SHORT, spec.T, spec.m)),
        lam=0.3 * rng.standard_normal((B_SHORT, spec.p, spec.T, spec.n)))
    steps = dict(
        x=0.05 * rng.standard_normal((B_SHORT, spec.N, spec.n)),
        u=0.05 * rng.standard_normal((B_SHORT, spec.T, spec.m)),
        lam=0.05 * rng.standard_normal((B_SHORT, spec.p, spec.T, spec.n)))
    alpha = 0.5 ** rng.integers(0, 6, size=B_SHORT)
    reg = 1e-3 * (1.0 + rng.integers(0, 20, size=B_SHORT)) ** 4
    jgc, tgc = random_al_state(jprob.gc, tprob.gc, B_SHORT, rng)
    assert trial.trial_supported(tprob.model, spec, tprob.obj, tgc)
    fused = fused_trial_for_spec(jprob.model, jspec, interpret=True)
    ref = jax.jit(jax.vmap(
        lambda g, t, d, a, r: fused(t, d, a, r, g, jprob.obj),
        in_axes=(gc_axes(jgc), 0, 0, 0, 0)))(
            jgc, ag.PrimalDual(**{k: jnp.asarray(v)
                                  for k, v in arrs.items()}),
            ag.PrimalDual(**{k: jnp.asarray(v) for k, v in steps.items()}),
            jnp.asarray(alpha), jnp.asarray(reg))

    def t(a):
        return torch.as_tensor(a, dtype=F64)
    tn, lite = trial.trial_eval(
        tprob.model, spec, tprob.obj, tgc,
        PrimalDual(**{k: t(v) for k, v in arrs.items()}),
        PrimalDual(**{k: t(v) for k, v in steps.items()}), t(alpha), t(reg))
    assert rel(tn.numpy(), ref[0], B_SHORT) <= 1e-12
    leaves, leaves_r = tree_leaves(lite), jax.tree_util.tree_leaves(ref[1])
    assert len(leaves) == len(leaves_r)
    for a, r in zip(leaves, leaves_r):
        assert tuple(a.shape) == tuple(np.asarray(r).shape)
        assert rel(a.numpy(), r, B_SHORT) <= 1e-12, rel(a.numpy(), r,
                                                        B_SHORT)


def test_trial_supported_on_the_wide_quadrotors():
    """K4's quadrotor instance takes up to 64 states (the 3- and 4-player
    quadrotors: 36 and 48); 6 players (72) lie outside and keep the eager
    trial; the unicycle takes up to 68 states (its wide instance past 32:
    9 players, 36 states, and 17 players, 68, inside; 18 players, 72,
    outside).  A state bound on all 48 states flags all 96 rows in the
    parameter array after its z_max and z_min (the quadrotor's instance
    reads them there, past the 64 rows of the record's mask), its mask
    0."""
    for p, inside in ((3, True), (4, True), (6, False)):
        prob, spec = quadrotor3d(CPU, F64, p=p)
        assert trial.trial_supported(prob.model, spec, prob.obj,
                                     prob.gc) == inside, p
    for p, inside in ((9, True), (17, True), (18, False)):
        uni = agt.unicycle_game(p=p)
        spec = agt.spec_from_model(uni, 5, 0.1)
        gc = tsets.game_constraints(spec, dtype=F64, device=CPU)
        obj = agt.game_objective(spec, Q=[np.ones(4)] * p,
                                 R=[np.ones(2)] * p, xf=[np.zeros(4)] * p,
                                 uf=[np.zeros(2)] * p, dtype=F64, device=CPU)
        assert spec.n == 4 * p
        assert trial.trial_supported(uni, spec, obj, gc) == inside, p
    prob, spec = quadrotor3d(CPU, F64, p=4)
    n = spec.n
    bound = tsets.ConBlock(
        params=make_bound(np.full(n, 5.0), np.full(n, -5.0), F64, CPU),
        lam=torch.zeros(spec.T, 2 * n), mu=torch.ones(spec.T, 2 * n),
        owner=0, is_state=True)
    gc = dataclasses.replace(prob.gc, state_blocks=prob.gc.state_blocks
                             + (bound,))
    assert trial.trial_supported(prob.model, spec, prob.obj, gc)
    assert "quadrotor" in trial._ROW_FLAGS
    meta, masks, spar, _ = trial._state_tables(gc.state_blocks, F64, CPU,
                                               True)
    assert masks[-1] == 0
    par = meta[-12 + 3]                  # the bound's first parameter
    assert spar.numel() == par + 4 * n
    assert spar[par + 2 * n:].tolist() == [1.0] * (2 * n)


def test_slice_matches_the_reference_schur_solve():
    """Two scenarios of the game (N=5, outer 1 x inner 4) through the
    port's ``"thomas"`` method with the fused trial (plain versions on the
    CPU) against the JAX package's ``"schur"`` solve."""
    jprob, jspec, tprob = short_game(5)
    tprob = dataclasses.replace(tprob, opts=dataclasses.replace(
        tprob.opts, ls_fused=True))
    assert trial.trial_supported(tprob.model, tprob.spec, tprob.obj,
                                 tprob.gc)
    rng = np.random.default_rng(2)
    x0s = np.asarray(jprob.x0)[None] + 0.05 * rng.standard_normal(
        (2, jspec.n))
    ref = jax.jit(lambda x: jbatch.solve_batch(jprob, x, method="schur"))(
        jnp.asarray(x0s))
    out = agt.parallel.solve_batch(tprob, torch.as_tensor(x0s))
    np.testing.assert_array_equal(out.stats.iter.numpy(),
                                  np.asarray(ref.stats.iter))
    np.testing.assert_allclose(out.traj.x.numpy(), np.asarray(ref.traj.x),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.traj.u.numpy(), np.asarray(ref.traj.u),
                               rtol=0, atol=1e-8)


def panel_lu(M, d):
    """The device-memory route's elimination of M [B, d, C] (K and the
    right-hand sides; ``csrc/thomas_global.cuh``): the pivot of column s
    the unused row of largest magnitude, the lowest index on ties; the rows
    not pivoted yet take K[r, c] -= (K[r, s] (1 / piv)) K[pr, c] over the
    columns c > s of K only; then per right-hand side, in pivot order, the
    forward substitution with the multipliers K[pr_j, s] (1 / piv_s) and
    the back substitution x_i = (y_i - sum_{j > i} U[i, j] x_j) / U[i, i],
    summed over increasing j.  Returns the solution [B, d, C - d] in
    variable order."""
    dt = M.dtype
    lanes = np.arange(M.shape[0])
    K = M[:, :, :d].copy()
    used = np.zeros((M.shape[0], d), bool)
    pivrow = np.zeros((M.shape[0], d), int)
    for s in range(d):
        col = K[:, :, s].copy()
        pr = np.argmax(np.where(used, -np.inf, np.abs(col)), axis=1)
        rp = (dt.type(1) / col[lanes, pr]).astype(dt)
        pivrow[:, s] = pr
        used[lanes, pr] = True
        prow = K[lanes, pr]
        upd = (~used)[:, :, None] & (np.arange(d) > s)[None, None, :]
        K = np.where(upd, K - (col * rp[:, None])[:, :, None]
                     * prow[:, None, :], K)
    Kp = K[lanes[:, None], pivrow]                      # rows in pivot order
    piv = Kp[:, np.arange(d), np.arange(d)]
    x = M[lanes[:, None], pivrow, d:].copy()
    for i in range(d):
        mult = Kp[:, i + 1:, i] * (dt.type(1) / piv[:, i])[:, None]
        x[:, i + 1:] = x[:, i + 1:] - mult[:, :, None] * x[:, i, None, :]
    for i in range(d - 1, -1, -1):
        s = x[:, i].copy()
        for j in range(i + 1, d):
            s = s - Kp[:, i, j, None] * x[:, j]
        x[:, i] = s / piv[:, i, None]
    return x


def blocked_knot(q, w, Ub, Bm, At, A1, bk, X, owner, w_owner, n, m, p):
    """One knot of K1's per-player blocked forward route
    (``csrc/thomas_blocked.cuh``, Q form ``StructuredForm``) on lanes'
    numpy operands: :func:`blocked_sweep_knot` with K's x columns in
    StructuredQ's order (``test_torch_k1_order.x_columns``)."""
    return blocked_sweep_knot(
        lambda K, F: k1o.x_columns(K, F, q, w, Bm, owner, w_owner, n, m, p),
        Ub, Bm, At, A1, bk, X, owner, n, m, p)


def dense_x_columns(K, F, Q, Bm, owner, n, m, p):
    """K3's x columns on the blocked route (``DenseForm``), in the kernel's
    order: player by player, k ascending, F_i Q_i added to the dyn rows and
    B^T Q_i to the statu rows that player i owns, into one running sum per
    entry from zero; then -I on the dyn rows."""
    dt = K.dtype
    own = np.asarray(owner, int)
    acc = np.zeros(K.shape[:1] + (m + n, n), dt)
    for i in range(p):
        mine = (own == i)[None, :, None]
        for k in range(n):
            acc[:, :m] = np.where(
                mine, acc[:, :m] + Bm[:, k, :, None] * Q[:, i, None, k, :],
                acc[:, :m])
            acc[:, m:] = acc[:, m:] + F[:, :, i * n + k, None] * Q[:, i, None,
                                                                   k, :]
    K[:, :, :n] = acc
    K[:, m:, :n] = K[:, m:, :n] + (-np.eye(n, dtype=dt))


def dense_blocked_knot(Q, Ub, Bm, At, A1, bk, X, owner, n, m, p):
    """One knot of K3's per-player blocked forward route (Q form
    ``DenseForm``): :func:`blocked_sweep_knot` with :func:`dense_x_columns`
    (``Q`` [B, p, n, n])."""
    return blocked_sweep_knot(
        lambda K, F: dense_x_columns(K, F, Q, Bm, owner, n, m, p), Ub, Bm,
        At, A1, bk, X, owner, n, m, p)


def blocked_sweep_knot(x_columns, Ub, Bm, At, A1, bk, X, owner, n, m, p):
    """One knot of the per-player blocked forward route
    (``csrc/thomas_blocked.cuh``) on lanes' numpy operands, in the kernel's
    order, K's x columns (-I included) by the Q form's ``x_columns(K,
    F)``: X [B, d, R] is the previous knot's solution in variable order
    (the carry: zero at the first knot); returns this knot's.

    u = y_{t-1} + G_{t-1} a, four partial sums over quarters of the row
    added pairwise; F_i = -A_t G_{t-1,i}; the y column c + B^T a_owner on
    the statu rows and d0 - A_t u on the dyn rows; K's x columns; LU of K
    with the lowest-index largest pivot, multipliers K[r, s] (1 / piv) of
    the rows not pivoted yet, which take K[r, :] -= l K[pr, :]; the
    right-hand sides [B^T A_{t+1}^T on the owner's statu rows; F_i
    A_{t+1}^T] in pivot order; the forward substitution Z[v] -= L[v, s]
    Z[s] over v > s, step by step; the back substitution last step first,
    x_s = Z[s] (1 / piv_s), Z[v] -= U[v, s] x_s over v < s."""
    dt = X.dtype
    Bsz = X.shape[0]
    pn, d = p * n, n + m
    lanes = np.arange(Bsz)
    a = bk[:, :pn]
    quarter = (pn + 3) // 4
    parts = []
    for part in range(4):
        s = np.zeros((Bsz, n), dt)
        for j in range(part * quarter, min(pn, (part + 1) * quarter)):
            s = s + X[:, :n, j] * a[:, None, j]
        parts.append(s)
    u = X[:, :n, pn] + ((parts[0] + parts[1]) + (parts[2] + parts[3]))
    F = np.zeros((Bsz, n, pn), dt)
    for i in range(p):
        F[:, :, i * n:(i + 1) * n] = k3o.fill_in(
            At, X[:, :n, i * n:(i + 1) * n])
    own = np.asarray(owner, int)
    yr = np.zeros((Bsz, d), dt)
    v = bk[:, pn:pn + m].copy()
    ba = a.reshape(Bsz, p, n)
    for k in range(n):                           # c + B^T a_owner
        v = v + Bm[:, k, :] * ba[:, own, k]
    yr[:, :m] = v
    s = np.zeros((Bsz, n), dt)
    for k in range(n):                           # d0 - A_t u
        s = s + At[:, :, k] * u[:, None, k]
    yr[:, m:] = bk[:, pn + m:] - s
    K = np.zeros((Bsz, d, d), dt)
    x_columns(K, F)
    K[:, :m, n:] = Ub
    K[:, m:, n:] = Bm
    used = np.zeros((Bsz, d), bool)
    pivrow = np.zeros((Bsz, d), int)
    rinv = np.zeros((Bsz, d), dt)
    L = np.zeros((Bsz, d, d), dt)                # rows in the original order
    for s in range(d):
        col = K[:, :, s].copy()
        pr = np.argmax(np.where(used, -np.inf, np.abs(col)), axis=1)
        ri = (dt.type(1) / col[lanes, pr]).astype(dt)
        mult = col * ri[:, None]
        L[:, :, s] = np.where(used, L[:, :, s], mult)
        pivrow[:, s], rinv[:, s] = pr, ri
        prow = K[lanes, pr].copy()
        upd = ~used & (np.arange(d)[None, :] != pr[:, None])
        K = np.where(upd[:, :, None], K - mult[:, :, None] * prow[:, None, :],
                     K)
        used[lanes, pr] = True
    rhs = np.zeros((Bsz, d, pn + 1), dt)
    for i in range(p):
        acc = np.zeros((Bsz, n, n), dt)          # F_i A_{t+1}^T
        for k in range(n):
            acc = acc + F[:, :, i * n + k, None] * A1[:, None, :, k]
        rhs[:, m:, i * n:(i + 1) * n] = acc
        acc = np.zeros((Bsz, m, n), dt)          # B^T A_{t+1}^T, owner i
        for k in range(n):
            acc = acc + Bm[:, k, :, None] * A1[:, None, :, k]
        rhs[:, :m, i * n:(i + 1) * n] = np.where(
            (own == i)[None, :, None], acc, dt.type(0))
    rhs[:, :, pn] = yr
    rows = (lanes[:, None], pivrow)
    Z, Lp, Up = rhs[rows], L[rows], K[rows]      # pivot order
    for s in range(d - 1):
        Z[:, s + 1:] = Z[:, s + 1:] - Lp[:, s + 1:, s, None] * Z[:, s, None]
    for s in range(d - 1, -1, -1):
        xs = Z[:, s] * rinv[:, s, None]
        Z[:, :s] = Z[:, :s] - Up[:, :s, s, None] * xs[:, None]
        Z[:, s] = xs
    return Z


def blocked_route(spec, sq, b, w_owner, dtype):
    """K1 on its per-player blocked forward route (``blocked_knot``) and the
    unchanged backward kernel, on numpy copies of ``sq`` and ``b`` in
    ``dtype``: the flat [B, S] solution."""
    q, w, Ub, Bm, A = (getattr(sq, f).numpy().astype(dtype)
                       for f in ("qdiag", "wv", "Ublk", "B", "A"))
    bk = b.numpy().astype(dtype)
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    owner = owner_map_u(spec)
    X = np.zeros((B, n + m, p * n + 1), dtype)
    zero = np.zeros((B, n, n), dtype)
    sols = []
    for t in range(T):
        A1 = A[:, t + 1] if t + 1 < T else zero
        X = blocked_knot(q[:, t], w[:, t], Ub[:, t], Bm[:, t], A[:, t], A1,
                         bk[:, t], X, owner, w_owner, n, m, p)
        sols.append(X)
    return k1o.backward(spec, sols, q, w, A, bk, w_owner, dtype)


def dense_blocked_route(spec, jb, b, dtype):
    """K3 on its per-player blocked forward route (``dense_blocked_knot``)
    and the unchanged backward kernel, on numpy copies of ``jb`` and ``b``
    in ``dtype``: the flat [B, S] solution."""
    Q, Ub, Bm, A = (getattr(jb, f).numpy().astype(dtype)
                    for f in ("Qblk", "Ublk", "B", "A"))
    bk = b.numpy().astype(dtype)
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    owner = owner_map_u(spec)
    X = np.zeros((B, n + m, p * n + 1), dtype)
    zero = np.zeros((B, n, n), dtype)
    sols = []
    for t in range(T):
        A1 = A[:, t + 1] if t + 1 < T else zero
        X = dense_blocked_knot(Q[:, t], Ub[:, t], Bm[:, t], A[:, t], A1,
                               bk[:, t], X, owner, n, m, p)
        sols.append(X)
    return k3o.backward(spec, sols, Q, A, bk, dtype)


@functools.lru_cache(maxsize=None)
def full_system(form, mu):
    """B lanes of the game's full-size KKT systems (N=15), as
    ``chip_smoke.py``'s ``K1-wide64`` (structured) and ``K3-big64`` (the
    same turned dense) build them; the blocked routes' are K1's structured
    ones and K3's dense ones."""
    if form == "blocked":
        return full_system("structured", mu)
    if form == "dense-blocked":
        return full_system("dense", mu)
    spec, sq, b, w_owner = chip_smoke.k1_system(
        CPU, B, mu, 950, preset=chip_smoke.quad4_game,
        iterates=chip_smoke.quad3_iterates)
    if form == "dense":
        return spec, chip_smoke.dense_of(spec, sq, w_owner), b, None
    return spec, sq, b, w_owner


def emulate(form, spec, blocks, b, w_owner, dtype):
    if form == "dense":
        return k3o.emulate(spec, blocks, b, dtype, panel_lu)
    if form == "blocked":
        return blocked_route(spec, blocks, b, w_owner, dtype)
    if form == "dense-blocked":
        return dense_blocked_route(spec, blocks, b, dtype)
    return k1o.emulate(spec, blocks, b, w_owner, dtype, panel_lu)


def plain(form, spec, blocks, b, w_owner):
    if form in ("dense", "dense-blocked"):
        return thomas.solve_thomas_plain(spec, blocks, b)
    return thomas.solve_thomas_structured_plain(spec, blocks, b, w_owner)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mu", [1e3, 1e7])
@pytest.mark.parametrize("form", ["structured", "dense", "blocked",
                                  "dense-blocked"])
def test_emulated_route_meets_the_quadrotor_gates(form, mu, dtype):
    spec, blocks, b, w_owner = full_system(form, mu)
    assert spec.n + spec.m == 64
    ref = plain(form, spec, blocks, b, w_owner).numpy()
    y = emulate(form, spec, blocks, b, w_owner, dtype)
    f32 = dtype == np.float32
    low = blocks if not f32 else tree_map(lambda a: a.float(), blocks)
    p_low = plain(form, spec, low, b.to(low.A.dtype), w_owner)
    bw, bw_plain = (float(e.max()) for e in chip_smoke.backward_errors(
        spec, blocks, w_owner, b, (torch.as_tensor(y), p_low)))
    err, err_plain = rel(y, ref, B), rel(p_low.numpy(), ref, B)
    print(f"{form} mu={mu:g} {np.dtype(dtype).name}: backward error "
          f"{bw:.3e} (plain {bw_plain:.3e}); forward {err:.3e} (plain "
          f"{err_plain:.3e})")
    assert bw <= (1e-7 if f32 else 1e-15) and bw <= 10 * bw_plain, (
        bw, bw_plain)
    if f32:
        assert err <= 30 * err_plain, (err, err_plain)


@pytest.mark.parametrize("form", ["structured", "dense", "blocked",
                                  "dense-blocked"])
def test_emulated_route_matches_the_jax_reference(form):
    spec, blocks, b, w_owner = full_system(form, 1e3)
    dense = (blocks if w_owner is None
             else chip_smoke.dense_of(spec, blocks, w_owner))
    jspec = ag.spec_from_model(ag.quadrotor_game(p=4), spec.N, 0.1)
    assert (jspec.T, jspec.n, jspec.m, jspec.p, jspec.pu) == (
        spec.T, spec.n, spec.m, spec.p, spec.pu)
    ref = jax_reference(jspec, dense, b)
    err = rel(emulate(form, spec, blocks, b, w_owner, np.float64), ref, B)
    assert err <= 1e-10, err


@functools.lru_cache(maxsize=None)
def dense_system(game, mu):
    """B lanes of K3 systems beyond its classes that the blocked route
    takes, with the JAX package's spec: ``"quad4 cost"``, the KKT systems
    of ``chip_smoke.quad4_cost_game`` at N=4 (T=3; the game's collision
    cost between every pair of players makes Q_i full), around
    ``quad3_iterates``; ``"uni6 dense"``, ``K1-wide36``'s systems of the
    6-player unicycle (d=36, no multiple of 16) turned dense.  mu on the
    statx diagonals."""
    if game == "quad4 cost":
        _, jspec, tprob = short_game(4)
        spec = tprob.spec
        prob = dataclasses.replace(tprob, obj=add_collision_cost(
            spec, tprob.obj, radius=0.2 * np.ones(spec.p),
            mu=2.0 * np.ones(spec.p)))
        spec, jb, b = chip_smoke.k3_system(
            CPU, B, mu, 31, preset=lambda dev, dtype: (prob, spec),
            iterates=chip_smoke.quad3_iterates)
        return jspec, spec, jb, b
    spec, sq, b, w_owner = chip_smoke.k1_system(CPU, B, mu, 980,
                                                preset=chip_smoke.uni6_game)
    jspec = ag.spec_from_model(ag.unicycle_game(p=6), spec.N, spec.dt)
    return jspec, spec, chip_smoke.dense_of(spec, sq, w_owner), b


def cross_player(spec, Q):
    """The largest |entry| of the Q_i [B, T, p, n, n] that couples two
    players' positions."""
    worst = 0.0
    for i in range(spec.p):
        for j in range(spec.p):
            if i != j:
                block = Q[..., list(spec.px[i]), :][..., list(spec.px[j])]
                worst = max(worst, float(np.abs(block).max()))
    return worst


@pytest.mark.parametrize("mu", [1e3, 1e7])
@pytest.mark.parametrize("game", ["quad4 cost", "uni6 dense"])
def test_dense_blocked_route_beyond_the_classes(game, mu):
    """K3's blocked route, emulated (``dense_blocked_route``), on the
    collision-cost game's own systems (genuinely dense Q_i) and on the
    6-player unicycle's (d=36): the quadrotor's gates in f64 and f32
    (``test_torch_k3_order.quad_gates``) and, at mu = 1e3, within 1e-10 of
    the JAX package's ``solve_tridiagonal_schur`` in f64."""
    jspec, spec, jb, b = dense_system(game, mu)
    assert (spec.n + spec.m, jspec.n, jspec.m, jspec.p, jspec.T) == (
        64 if game == "quad4 cost" else 36, spec.n, spec.m, spec.p, spec.T)
    if game == "quad4 cost":
        assert cross_player(spec, jb.Qblk.numpy()) > 0
    ref = thomas.solve_thomas_plain(spec, jb, b).numpy()
    for dtype in (np.float64, np.float32):
        y = dense_blocked_route(spec, jb, b, dtype)
        k3o.quad_gates(spec, jb, b, y, dtype, ref)
        if dtype == np.float64 and mu == 1e3:
            err = rel(y, jax_reference(jspec, jb, b), B)
            assert err <= 1e-10, err
