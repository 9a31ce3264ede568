"""The arithmetic of K3's register-tiled forward kernel
(``algames_tpu_torch/csrc/thomas_dense_core.cuh``), emulated in numpy on
full-size KKT systems built by the port on the CPU -- the roundabout's and
the bicycle's (size classes for d <= 24, Gauss-Jordan), the quadrotor's
turned dense (d=32) and iterative best response's quadrotor player systems
(p=1, d=28; the classes for d <= 32, LU) -- against the plain version
(``ops.thomas.solve_thomas_plain``) and the JAX package's reference solve
(``algames_tpu/problem/linear_solver.py::solve_tridiagonal_schur``).

The emulation follows the CUDA source step by step: the products of the
augmented system M = [K | RHS] as sequential sums in the kernel's order;
the x columns eliminated first; the pivot of column s the unused row of
largest magnitude, the lowest index on ties; with the reciprocal pivot,
either Gauss-Jordan elimination: the multipliers M[r, s] (1 / piv) of
every row but the pivot row, each such row updated over every column by
M[r, :] -= l_r M[pr, :], rows pivoted earlier included, then each pivot
row's right-hand sides times its 1 / piv are the unknowns; or LU (K1's,
``lu_back_substitution``): only the rows not pivoted yet are updated, then
a back substitution on the right-hand sides.  Only the kernel's fused
multiply-adds round once where numpy rounds twice.  The backward sweep is
the unchanged kernel's recursion.

Tolerances: on the roundabout and the bicycle, f64 <= 1e-10 relative to the
f64 plain version (worst lane, max |a - ref| / max |ref|); f32 within
``chip_smoke.py``'s K3 gate of 1e-3 against the f64 plain version, the
worst value printed.  The quadrotor's systems are too ill-conditioned for
a forward gate (the f32 plain version misses 1e-3 too): as in
``tests/test_torch_k1_order.py``, the normwise backward error
(``chip_smoke.backward_errors``), f64 <= 1e-15 and f32 <= 1e-7, each <= 10
x the plain version's in the same precision, and the f32 forward error
<= 30 x the f32 plain version's.  Against the JAX package (mu = 1e3, f64):
<= 1e-10.  Gauss-Jordan in LU's place misses the quadrotor's f32 gate
(``test_gauss_jordan_misses_the_dense_quadrotor_gate``): the reason the
classes for d <= 32 eliminate LU.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from algames_tpu.presets import PRESETS as JAX_PRESETS
from algames_tpu.problem import ibr as jibr
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur
from algames_tpu.problem.residual import JacBlocks as JaxJacBlocks

import chip_smoke
from algames_tpu_torch.core.spec import owner_map_u
from algames_tpu_torch.ops import thomas
from algames_tpu_torch.presets import intro_bicycle, quadrotor3d

torch.set_num_threads(1)
CPU = torch.device("cpu")
B = 4
QUAD = dict(preset=quadrotor3d,
            iterates=chip_smoke.golden_iterates("quad2_N15"))
GAMES = {"round4_N40": {},
         "bike3_N20": dict(preset=intro_bicycle,
                           iterates=chip_smoke.golden_iterates("bike3_N20")),
         "quad2_N15 dense": QUAD,
         "quad2_N15 ibr": QUAD}
# The systems too ill-conditioned for a forward gate.
QUAD_GAMES = ("quad2_N15 dense", "quad2_N15 ibr")


@functools.lru_cache(maxsize=None)
def system(game, mu):
    """B lanes of ``game``'s KKT systems (f64), as ``chip_smoke.py``'s K3
    phases build them: mu on the statx diagonals.  ``quad2_N15 dense``:
    the quadrotor's structured systems of ``tests/test_torch_k1_order.py``
    (its seed) turned dense (``K3-big``); ``quad2_N15 ibr``: its p=1
    player systems (``K3-ibr-quad``)."""
    kw = GAMES[game]
    if game == "quad2_N15 dense":
        spec, sq, b, w_owner = chip_smoke.k1_system(CPU, B, mu, 507, **kw)
        return spec, chip_smoke.dense_of(spec, sq, w_owner), b
    if game == "quad2_N15 ibr":
        return chip_smoke.ibr_player_system(CPU, B, mu, 7, **kw)
    return chip_smoke.k3_system(CPU, B, mu, 7, False, (0.3, 1.5),
                                kw.get("preset"), kw.get("iterates"))


def fill_in(At, Gx):
    """The Thomas fill-in F = -A_t G_{t-1} [B, n, pn], summed over k."""
    F = np.zeros(At.shape[:2] + Gx.shape[2:], At.dtype)
    for k in range(At.shape[2]):
        F = F + At[:, :, k, None] * Gx[:, None, k, :]
    return -F


def rhs_columns(M, F, Ub, Bm, At, A1, bk, yx, owner, n, m, p):
    """The u columns and the right-hand sides of the augmented system M
    (shared by K1 and K3), as the kernel sums them."""
    dt = M.dtype
    Bsz, pn, d = M.shape[0], p * n, n + m
    C = d + pn + 1
    M[:, :m, n:d] = Ub
    M[:, m:, n:d] = Bm
    for i in range(p):                           # G right-hand sides
        cols = slice(d + i * n, d + (i + 1) * n)
        acc = np.zeros((Bsz, n, n), dt)          # F_i A_{t+1}^T
        for k in range(n):
            acc = acc + F[:, :, i * n + k, None] * A1[:, None, :, k]
        M[:, m:, cols] = acc
        own = np.asarray(owner) == i
        acc = np.zeros((Bsz, m, n), dt)          # B^T A_{t+1}^T, owner i
        for k in range(n):
            acc = acc + Bm[:, k, :, None] * A1[:, None, :, k]
        M[:, :m, cols] = np.where(own[None, :, None], acc, dt.type(0))
    v = bk[:, pn:pn + m].copy()
    ba = bk[:, :pn].reshape(Bsz, p, n)
    for k in range(n):                           # c + B^T a_owner
        v = v + Bm[:, k, :] * ba[:, owner, k]
    M[:, :m, C - 1] = v
    s1 = np.zeros((Bsz, n), dt)
    for k in range(n):
        s1 = s1 + At[:, :, k] * yx[:, None, k]
    s2 = np.zeros((Bsz, n), dt)
    for k in range(pn):
        s2 = s2 + F[:, :, k] * bk[:, None, k]
    M[:, m:, C - 1] = bk[:, pn + m:] - s1 + s2


def gauss_jordan(M, d):
    """The kernel's elimination of M [B, d, C] in place: the solution
    [B, d, C - d], rows in step order ((x, u) order: x columns first)."""
    dt = M.dtype
    Bsz = M.shape[0]
    lanes = np.arange(Bsz)
    used = np.zeros((Bsz, d), bool)
    step_of = np.zeros((Bsz, d), int)
    pivrow = np.zeros((Bsz, d), int)
    rinvs = np.zeros((Bsz, d), dt)
    for s in range(d):
        col = M[:, :, s].copy()
        mag = np.where(used, -np.inf, np.abs(col))
        pr = np.argmax(mag, axis=1)              # first maximum: lowest index
        rinv = (dt.type(1) / col[lanes, pr]).astype(dt)
        slot = col * rinv[:, None]               # multipliers of every row
        pivrow[:, s], rinvs[:, s] = pr, rinv
        upd = np.ones((Bsz, d), bool)
        upd[lanes, pr] = False                   # every row but the pivot row
        prow = M[lanes, pr]                      # [B, C]
        M[:] = np.where(upd[:, :, None],
                        M - slot[:, :, None] * prow[:, None, :], M)
        step_of[lanes, pr] = s
        used[lanes, pr] = True
    M[:, :, d:] = M[:, :, d:] * rinvs[lanes[:, None], step_of][:, :, None]
    return M[lanes[:, None], pivrow, d:]


def lu_back_substitution(M, d):
    """The LU elimination of M [B, d, C] in place (K1's, and K3's classes
    for d > 24): the reciprocal pivot, only the rows not pivoted yet
    updated, then the back substitution on the right-hand sides.  Returns
    the solution [B, d, C - d], rows in step order."""
    dt = M.dtype
    Bsz = M.shape[0]
    lanes = np.arange(Bsz)
    used = np.zeros((Bsz, d), bool)
    step_of = np.zeros((Bsz, d), int)
    pivrow = np.zeros((Bsz, d), int)
    rinvs = np.zeros((Bsz, d), dt)
    for s in range(d):
        col = M[:, :, s].copy()
        mag = np.where(used, -np.inf, np.abs(col))
        pr = np.argmax(mag, axis=1)              # first maximum: lowest index
        rinv = (dt.type(1) / col[lanes, pr]).astype(dt)
        slot = col * rinv[:, None]               # multipliers
        pivrow[:, s], rinvs[:, s] = pr, rinv
        used[lanes, pr] = True
        step_of[lanes, pr] = s
        prow = M[lanes, pr]                      # [B, C]
        M[:] = np.where(~used[:, :, None],      # the rows not pivoted yet
                        M - slot[:, :, None] * prow[:, None, :], M)
    for s in range(d - 1, 0, -1):
        xs = M[lanes, pivrow[:, s], d:] * rinvs[:, s, None]
        earlier = (step_of < s)[:, :, None]
        M[:, :, d:] = np.where(earlier, M[:, :, d:]
                               - M[:, :, s, None] * xs[:, None, :],
                               M[:, :, d:])
    M[:, :, d:] = M[:, :, d:] * rinvs[lanes[:, None], step_of][:, :, None]
    return M[lanes[:, None], pivrow, d:]


def elimination_of(spec):
    """The elimination of the size class K3 takes at ``spec``'s widths:
    Gauss-Jordan for d <= 24, LU beyond (``csrc/thomas_dense.cu::
    tiled_kernel``)."""
    return gauss_jordan if spec.n + spec.m <= 24 else lu_back_substitution


def forward_knot(Q, Ub, Bm, At, A1, bk, Gx, yx, owner, n, m, p,
                 eliminate=gauss_jordan):
    """One knot of the forward sweep, as the kernel computes it: returns
    the solution [B, d, R] (rows in (x, u) order, columns [G | y])."""
    dt = Q.dtype
    pn, d = p * n, n + m
    Bsz = Q.shape[0]
    F = fill_in(At, Gx)
    M = np.zeros((Bsz, d, d + pn + 1), dt)
    Qo = Q[:, owner]                             # [B, m, n, n]
    acc = np.zeros((Bsz, m, n), dt)              # B^T Q_owner
    for k in range(n):
        acc = acc + Bm[:, k, :, None] * Qo[:, :, k, :]
    M[:, :m, :n] = acc
    acc = np.zeros((Bsz, n, n), dt)              # sum_i F_i Q_i
    for i in range(p):
        for k in range(n):
            acc = acc + F[:, :, i * n + k, None] * Q[:, i, k, None, :]
    M[:, m:, :n] = acc - np.eye(n, dtype=dt)
    rhs_columns(M, F, Ub, Bm, At, A1, bk, yx, owner, n, m, p)
    return eliminate(M, d)


def emulate(spec, jb, b, dtype, eliminate=None):
    """K3 (register-tiled forward, the unchanged backward) on numpy copies
    of ``jb`` and ``b`` in ``dtype``: the flat [B, S] solution.
    ``eliminate``: the elimination of each knot's system (default: that of
    the size class at these widths)."""
    eliminate = eliminate or elimination_of(spec)
    Q, Ub, Bm, A = (getattr(jb, f).numpy().astype(dtype)
                    for f in ("Qblk", "Ublk", "B", "A"))
    bk = b.numpy().astype(dtype)
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    pn = p * n
    owner = owner_map_u(spec)
    Gx = np.zeros((B, n, pn), dtype)
    yx = np.zeros((B, n), dtype)
    zero = np.zeros((B, n, n), dtype)
    sols = []
    for t in range(T):
        A1 = A[:, t + 1] if t + 1 < T else zero
        sol = forward_knot(Q[:, t], Ub[:, t], Bm[:, t], A[:, t], A1,
                           bk[:, t], Gx, yx, owner, n, m, p, eliminate)
        sols.append(sol)
        Gx, yx = sol[:, :n, :pn], sol[:, :n, pn]
    return backward(spec, sols, Q, A, bk, dtype)


def backward(spec, sols, Q, A, bk, dtype):
    """K3's backward recursion (thomas_dense_bwd_kernel) from each knot's
    forward solution [B, d, p n + 1] (``sols``; numpy operands in
    ``dtype``): the flat [B, S] solution."""
    n, p, T = spec.n, spec.p, spec.T
    pn = p * n
    zero = np.zeros((B, n, n), dtype)
    lam_next = np.zeros((B, pn), dtype)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        G, yhat = sols[t][:, :, :pn], sols[t][:, :, pn]
        xu = yhat - np.einsum("zrc,zc->zr", G, lam_next)
        A1T = (A[:, t + 1] if t + 1 < T else zero).transpose(0, 2, 1)
        lam = (np.einsum("zpab,zb->zpa", Q[:, t], xu[:, :n])
               + np.einsum("zab,zpb->zpa", A1T, lam_next.reshape(B, p, n))
               - bk[:, t, :pn].reshape(B, p, n)).reshape(B, pn)
        out[t] = np.concatenate([xu, lam], axis=1)
        lam_next = lam
    return np.stack(out, axis=1).reshape(B, -1)


def rel(a, ref):
    a = np.asarray(a, np.float64).reshape(B, -1)
    ref = np.asarray(ref, np.float64).reshape(B, -1)
    return float((np.abs(a - ref).max(1) / np.abs(ref).max(1)).max())


def quad_gates(spec, jb, b, y, dtype, ref):
    """The quadrotor's gates on the emulated solution ``y``: backward error
    f64 <= 1e-15, f32 <= 1e-7, each <= 10 x the plain version's in the same
    precision; in f32 the forward error <= 30 x the f32 plain version's.
    Returns (backward error, the plain version's)."""
    f32 = dtype == np.float32
    jbd = type(jb)(*[getattr(jb, f).float() if f32 else getattr(jb, f)
                     for f in ("Qblk", "Ublk", "A", "B")])
    plain = thomas.solve_thomas_plain(spec, jbd, b.to(jbd.A.dtype))
    bw, bw_plain = (float(e.max()) for e in chip_smoke.backward_errors(
        spec, jb, None, b, (torch.as_tensor(y), plain)))
    err, err_plain = rel(y, ref), rel(plain.numpy(), ref)
    print(f"backward error {bw:.3e} (plain {bw_plain:.3e}); forward "
          f"{err:.3e} (plain {err_plain:.3e})")
    assert bw <= (1e-7 if f32 else 1e-15) and bw <= 10 * bw_plain, (
        bw, bw_plain)
    if f32:
        assert err <= 30 * err_plain, (err, err_plain)
    return bw, bw_plain


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mu", [1.0, 1e3, 1e7])
@pytest.mark.parametrize("game", sorted(GAMES))
def test_emulated_elimination_matches_the_plain_version(game, mu, dtype):
    spec, jb, b = system(game, mu)
    ref = thomas.solve_thomas_plain(spec, jb, b).numpy()
    y = emulate(spec, jb, b, dtype)
    print(f"{game} mu={mu:g} {np.dtype(dtype).name}:", end=" ")
    if game in QUAD_GAMES:
        quad_gates(spec, jb, b, y, dtype, ref)
        return
    err = rel(y, ref)
    print(f"worst relative error {err:.3e}")
    assert err <= (1e-10 if dtype == np.float64 else 1e-3), err


def test_gauss_jordan_misses_the_dense_quadrotor_gate():
    """Gauss-Jordan in the place of LU on the quadrotor's systems turned
    dense (d=32): at mu = 1e7 in f32 its normwise backward error exceeds
    10 x the f32 plain version's, which LU meets (the test above): the
    reason K3's classes for d <= 32 eliminate LU."""
    spec, jb, b = system("quad2_N15 dense", 1e7)
    jb32 = type(jb)(*[getattr(jb, f).float()
                      for f in ("Qblk", "Ublk", "A", "B")])
    p32 = thomas.solve_thomas_plain(spec, jb32, b.float())
    y = emulate(spec, jb, b, np.float32, gauss_jordan)
    bw, bw_plain = (float(e.max()) for e in chip_smoke.backward_errors(
        spec, jb, None, b, (torch.as_tensor(y), p32)))
    print(f"Gauss-Jordan backward error {bw:.3e}, {bw / bw_plain:.1f} x the "
          f"f32 plain version's {bw_plain:.3e}")
    assert bw > 10 * bw_plain, (bw, bw_plain)


def jax_spec(game, spec):
    """The JAX package's spec of ``game``'s systems: its preset's, or for
    the IBR player systems its player spec (player 0: the players share
    their widths)."""
    _, jspec = JAX_PRESETS[game.split()[0]]()
    return jibr._PlayerSpec(jspec, 0) if game == "quad2_N15 ibr" else jspec


@pytest.mark.parametrize("game", sorted(GAMES))
def test_emulated_elimination_matches_the_jax_reference(game):
    """The same systems (mu = 1e3, f64) through the JAX package's
    ``solve_tridiagonal_schur``, lane by lane."""
    spec, jb, b = system(game, 1e3)
    jspec = jax_spec(game, spec)
    assert (jspec.T, jspec.n, jspec.m, jspec.p, jspec.pu) == (
        spec.T, spec.n, spec.m, spec.p, spec.pu)
    jjb = JaxJacBlocks(*[getattr(jb, f).numpy()
                         for f in ("Qblk", "Ublk", "A", "B")])
    ref = jax.jit(jax.vmap(lambda j, bb: solve_tridiagonal_schur(
        jspec, j, bb)))(jjb, b.numpy())
    err = rel(emulate(spec, jb, b, np.float64), np.asarray(ref))
    assert err <= 1e-10, err
