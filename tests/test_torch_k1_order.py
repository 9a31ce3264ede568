"""The arithmetic of K1's register-tiled forward kernel
(``algames_tpu_torch/csrc/thomas_sq.cu`` on the structured Q form of
``csrc/thomas_dense_core.cuh``), emulated in numpy on full-size flagship,
double-integrator, quadrotor and 3-player quadrotor (d=48, the tall size
class of 256 threads) KKT systems built by the port on the CPU, against the
plain version (``ops.thomas.solve_thomas_structured_plain``) and the JAX
package's structured Pallas kernel (interpret mode) or, for the
quadrotors, its reference solve on the densified Q.

The emulation follows the CUDA source step by step: the fill-in
F = -A_t G_{t-1}; the products Bw[r, k] = B[:, r] . w_k (zero unless player
owner(r) owns w_k) and Fw[a, k] = F[a, owner(k) block] . w_k; the x columns
of the augmented system as sequential sums in the kernel's order,
  statu rows  B[c, r] q_o[c] + sum_k Bw[r, k] w_k[c],
  dyn rows    sum_i F[a, i n + c] q_i[c] + sum_k Fw[a, k] w_k[c] - delta_ac;
the other columns as K3's (``tests/test_torch_k3_order.py``); x columns
first, the lowest-index largest pivot and the reciprocal pivot as K3's,
but LU: at step s only the rows not pivoted yet are updated,
M[r, :] -= (M[r, s] / piv) M[pr, :]; then the back substitution on the
right-hand sides, last step first: x_s = M[pr_s, d:] / piv_s, and every row
pivoted before step s takes M[r, d:] -= M[r, s] x_s; each pivot row's
right-hand sides times its 1 / piv are the unknowns.  Then K1's unchanged
backward recursion.  Only the kernel's fused multiply-adds round once where
numpy rounds twice.  The tall class's 16 row groups change no summation
order: every sum is one thread's chain, whatever the thread grid.

Why LU and not K3's Gauss-Jordan: on the quadrotor's f32 systems
Gauss-Jordan misses the backward-error gate (``test_gauss_jordan_misses_
the_quadrotor_gate``).

Tolerances: ``chip_smoke.py``'s K1 gates.  On the flagship and the double
integrator the worst relative error against the f64 plain version (worst
lane, max |a - ref| / max |ref|): f64 <= 1e-10, f32 <= 1e-3.  The
quadrotor's systems are too ill-conditioned for a forward gate (at
mu = 1e7 two backward-stable f64 solvers differ by up to ~cond x eps: the
shared-memory kernel's elimination order gives 2.5e-10 there, this one
1.0e-10; both printed): its gate is the normwise backward error
(``chip_smoke.backward_errors``), f64 <= 1e-15 and f32 <= 1e-7, each <= 10 x
the plain version's in the same precision, and the f32 forward error <= 30
x the f32 plain version's; the 3-player quadrotor's likewise.  Against the
JAX package (mu = 1e3, f64): <= 1e-10.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from algames_tpu.core.spec import spec_from_model
from algames_tpu.models.quadrotor import quadrotor_game
from algames_tpu.ops.thomas_pallas import thomas_pallas_structured_for_spec
from algames_tpu.presets import PRESETS as JAX_PRESETS
from algames_tpu.problem.linear_solver import solve_tridiagonal_schur
from algames_tpu.problem.residual import JacBlocks as JaxJacBlocks
from algames_tpu.problem.residual import StructuredQ as JaxStructuredQ

import chip_smoke
from algames_tpu_torch.core.spec import owner_map_u
from algames_tpu_torch.ops import thomas
from algames_tpu_torch.presets import intro_di, quadrotor3d
from test_torch_k3_order import (fill_in, gauss_jordan, lu_back_substitution,
                                 rhs_columns)

torch.set_num_threads(1)
CPU = torch.device("cpu")
B = 4
GAMES = {"uni3_N20": (dict(), 0),
         "di2_N10": (dict(preset=intro_di,
                          iterates=chip_smoke.golden_iterates("di2_N10")),
                     300),
         "quad2_N15": (dict(preset=quadrotor3d,
                            iterates=chip_smoke.golden_iterates("quad2_N15")),
                       500),
         "quad3_N15": (dict(preset=chip_smoke.quad3_game,
                            iterates=chip_smoke.quad3_iterates), 900)}
# The systems too ill-conditioned for a forward gate.
QUAD_GAMES = ("quad2_N15", "quad3_N15")


@functools.lru_cache(maxsize=None)
def system(game, mu, no_w=False):
    """B lanes of ``game``'s structured KKT systems (f64), as
    ``chip_smoke.py``'s K1 phases build them: mu on the statx diagonals.
    With ``no_w`` the rank-1 terms are dropped (NW = 0)."""
    kw, seed = GAMES[game]
    spec, sq, b, w_owner = chip_smoke.k1_system(CPU, B, mu, seed + 7, **kw)
    if no_w:
        sq = dataclasses.replace(sq, wv=sq.wv[:, :, :0].contiguous())
        w_owner = ()
    return spec, sq, b, w_owner


def x_columns(M, F, q, w, Bm, owner, w_owner, n, m, p):
    """The x columns of the augmented system on the structured Q form."""
    dt = M.dtype
    Bsz, NW = M.shape[0], w.shape[1]
    own = np.asarray(owner, int)
    wown = np.asarray(w_owner, int)
    Bw = np.zeros((Bsz, m, NW), dt)              # B[:, r] . w_k
    for j in range(n):
        Bw = Bw + Bm[:, j, :, None] * w[:, None, :, j]
    Bw = np.where(own[None, :, None] == wown[None, None, :], Bw, dt.type(0))
    Fw = np.zeros((Bsz, n, NW), dt)              # F[a, owner(k)] . w_k
    for j in range(n):
        Fw = Fw + F[:, :, wown * n + j] * w[:, None, :, j]
    v = Bm[:, :, :].transpose(0, 2, 1) * q[:, own, :]     # [B, m, n]
    for k in range(NW):
        v = v + Bw[:, :, k, None] * w[:, None, k, :]
    M[:, :m, :n] = v
    v = np.zeros((Bsz, n, n), dt)
    for i in range(p):
        v = v + F[:, :, i * n:(i + 1) * n] * q[:, None, i, :]
    for k in range(NW):
        v = v + Fw[:, :, k, None] * w[:, None, k, :]
    M[:, m:, :n] = v + (-np.eye(n, dtype=dt))


def emulate(spec, sq, b, w_owner, dtype, eliminate=lu_back_substitution):
    """K1 (register-tiled forward, the unchanged backward) on numpy copies
    of ``sq`` and ``b`` in ``dtype``: the flat [B, S] solution.
    ``eliminate`` is the elimination of each knot's augmented system."""
    q, w, Ub, Bm, A = (getattr(sq, f).numpy().astype(dtype)
                       for f in ("qdiag", "wv", "Ublk", "B", "A"))
    bk = b.numpy().astype(dtype)
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    pn, d = p * n, n + m
    owner = owner_map_u(spec)
    Gx = np.zeros((B, n, pn), dtype)
    yx = np.zeros((B, n), dtype)
    zero = np.zeros((B, n, n), dtype)
    sols = []
    for t in range(T):
        A1 = A[:, t + 1] if t + 1 < T else zero
        F = fill_in(A[:, t], Gx)
        M = np.zeros((B, d, d + pn + 1), dtype)
        x_columns(M, F, q[:, t], w[:, t], Bm[:, t], owner, w_owner, n, m, p)
        rhs_columns(M, F, Ub[:, t], Bm[:, t], A[:, t], A1, bk[:, t], yx,
                    owner, n, m, p)
        sol = eliminate(M, d)
        sols.append(sol)
        Gx, yx = sol[:, :n, :pn], sol[:, :n, pn]
    return backward(spec, sols, q, w, A, bk, w_owner, dtype)


def backward(spec, sols, q, w, A, bk, w_owner, dtype):
    """K1's backward recursion (thomas_sq_bwd_kernel) from each knot's
    forward solution [B, d, p n + 1] (``sols``; numpy operands in
    ``dtype``): the flat [B, S] solution."""
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    pn, d = p * n, n + m
    wown = np.asarray(w_owner, int)
    zero = np.zeros((B, n, n), dtype)
    lam_next = np.zeros((B, pn), dtype)
    out = [None] * T
    for t in range(T - 1, -1, -1):               # thomas_sq_bwd_kernel
        G, yhat = sols[t][:, :, :pn], sols[t][:, :, pn]
        s = np.zeros((B, d), dtype)
        for c in range(pn):
            s = s + G[:, :, c] * lam_next[:, None, c]
        xu = yhat - s
        wx = np.zeros((B, len(wown)), dtype)
        for j in range(n):
            wx = wx + w[:, t, :, j] * xu[:, None, j]
        A1T = (A[:, t + 1] if t + 1 < T else zero).transpose(0, 2, 1)
        lam = np.zeros((B, p, n), dtype)
        for i in range(p):
            v = q[:, t, i] * xu[:, :n]
            for k in np.flatnonzero(wown == i):
                v = v + wx[:, k, None] * w[:, t, k]
            s = np.zeros((B, n), dtype)
            for j in range(n):
                s = s + A1T[:, :, j] * lam_next[:, None, i * n + j]
            lam[:, i] = v + s - bk[:, t, i * n:(i + 1) * n]
        lam = lam.reshape(B, pn)
        out[t] = np.concatenate([xu, lam], axis=1)
        lam_next = lam
    return np.stack(out, axis=1).reshape(B, -1)


def rel(a, ref):
    a = np.asarray(a, np.float64).reshape(B, -1)
    ref = np.asarray(ref, np.float64).reshape(B, -1)
    return float((np.abs(a - ref).max(1) / np.abs(ref).max(1)).max())


CASES = [(g, False) for g in sorted(GAMES)] + [("di2_N10", True)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mu", [1.0, 1e3, 1e7])
@pytest.mark.parametrize("game,no_w", CASES)
def test_emulated_elimination_matches_the_plain_version(game, no_w, mu,
                                                        dtype):
    spec, sq, b, w_owner = system(game, mu, no_w)
    ref = thomas.solve_thomas_structured_plain(spec, sq, b, w_owner)
    y = emulate(spec, sq, b, w_owner, dtype)
    err = rel(y, ref.numpy())
    tag = f"{game}{' NW=0' if no_w else ''} mu={mu:g} {np.dtype(dtype).name}"
    if game not in QUAD_GAMES:
        print(f"{tag}: worst relative error {err:.3e}")
        assert err <= (1e-10 if dtype == np.float64 else 1e-3), err
        return
    f32 = dtype == np.float32
    sqd = sq if not f32 else type(sq)(*[getattr(sq, f).float() for f in
                                         ("qdiag", "wv", "Ublk", "A", "B")])
    plain = thomas.solve_thomas_structured_plain(spec, sqd, b.to(sqd.A.dtype),
                                                 w_owner)
    bw, bw_plain = (float(e.max()) for e in chip_smoke.backward_errors(
        spec, sq, w_owner, b, (torch.as_tensor(y), plain)))
    err_plain = rel(plain.numpy(), ref.numpy())
    print(f"{tag}: backward error {bw:.3e} (plain {bw_plain:.3e}); forward "
          f"{err:.3e} (plain {err_plain:.3e})")
    assert bw <= (1e-7 if f32 else 1e-15) and bw <= 10 * bw_plain, (
        bw, bw_plain)
    if f32:
        assert err <= 30 * err_plain, (err, err_plain)


def test_gauss_jordan_misses_the_quadrotor_gate():
    """K3's Gauss-Jordan elimination in K1's place: on the quadrotor's f32
    systems at mu = 1e7 its normwise backward error exceeds 10 x the f32
    plain version's (66 x on these lanes), which LU meets (the test
    above): the reason K1 eliminates LU."""
    spec, sq, b, w_owner = system("quad2_N15", 1e7)
    sq32 = type(sq)(*[getattr(sq, f).float() for f in
                      ("qdiag", "wv", "Ublk", "A", "B")])
    p32 = thomas.solve_thomas_structured_plain(spec, sq32, b.float(),
                                               w_owner)
    y = emulate(spec, sq, b, w_owner, np.float32, gauss_jordan)
    bw, bw_plain = (float(e.max()) for e in chip_smoke.backward_errors(
        spec, sq, w_owner, b, (torch.as_tensor(y), p32)))
    print(f"Gauss-Jordan backward error {bw:.3e}, {bw / bw_plain:.1f} x the "
          f"f32 plain version's {bw_plain:.3e}")
    assert bw > 10 * bw_plain, (bw, bw_plain)


@pytest.mark.parametrize("game,no_w", CASES)
def test_emulated_elimination_matches_the_jax_reference(game, no_w):
    """The same systems (mu = 1e3, f64) through the JAX package, lane by
    lane: its structured Pallas kernel in interpret mode, or for the
    quadrotors its Schur solve on the densified Q (the 3-player spec from
    its quadrotor model: it has no such preset)."""
    spec, sq, b, w_owner = system(game, 1e3, no_w)
    if game == "quad3_N15":
        jspec = spec_from_model(quadrotor_game(p=3), 15, 0.1)
    else:
        _, jspec = JAX_PRESETS[game]()
    assert (jspec.T, jspec.n, jspec.m, jspec.p, jspec.pu) == (
        spec.T, spec.n, spec.m, spec.p, spec.pu)
    if game in QUAD_GAMES:
        jjb = JaxJacBlocks(
            thomas.structured_to_dense(sq, w_owner, spec.p).numpy(),
            *[getattr(sq, f).numpy() for f in ("Ublk", "A", "B")])
        ref = jax.jit(jax.vmap(lambda j, bb: solve_tridiagonal_schur(
            jspec, j, bb)))(jjb, b.numpy())
    else:
        jsq = JaxStructuredQ(*[getattr(sq, f).numpy() for f in
                               ("qdiag", "wv", "Ublk", "A", "B")])
        solve = thomas_pallas_structured_for_spec(jspec, tuple(w_owner),
                                                  interpret=True)
        ref = jax.jit(jax.vmap(solve))(jsq, b.numpy())
    err = rel(emulate(spec, sq, b, w_owner, np.float64), np.asarray(ref))
    assert err <= 1e-10, err
