"""The KKT linear solves in plain PyTorch (counterpart of
``algames_tpu/problem/linear_solver.py``), batched over a leading lane
axis.

The block-tridiagonal system, per knot equation t (W x W blocks from
``residual.build_tridiagonal``)::

    L_{t-1} y_{t-1} + D_t y_t + U_t y_{t+1} = b_t

is solved by one of: a dense S x S solve (``solve_dense``), block Thomas
(``solve_tridiagonal``), block cyclic reduction
(``solve_cyclic_reduction``), or the Schur-condensed block Thomas on the
dense per-knot ingredients (``solve_tridiagonal_schur``), the plain
version of kernels K1 and K3 (``ops/thomas.py``).  The pivoted solves are
``torch.linalg.solve_ex``: a singular lane yields non-finite values (as in
the reference) instead of failing the whole batch.

In the Schur-condensed sweep, per knot, the statx rows ``[Q_i | 0 | -I(own lam)]`` eliminate the p*n
multiplier unknowns exactly (``lam_i = Q_i x - a_i``), leaving one pivoted
(n+m)-size solve with (p*n + 1) right-hand sides; the multipliers are
rebuilt in the backward sweep.

Heterogeneous specs (unequal per-player control widths ``mi``) are padded:
every player's control block grows to ``max(mi)`` in player-major order,
the padding rows are identity rows with zero couplings (a virtual zero
column of B), so the padded unknowns solve ``1 * u_pad = 0`` exactly and
decouple; the result is gathered back to natural control order.

On CUDA in f32 the products here follow
``torch.backends.cuda.matmul.allow_tf32``; a caller that wants full f32
(``chip_smoke.py`` does) sets it to False.
"""
from __future__ import annotations

import dataclasses

import torch


def dense_from_tridiagonal(spec, D, U, L, out=None):
    """The block-tridiagonal matrix of D [B, T, W, W] and U, L
    [B, T-1, W, W] (L[:, t] is the sub-diagonal block of equation t+1) as
    a dense [B, S, S] matrix, written into the leading S x S corner of
    ``out`` (zeros elsewhere) when given."""
    T, W = spec.T, spec.W
    J = D.new_zeros((D.shape[0], T * W, T * W)) if out is None else out
    for t in range(T):
        r = slice(t * W, (t + 1) * W)
        J[:, r, r] = D[:, t]
        if t + 1 < T:
            r1 = slice((t + 1) * W, (t + 2) * W)
            J[:, r, r1] = U[:, t]
            J[:, r1, r] = L[:, t]
    return J


def solve_dense(spec, D, U, L, b_knots):
    """Dense S x S solve of the block-tridiagonal system
    (:func:`dense_from_tridiagonal`), b_knots [B, T, W].  Returns the flat
    [B, S] solution of J y = b."""
    J = dense_from_tridiagonal(spec, D, U, L)
    return torch.linalg.solve_ex(J, b_knots.reshape(b_knots.shape[0], -1))[0]


def pad_couplings(D, U, L):
    """(Lhat, Uhat) [B, T, W, W]: the off-diagonal blocks by equation, with
    zero blocks at Lhat_0 and Uhat_{T-1}."""
    zero = D.new_zeros((D.shape[0], 1) + D.shape[2:])
    return torch.cat([zero, L], dim=1), torch.cat([U, zero], dim=1)


def block_thomas(D, Lhat, Uhat, RHS):
    """Block-Thomas sweep of the block-tridiagonal system (D, Lhat, Uhat)
    [B, T, W, W] with R right-hand sides RHS [B, T, W, R]: one pivoted
    W x W solve with W + R columns per knot, then the backward sweep.
    Returns the solution [B, T, W, R]."""
    T, W = D.shape[1], D.shape[2]
    G = D.new_zeros(D.shape[:1] + D.shape[2:])
    Y = RHS.new_zeros(RHS.shape[:1] + RHS.shape[2:])
    Gs, Ys = [], []
    for t in range(T):
        M = D[:, t] - Lhat[:, t] @ G
        sol = torch.linalg.solve_ex(
            M, torch.cat([Uhat[:, t], RHS[:, t] - Lhat[:, t] @ Y], dim=2))[0]
        G, Y = sol[:, :, :W], sol[:, :, W:]
        Gs.append(G)
        Ys.append(Y)
    out = [None] * T
    Y_next = torch.zeros_like(Y)
    for t in range(T - 1, -1, -1):
        Y_next = Ys[t] - Gs[t] @ Y_next
        out[t] = Y_next
    return torch.stack(out, dim=1)


def solve_tridiagonal(spec, D, U, L, b_knots):
    """Block-Thomas solve of the system of :func:`solve_dense`
    (:func:`block_thomas` with one right-hand side).  Returns flat
    [B, S]."""
    Lhat, Uhat = pad_couplings(D, U, L)
    y = block_thomas(D, Lhat, Uhat, b_knots[..., None])
    return y.reshape(b_knots.shape[0], -1)


def newton_step(spec, D, U, L, b_knots, method: str = "tridiag"):
    """The Newton step: the solution of J y = -b, flat [B, S] in column
    order, by ``"dense"`` or ``"tridiag"`` (block Thomas)."""
    if method == "dense":
        return solve_dense(spec, D, U, L, -b_knots)
    return solve_tridiagonal(spec, D, U, L, -b_knots)


def _bmv(M, v):
    """Batched matrix-vector products [..., i, j] x [..., j]."""
    return (M @ v[..., None])[..., 0]


def solve_cyclic_reduction(spec, D, U, L, b_knots):
    """Block cyclic reduction of the system of :func:`solve_dense`: each of
    ceil(log2 T) levels eliminates every odd-indexed block at once,

      y_odd = D_odd^{-1} (b_odd - Lh_odd y_{odd-1} - Uh_odd y_{odd+1})
      D'_e  = D_e - Lh_e D_{e-1}^{-1} Uh_{e-1} - Uh_e D_{e+1}^{-1} Lh_{e+1}
      Lh'_e = -Lh_e D_{e-1}^{-1} Lh_{e-1};  Uh'_e = -Uh_e D_{e+1}^{-1} Uh_{e+1}
      b'_e  = b_e - Lh_e D_{e-1}^{-1} b_{e-1} - Uh_e D_{e+1}^{-1} b_{e+1}

    with an identity block appended to a level of odd length (trimmed in
    the back substitution).  Returns flat [B, S]."""
    T, W = spec.T, spec.W
    Bsz = b_knots.shape[0]
    zero = D.new_zeros((Bsz, 1, W, W))
    Lh = torch.cat([zero, L], dim=1)                    # sub-diag of eq t
    Uh = torch.cat([U, zero], dim=1)                    # super-diag of eq t
    b = b_knots
    stack = []
    while D.shape[1] > 1:
        Tl = D.shape[1]
        if Tl % 2 == 1:
            eye = torch.eye(W, dtype=D.dtype, device=D.device)
            D = torch.cat([D, eye.expand(Bsz, 1, W, W)], dim=1)
            Lh = torch.cat([Lh, zero], dim=1)
            Uh = torch.cat([Uh, zero], dim=1)
            b = torch.cat([b, b.new_zeros((Bsz, 1, W))], dim=1)
            Tl += 1
        Do, De = D[:, 1::2], D[:, 0::2]
        Lo, Le = Lh[:, 1::2], Lh[:, 0::2]
        Uo, Ue = Uh[:, 1::2], Uh[:, 0::2]
        bo, be = b[:, 1::2], b[:, 0::2]
        # D_o^{-1} [L_o U_o b_o] against every odd diagonal block at once.
        rhs = torch.cat([Lo, Uo, bo[..., None]], dim=-1)
        sol = torch.linalg.solve_ex(Do, rhs)[0]
        DiL, DiU, Dib = sol[..., :W], sol[..., W:2 * W], sol[..., 2 * W]
        stack.append((DiL, DiU, Dib, Tl))
        # Even block jj: right odd neighbour jj (if any), left jj - 1.
        ne, no = De.shape[1], DiL.shape[1]
        m_r = min(ne, no)
        Dn, bn = De.clone(), be.clone()
        Ln, Un = torch.zeros_like(Le), torch.zeros_like(Ue)
        Dn[:, :m_r] += -Ue[:, :m_r] @ DiL[:, :m_r]
        Un[:, :m_r] = -Ue[:, :m_r] @ DiU[:, :m_r]
        bn[:, :m_r] += -_bmv(Ue[:, :m_r], Dib[:, :m_r])
        if ne > 1:
            Dn[:, 1:] += -Le[:, 1:] @ DiU[:, :ne - 1]
            Ln[:, 1:] = -Le[:, 1:] @ DiL[:, :ne - 1]
            bn[:, 1:] += -_bmv(Le[:, 1:], Dib[:, :ne - 1])
        D, Lh, Uh, b = Dn, Ln, Un, bn

    ys = torch.linalg.solve_ex(D[:, 0], b[:, 0])[0][:, None]
    for DiL, DiU, Dib, Tl in reversed(stack):
        half = Tl // 2
        y_even = ys[:, :half]                           # trim a coarser pad
        y_odd = Dib - _bmv(DiL, y_even)
        if half > 1:
            y_odd[:, :half - 1] += -_bmv(DiU[:, :half - 1], y_even[:, 1:])
        merged = b_knots.new_zeros((Bsz, Tl, W))
        merged[:, 0::2] = y_even
        merged[:, 1::2] = y_odd
        ys = merged
    return ys[:, :T].reshape(Bsz, -1)


@dataclasses.dataclass
class JacBlocks:
    """Dense per-knot KKT ingredients, batched."""
    Qblk: torch.Tensor   # [B, T, p, n, n] statx Hessian blocks
    Ublk: torch.Tensor   # [B, T, m, m]    statu Hessian blocks
    A: torch.Tensor      # [B, T, n, n]    RK2 d/dx
    B: torch.Tensor      # [B, T, n, m]    RK2 d/du


def pad_operands(spec, jb: JacBlocks, b: torch.Tensor):
    """A heterogeneous spec's KKT operands with every player's controls
    padded to ``max(mi)`` in player-major order: ``(Ublk, B, b, owner)`` at
    ``ms = p max(mi)`` control rows, contiguous.  Padded row r is natural
    control ``idx[r]``, or, past a player's own ``mi``, an identity row of
    a virtual zero column of B with a zero right-hand side; ``owner[r] =
    r // max(mi)``."""
    n, m, p, pn = spec.n, spec.m, spec.p, spec.p * spec.n
    mmax = max(spec.mi)
    idx = [m] * (p * mmax)
    for i in range(p):
        for c, j in enumerate(spec.pu[i]):
            idx[i * mmax + c] = j
    pad_eye = torch.diag(torch.as_tensor([float(j == m) for j in idx],
                                         dtype=b.dtype, device=b.device))
    zcol = b.new_zeros(b.shape[:2] + (n, 1))
    Bm = torch.cat([jb.B, zcol], dim=3)[..., idx]
    Ub = torch.nn.functional.pad(jb.Ublk, (0, 1, 0, 1))[:, :, idx][:, :, :,
                                                                   idx]
    c = torch.nn.functional.pad(b[:, :, pn:pn + m], (0, 1))[..., idx]
    bk = torch.cat([b[:, :, :pn], c, b[:, :, pn + m:]], dim=2)
    owner = [r // mmax for r in range(p * mmax)]
    return ((Ub + pad_eye).contiguous(), Bm.contiguous(), bk.contiguous(),
            owner)


def unpad_columns(spec, ms):
    """Columns of a padded per-knot solution [x | u padded (ms) | lam]
    (:func:`pad_operands`) that hold [x | u | lam] in natural control
    order."""
    n, p = spec.n, spec.p
    mmax = ms // p
    nat = [0] * spec.m
    for i in range(p):
        for c, j in enumerate(spec.pu[i]):
            nat[j] = n + i * mmax + c
    return list(range(n)) + nat + list(range(n + ms, n + ms + p * n))


def solve_tridiagonal_schur(spec, jb: JacBlocks, b_knots: torch.Tensor):
    """Solve the KKT system for ``b_knots`` [B, T, W] (pass the NEGATED
    residual to get the Newton step).  Returns the flat [B, S] solution in
    per-knot column order."""
    T, n, m, p = spec.T, spec.n, spec.m, spec.p
    pn = p * n
    Bsz = b_knots.shape[0]
    dtype, device = b_knots.dtype, b_knots.device
    eye_n = torch.eye(n, dtype=dtype, device=device)

    zero_n = torch.zeros((Bsz, 1, n, n), dtype=dtype, device=device)
    Asub = torch.cat([zero_n, jb.A[:, 1:]], dim=1)       # A_t (0 at t=0)
    Asup = torch.cat([jb.A[:, 1:], zero_n], dim=1)       # A_{t+1} (0 at T-1)
    AsupT = Asup.transpose(-1, -2)

    a_all = b_knots[:, :, :pn].reshape(Bsz, T, p, n)
    c_all = b_knots[:, :, pn:pn + m]
    d_all = b_knots[:, :, pn + m:]
    Q_all = jb.Qblk

    if spec.homogeneous:
        # Per-player control columns of B: [B, T, p, n, mi].
        ms = m
        perm = [j for i in range(p) for j in spec.pu[i]]
        inv = sorted(range(m), key=lambda r: perm[r])
        Bp = jb.B[..., perm].reshape(Bsz, T, n, p, m // p).permute(
            0, 1, 3, 2, 4)
        B_s, Ub_s, c_s = jb.B, jb.Ublk, c_all
    else:
        # Controls padded to p max(mi), player-major (pad_operands).
        Ub_s, B_s, b_pad, owner = pad_operands(spec, jb, b_knots)
        ms, inv = len(owner), None
        Bp = B_s.reshape(Bsz, T, n, p, ms // p).permute(0, 1, 3, 2, 4)
        c_s = b_pad[:, :, pn:pn + ms]

    def natural(rows):
        """Padded or per-player row order [B, T, ms, ...] -> the rows of
        the system (natural control order when homogeneous)."""
        return rows if inv is None else rows[:, :, inv]

    BtQ_p = (Bp[..., None] * Q_all[:, :, :, :, None, :]).sum(dim=3)
    BtQ = natural(BtQ_p.reshape(Bsz, T, ms, n))
    Kbase = torch.cat([
        torch.cat([BtQ, Ub_s], dim=3),
        torch.cat([(-eye_n).expand(Bsz, T, n, n), B_s], dim=3)],
        dim=2)                                           # [B, T, n+ms, n+ms]

    cG_p = (Bp[..., None] * AsupT[:, :, None, :, None, :]).sum(dim=3)
    eye_p = torch.eye(p, dtype=dtype, device=device)
    cG = natural((cG_p[:, :, :, :, None, :] * eye_p[:, None, :, None]
                  ).reshape(Bsz, T, ms, pn))
    cy_add = (Bp * a_all[..., None]).sum(dim=3)          # [B, T, p, mi]
    cy = c_s + natural(cy_add.reshape(Bsz, T, ms))
    RHS_top = torch.cat([cG, cy[..., None]], dim=3)      # [B, T, ms, pn+1]

    d = n + ms
    G_prev = torch.zeros((Bsz, d, pn), dtype=dtype, device=device)
    y_prev = torch.zeros((Bsz, d), dtype=dtype, device=device)
    Gs, ys = [], []
    for t in range(T):
        At, At1T, a = Asub[:, t], AsupT[:, t], a_all[:, t]
        F = -(At @ G_prev[:, :n])                        # [B, n, pn]
        F3 = F.reshape(Bsz, n, p, n)
        FQ = torch.einsum('zaib,zibq->zaq', F3, Q_all[:, t])
        K = Kbase[:, t].clone()
        K[:, ms:, :n] += FQ
        dG = torch.einsum('zaib,zbq->zaiq', F3, At1T).reshape(Bsz, n, pn)
        dy = (d_all[:, t] - (At @ y_prev[:, :n, None])[..., 0]
              + torch.einsum('zaib,zib->za', F3, a))
        RHS = torch.cat([RHS_top[:, t],
                         torch.cat([dG, dy[..., None]], dim=2)], dim=1)
        # No error check: a singular lane yields non-finite values (as in
        # the reference) instead of failing the whole batch.
        sol = torch.linalg.solve_ex(K, RHS)[0]           # [B, d, pn+1]
        G_prev, y_prev = sol[:, :, :pn], sol[:, :, pn]
        Gs.append(G_prev)
        ys.append(y_prev)

    lam_next = torch.zeros((Bsz, pn), dtype=dtype, device=device)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        # lam_{i,t} = Q_i x_t + A_{t+1}^T lam_{i,t+1} - a_{i,t}
        xu = ys[t] - (Gs[t] @ lam_next[..., None])[..., 0]
        x = xu[:, :n]
        lam = (torch.einsum('zpab,zb->zpa', Q_all[:, t], x)
               + torch.einsum('zab,zpb->zpa', AsupT[:, t],
                              lam_next.reshape(Bsz, p, n))
               - a_all[:, t]).reshape(Bsz, pn)
        out[t] = torch.cat([xu, lam], dim=1)
        lam_next = lam
    ys = torch.stack(out, dim=1)
    if not spec.homogeneous:
        ys = ys[..., unpad_columns(spec, ms)]
    return ys.reshape(Bsz, -1)
