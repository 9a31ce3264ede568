"""Schur-condensed block-Thomas KKT solve in plain PyTorch (counterpart of
``algames_tpu/problem/linear_solver.py::solve_tridiagonal_schur``).  It is
the plain version of kernels K1 and K3 (``ops/thomas.py``).

Per knot, the statx rows ``[Q_i | 0 | -I(own lam)]`` eliminate the p*n
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
