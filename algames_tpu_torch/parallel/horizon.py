"""Horizon parallelism: the KKT solve split over the knot axis (counterpart
of ``algames_tpu/parallel/horizon.py``), batch-first, over a
``torch.distributed`` group.

Every rank of the group holds the whole block-tridiagonal system (the
Newton loop runs replicated on every rank) and eliminates its own
contiguous slab of T / world knots (the partitioned block Thomas, SPIKE):

  1. local:   express the slab solution as  y = y0 + V y_left + Z y_right
              (one block-Thomas sweep with 1 + 2W right-hand sides)
  2. gather:  all_gather the slab boundary rows (2 blocks per rank and
              lane), the only traffic, O(world W^2) per lane
  3. reduced: every rank solves the 2 world W coupled boundary system
  4. local:   back-substitute the slab with the now known neighbours

and the slab solutions are all-gathered, so every rank returns the whole
solution.  The sweeps are plain PyTorch (``linear_solver.block_thomas``,
``torch.linalg.solve_ex`` per knot over the lane axis), as the JAX
package's are ``jnp.linalg.solve`` under ``lax.scan``: no TPU kernel lies
on this path.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..problem.linear_solver import block_thomas, pad_couplings


def _all_gather(t: torch.Tensor, group) -> list:
    """``t`` from every rank of ``group``, in group-rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _local_spike(Dl, Lh, Uh, bl, group):
    """This rank's slab solve.  Dl/Lh/Uh [B, Tl, W, W], bl [B, Tl, W];
    Lh[:, 0] couples to the left neighbour's last unknown, Uh[:, -1] to the
    right neighbour's first (zero blocks on the outer slabs).  Returns
    y_local [B, Tl, W]."""
    Bsz, Tl, W, _ = Dl.shape
    R = 1 + 2 * W

    # Right-hand sides: [b | -Lh0 (first row only) | -Uh_last (last row only)]
    RHS = Dl.new_zeros((Bsz, Tl, W, R))
    RHS[:, :, :, 0] = bl
    RHS[:, 0, :, 1:W + 1] = -Lh[:, 0]
    RHS[:, -1, :, W + 1:] = -Uh[:, -1]

    # Interior couplings only: the cross-slab blocks masked out.
    Lh_in = Lh.clone()
    Lh_in[:, 0] = 0
    Uh_in = Uh.clone()
    Uh_in[:, -1] = 0

    sol = block_thomas(Dl, Lh_in, Uh_in, RHS)   # [B, Tl, W, R] = [y0 | V | Z]

    # ---- reduced boundary system over all slabs (on every rank) --------
    nd = dist.get_world_size(group)
    idx = dist.get_rank(group)
    Sf = _all_gather(sol[:, 0], group)   # nd x [B, W, R]
    Sl = _all_gather(sol[:, -1], group)

    DW = nd * 2 * W                      # unknowns: (y_first, y_last) per slab
    M = torch.eye(DW, dtype=Dl.dtype, device=Dl.device).repeat(Bsz, 1, 1)
    rhs = Dl.new_zeros((Bsz, DW))
    for d in range(nd):
        rf, rl = (2 * d) * W, (2 * d + 1) * W
        rhs[:, rf:rf + W] = Sf[d][:, :, 0]
        rhs[:, rl:rl + W] = Sl[d][:, :, 0]
        if d > 0:
            cl = (2 * (d - 1) + 1) * W           # left neighbour's y_last
            M[:, rf:rf + W, cl:cl + W] -= Sf[d][:, :, 1:W + 1]
            M[:, rl:rl + W, cl:cl + W] -= Sl[d][:, :, 1:W + 1]
        if d < nd - 1:
            cf = (2 * (d + 1)) * W               # right neighbour's y_first
            M[:, rf:rf + W, cf:cf + W] -= Sf[d][:, :, W + 1:]
            M[:, rl:rl + W, cf:cf + W] -= Sl[d][:, :, W + 1:]
    g2 = torch.linalg.solve_ex(M, rhs)[0].reshape(Bsz, nd, 2, W)

    y = sol[..., 0]
    if idx > 0:                          # y_left: the left slab's y_last
        y = y + (sol[..., 1:W + 1] @ g2[:, None, idx - 1, 1, :, None])[..., 0]
    if idx < nd - 1:                     # y_right: the right slab's y_first
        y = y + (sol[..., W + 1:] @ g2[:, None, idx + 1, 0, :, None])[..., 0]
    return y


def solve_tridiagonal_sharded(spec, D, U, L, b_knots, group=None):
    """Block-tridiagonal solve with the knots split over the ranks of
    ``group`` (default: the whole world).  Same system convention as
    ``linear_solver.solve_tridiagonal``: D [B, T, W, W]; U, L
    [B, T-1, W, W] (L[:, t] the sub-diagonal block of equation t+1);
    b_knots [B, T, W], the same on every rank.  T must be divisible by the
    group's size.  Returns the flat solution [B, S] on every rank."""
    T, W = spec.T, spec.W
    nd = dist.get_world_size(group)
    if T % nd:
        raise ValueError(f"T={T} is not divisible by the group's {nd} ranks")
    Tl = T // nd
    sl = slice(dist.get_rank(group) * Tl, (dist.get_rank(group) + 1) * Tl)
    Bsz = b_knots.shape[0]
    Lhat, Uhat = pad_couplings(D, U, L)
    y = _local_spike(D[:, sl], Lhat[:, sl], Uhat[:, sl], b_knots[:, sl],
                     group)
    return torch.cat(_all_gather(y, group), dim=1).reshape(Bsz, -1)


def spike_kkt_method(group=None):
    """A ``method=`` callable for ``newton_solve``: the Newton step's KKT
    solve split over the horizon among the ranks of ``group`` (default:
    the whole world).  Every rank runs the same solve on the same inputs:

        res = agt.newton_solve(prob, method=spike_kkt_method())

    It solves J y = nb on ``residual.build_tridiagonal``'s dense blocks,
    as the ladder's methods do, and is marked ``dense_only``."""
    from ..problem import residual as R

    def method(spec, jb, nb, w_owner):
        D, U, L = R.build_tridiagonal(spec, jb)
        return solve_tridiagonal_sharded(spec, D, U, L, nb, group)
    method.dense_only = True
    return method
