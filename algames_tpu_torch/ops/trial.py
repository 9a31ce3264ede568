"""Kernels K2 and K4: the fused line-search trial for the unicycle games.

K2 replaces ``algames_tpu/ops/trial_kernel.py::_trial_eval_handwritten``
(``_make_kernel_h``; the per-knot variant ``_make_kernel`` computes the same
function).  K4 replaces, for the unicycle family,
``algames_tpu/ops/trial_pallas.py::trial_eval_pallas`` as driven by
``fused_trial_for_spec``: the generic fused trial that the reference runs
whenever its hand-written kernel does not cover the problem (collision-cost
pairs, circle obstacles, state bounds).  Both are one CUDA C++ kernel,
``csrc/trial_unicycle.cu``, widened from K2 by a block kind per state block
and a table of collision-cost pairs.  CUDA was chosen over Triton because
the body is a per-knot scalar program with data-dependent indices
(collision pairs, owners, bound masks) and loops over players and blocks,
which maps directly onto one thread per knot; in Triton it would have to be
recast as padded power-of-two tiles with gathers.

On the card the trial is bound by latency, not by bytes: at about one flop
per byte it would be memory-bound at full occupancy, but a batch of 1,024
lanes gives only about eight warps per SM to hide the per-knot loads and
the sin/cos chains.  The kernel makes one pass, one warp per lane and one
thread per knot, with all intermediates in registers and a warp-shuffle sum
for the norm, so that nothing but the inputs and the carried point touches
device memory.

``trial_eval`` takes the plain PyTorch version (``trial_eval_plain``: the
eager ``point_lite_res`` + the Tikhonov pull + ``residual_norm``) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constraints.kernels import (BoundParams, CircleParams,
                                   CollisionParams, num_rows)
from ..core.spec import owner_map_u
from ..core.traj import PrimalDual, update_traj
from ..models.base import interleaved_indices
from ..models.unicycle import UnicycleGame
from ..problem import residual as R
from . import build

_LIB = "trial_unicycle"


_KIND = {CollisionParams: 0, CircleParams: 1, BoundParams: 2}
_MAX_SB, _MAX_CB, _MAX_PAIR, _MAX_M, _MAX_N = 64, 4, 64, 32, 32
_PAIR_EPS = 1e-10


def _state_block_ok(blk) -> bool:
    par = blk.params
    if isinstance(par, CollisionParams):
        return len(par.pxi) == 2
    return isinstance(par, (CircleParams, BoundParams))


def trial_supported(model, spec, obj, gc) -> bool:
    """True iff the problem lies inside the kernel's specialization:
    unicycle dynamics with the interleaved control layout; state blocks
    that are planar collision, circle or state-bound blocks; box bounds as
    the only control blocks; collision-cost pairs on planar positions; all
    within the kernel's table sizes."""
    return (isinstance(model, UnicycleGame) and spec.homogeneous
            and spec.pu == interleaved_indices(spec.p, 2)
            and all(_state_block_ok(b) for b in gc.state_blocks)
            and all(isinstance(b.params, BoundParams)
                    for b in gc.control_blocks)
            and all(len(px) == 2 for px in obj.pxi + obj.pxj)
            and len(gc.state_blocks) <= _MAX_SB
            and len(gc.control_blocks) <= _MAX_CB
            and len(obj.pair_i) <= _MAX_PAIR
            and spec.m <= _MAX_M and spec.n <= _MAX_N)


def trial_eval_plain(model, spec, obj, gc, traj: PrimalDual,
                     dtraj: PrimalDual, alpha: torch.Tensor,
                     reg_eff: torch.Tensor, norm_fn=R.residual_norm):
    """One trial at ``traj + alpha dtraj`` per lane: ``(tn [B], PointLite)``
    with tn the norm (default: mean 1-norm) of the residual plus the
    Tikhonov pull ``reg_eff (trial - traj)`` on the primal rows."""
    trial = update_traj(traj, alpha, dtraj)
    lite, res_t = R.point_lite_res(model, spec, obj, gc, trial)
    reg = reg_eff[:, None, None]
    rx = res_t.rx + (reg * (trial.x[:, 1:] - traj.x[:, 1:]))[:, :, None, :]
    ru = res_t.ru + reg * (trial.u - traj.u)
    return norm_fn(spec, R.Residual(rx=rx, ru=ru, rd=res_t.rd)), lite


def _param_shapes(blk, spec):
    par = blk.params
    if isinstance(par, CollisionParams):
        return [(par.radius, ())]
    if isinstance(par, CircleParams):
        C = par.xc.shape[0]
        return [(par.xc, (C,)), (par.yc, (C,)), (par.radius, (C,))]
    dim = spec.n if blk.is_state else spec.m
    return [(par.z_max, (dim,)), (par.z_min, (dim,))]


def _check(model, spec, obj, gc, traj, dtraj, alpha, reg_eff) -> None:
    if not trial_supported(model, spec, obj, gc):
        raise ValueError("problem outside the fused trial's specialization")
    Bsz = traj.x.shape[0]
    ref = traj.x
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {ref.dtype}")
    shapes = [(traj.x, (Bsz, spec.N, spec.n)), (traj.u, (Bsz, spec.T, spec.m)),
              (traj.lam, (Bsz, spec.p, spec.T, spec.n)),
              (dtraj.x, (Bsz, spec.N, spec.n)),
              (dtraj.u, (Bsz, spec.T, spec.m)),
              (dtraj.lam, (Bsz, spec.p, spec.T, spec.n)),
              (alpha, (Bsz,)), (reg_eff, (Bsz,))]
    for blk in gc.state_blocks + gc.control_blocks:
        C = num_rows(blk.params)
        shapes += [(blk.lam, (Bsz, spec.T, C)), (blk.mu, (Bsz, spec.T, C))]
        shapes += _param_shapes(blk, spec)
    npair = len(obj.pair_i)
    shapes += [(obj.Qd, (spec.p, spec.n)), (obj.xf, (spec.p, spec.n)),
               (obj.Rd, (spec.p, spec.m)), (obj.uf, (spec.p, spec.m)),
               (obj.mu, (npair,)), (obj.r, (npair,))]
    for a, shape in shapes:
        if tuple(a.shape) != shape:
            raise ValueError(f"operand of shape {tuple(a.shape)}, want {shape}")
        if a.dtype != ref.dtype or a.device != ref.device:
            raise TypeError(f"operand is {a.dtype} on {a.device}, trajectory "
                            f"is {ref.dtype} on {ref.device}")
        if not a.is_contiguous():
            raise ValueError("trial operands must be contiguous")


def _state_tables(spec, sb, dtype, device):
    """The kernel's state-block table: per block (kind, owner, first row,
    first parameter, four indices) and its bound mask, plus the parameter
    array (collision r^2; circle (xc, yc, r) per circle; bound z_max then
    z_min)."""
    meta, masks, params = [], [], []
    row = npar = 0
    for blk in sb:
        par = blk.params
        kind = _KIND[type(par)]
        mask = 0
        if kind == 0:
            idx = tuple(par.pxi) + tuple(par.pxj)
            vals = [par.radius.reshape(1) ** 2]
        elif kind == 1:
            idx = (par.xi, par.yi, par.xc.shape[0], 0)
            vals = [torch.stack([par.xc, par.yc, par.radius], dim=1)
                    .reshape(-1)]
        else:
            idx = (0, 0, 0, 0)
            mask = sum(1 << j for j, f in enumerate(par.mask) if f)
            vals = [par.z_max, par.z_min]
        meta += [kind, blk.owner, row, npar, *idx]
        masks.append(mask)
        row += blk.lam.shape[-1]
        npar += sum(int(v.numel()) for v in vals)
        params += vals
    spar = (torch.cat(params).to(dtype).contiguous() if params
            else torch.zeros((0,), dtype=dtype, device=device))
    return meta, masks, spar, row


def trial_eval(model, spec, obj, gc, traj: PrimalDual, dtraj: PrimalDual,
               alpha: torch.Tensor, reg_eff: torch.Tensor):
    """Fused trial: ``(tn [B], PointLite)`` at ``traj + alpha dtraj``, with
    per-lane ``alpha`` and ``reg_eff`` [B].  Same function as
    :func:`trial_eval_plain`."""
    _check(model, spec, obj, gc, traj, dtraj, alpha, reg_eff)
    if traj.x.device.type == "cpu":
        return trial_eval_plain(model, spec, obj, gc, traj, dtraj, alpha,
                                reg_eff)
    if traj.x.device.type != "cuda":
        raise ValueError(f"unsupported device {traj.x.device}")
    lib = build.load(_LIB)
    dtype, device = traj.x.dtype, traj.x.device
    sfx = "f32" if dtype == torch.float32 else "f64"
    P, I, D = build.P, build.I, build.ctypes.c_double
    fn = build.bind(lib, f"trial_unicycle_{sfx}",
                    [P] * 30 + [I] * 8 + [D, D, P])
    Bsz, T, n, m, p = traj.x.shape[0], spec.T, spec.n, spec.m, spec.p
    sb, cb = gc.state_blocks, gc.control_blocks
    nsb, ncb, npair = len(sb), len(cb), len(obj.pair_i)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    s_meta, s_mask, spar, csum = _state_tables(spec, sb, dtype, device)
    # Stacked state AL state [B, Csum, T]: rows of every block, knots last.
    slam = (torch.cat([b.lam.transpose(1, 2) for b in sb], dim=1) if sb
            else zeros(Bsz, 0, T))
    smu = (torch.cat([b.mu.transpose(1, 2) for b in sb], dim=1) if sb
           else zeros(Bsz, 0, T))
    clam = (torch.stack([b.lam for b in cb], dim=1) if cb
            else zeros(Bsz, 0, T, 2 * m))
    cmu = (torch.stack([b.mu for b in cb], dim=1) if cb
           else zeros(Bsz, 0, T, 2 * m))
    zmax = (torch.stack([b.params.z_max for b in cb]) if cb else zeros(0, m))
    zmin = (torch.stack([b.params.z_min for b in cb]) if cb else zeros(0, m))
    pmr = torch.stack([obj.mu, obj.r], dim=1).contiguous()
    own = torch.as_tensor(owner_map_u(spec), device=device)
    j = torch.arange(m, device=device)
    Rdp = obj.Rd[own, j].contiguous()
    ufp = obj.uf[own, j].contiguous()
    p_meta = build.int_table(
        [v for k, i in enumerate(obj.pair_i)
         for v in (i,) + tuple(obj.pxi[k]) + tuple(obj.pxj[k])])
    c_mask = build.byte_table([v for b in cb for v in b.params.mask])

    rx0 = torch.empty((Bsz, T, p, n), dtype=dtype, device=device)
    ru0 = torch.empty((Bsz, T, m), dtype=dtype, device=device)
    rd = torch.empty((Bsz, T, n), dtype=dtype, device=device)
    sc = torch.empty((Bsz, csum, T), dtype=dtype, device=device)
    cc = torch.empty((Bsz, ncb, T, 2 * m), dtype=dtype, device=device)
    tn = torch.empty((Bsz,), dtype=dtype, device=device)
    ins = [traj.x, traj.u, traj.lam, dtraj.x, dtraj.u, dtraj.lam, alpha,
           reg_eff, obj.Qd.contiguous(), obj.xf.contiguous(), Rdp, ufp, spar,
           slam, smu, zmax, zmin, clam, cmu, pmr]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib, _LIB, fn(
            *[a.data_ptr() for a in ins], build.int_table(s_meta),
            (build.ctypes.c_ulonglong * max(1, nsb))(*s_mask), p_meta,
            c_mask, *[a.data_ptr() for a in (rx0, ru0, rd, sc, cc, tn)],
            Bsz, spec.N, p, nsb, csum, ncb, npair, spec.S, float(spec.dt),
            _PAIR_EPS * math.sqrt(n), stream))
    trial_eval.launches += 1
    rows = np.cumsum([0] + [b.lam.shape[-1] for b in sb])
    lite = R.PointLite(
        rx0=rx0, ru0=ru0, rd=rd,
        state_c=tuple(sc[:, rows[k]:rows[k + 1]].transpose(1, 2)
                      for k in range(nsb)),
        control_c=tuple(cc[:, k] for k in range(ncb)))
    return tn, lite


trial_eval.launches = 0
