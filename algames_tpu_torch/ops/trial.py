"""Kernels K2 and K4: the fused line-search trial.

K2 replaces ``algames_tpu/ops/trial_kernel.py::_trial_eval_handwritten``
(``_make_kernel_h``; the per-knot variant ``_make_kernel`` computes the same
function) for the unicycle games.  K4 replaces
``algames_tpu/ops/trial_pallas.py::trial_eval_pallas`` as driven by
``fused_trial_for_spec``: the generic fused trial, which the reference runs
for every model and constraint family its hand-written kernel does not
cover.  Both are one CUDA C++ source, ``csrc/trial_fused.cu`` (library
``trial_fused``), compiled once per model (unicycle, double integrator in 2
or 3 dimensions, the planar heterogeneous double integrator, bicycle,
quadrotor), threads per knot and type: the model is a template parameter
of the kernel, with its layout (interleaved, or player-blocked with ragged
controls) as a compile-time policy; its constants are kernel arguments, and
the state
blocks (collision in 2 or 3 dimensions, circle, 2D wall, 3D wall, cylinder,
state bound) travel as a device array of ``SBlock`` records (:data:`SBLOCK`),
the collision-cost pairs and control bounds as a device array of bytes
(:func:`_meta_table`: :data:`PAIR` records, then the control blocks' row
flags and senses), both uploaded once per problem, so that their numbers
and the control dimension are bounded by memory alone; each block carries
its sense (equality rows are always penalized; the inequality and
second-order-cone rows by the inequality rule).  CUDA was
chosen over Triton because the body is a per-knot scalar
program with data-dependent indices (collision pairs, owners, bound masks,
gates) and loops over players and blocks, which maps directly onto one
thread per knot; in Triton it would have to be recast as padded power-of-two
tiles with gathers.

On the card the trial is bound by the latency of each knot's chain, not by
bytes.  One block per lane makes one pass over the knots: ceil(T TPK / 32)
warps, TPK threads per knot (two for the unicycle games of four or more
players, :func:`instance_name`; one elsewhere) splitting a knot's blocks,
collision-cost pairs and players, with the lane's trial point staged in
shared memory for the unicycle, bicycle and quadrotor (past 32 states, the
unicycle's trial multipliers stay in device memory in f64); nothing but the
inputs and the carried point touches device memory.  See the source for
the measured numbers.

``trial_eval`` takes the plain PyTorch version (``trial_eval_plain``: the
eager ``point_lite_res`` + the Tikhonov pull + ``residual_norm``) for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..constraints.kernels import (BoundParams, CircleParams, CollisionParams,
                                   CylinderParams, Wall2DParams, Wall3DParams,
                                   num_rows)
from ..core.spec import owner_map_u
from ..core.traj import PrimalDual, update_traj
from ..models.base import interleaved_indices
from ..models.bicycle import BicycleGame
from ..models.double_integrator import DoubleIntegratorGame
from ..models.hetero import HeteroDoubleIntegratorGame
from ..models.quadrotor import QuadrotorGame
from ..models.unicycle import UnicycleGame
from ..problem import residual as R
from . import build

_LIB = "trial_fused"

_KIND = {CollisionParams: 0, CircleParams: 1, BoundParams: 2,
         Wall2DParams: 3, Wall3DParams: 4, CylinderParams: 5}
# Per-player state / control dimension of each compiled model.
_DIMS = {"unicycle": (4, 2), "di2": (4, 2), "di3": (6, 3),
         "hdi2": (4, 2), "bicycle": (4, 2), "quadrotor": (12, 4)}
# Cylinders a block: two axis bits each in ``SBlock::mask``.
_MAX_CYL = 32
# Most states of a model: 2n state-bound rows in one 64-bit mask, or, for
# the instances in ``_ROW_FLAGS``, flagged in the parameter array: the
# quadrotor's, up to the widest the card has checked (4 players), and the
# wide unicycle's, whose lane fits a block in f64 up to 17 players (n = 68:
# 224,552 bytes of shared memory with the merge's 272 state blocks).
_MAX_N = {"quadrotor": 64, "unicycle": 68}
_MAX_N_DEFAULT = 32
_ROW_FLAGS = ("quadrotor", "unicycle_wide")
_N_CONST = 12
_PAIR_EPS = 1e-10


def model_name(model) -> str | None:
    """The kernel's compiled model for ``model``, or None."""
    if isinstance(model, UnicycleGame):
        return "unicycle"
    if isinstance(model, DoubleIntegratorGame) and model.d in (2, 3):
        return f"di{model.d}"
    if isinstance(model, HeteroDoubleIntegratorGame) and model.d == 2:
        return "hdi2"
    if isinstance(model, BicycleGame):
        return "bicycle"
    if isinstance(model, QuadrotorGame):
        return "quadrotor"
    return None


def instance_name(model, spec) -> str:
    """The compiled kernel instance for ``model``: the model's name, with
    ``_spread`` (two threads per knot, which split the knot's blocks,
    collision-cost pairs and players) for unicycle games of four or more
    players, whose knots carry the most blocks and pairs, and ``_wide``
    (two threads per knot, a state bound's rows flagged in the parameter
    array, in f64 the trial multipliers read from device memory) past 32
    states, nine players or more."""
    name = model_name(model)
    if name != "unicycle" or spec.p < 4:
        return name
    return "unicycle_wide" if spec.n > _MAX_N_DEFAULT else "unicycle_spread"


def model_constants(model) -> list:
    """The model's constants in the kernel's order (zero-padded)."""
    vals = []
    if isinstance(model, BicycleGame):
        vals = [model.lf, model.lr]
    elif isinstance(model, QuadrotorGame):
        vals = [model.mass, *model.J, *model.gravity, model.motor_dist,
                model.kf, model.km, model.thrust_smoothing]
    elif isinstance(model, HeteroDoubleIntegratorGame):
        vals = [sum(model.mi[:i]) for i in range(model.p + 1)]
    return [float(v) for v in vals] + [0.0] * (_N_CONST - len(vals))


def _state_block_ok(blk) -> bool:
    par = blk.params
    if isinstance(par, CollisionParams):
        return len(par.pxi) in (2, 3) and len(par.pxj) == len(par.pxi)
    if isinstance(par, CylinderParams):
        return len(par.axis) <= _MAX_CYL
    return isinstance(par, (CircleParams, Wall2DParams, Wall3DParams,
                            BoundParams))


def _layout_ok(name, spec) -> bool:
    """The spec has the compiled model's layout: interleaved and homogeneous
    (component c of player i at c p + i of the state and the control), or,
    for the heterogeneous double integrator, player-blocked (player i's
    state at ni i .., its controls packed after player i-1's, 1 <= mi <= d)
    with the control offsets in the model constants."""
    ni, mi = _DIMS[name]
    p = spec.p
    if spec.ni != (ni,) * p:
        return False
    if name.startswith("hdi"):
        offs = [sum(spec.mi[:i]) for i in range(p + 1)]
        return (all(1 <= k <= mi for k in spec.mi) and p + 1 <= _N_CONST
                and spec.pz == tuple(tuple(range(ni * i, ni * (i + 1)))
                                     for i in range(p))
                and spec.pu == tuple(tuple(range(offs[i], offs[i + 1]))
                                     for i in range(p)))
    return (spec.mi == (mi,) * p and spec.pz == interleaved_indices(p, ni)
            and spec.pu == interleaved_indices(p, mi))


def trial_supported(model, spec, obj, gc) -> bool:
    """True iff the problem lies inside the kernel's specialization: one of
    the compiled models with its layout (``_layout_ok``); state blocks of
    the collision (2 or 3 coordinates), circle, wall, 3D wall, cylinder or
    state-bound families; box bounds as the only control blocks;
    collision-cost pairs on 2 or 3 coordinates (any number of blocks, pairs
    and controls); at most 32 states (the quadrotor's instance 64, the
    unicycle's 68).  Every sense is
    inside: equality rows are always
    penalized, inequality and second-order-cone rows by the inequality
    rule, as in :func:`~..constraints.sets.al_irho`."""
    name = model_name(model)
    if name is None or spec.mi != model.mi:
        return False
    return (_layout_ok(name, spec)
            and all(_state_block_ok(b) for b in gc.state_blocks)
            and all(isinstance(b.params, BoundParams)
                    for b in gc.control_blocks)
            and all(len(a) in (2, 3) and len(a) == len(b)
                    for a, b in zip(obj.pxi, obj.pxj))
            and spec.n <= _MAX_N.get(name, _MAX_N_DEFAULT))


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
    if isinstance(par, BoundParams):
        dim = spec.n if blk.is_state else spec.m
        return [(par.z_max, (dim,)), (par.z_min, (dim,))]
    C = num_rows(par)
    return [(getattr(par, f.name), (C,)) for f in dataclasses.fields(par)
            if f.type == "torch.Tensor"]


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


@functools.lru_cache(maxsize=None)
def _row_flags(mask, dtype, device):
    """A state bound's 2n row flags (1 for a finite bound) as the
    parameter array holds them, on ``device`` once per mask."""
    return torch.tensor(mask, dtype=dtype, device=device)


def _state_tables(sb, dtype, device, flags=False):
    """The kernel's state-block table: per block (kind, owner, first row,
    first parameter, count, six indices, equality flag) and its mask (a
    state bound's: bit j the upper row of state j, bit n + j its lower
    row, 0 with ``flags``; a cylinder block's: two axis bits per cylinder),
    plus the parameter array (see ``csrc/trial_fused.cu`` SBlock for the
    layout: a state bound's z_max, z_min, then, with ``flags``, its 2n row
    flags)."""
    meta, masks, params = [], [], []
    row = npar = 0
    for blk in sb:
        par = blk.params
        kind = _KIND[type(par)]
        idx, mask, cnt = [0] * 6, 0, 0
        if kind == 0:
            cnt = len(par.pxi)
            idx[:cnt], idx[3:3 + cnt] = par.pxi, par.pxj
            vals = [par.radius.reshape(1) ** 2]
        elif kind == 2:
            vals = [par.z_max, par.z_min]
            if flags:
                vals.append(_row_flags(par.mask, dtype, device))
            else:
                mask = sum(1 << j for j, f in enumerate(par.mask) if f)
        else:
            cnt = num_rows(par)
            if kind == 1:
                idx[:2] = par.xi, par.yi
                cols = [par.xc, par.yc, par.radius]
            elif kind == 3:
                idx[:2] = par.xi, par.yi
                cols = [par.x1, par.y1, par.x2, par.y2, par.xv, par.yv]
            else:
                idx[:3] = par.xi, par.yi, par.zi
                names = (("x1", "y1", "z1", "x2", "y2", "z2", "x3", "y3",
                          "z3", "xv", "yv", "zv") if kind == 4
                         else ("p1", "p2", "p3", "l", "r"))
                cols = [getattr(par, f) for f in names]
                if kind == 5:
                    mask = sum(a << (2 * j) for j, a in enumerate(par.axis))
            vals = [torch.stack(cols, dim=1).reshape(-1)]
        meta += [kind, blk.owner, row, npar, cnt, *idx,
                 int(blk.sense == "eq")]
        masks.append(mask)
        row += blk.lam.shape[-1]
        npar += sum(int(v.numel()) for v in vals)
        params += vals
    spar = (torch.cat(params).to(dtype).contiguous() if params
            else torch.zeros((0,), dtype=dtype, device=device))
    return meta, masks, spar, row


# ``SBlock`` of ``csrc/trial_fused.cu``: one state block's record, 32 bytes.
SBLOCK = np.dtype({
    "names": ["mask", "row", "par", "kind", "owner", "cnt", "eq", "a"],
    "formats": ["<u8", "<i4", "<i4", "u1", "u1", "u1", "u1", ("u1", 6)],
    "offsets": [0, 8, 12, 16, 17, 18, 19, 20], "itemsize": 32})


def _sblock_table(meta, masks) -> np.ndarray:
    """The state blocks as the kernel's ``SBlock`` records, from
    :func:`_state_tables`' ``meta`` (12 ints a block) and ``masks``."""
    nsb = len(masks)
    rec = np.zeros(nsb, SBLOCK)
    if nsb:
        m = np.asarray(meta, np.int64).reshape(nsb, 12)
        rec["mask"] = np.asarray(masks, np.uint64)
        rec["kind"], rec["owner"], rec["row"], rec["par"] = m.T[:4]
        rec["cnt"], rec["a"], rec["eq"] = m[:, 4], m[:, 5:11], m[:, 11]
    return rec


# ``Pair`` of ``csrc/trial_fused.cu``: one collision-cost pair, 8 bytes.
PAIR = np.dtype({"names": ["owner", "dim", "a", "b"],
                 "formats": ["u1", "u1", ("u1", 3), ("u1", 3)],
                 "offsets": [0, 1, 2, 5], "itemsize": 8})


def _meta_table(pairs, c_mask, c_eq) -> np.ndarray:
    """``TrialMeta``'s table of ``csrc/trial_fused.cu`` as bytes: the
    collision-cost pairs as :data:`PAIR` records (``pairs``: per pair its
    owner, then its pxi and pxj, 2 or 3 indices each), then each control
    block's 2m row flags (``c_mask``, flat, block after block), then each
    control block's equality flag (``c_eq``), padded with zeros to 8
    bytes (at least 8)."""
    rec = np.zeros(len(pairs), PAIR)
    for k, (owner, a, b) in enumerate(pairs):
        rec[k]["owner"], rec[k]["dim"] = owner, len(a)
        rec[k]["a"][:len(a)], rec[k]["b"][:len(b)] = a, b
    raw = rec.tobytes() + bytes(c_mask) + bytes(c_eq)
    pad = -len(raw) % 8 if raw else 8
    return np.frombuffer(raw + bytes(pad), np.uint8)


def _meta_args(obj, control_blocks):
    """:func:`_meta_table`'s arguments for a problem, as hashable tuples:
    the objective's collision-cost pairs (owner, pxi, pxj) and the control
    blocks' row flags and equality flags."""
    return (tuple((int(i), tuple(obj.pxi[k]), tuple(obj.pxj[k]))
                  for k, i in enumerate(obj.pair_i)),
            tuple(int(v) for b in control_blocks for v in b.params.mask),
            tuple(int(b.sense == "eq") for b in control_blocks))


@functools.lru_cache(maxsize=64)
def _meta_device(pairs, c_mask, c_eq, device):
    """:func:`_meta_table` on ``device``, uploaded once per table."""
    return torch.as_tensor(_meta_table(pairs, c_mask, c_eq).copy()).to(device)


@functools.lru_cache(maxsize=64)
def _sblock_device(meta, masks, device):
    """:func:`_sblock_table` on ``device``, uploaded once per table (a copy
    from the host on every call would synchronise the stream each time)."""
    rec = _sblock_table(meta, masks)
    return torch.as_tensor(rec.view(np.uint8).copy()).to(device)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, its ``SBlock`` and ``Pair`` sizes checked
    against :data:`SBLOCK` and :data:`PAIR`."""
    lib = build.load(_LIB)
    for name, want in (("SBlock", SBLOCK), ("Pair", PAIR)):
        size = build.bind(lib, f"trial_fused_{name.lower()}_bytes", [])()
        if size != want.itemsize:
            raise RuntimeError(f"{name} is {size} bytes in the library, "
                               f"{want.itemsize} in the wrapper")
    return lib


@functools.lru_cache(maxsize=None)
def _owner_index(spec, device):
    """(owner of each control, control index), on ``device``, once per spec:
    a table copied from the host on every call would synchronise the
    stream each time."""
    return (torch.as_tensor(owner_map_u(spec), device=device),
            torch.arange(spec.m, device=device))


def _launch(lib, model, spec, obj, gc, traj, dtraj, alpha, reg_eff, stream):
    """Pack the operands and tables, run the kernel of ``lib`` on
    ``stream``, and return ``(tn, PointLite)``."""
    dtype, device = traj.x.dtype, traj.x.device
    sfx = "f32" if dtype == torch.float32 else "f64"
    P, I, D = build.P, build.I, ctypes.c_double
    inst = instance_name(model, spec)
    fn = build.launcher(lib, f"trial_fused_{inst}_{sfx}",
                        [P] * 5 + [I] * 8 + [D, D, P])
    Bsz, T, n, m, p = traj.x.shape[0], spec.T, spec.n, spec.m, spec.p
    sb, cb = gc.state_blocks, gc.control_blocks
    nsb, ncb, npair = len(sb), len(cb), len(obj.pair_i)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    s_meta, s_mask, spar, csum = _state_tables(sb, dtype, device,
                                               inst in _ROW_FLAGS)
    sblocks = _sblock_device(tuple(s_meta), tuple(s_mask), device)
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
    own, j = _owner_index(spec, device)
    Rdp = obj.Rd[own, j].contiguous()
    ufp = obj.uf[own, j].contiguous()
    table = _meta_device(*_meta_args(obj, cb), device)

    rx0 = torch.empty((Bsz, T, p, n), dtype=dtype, device=device)
    ru0 = torch.empty((Bsz, T, m), dtype=dtype, device=device)
    rd = torch.empty((Bsz, T, n), dtype=dtype, device=device)
    sc = torch.empty((Bsz, csum, T), dtype=dtype, device=device)
    cc = torch.empty((Bsz, ncb, T, 2 * m), dtype=dtype, device=device)
    tn = torch.empty((Bsz,), dtype=dtype, device=device)
    ins = [traj.x, traj.u, traj.lam, dtraj.x, dtraj.u, dtraj.lam, alpha,
           reg_eff, obj.Qd.contiguous(), obj.xf.contiguous(), Rdp, ufp, spar,
           slam, smu, zmax, zmin, clam, cmu, pmr]
    outs = [rx0, ru0, rd, sc, cc, tn]
    build.check(lib, _LIB, fn(
        (ctypes.c_void_p * len(ins))(*[a.data_ptr() for a in ins]),
        (ctypes.c_void_p * len(outs))(*[a.data_ptr() for a in outs]),
        (ctypes.c_double * _N_CONST)(*model_constants(model)),
        sblocks.data_ptr(), table.data_ptr(), Bsz, spec.N, p, nsb, csum, ncb,
        npair, spec.S, float(spec.dt), _PAIR_EPS * math.sqrt(n), stream))
    rows = np.cumsum([0] + [b.lam.shape[-1] for b in sb])
    lite = R.PointLite(
        rx0=rx0, ru0=ru0, rd=rd,
        state_c=tuple(sc[:, rows[k]:rows[k + 1]].transpose(1, 2)
                      for k in range(nsb)),
        control_c=tuple(cc[:, k] for k in range(ncb)))
    return tn, lite


def trial_occupancy(model, spec, obj, dtype, nsb=0, ncb=0) -> int:
    """Lanes per SM of the kernel instance that runs ``model``'s trials with
    ``nsb`` state blocks and ``ncb`` control blocks
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs a card."""
    lib = _library()
    sfx = "f32" if dtype == torch.float32 else "f64"
    fn = build.bind(lib, f"trial_fused_{instance_name(model, spec)}_{sfx}"
                    "_occupancy", [build.P] + [build.I] * 5)
    return fn((ctypes.c_double * _N_CONST)(*model_constants(model)), spec.N,
              spec.p, len(obj.pair_i), nsb, ncb)


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
    lib = _library()
    with torch.cuda.device(traj.x.device):
        out = _launch(lib, model, spec, obj, gc, traj, dtraj, alpha, reg_eff,
                      torch.cuda.current_stream().cuda_stream)
    trial_eval.launches += 1
    return out


trial_eval.launches = 0
