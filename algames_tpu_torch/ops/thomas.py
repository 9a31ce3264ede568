"""Kernels K1 and K3: the Schur-condensed block-Thomas KKT sweep, with the
statx Hessian blocks in structured (K1) or dense (K3) form.

K1 replaces ``algames_tpu/ops/thomas_pallas.py::solve_thomas_pallas_structured``
(forward ``_make_fwd_kernel_sq``, backward ``_make_bwd_kernel_sq``, pivoted
``_reduced_solve``) for homogeneous specs; K3 replaces ``solve_thomas_pallas``
(``_make_fwd_kernel``, ``_make_bwd_kernel``) for every spec.  Both are CUDA
C++ (``csrc/thomas_sq.cu``, ``csrc/thomas_dense.cu``, sharing
``csrc/thomas_common.cuh``): two launches, forward and backward, one thread
block per scenario lane with the knot recursion as a loop inside the block.

A heterogeneous spec (unequal per-player control widths) reaches K3 padded,
as in the reference (``thomas_pallas.py:449-467, 553-561``): the wrapper
pads every player's controls to ``max(mi)`` in player-major order with
identity rows of a virtual zero column of B, launches the unchanged kernel
with ``m = p max(mi)`` and ``owner[r] = r // max(mi)``, and gathers the
solution back to natural control order.  The padded unknowns solve
``1 * u_pad = 0`` exactly.  K1 stays homogeneous, as in the reference.

The forward kernels of both hold the augmented system in registers, one
fixed tile per thread, with one block barrier per pivot step and the next
knot's operands copied in while a knot is eliminated
(``csrc/thomas_dense_core.cuh``, with the Q form a compile-time policy:
K1 and K3's classes for d > 24 LU and a back substitution, K3's others
Gauss-Jordan).  K3's size classes cover d = n + m <= 32 and d + p n + 1 <=
96, K1's d <= 32 and d + p n + 1 <= 96 with 128 threads a lane and, with
256, d <= 48 and d + p n + 1 <= 160.  Wider systems up to d = 64 take the
per-player blocked route of ``csrc/thomas_blocked.cuh`` (the fill-in
formed over the carry in place, K's LU in registers, the right-hand sides
built in pivot order and substituted in registers, 256 threads a lane),
its Q form a policy: K1's q and w staged a knot (the 4-player quadrotor,
the 6-player unicycle), K3's dense Q_i staged a player at a time into two
slots (the 4-player quadrotor with collision-cost pairs, the 3-player
quadrotor turned dense, d = 48); counted in
``solve_thomas_structured.blocked_launches`` and
``solve_thomas.blocked_launches``.  Systems beyond it take the
shared-memory forward kernel of ``csrc/thomas_common.cuh`` (every per-knot
operand, the carry and the augmented system in shared memory) where its
bytes fit a block's 232,448, counted apart in ``solve_thomas.big_launches``
and ``solve_thomas_structured.wide_launches``; beyond that the
device-memory route of ``csrc/thomas_global.cuh`` (K [d, d] and a panel of
128 right-hand sides in shared memory, the fill-in F in a workspace this
wrapper allocates, n p n scalars a lane; K1's rank-1 products a panel of
128 w vectors at a time), counted in ``global_launches``: the route of the
unicycle merges of 11 to 17 players; it takes d <= 128 within those bytes
(in f64 d up to about 104) and wider systems raise.  The owners of the
control rows (and K1's of the w vectors) are int32 arrays on the card
(:func:`owner_table`), so no table of a fixed size bounds m or the w
vectors.  The library says which route a shape takes
(``thomas_sq_route_*``, ``thomas_dense_route_*``), before the launch; a
build or launch error raises.  ``forward="blocked"``, ``"shared"`` or
``"device"`` takes that route at any widths that it holds, to time it
against the route the shape takes.  See the sources for what bounds each
on the card.

Each wrapper takes its plain PyTorch version (``problem.linear_solver
.solve_tridiagonal_schur``, after densifying Q for K1) for CPU tensors only;
for CUDA tensors it launches the kernel or raises.  ``kkt_solve`` picks K1
or K3 by the form of the Hessian blocks, ``kkt_solve_plain`` their plain
versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.spec import owner_map_u
from ..problem.linear_solver import (JacBlocks, pad_operands,
                                     solve_tridiagonal_schur, unpad_columns)
from ..problem.residual import StructuredQ
from . import build

_LIB = "thomas_sq"
_LIB_DENSE = "thomas_dense"


def structured_to_dense(sq: StructuredQ, w_owner, p: int) -> torch.Tensor:
    """Qblk [B, T, p, n, n] = diag(qdiag) + sum of the owned w w^T."""
    per = [torch.diag_embed(sq.qdiag[:, :, i]) for i in range(p)]
    for k, o in enumerate(w_owner):
        w = sq.wv[:, :, k]
        per[o] = per[o] + w[..., :, None] * w[..., None, :]
    return torch.stack(per, dim=2)


def solve_thomas_structured_plain(spec, sq: StructuredQ, b: torch.Tensor,
                                  w_owner) -> torch.Tensor:
    """Plain PyTorch version of K1 (pivoted ``torch.linalg`` solves)."""
    jb = JacBlocks(Qblk=structured_to_dense(sq, w_owner, spec.p),
                   Ublk=sq.Ublk, A=sq.A, B=sq.B)
    return solve_tridiagonal_schur(spec, jb, b)


def _check_operands(spec, blocks, b: torch.Tensor, want) -> None:
    """Raise unless ``b`` and every named operand of ``blocks`` has its
    shape, ``b``'s type and device, and is contiguous.  The widths the
    kernels take are the library's to say, where one is about to launch
    (``_shape_route``); the plain versions take any."""
    Bsz, T = b.shape[0], spec.T
    if tuple(b.shape) != (Bsz, T, spec.W):
        raise ValueError(f"b has shape {tuple(b.shape)}, want "
                         f"{(Bsz, T, spec.W)}")
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {b.dtype}")
    for name, shape in want.items():
        a = getattr(blocks, name)
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, want "
                             f"{shape}")
        if a.dtype != b.dtype or a.device != b.device:
            raise TypeError(f"{name} is {a.dtype} on {a.device}, b is "
                            f"{b.dtype} on {b.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")


def _route(b: torch.Tensor) -> str:
    """``"plain"`` for a CPU tensor, ``"kernel"`` for a CUDA tensor."""
    if b.device.type == "cpu":
        return "plain"
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    return "kernel"


def _check(spec, sq: StructuredQ, b: torch.Tensor, w_owner) -> None:
    if not spec.homogeneous:
        raise ValueError("the Thomas sweep kernel K1 needs a homogeneous "
                         "spec")
    Bsz, T, n, m, p = b.shape[0], spec.T, spec.n, spec.m, spec.p
    NW = len(w_owner)
    _check_operands(spec, sq, b, {
        "qdiag": (Bsz, T, p, n), "wv": (Bsz, T, NW, n),
        "Ublk": (Bsz, T, m, m), "A": (Bsz, T, n, n), "B": (Bsz, T, n, m)})


# The forward routes in the order of the libraries' ``*_route_*`` numbers,
# their names, and their exports' infixes in K1's and K3's library.
_ROUTES = ("tiled", "shared", "device", "blocked")
_ROUTE_NAMES = {"tiled": "register-tiled", "shared": "shared-memory",
                "device": "device-memory", "blocked": "per-player blocked"}
_INFIX = {_LIB: {"tiled": "", "shared": "wide_", "device": "global_",
                 "blocked": "blocked_"},
          _LIB_DENSE: {"tiled": "", "shared": "big_", "device": "global_",
                       "blocked": "blocked_"}}


def _sfx(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


@functools.lru_cache(maxsize=None)
def _shape_route(name: str, dtype, widths) -> str:
    """The forward route that library ``name`` picks for ``widths`` ((n, m,
    p, NW) for K1, (n, m, p) for K3), asked once per shape; raises where no
    route holds the system."""
    export = f"{name}_route_{_sfx(dtype)}"
    code = build.bind(build.load(name), export,
                      [build.I] * len(widths))(*widths)
    if code < 0:
        raise ValueError(f"no forward kernel takes a system of widths "
                         f"{tuple(widths)} ({export})")
    return _ROUTES[code]


def _pick_route(name: str, dtype, widths, forward: str) -> str:
    """The route the shape takes (``forward`` "auto"), or the one that
    ``forward`` names: "blocked", "shared" or "device", to time it against
    the shape's."""
    if forward == "auto":
        return _shape_route(name, dtype, tuple(widths))
    if forward == "tiled" or forward not in _INFIX[name]:
        raise ValueError(f"unknown forward route {forward!r}")
    return forward


@functools.lru_cache(maxsize=None)
def owner_table(owner: tuple, device) -> torch.Tensor:
    """An owner table (the control rows' owners, or K1's w vectors') as
    the int32 array on ``device`` that the kernels read, built once per
    table and device: a copy from the host on every call would synchronise
    the stream each time.  No table of a fixed size bounds its length."""
    return torch.tensor(owner or (0,), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _sq_launch(spec, w_owner, dtype, device, forward="auto"):
    """K1 at these widths, once per (shape, dtype, device, route asked
    for): ``(route, library, forward and backward launchers, the control
    rows' owners [m] and the w vectors' owners [NW], each int32 on
    ``device``)``."""
    lib = build.load(_LIB)
    sfx = _sfx(dtype)
    P, I = build.P, build.I
    route = _pick_route(_LIB, dtype, (spec.n, spec.m, spec.p, len(w_owner)),
                        forward)
    fwd = build.launcher(lib, f"thomas_sq_fwd_{_INFIX[_LIB][route]}{sfx}",
                         [P] * (11 if route == "device" else 10) + [I] * 6
                         + [P])
    bwd = build.launcher(lib, f"thomas_sq_bwd_{sfx}", [P] * 9 + [I] * 6 + [P])
    return (route, lib, fwd, bwd, owner_table(owner_map_u(spec), device),
            owner_table(tuple(w_owner), device))


def _occupancy(name: str, dtype, widths, forward: str):
    """``(route name, lanes per SM, registers a thread, local memory bytes
    a thread)`` of library ``name``'s forward kernel at ``widths`` on the
    route ``forward`` names or the shape takes, from the CUDA runtime."""
    lib = build.load(name)
    route = _pick_route(name, dtype, widths, forward)
    fn = build.bind(lib, f"{name}_occupancy_{_sfx(dtype)}",
                    [build.I] * (len(widths) + 1) + [build.P])
    out = (ctypes.c_int * 3)()
    build.check(lib, name, fn(*widths, _ROUTES.index(route), out))
    return (_ROUTE_NAMES[route], *out)


def structured_forward(n: int, m: int, p: int, NW: int, dtype,
                       forward="auto"):
    """The forward kernel that K1 runs at these widths with ``NW`` w
    vectors (``forward``: the route asked for): ``(route name, lanes per
    SM, registers a thread, local memory bytes a thread)``; needs a
    card."""
    return _occupancy(_LIB, dtype, (n, m, p, NW), forward)


def solve_thomas_structured(spec, sq: StructuredQ, b: torch.Tensor,
                            w_owner, forward: str = "auto") -> torch.Tensor:
    """Solve the KKT system for ``b`` [B, T, W] (pass the negated residual
    for the Newton step); ``sq`` leaves are [B, T, ...] and contiguous.
    Returns the flat [B, S] solution in per-knot column order.  The
    forward kernel is the one the library picks by shape (or the route
    ``forward`` names: "blocked", "shared", "device"); the blocked one is
    counted by ``blocked_launches``, the shared-memory one by
    ``wide_launches``, the device-memory one by ``global_launches``."""
    _check(spec, sq, b, w_owner)
    if _route(b) == "plain":
        return solve_thomas_structured_plain(spec, sq, b, w_owner)
    route, lib, fwd, bwd, owner, w_own = _sq_launch(
        spec, tuple(w_owner), b.dtype, b.device, forward)
    Bsz, T, n, m, p = b.shape[0], spec.T, spec.n, spec.m, spec.p
    d, pn, NW = n + m, p * n, len(w_owner)
    G = torch.empty((Bsz, T, d, pn), dtype=b.dtype, device=b.device)
    yhat = torch.empty((Bsz, T, d), dtype=b.dtype, device=b.device)
    y = torch.empty((Bsz, T, spec.W), dtype=b.dtype, device=b.device)
    outs = [G.data_ptr(), yhat.data_ptr()]
    if route == "device":
        work = torch.empty((Bsz, n * pn), dtype=b.dtype, device=b.device)
        outs.append(work.data_ptr())
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib, _LIB, fwd(
            sq.qdiag.data_ptr(), sq.wv.data_ptr(), sq.Ublk.data_ptr(),
            sq.B.data_ptr(), sq.A.data_ptr(), b.data_ptr(), owner.data_ptr(),
            w_own.data_ptr(), *outs, Bsz, T, n, m, p, NW, stream))
        build.check(lib, _LIB, bwd(
            G.data_ptr(), yhat.data_ptr(), sq.qdiag.data_ptr(),
            sq.wv.data_ptr(), sq.A.data_ptr(), b.data_ptr(), owner.data_ptr(),
            w_own.data_ptr(), y.data_ptr(), Bsz, T, n, m, p, NW, stream))
    if route == "shared":
        solve_thomas_structured.wide_launches += 1
    elif route == "device":
        solve_thomas_structured.global_launches += 1
    elif route == "blocked":
        solve_thomas_structured.blocked_launches += 1
    solve_thomas_structured.launches += 1
    return y.reshape(Bsz, -1)


solve_thomas_structured.launches = 0
solve_thomas_structured.wide_launches = 0
solve_thomas_structured.global_launches = 0
solve_thomas_structured.blocked_launches = 0


def solve_thomas_plain(spec, jb: JacBlocks, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (pivoted ``torch.linalg`` solves)."""
    return solve_tridiagonal_schur(spec, jb, b)


def _launch_dense(Q, Ub, Bm, A, b, owner, n, m, p, forward="auto"
                  ) -> torch.Tensor:
    """Run K3's forward and backward kernels on [B, T, ...] operands with
    ``m`` control rows owned per ``owner``; returns y [B, T, n + m + p n].
    The forward kernel is the one the library picks by shape, or the route
    ``forward`` names (counted by ``solve_thomas.blocked_launches`` for the
    blocked one, ``big_launches`` for the shared-memory one,
    ``global_launches`` for the device-memory one)."""
    lib = build.load(_LIB_DENSE)
    sfx = _sfx(b.dtype)
    route = _pick_route(_LIB_DENSE, b.dtype, (n, m, p), forward)
    P, I = build.P, build.I
    fwd = build.launcher(
        lib, f"thomas_dense_fwd_{_INFIX[_LIB_DENSE][route]}{sfx}",
        [P] * (9 if route == "device" else 8) + [I] * 5 + [P])
    bwd = build.launcher(lib, f"thomas_dense_bwd_{sfx}",
                         [P] * 6 + [I] * 5 + [P])
    Bsz, T = b.shape[:2]
    d, pn = n + m, p * n
    own = owner_table(tuple(owner), b.device)
    G = torch.empty((Bsz, T, d, pn), dtype=b.dtype, device=b.device)
    yhat = torch.empty((Bsz, T, d), dtype=b.dtype, device=b.device)
    y = torch.empty((Bsz, T, d + pn), dtype=b.dtype, device=b.device)
    outs = [G.data_ptr(), yhat.data_ptr()]
    if route == "device":
        work = torch.empty((Bsz, n * pn), dtype=b.dtype, device=b.device)
        outs.append(work.data_ptr())
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib, _LIB_DENSE, fwd(
            Q.data_ptr(), Ub.data_ptr(), Bm.data_ptr(), A.data_ptr(),
            b.data_ptr(), own.data_ptr(), *outs, Bsz, T, n, m, p, stream))
        build.check(lib, _LIB_DENSE, bwd(
            G.data_ptr(), yhat.data_ptr(), Q.data_ptr(), A.data_ptr(),
            b.data_ptr(), y.data_ptr(), Bsz, T, n, m, p, stream))
    if route == "shared":
        solve_thomas.big_launches += 1
    elif route == "device":
        solve_thomas.global_launches += 1
    elif route == "blocked":
        solve_thomas.blocked_launches += 1
    return y


def dense_forward(n: int, m: int, p: int, dtype, forward="auto"):
    """The forward kernel that K3 runs at these widths (``m``: the padded
    control rows; ``forward``: the route asked for): ``(route name, lanes
    per SM, registers a thread, local memory bytes a thread)``; needs a
    card."""
    return _occupancy(_LIB_DENSE, dtype, (n, m, p), forward)


def solve_thomas(spec, jb: JacBlocks, b: torch.Tensor,
                 forward: str = "auto") -> torch.Tensor:
    """Solve the KKT system with dense Hessian blocks (kernel K3) for ``b``
    [B, T, W]; ``jb`` leaves are [B, T, ...] and contiguous.  Returns the
    flat [B, S] solution in per-knot column order.  A heterogeneous spec
    is solved padded (see the module's docstring).  ``forward``: the
    forward route to take ("blocked", "shared", "device") at any widths
    that it holds; by default the one the library picks by shape."""
    Bsz, T, n, m, p = b.shape[0], spec.T, spec.n, spec.m, spec.p
    _check_operands(spec, jb, b, {
        "Qblk": (Bsz, T, p, n, n), "Ublk": (Bsz, T, m, m),
        "A": (Bsz, T, n, n), "B": (Bsz, T, n, m)})
    if _route(b) == "plain":
        return solve_thomas_plain(spec, jb, b)
    launch = (_launch_dense if forward == "auto"
              else functools.partial(_launch_dense, forward=forward))
    if spec.homogeneous:
        y = launch(jb.Qblk, jb.Ublk, jb.B, jb.A, b, owner_map_u(spec), n, m,
                   p)
    else:
        Ub, Bm, bk, owner = pad_operands(spec, jb, b)
        y = launch(jb.Qblk, Ub, Bm, jb.A, bk, owner, n, len(owner), p)
        y = y[..., unpad_columns(spec, len(owner))]
    solve_thomas.launches += 1
    return y.reshape(Bsz, -1)


solve_thomas.launches = 0
solve_thomas.big_launches = 0
solve_thomas.global_launches = 0
solve_thomas.blocked_launches = 0


def kkt_solve(spec, blocks, b: torch.Tensor, w_owner) -> torch.Tensor:
    """K1 for :class:`StructuredQ` blocks, K3 for :class:`JacBlocks`."""
    if isinstance(blocks, StructuredQ):
        return solve_thomas_structured(spec, blocks, b, w_owner)
    return solve_thomas(spec, blocks, b)


def kkt_solve_plain(spec, blocks, b: torch.Tensor, w_owner) -> torch.Tensor:
    """The plain version of :func:`kkt_solve`'s kernel, on any device."""
    if isinstance(blocks, StructuredQ):
        return solve_thomas_structured_plain(spec, blocks, b, w_owner)
    return solve_thomas_plain(spec, blocks, b)
