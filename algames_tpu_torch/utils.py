"""Dataclass helpers: the containers of the port are plain dataclasses whose
tensor fields carry a leading batch axis ``[B, ...]`` (or none, for leaves
shared by every lane), and whose other fields are static structure.

Counterpart of ``algames_tpu/utils.py``'s pytree glue: ``tree_map`` walks
dataclasses, tuples and lists, maps ``fn`` over tensor leaves and passes every
other value (ints, index tuples, strings, models) through from the first
tree.  Also its user-facing formatting helpers (the reference's
``src/utils.jl``): ``scn``, the solver table rows and the video-to-gif
conversion.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``, which must have the same structure)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kw = {f.name: tree_map(fn, getattr(tree, f.name),
                               *(getattr(r, f.name) for r in rest))
              for f in dataclasses.fields(tree)}
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return tree


def tree_leaves(tree) -> list:
    """Tensor leaves of ``tree`` in field order."""
    out = []
    tree_map(lambda a: out.append(a), tree)
    return out


def lanes(v, ndim: int):
    """A per-lane [B] tensor shaped to broadcast against a [B, ...] leaf of
    ``ndim`` dimensions; Python scalars and 0-d tensors pass through."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.reshape(v.shape + (1,) * (ndim - 1))
    return v


def where_tree(mask: torch.Tensor, new, old):
    """Per-lane select ``mask ? new : old`` over batched leaves (mask [B]).

    A leaf that is the same object in both trees is shared by every lane
    (radius, bounds, objective weights) and is returned as it is, never
    broadcast to the batch; so is an empty placeholder leaf.
    """
    def sel(a, b):
        if a is b or a.numel() == 0:
            return a
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)
    return tree_map(sel, new, old)


def scn(a: float, digits: int = 1) -> str:
    """Scientific-notation string ``" 1.2e-3"`` matching the reference's
    ``scn`` (``src/utils.jl:63-85``)."""
    assert digits >= 0
    a = float(a)
    if a == 0 or not math.isfinite(a):
        e, mant = 0, 0.0 if a == 0 else a
    else:
        e = int(math.floor(math.log10(abs(a))))
        mant = a / (10.0 ** e)
    mant = round(mant, digits)
    if digits == 0:
        s = str(int(math.floor(mant)))
    else:
        s = f"{mant:.{digits}f}"
    sgn = " " if a >= 0 else ""
    sgne = "+" if e >= 0 else ""
    return f"{sgn}{s}e{sgne}{e}"


def display_solver_header() -> None:
    """Console header row (reference ``display_solver_header``,
    ``src/utils.jl:37-48``)."""
    print(f"{'out':<3} {'in':<2} {'α':<2} {'Δ':<6} {'res':<6} {'reg':<6}")


def display_solver_data(k, l, j, delta, res_norm, reg_x) -> None:
    """Console data row (reference ``display_solver_data``,
    ``src/utils.jl:50-61``)."""
    print(f"{k:<3} {l:<2} {j:<2} {float(delta):<6.0e} "
          f"{float(res_norm):<6.0e} {float(reg_x):<6.0e}")


def convert_video_to_gif(video_path: str, gif_path: str,
                         framerate: int = 30, width: int = 1080,
                         overwrite: bool = True) -> None:
    """Convert a screen-capture video to a gif with ``ffmpeg`` (the
    reference's ``convert_video_to_gif``, ``src/utils.jl:91-120``).  Raises
    ``FileNotFoundError`` when no ``ffmpeg`` is on PATH."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise FileNotFoundError("ffmpeg not found on PATH")
    cmd = [ffmpeg, "-i", video_path,
           "-vf", f"fps={framerate},scale={width}:-1:flags=lanczos",
           gif_path]
    if overwrite:
        cmd.insert(1, "-y")
    subprocess.run(cmd, check=True, capture_output=True)
