"""Checkpoint and resume of trajectories and solver state (counterpart of
``algames_tpu/checkpoint.py``).

``save_traj``/``load_traj`` keep the JAX package's ``.npz`` layout (keys
``x``, ``u``, ``lam``), so a file written by either package loads in the
other.  ``save_pytree``/``restore_pytree`` write the layout of the JAX
package's ``.npz`` fallback: one array ``leaf_{i}`` per tensor leaf, in the
order of ``utils.tree_leaves``; the example tree given to the restore
supplies the structure, and each leaf's device and dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.traj import PrimalDual
from .utils import tree_leaves, tree_map


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_traj(path: str, traj: PrimalDual) -> None:
    """Write a PrimalDual warm-start buffer to ``path`` (.npz)."""
    np.savez(path, **{k: getattr(traj, k).detach().cpu().numpy()
                      for k in ("x", "u", "lam")})


def load_traj(path: str, dtype=None, device="cuda") -> PrimalDual:
    """Read a PrimalDual written by either package's ``save_traj``, its
    arrays as stored (a batch axis where the writer had one), in ``dtype``
    (default: as stored) on ``device``."""
    with np.load(path) as z:
        arrays = {k: torch.as_tensor(z[k]) for k in ("x", "u", "lam")}
    return PrimalDual(**{k: a.to(device=device, dtype=dtype or a.dtype)
                         for k, a in arrays.items()})


def save_pytree(path: str, tree: Any) -> None:
    """Checkpoint a tree of tensors (SolveResult, GameConstraints AL state,
    stats) as ``.npz``: ``leaf_{i}`` per tensor leaf."""
    np.savez(_npz(path), **{f"leaf_{i}": a.detach().cpu().numpy()
                            for i, a in enumerate(tree_leaves(tree))})


def restore_pytree(path: str, example: Any) -> Any:
    """Restore a checkpoint of :func:`save_pytree` onto the structure of
    ``example``, each leaf on its example leaf's device and dtype."""
    with np.load(_npz(path), allow_pickle=False) as z:
        leaves = iter([z[f"leaf_{i}"] for i in
                       range(len(tree_leaves(example)))])
    return tree_map(lambda a: torch.as_tensor(next(leaves)).to(
        device=a.device, dtype=a.dtype), example)
