"""Procedural quadrotor visualization mesh (counterpart of
``algames_tpu/plots/mesh.py``, a numpy copy of it).

The reference ships static quadrotor OBJ/MTL assets
(``src/mesh/quadrotor/quadrotor.obj``) consumed only by the downstream
AlgamesDriving visualizer (``README.md:6``).  Instead of binary assets, this
module *generates* an equivalent watertight quadrotor mesh — a central body
box, four arms, and four rotor disks — and writes standard Wavefront OBJ, so
any viewer the reference's assets served can be fed from here.
"""
from __future__ import annotations

import math

import numpy as np


def _box(cx, cy, cz, sx, sy, sz):
    """Axis-aligned box: 8 vertices, 12 triangles (0-based indices)."""
    dx, dy, dz = sx / 2, sy / 2, sz / 2
    v = np.array([[cx + ix * dx, cy + iy * dy, cz + iz * dz]
                  for ix in (-1, 1) for iy in (-1, 1) for iz in (-1, 1)])
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],   # x faces
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],   # y faces
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],   # z faces
    ])
    return v, f


def _disk(cx, cy, cz, r, nseg=24):
    """Flat rotor disk as a triangle fan."""
    ang = [2 * math.pi * k / nseg for k in range(nseg)]
    rim = np.array([[cx + r * math.cos(a), cy + r * math.sin(a), cz]
                    for a in ang])
    v = np.vstack([[cx, cy, cz], rim])
    f = np.array([[0, 1 + k, 1 + (k + 1) % nseg] for k in range(nseg)])
    return v, f


def quadrotor_mesh(arm_length: float = 0.2, body_size: float = 0.12,
                   rotor_radius: float = 0.08):
    """Build the quadrotor mesh.  Returns (vertices [V, 3], faces [F, 3])
    with 0-based triangle indices.  The rotors sit at ``(+-L, +-L)`` in the
    body frame — the standard X-configuration."""
    verts, faces = [], []

    def add(v, f):
        base = sum(len(x) for x in verts)
        verts.append(v)
        faces.append(f + base)

    add(*_box(0, 0, 0, body_size, body_size, body_size * 0.5))
    L = arm_length
    arm_w = body_size * 0.25
    add(*_box(L / 2, L / 2, 0, L * 1.2, arm_w, arm_w))      # (+,+) arm
    add(*_box(-L / 2, -L / 2, 0, L * 1.2, arm_w, arm_w))
    add(*_box(L / 2, -L / 2, 0, arm_w, L * 1.2, arm_w))
    add(*_box(-L / 2, L / 2, 0, arm_w, L * 1.2, arm_w))
    z_rot = body_size * 0.35
    for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        add(*_disk(sx * L, sy * L, z_rot, rotor_radius))
    return np.vstack(verts), np.vstack(faces)


def write_obj(path: str, vertices=None, faces=None) -> str:
    """Write the quadrotor mesh (or a custom one) as Wavefront OBJ."""
    if vertices is None or faces is None:
        vertices, faces = quadrotor_mesh()
    with open(path, "w") as fh:
        fh.write("# tpu-algames procedural quadrotor mesh\n")
        for v in vertices:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")  # OBJ is 1-based
    return path
