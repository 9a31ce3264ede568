"""Build the hand-written CUDA kernels of ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for Hopper (``sm_90a``) into ``_build/<name>-<hash>.so``, keyed
by a hash of the source, the shared ``csrc/*.cuh`` headers and the flags,
and loaded with ``ctypes``.  The
compiler's register/shared-memory report (``-Xptxas -v``) is kept beside the
library as ``<name>-<hash>.log``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return found


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers and the
    flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    lib = ctypes.CDLL(str(build(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


P = ctypes.c_void_p   # device pointer, host table or stream
I = ctypes.c_int


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> object:
    """Declare an export's argument types; it returns an int (a launcher:
    a CUDA error code)."""
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


launch_hook = None
"""When set, every call of a :func:`launcher` runs ``launch_hook(fn,
args)`` instead of ``fn(*args)``: a timer's way in (``chip_smoke.py``'s
``device_ms`` brackets each launch with CUDA events)."""


def launcher(lib: ctypes.CDLL, fn: str, argtypes):
    """A kernel launcher bound with :func:`bind`, called through
    :data:`launch_hook` when one is set; it may be kept and reused."""
    f = bind(lib, fn, argtypes)

    def launch(*args):
        hook = launch_hook
        return f(*args) if hook is None else hook(f, args)
    return launch


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
