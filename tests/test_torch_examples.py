"""The port's examples (``examples_torch/*.py``) run end to end as
subprocesses on the CPU at the reduced budget (``SMOKE=1 --device cpu``),
each gated on the completion marker that ``tests/test_examples.py`` gates
the JAX package's examples on; the two with plots save them into a
temporary directory."""
import os
import subprocess
import sys

import pytest

from test_examples import MARKERS

EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples_torch")
PLOTS = {"intro_example.py": ("intro_traj.png", "intro_violations.png"),
         "roundabout_example.py": ("roundabout.png",)}


@pytest.mark.parametrize("name", sorted(MARKERS))
def test_example_smoke(name, tmp_path):
    env = dict(os.environ, SMOKE="1")
    args = ["--device", "cpu"]
    if name in PLOTS:
        args += ["--plots", str(tmp_path)]
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, name)] + args,
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n--- stdout ---\n"
        f"{proc.stdout[-3000:]}\n--- stderr ---\n{proc.stderr[-3000:]}")
    assert MARKERS[name] in proc.stdout, (
        f"{name} ran but its completion marker {MARKERS[name]!r} is missing"
        f"\n--- stdout ---\n{proc.stdout[-3000:]}")
    for f in PLOTS.get(name, ()):
        assert (tmp_path / f).stat().st_size > 0
