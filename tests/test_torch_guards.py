"""Guards of the PyTorch port: it never imports JAX, it has no CPU fallback
for its kernels, and ``chip_smoke.py`` refuses to report without a card."""
import dataclasses
import inspect
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.ops.thomas import solve_thomas, solve_thomas_structured
from algames_tpu_torch.ops.trial import trial_eval, trial_supported
from algames_tpu_torch.ops import build
from algames_tpu_torch.presets import PRESETS, flagship_unicycle

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "algames_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG],
                                                        "algames_tpu_torch."))


def test_imports_with_jax_blocked():
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "import algames_tpu_torch; "
            f"[importlib.import_module(m) for m in {_modules()!r}]; "
            "assert not any(k == 'jax' or k.startswith(('jax.', "
            "'algames_tpu.')) for k, v in sys.modules.items() "
            "if v is not None); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    offenders += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                                  if pat.match(line)]
    assert not offenders, offenders


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (and, alone, no package beside it): non-zero exit, no ok."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout + out.stderr


def test_cpu_solve_launches_no_kernel():
    """CPU solves with the fused trial run the plain versions: no kernel's
    launch counter moves, on any preset (the flagship and the double
    integrator and quadrotor: K1, K2/K4; the roundabout and the bicycle: K3,
    K4)."""
    cpu = torch.device("cpu")
    problems = [flagship_unicycle(cpu, torch.float64, outer=1, inner=2, p=2,
                                  N=5)]
    problems += [PRESETS[k](cpu, torch.float64, outer=1, inner=2)
                 for k in ("round4_N40", "di2_N10", "bike3_N20", "quad2_N15")]
    counters = (solve_thomas_structured, solve_thomas, trial_eval)
    before = [c.launches for c in counters]
    for pr, sp in problems:
        pr = dataclasses.replace(pr, opts=dataclasses.replace(pr.opts,
                                                              ls_fused=True))
        assert trial_supported(pr.model, sp, pr.obj, pr.gc)
        out = agt.newton_solve(pr, pr.x0[None].repeat(2, 1))
        assert out.traj.x.shape == (2, sp.N, sp.n)
        assert bool(torch.isfinite(out.traj.x).all())
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_presets_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU: every preset's device defaults to CUDA."""
    assert sorted(PRESETS) == ["bike3_N20", "di2_N10", "quad2_N15",
                               "round4_N40", "uni3_N20"]
    for fn in PRESETS.values():
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernel_libraries_have_sources():
    """Every library a wrapper loads is a source of ``csrc/`` with its own
    error-string export, and every source is loaded by some wrapper."""
    from algames_tpu_torch.ops import thomas, trial
    libs = {trial._LIB, *(v for k, v in vars(thomas).items()
                          if k.startswith("_LIB"))}
    sources = {p.stem for p in build.CSRC_DIR.glob("*.cu")}
    assert libs == sources == {"thomas_sq", "thomas_dense", "trial_fused"}
    for name in sources:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        assert f'extern "C" const char* {name}_error_string' in text
