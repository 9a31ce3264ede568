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
from algames_tpu_torch.presets import flagship_unicycle, roundabout

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
    launch counter moves, neither on the flagship (K1, K2) nor on the
    roundabout (K3, K4: dense Hessians, the widened trial)."""
    prob, spec = flagship_unicycle(torch.device("cpu"), torch.float64,
                                   outer=1, inner=2, p=2, N=5)
    prob = dataclasses.replace(prob, opts=dataclasses.replace(prob.opts,
                                                              ls_fused=True))
    rprob, rspec = roundabout(torch.device("cpu"), torch.float64, outer=1,
                              inner=2)
    rprob = dataclasses.replace(rprob, opts=dataclasses.replace(
        rprob.opts, ls_fused=True))
    counters = (solve_thomas_structured, solve_thomas, trial_eval)
    before = [c.launches for c in counters]
    for pr, sp in ((prob, spec), (rprob, rspec)):
        assert trial_supported(pr.model, sp, pr.obj, pr.gc)
        out = agt.newton_solve(pr, pr.x0[None].repeat(2, 1))
        assert out.traj.x.shape == (2, sp.N, sp.n)
        assert bool(torch.isfinite(out.traj.x).all())
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_presets_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU: the presets' device defaults to CUDA."""
    for fn in (flagship_unicycle, roundabout):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
