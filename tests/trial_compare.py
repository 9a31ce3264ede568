"""The fused trial kernel (K2 / K4) of two source trees on the same inputs,
on one CUDA card: outputs bitwise and device times.  Not a test module
(pytest does not collect it).

    python3 tests/trial_compare.py dump TREE NAME DIR
    python3 tests/trial_compare.py compare DIR NAME_A NAME_B

``dump`` imports ``chip_smoke.py`` and the port from TREE (a checkout, e.g.
``git archive`` of another commit unpacked in a git-ignored directory), runs
its fused trial on ``chip_smoke.py``'s trial inputs at B=1024 (K2's and the
roundabout K4's, and, where TREE's ``chip_smoke.py`` has them, those of the
double-integrator, bicycle and quadrotor games, the 3D double
integrator, the heterogeneous double integrator, the ring road, the
highway (B=32), the 3- and 4-player quadrotors (with a state bound, with
collision-cost pairs) and the 9- and 17-player merges), in f32 and f64,
prints each call's time (CUDA events, host work included) and device time (the
event reading of this repository's ``chip_smoke.device_ms``, so both trees
are timed alike), and saves the outputs to DIR/NAME.pt.  ``compare``
counts the unequal output elements of two dumps, input set by input set.
Run each ``dump`` in its own process: the two trees' packages share a name.
"""
import sys
from pathlib import Path

import torch

from thomas_compare import _timing


def dump(tree, name, out_dir):
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from algames_tpu_torch.ops.trial import trial_eval
    from algames_tpu_torch.utils import tree_leaves
    if Path(cs.__file__).resolve().parent != tree:
        raise SystemExit(f"chip_smoke.py was not imported from {tree}")
    tm = _timing()
    dev = torch.device("cuda:0")
    cases = [("K2", cs.k2_inputs), ("K4", cs.k4_inputs)]
    if hasattr(cs, "game_trial_inputs"):
        from algames_tpu_torch.presets import (intro_bicycle, intro_di,
                                               quadrotor3d)
        cases += [
            ("di2", cs.game_trial_inputs(intro_di, "di2_N10", 13)),
            ("bike3", cs.game_trial_inputs(intro_bicycle, "bike3_N20", 17)),
            ("quad2", cs.game_trial_inputs(quadrotor3d, "quad2_N15", 19,
                                           zero_u=True)),
            ("quad2-smooth", cs.game_trial_inputs(
                quadrotor3d, "quad2_N15", 23, zero_u=True, smoothing=100.0)),
            ("di3", lambda d, t: cs.trial_inputs(
                cs.di3_game, cs.random_iterates, True, d, t, seed=29))]
    if hasattr(cs, "hetero_game"):
        cases += [("hetero", cs.game_trial_inputs(cs.hetero_game,
                                                  "hetero2_N8", 37))]
    if hasattr(cs, "ring_trial_inputs"):
        cases += [("ring-eq", cs.ring_trial_inputs()),
                  ("highway", cs.highway_trial_inputs)]
    if hasattr(cs, "quad4_cost_game"):
        cases += [(tag, lambda d, t, g=game, s=seed: cs.trial_inputs(
                      g, cs.quad3_iterates, True, d, t, seed=s))
                  for tag, game, seed in (
                      ("quad3", cs.quad3_game, 43),
                      ("quad4", cs.quad4_game, 47),
                      ("quad4-bound", cs.quad4_bound_game, 53),
                      ("quad4-cost", cs.quad4_cost_game, 59))]
    if hasattr(cs, "uni9_game"):
        cases += [("uni9", lambda d, t: cs.trial_inputs(
            cs.uni9_game, cs.flagship_iterates, True, d, t, seed=61))]
    if hasattr(cs, "uni17_game"):
        cases += [("uni17", lambda d, t: cs.trial_inputs(
            cs.uni17_game, cs.flagship_iterates, True, d, t, seed=67))]
    res = {}
    for tag, inputs in cases:
        for dtype in (torch.float32, torch.float64):
            prob, spec, gc, traj, dtraj, alpha, reg = inputs(dev, dtype)
            args = (prob.model, spec, prob.obj, gc, traj, dtraj, alpha, reg)
            sfx = "f32" if dtype == torch.float32 else "f64"
            try:
                tn, lite = trial_eval(*args)
            except RuntimeError as err:      # a variant's lane may not fit
                print(f"{name} {tag} {sfx}: {err}", flush=True)
                continue
            res[f"{tag} {str(dtype)[-7:]}"] = [
                a.cpu() for a in [tn] + tree_leaves(lite)]
            call = cs.cuda_ms(lambda: trial_eval(*args), 20)
            device = tm.device_ms(lambda: trial_eval(*args), 50,
                                  ("trial_",), 1, f"{name} {tag} {sfx}")
            print(f"{name} {tag} {sfx} B={cs.B_KERNEL}: call {call:.4f} "
                  f"ms, device {device:.4f} ms", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(res, out_dir / f"{name}.pt")


def compare(out_dir, a_name, b_name):
    a = torch.load(out_dir / f"{a_name}.pt")
    b = torch.load(out_dir / f"{b_name}.pt")
    for key in a:
        if key not in b:
            continue
        unequal = sum(int((x != y).sum()) for x, y in zip(a[key], b[key]))
        worst = max(float((x.double() - y.double()).abs().max())
                    for x, y in zip(a[key], b[key]))
        print(f"{a_name} vs {b_name}, {key}: {unequal} unequal elements of "
              f"{sum(x.numel() for x in a[key])}, max |diff| {worst:.3e}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(Path(sys.argv[2]).resolve(), sys.argv[3], Path(sys.argv[4]))
    else:
        compare(Path(sys.argv[2]), sys.argv[3], sys.argv[4])
