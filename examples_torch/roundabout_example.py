"""4-player roundabout, N=40: the BASELINE.json config-4 scenario.

Four unicycles enter from the four compass directions and exit to their
right, yielding around a central circular island (circle constraint) with
pairwise collision constraints, a smooth collision cost, speed limits
(velocity bounds) and control bounds.  Entry speeds are staggered so the
crossing order is well-defined: the fully symmetric head-on variant has a
degenerate (colliding) symmetric equilibrium that no local Nash solver
handles.

  python examples_torch/roundabout_example.py            # on the card
  python examples_torch/roundabout_example.py --device cpu --plots DIR
"""
import os
import time

import _common

import numpy as np
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as S
from algames_tpu_torch.objective.objective import add_collision_cost


def main():
    ap = _common.parser(__doc__)
    ap.add_argument("--plots", default=None,
                    help="directory to save the plot into (needs matplotlib)")
    args = ap.parse_args()
    device, dtype = _common.setup(args)

    p = 4
    model = agt.unicycle_game(p=p)
    N, dt = 40, 0.1
    spec = agt.spec_from_model(model, N, dt)

    starts = np.array([[-1.5, 0.0], [1.5, 0.0], [0.0, -1.5], [0.0, 1.5]])
    # exit arm to the player's right
    order = [3, 2, 0, 1]
    goals = np.array([-starts[order[i]] for i in range(p)])
    headings = np.arctan2(-starts[:, 1], -starts[:, 0])

    obj = agt.game_objective(
        spec, Q=[np.asarray([5.0, 5.0, 0.2, 0.2])] * p,
        R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([goals[i, 0], goals[i, 1], headings[i], 0.3])
            for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    obj = add_collision_cost(spec, obj, radius=0.4 * np.ones(p),
                             mu=5.0 * np.ones(p))

    gc = S.game_constraints(spec, dtype=dtype, device=device)
    gc = S.add_collision_avoidance(spec, gc, 0.08)
    gc = S.add_circle_constraint(spec, gc, [0.0], [0.0], [0.3])
    gc = S.add_velocity_bound(spec, model, gc, 1.5 * np.ones(p),
                              -0.2 * np.ones(p))
    gc = S.add_control_bound(spec, gc, 3 * np.ones(spec.m),
                             -3 * np.ones(spec.m))

    x0 = np.zeros(spec.n)
    for i in range(p):
        x0[list(spec.px[i])] = starts[i]
        x0[spec.pz[i][2]] = headings[i]
        x0[spec.pz[i][3]] = 0.3 + 0.1 * i   # staggered entry speeds
    opts = (agt.Options(outer_iter=2, inner_iter=4) if _common.smoke()
            else agt.Options(outer_iter=10, inner_iter=16))
    prob = agt.game_problem(N, dt, torch.as_tensor(x0, dtype=dtype,
                                                   device=device),
                            model, opts, obj, gc)

    t0 = time.perf_counter()
    out = agt.newton_solve(prob)
    it = int(out.stats.iter[0])
    print(f"roundabout p=4 N=40: {it} iterations in "
          f"{time.perf_counter() - t0:.1f}s (the first call builds the "
          f"kernels)")
    print("violations:", _common.final_violations(out))
    X = out.traj.x[0].cpu().numpy()
    dmin = min(np.min(np.linalg.norm(
        X[:, list(spec.px[a])] - X[:, list(spec.px[b])], axis=1))
        for a in range(p) for b in range(a + 1, p))
    print(f"min pairwise distance: {dmin:.3f} (constraint: 0.16)")
    island = min(np.min(np.linalg.norm(X[:, list(spec.px[i])], axis=1))
                 for i in range(p))
    print(f"min distance to island center: {island:.3f} (constraint: 0.3)")

    if args.plots:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib.patches import Circle
        from algames_tpu_torch.plots import plot_trajectory
        ax = plot_trajectory(spec, out.traj)
        ax.add_patch(Circle((0, 0), 0.3, fill=False, color="k"))
        os.makedirs(args.plots, exist_ok=True)
        path = os.path.join(args.plots, "roundabout.png")
        ax.figure.savefig(path, dpi=120)
        print("plot saved to", path)


if __name__ == "__main__":
    main()
