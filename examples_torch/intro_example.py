"""Intro example: 3-player bicycle game with the full constraint stack.

Mirror of the reference ``examples/intro_example.jl:1-80``: build model ->
objective (+ collision cost) -> constraints (collision avoidance, control
and state bounds, wall, circles) -> GameProblem -> newton_solve -> plots.

  python examples_torch/intro_example.py                  # on the card
  python examples_torch/intro_example.py --device cpu --plots DIR
"""
import os
import time

import _common

import numpy as np
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as S
from algames_tpu_torch.models.bicycle import bicycle_game
from algames_tpu_torch.objective.objective import add_collision_cost


def main():
    ap = _common.parser(__doc__)
    ap.add_argument("--plots", default=None,
                    help="directory to save the plots into (needs matplotlib)")
    args = ap.parse_args()
    device, dtype = _common.setup(args)

    # Dynamics: 3-player bicycle game (intro_example.jl:10-14).
    p = 3
    model = bicycle_game(p=p)
    N, dt = 20, 0.1
    spec = agt.spec_from_model(model, N, dt)

    # Per-player LQR objective (intro_example.jl:21-33).
    obj = agt.game_objective(
        spec, Q=[10 * np.ones(model.ni[i]) for i in range(p)],
        R=[0.1 * np.ones(model.mi[i]) for i in range(p)],
        xf=[np.asarray(v, np.float64) for v in
            ([2, +0.4, 0, 0], [2, 0.0, 0, 0], [3, -0.4, 0, 0])],
        uf=[np.zeros(model.mi[i]) for i in range(p)],
        dtype=dtype, device=device)
    obj = add_collision_cost(spec, obj, radius=np.ones(p), mu=5.0 * np.ones(p))

    # Constraints (intro_example.jl:38-58).
    gc = S.game_constraints(spec, dtype=dtype, device=device)
    gc = S.add_collision_avoidance(spec, gc, 0.08)
    gc = S.add_control_bound(spec, gc, 5 * np.ones(spec.m), -5 * np.ones(spec.m))
    gc = S.add_state_bound(spec, gc, 0, 5 * np.ones(spec.n), -5 * np.ones(spec.n))
    gc = S.add_wall_constraint(
        spec, gc, [S.Wall([0.0, -0.4], [1.0, -0.4], [0.0, -1.0])])
    gc = S.add_circle_constraint(spec, gc, [1.0, 2.0, 3.0], [1.0, 2.0, 3.0],
                                 [0.1, 0.2, 0.3])

    # Initial state (intro_example.jl:61-67): [x (p); y (p); v (p); psi (p)].
    x0 = torch.as_tensor([0.1, 0.0, 0.5, -0.4, 0.0, 0.7,
                          0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=dtype,
                         device=device)
    opts = (agt.Options(outer_iter=2, inner_iter=4) if _common.smoke()
            else agt.Options())
    prob = agt.game_problem(N, dt, x0, model, opts, obj, gc)

    times = []
    for _ in range(2):              # the first call builds the kernels
        t0 = time.perf_counter()
        result = agt.newton_solve(prob)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    it = int(result.stats.iter[0])
    print(f"solved in {it} Newton iterations (first solve {times[0]:.2f}s, "
          f"second {times[1] * 1e3:.1f}ms)")
    print("violations:", _common.final_violations(result))

    if args.plots:
        import matplotlib
        matplotlib.use("Agg")
        from algames_tpu_torch.plots import plot_trajectory, plot_violations
        os.makedirs(args.plots, exist_ok=True)
        paths = [os.path.join(args.plots, f) for f in
                 ("intro_traj.png", "intro_violations.png")]
        plot_trajectory(spec, result.traj).figure.savefig(paths[0], dpi=120)
        plot_violations(result.stats).figure.savefig(paths[1], dpi=120)
        print("plots saved to", ", ".join(paths))


if __name__ == "__main__":
    main()
