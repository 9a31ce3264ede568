"""3D example: 2-player quadrotor game with spherical collision avoidance,
a 3D wall facet, and a cylinder keep-out.

Exercises the 3D constraint families (reference ``Wall3DConstraint``,
``CylinderConstraint``, ``add_spherical_collision_avoidance!``) on the
12-state MRP quadrotor model.

  python examples_torch/quadrotor_example.py             # on the card
  python examples_torch/quadrotor_example.py --device cpu
"""
import _common

import numpy as np
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as S
from algames_tpu_torch.models.quadrotor import quadrotor_game


def main():
    device, dtype = _common.setup(_common.parser(__doc__).parse_args())
    p = 2
    model = quadrotor_game(p=p)
    N, dt = 15, 0.1
    spec = agt.spec_from_model(model, N, dt)

    hover = 0.5 * 9.81 / 4.0 / model.kf
    obj = agt.game_objective(
        spec, Q=[np.asarray([10, 10, 10, 1, 1, 1, 1, 1, 1, 1, 1, 1],
                            np.float64)] * p,
        R=[0.1 * np.ones(4)] * p,
        xf=[np.concatenate([[1.5, 0.3 * i, 1.0], np.zeros(9)])
            for i in range(p)],
        uf=[np.full((4,), hover)] * p, dtype=dtype, device=device)

    gc = S.game_constraints(spec, dtype=dtype, device=device)
    gc = S.add_spherical_collision_avoidance(spec, gc, 0.1)
    # floor facet at z=0.2 over the unit square, forbidden side below
    gc = S.add_wall_constraint(spec, gc, [
        S.Wall3D([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
                 [0.0, 0.0, -1.0])])
    # vertical cylinder obstacle
    gc = S.add_wall_constraint(spec, gc, [
        S.CylinderWall([0.75, 0.15, 0.0], "z", 2.0, 0.2)])
    gc = S.add_control_bound(spec, gc, 3 * np.ones(spec.m), np.zeros(spec.m))

    x0 = np.zeros(spec.n)
    x0[[spec.pz[i][2] for i in range(p)]] = 1.0    # z = 1
    x0[spec.pz[1][1]] = 0.3                        # y offset
    opts = (agt.Options(outer_iter=2, inner_iter=4) if _common.smoke()
            else agt.Options(outer_iter=6, inner_iter=12))
    prob = agt.game_problem(N, dt, torch.as_tensor(x0, dtype=dtype,
                                                   device=device),
                            model, opts, obj, gc)

    out = agt.newton_solve(prob)
    it = int(out.stats.iter[0])
    print(f"quadrotor game: {it} iterations")
    print("violations:", _common.final_violations(out))
    X = out.traj.x[0].cpu().numpy()
    for i in range(p):
        pz = list(spec.pz[i][:3])
        print(f"player {i}: start {X[0, pz]}, end {X[-1, pz]}")


if __name__ == "__main__":
    main()
