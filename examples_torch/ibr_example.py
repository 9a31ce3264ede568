"""ALGAMES vs iterative best response: mirror of the reference
``examples/ibr_example.jl:1-155``.

Solves the same 3-player unicycle scenario with (a) the full Nash solver and
(b) Gauss-Seidel IBR, then compares residuals and trajectories.  As the
reference example documents (``ibr_example.jl:137-154``), the IBR fixed
point is generally NOT a Nash equilibrium: its full-game stationarity
residual stays large even when each player is unilaterally optimal against
the frozen others.

  python examples_torch/ibr_example.py                   # on the card
  python examples_torch/ibr_example.py --device cpu
"""
import _common

import numpy as np
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as S


def main():
    device, dtype = _common.setup(_common.parser(__doc__).parse_args())
    p = 3
    model = agt.unicycle_game(p=p)
    N, dt = 20, 0.1
    spec = agt.spec_from_model(model, N, dt)

    obj = agt.game_objective(
        spec, Q=[10 * np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([2.0, -0.4 * (i - 1), 0.0, 0.0]) for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    gc = S.game_constraints(spec, dtype=dtype, device=device)
    gc = S.add_collision_avoidance(spec, gc, 0.05)
    x0 = torch.as_tensor([0.0, 0.0, 0.0, -0.4, 0.0, 0.4, 0.0, 0.0, 0.0,
                          0.5, 0.5, 0.5], dtype=dtype, device=device)
    opts = agt.Options(reg_0=1e-7)
    ibr_iter = 10
    if _common.smoke():
        opts = agt.Options(reg_0=1e-7, outer_iter=2, inner_iter=4)
        ibr_iter = 2
    prob = agt.game_problem(N, dt, x0, model, opts, obj, gc)

    nash = agt.newton_solve(prob)
    ibr = agt.ibr_newton_solve(prob, agt.IBROptions(ibr_iter=ibr_iter))

    i_n, i_b = int(nash.stats.iter[0]), int(ibr.stats.iter[0])
    print(f"Nash solver:  res = {float(nash.stats.res[0, i_n - 1]):.2e}")
    print(f"IBR solver:   res = {float(ibr.stats.res[0, i_b - 1]):.2e} "
          "(full-game residual at the IBR fixed point)")
    dx = float((nash.traj.x - ibr.traj.x).abs().max())
    print(f"max trajectory difference Nash vs IBR: {dx:.2e} "
          "(nonzero: different solution concepts)")


if __name__ == "__main__":
    main()
