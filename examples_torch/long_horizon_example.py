"""Long-horizon game with the KKT solve split over the knot axis.

The reference solves every horizon sequentially (sparse LU over all knots,
``src/problem/solver_methods.jl:87``).  This example solves a 2-player
N=129 (T=128 intervals) unicycle overtaking game with the Newton step's
block-tridiagonal solve split over the horizon among ``--ranks`` processes
(``parallel.spike_kkt_method``): each rank eliminates a slab of knots and
the ranks exchange only slab-boundary blocks.  Every rank runs the same
solve; the result is checked against the sequential ``"tridiag"`` solve.

  python examples_torch/long_horizon_example.py                 # NCCL, one rank per card
  python examples_torch/long_horizon_example.py --ranks 4 --backend gloo   # ranks sharing a card
  python examples_torch/long_horizon_example.py --device cpu    # 4 gloo ranks on the CPU
"""
import _common

import numpy as np
import torch

import algames_tpu_torch as agt
from algames_tpu_torch.constraints import sets as S
from algames_tpu_torch.parallel import run_ranks, spike_kkt_method


def build_problem(N, device, dtype):
    p, dt = 2, 0.05
    model = agt.unicycle_game(p=p)
    spec = agt.spec_from_model(model, N, dt)
    obj = agt.game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([6.0, 0.3 * i, 0.0, 0.5]) for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    gc = S.game_constraints(spec, dtype=dtype, device=device)
    gc = S.add_collision_avoidance(spec, gc, 0.1)
    gc = S.add_control_bound(spec, gc, 2 * np.ones(spec.m),
                             -2 * np.ones(spec.m))
    opts = (agt.Options(outer_iter=2, inner_iter=4) if _common.smoke()
            else agt.Options(outer_iter=4, inner_iter=10))
    x0 = torch.as_tensor([0.0, -0.5, 0.0, 0.3, 0.0, 0.0, 0.6, 0.4],
                         dtype=dtype, device=device)
    return agt.game_problem(N, dt, x0, model, opts, obj, gc), spec


def spike_rank(rank, device, N, dtype):
    """One rank: the whole solve, its KKT steps split over the world."""
    prob, _ = build_problem(N, device, dtype)
    res = agt.newton_solve(prob, method=spike_kkt_method())
    return res.traj.x, _common.final_violations(res), int(res.stats.iter[0])


def main():
    ap = _common.parser(__doc__)
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: the CUDA device count on the "
                         "card, 4 on the CPU)")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on the "
                         "card, gloo on the CPU)")
    args = ap.parse_args()
    device, dtype = _common.setup(args)
    on_card = device.type == "cuda"
    ranks = args.ranks or (torch.cuda.device_count() if on_card else 4)
    backend = args.backend or ("nccl" if on_card else "gloo")
    N = 33 if _common.smoke() else 129     # T=32: 8 knots per rank on 4
    prob, spec = build_problem(N, device, dtype)
    print(f"horizon T={spec.T} split over {ranks} ranks ({backend}; "
          f"{spec.T // ranks} knots per rank)")

    x, vio, it = run_ranks(spike_rank, ranks, backend, device, N, dtype)[0]
    print(f"iters={it}  dyn_vio={vio['dyn_vio']:.2e}  "
          f"con_vio={vio['con_vio']:.2e}  opt_vio={vio['opt_vio']:.2e}")

    # Cross-check against the sequential sweep.
    ref = agt.newton_solve(prob, method="tridiag")
    err = float((x - ref.traj.x.cpu()).abs().max())
    print(f"max |x_spike - x_sequential| = {err:.2e}")


if __name__ == "__main__":
    main()
