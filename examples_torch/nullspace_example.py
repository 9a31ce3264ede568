"""Equilibrium-subspace exploration with the active-set nullspace.

The reference's research purpose for the active-set machinery is exploring
the manifold of nearby generalized Nash equilibria
(``src/active_set/active_set_methods.jl:5-26`` + ``NullSpace``,
``active_set_core.jl:5-45``): at a converged equilibrium with active
collision constraints, the active-set extended KKT Jacobian has a nontrivial
nullspace, and stepping along a basis vector moves the trajectory O(eps)
while keeping the extended residual O(eps^2), a first-order direction along
the equilibrium manifold.

This example solves a 3-player unicycle game whose collision constraint is
active at the equilibrium, computes the nullspace basis, and verifies the
first-order invariance numerically: a step eps*v along a basis vector vs a
random direction of the same norm.

  python examples_torch/nullspace_example.py             # on the card
  python examples_torch/nullspace_example.py --device cpu
"""
import dataclasses

import _common

import numpy as np
import torch

import algames_tpu_torch as agt
from algames_tpu_torch import active_set as A
from algames_tpu_torch.constraints import sets as S
from algames_tpu_torch.core.traj import unpack_step, update_traj


def main():
    device, dtype = _common.setup(_common.parser(__doc__).parse_args())
    p, N, dt = 3, 20, 0.1
    model = agt.unicycle_game(p=p)
    spec = agt.spec_from_model(model, N, dt)
    obj = agt.game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        # Crossing targets force the collision constraint active.
        xf=[np.asarray([2.0, 0.4 * (p - 1 - i) - 0.4 * i, 0.0, 0.3])
            for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=device)
    gc = S.game_constraints(spec, dtype=dtype, device=device)
    gc = S.add_collision_avoidance(spec, gc, 0.25)
    x0 = torch.as_tensor(np.concatenate([np.zeros(p), 0.4 * np.arange(p),
                                         np.zeros(p), 0.3 * np.ones(p)]),
                         dtype=dtype, device=device)
    opts = (agt.Options(outer_iter=3, inner_iter=8) if _common.smoke()
            else agt.Options())
    prob = agt.game_problem(N, dt, x0, model, opts, obj, gc)

    out = agt.newton_solve(prob, method="tridiag")
    prob = dataclasses.replace(prob, gc=A.lane_slice(out.gc, 0))
    gc_a = agt.update_active_set(out.gc, out.traj)
    n_active = sum(int(b.active.sum()) for b in gc_a.state_blocks)
    print(f"converged; active collision entries: {n_active}")

    ns = A.update_nullspace(prob, out.traj)
    print(f"nullspace dimension: {ns.mat.shape[1]}")

    # First-order invariance: r(z + eps v) - r(z) is O(eps^2) along the
    # basis, O(eps) along a random direction of equal norm.
    S_, T = spec.S, spec.T
    nop = len(A.ordered_pairs(p))
    v = ns.vec[0]
    r0 = A.extended_residual(prob, out.traj, v.new_zeros((1, T, nop)))
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=v.shape), dtype=dtype, device=device)
    w = w * (v.norm() / w.norm())

    def moved(d, eps):
        t = update_traj(out.traj, torch.full((1,), eps, dtype=dtype,
                                             device=device),
                        unpack_step(spec, d[None, :S_]))
        r = A.extended_residual(prob, t, eps * d[S_:].reshape(1, T, nop))
        return t, float((r - r0).norm())

    print(f"{'eps':>8} {'|dr| along basis':>18} {'|dr| random dir':>16}")
    for eps in (1e-2, 1e-3, 1e-4):
        t1, dn = moved(v, eps)
        _, dw = moved(w, eps)
        print(f"{eps:8.0e} {dn:18.3e} {dw:16.3e}")
        move = float((t1.x - out.traj.x).abs().max())
        print(f"         trajectory moved {move:.3e} (O(eps))")


if __name__ == "__main__":
    main()
