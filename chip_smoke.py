#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Drives the port's main paths on the card (the five presets and the
heterogeneous game through ``parallel.solve_many`` -> ``newton_solve`` with
``method="thomas"`` and ``ls_fused=True``, iterative best response
through ``ibr_newton_solve``, receding-horizon MPC through
``mpc_solve``, a sweep split over ranks through
``parallel.sharded_monte_carlo``, and the long-horizon game with its KKT
step split over ranks through ``parallel.spike_kkt_method``), through its
hand-written CUDA kernels, after checking each kernel against its plain
PyTorch version:

- the flagship batched game solve (3-player unicycle merge, N=20): K1
  (structured-Q block-Thomas KKT sweep) and K2 (fused line-search trial);
- the 4-player roundabout (N=40, collision-cost pairs, circle obstacle,
  speed and control bounds): K3 (dense-Q KKT sweep) and K4 (the generic
  fused trial; same source and wrapper as K2);
- the 2-player double integrator (N=10): K1 and K4;
- the 3-player bicycle (N=20, collision cost, walls, circles, state and
  control bounds): K3 and K4;
- the 2-player quadrotor (N=15, spherical collision, a floor facet, a
  cylinder, thrust bounds [0, 3]): K1 and K4, and K3 on its systems
  turned dense; with 3 players (d=48) K1's tall size class and K4; with 4
  (d=64) K1's per-player blocked route, K3's (with collision-cost pairs)
  and K4;
- the heterogeneous double integrator (mi = (2, 1), player-blocked, N=8):
  K3 on controls padded to p max(mi) and K4's player-blocked instance;
- iterative best response on the flagship and on the quadrotor
  (``ibr_newton_solve``): K3 on each player's p=1 subproblem;
- receding-horizon MPC on the 3-player highway (``mpc_solve``): K1, and
  K2 with the fused trial;
- the ring road (the flagship with player 0 held on a ring by an equality
  block): K1, and K4's equality rows;
- the KKT ladder's plain solves (``method="schur"``, ``"tridiag"``,
  ``"dense"``, ``"cr"``) and the active-set nullspace, on the card;
- scenario sharding over a world of ranks (``parallel.run_ranks``): K1
  and K2 in every rank;
- the long-horizon game of ``benchmarks/bench_spike.py`` (N=257, T=256):
  K1, and the horizon-split SPIKE solve (plain PyTorch, as the JAX
  package's; no TPU kernel) over 1 and 4 ranks.

Phases:

1. build the three kernel libraries from ``algames_tpu_torch/csrc`` with
   nvcc, one process per source started together (timed; registers and
   spills from ``-Xptxas -v``);
2. K1 vs its plain version at flagship shapes, B=1024, over AL penalties
   mu = 1 .. 1e7: f64 <= 1e-9, f32 (against the f64 plain version) <= 1e-3,
   worst per-lane relative error; K1 on its register-tiled forward kernel
   (every K1 phase, golden and sweep of a preset checks the route; each
   K1 phase prints its forward kernel's lanes per SM, waves, registers and
   local memory);
3. K2 vs its plain version, B=1024: every carried leaf and tn, f64 <= 1e-12
   and f32 <= 1e-5 relative;
4. one f64 flagship solve (outer 7 x inner 20) through K1 and K2 (not K3)
   against ``tests/golden/uni3_N20.npz``: same iteration count, x and u
   within 1e-8;
5. the flagship sweep in f32: 4096 scenarios (x0 + 0.05 N(0, 1) noise from
   numpy seed 0), outer 3 x 8, chunk 1024; every trajectory finite,
   converged fraction >= 0.99, no divergence, K1 and K2 launched; one
   chunk with the plain versions on the card, and a profile of one chunk;
6. K3 vs its plain version on roundabout KKT systems, B=1024, mu = 1 ..
   1e7, speeds from the entry speeds to the limit: f64 <= 1e-9, f32 <=
   1e-3; over the whole speed band, f32 no worse than max(1e-3, 10 x the
   f32 plain version's own error); K3 vs K1 on flagship systems turned
   dense, f64 <= 1e-9;
7. K4 vs its plain version on roundabout trial inputs, B=1024: f64 <=
   1e-12, f32 <= 1e-5 relative;
8. one f64 roundabout solve (outer 10 x inner 16) through K3 and K4 (not
   K1) against ``tests/golden/round4_N40.npz``: iteration 37, x and u
   within 1e-8;
9. the roundabout sweep in f32: 4096 scenarios (x0 + 0.05 N(0, 1), numpy
   seed 0), outer 10 x 16, chunk 1024; every trajectory finite, no
   divergence, the converged fractions of the first 256 and of all 4096
   scenarios each >= the reference package's own on the first 256 minus
   0.01; K3 and K4 launched and K1 not; one chunk with the plain versions
   on the card through its first outer iteration (stats rows compared
   lane by lane with the kernels' rows of that iteration), and a
   profile of one chunk's first PROFILE_INNER inner iterations (the game
   sweeps' plain chunk and profile cut so from the whole budget and two
   outer iterations, then from half the outer budget and one outer
   iteration, to keep the script in its time limit);
10. the double integrator: K1 on its KKT systems as in 2, K4 on its trial
   inputs as in 7, the f64 solve against ``di2_N10.npz`` (iteration 30, x
   and u within 1e-8), and its f32 sweep at the preset budget (outer 7 x
   20): the first 1024 of the scenarios of 9 (GAME_SWEEP_LANES; the
   double integrator's, bicycle's, quadrotor's and heterogeneous game's
   sweeps cut so from 4096 to keep the script in its time limit), finite,
   no divergence, the converged fractions of the first 256 and of all
   1024 scenarios each >= the reference package's own on the same inputs
   minus 0.01 (``tests/reference_fractions.py subset`` and ``full``), K1
   and K4 launched and K3 not; one chunk with the plain versions, a
   profile;
11. the bicycle: K3 on its KKT systems as in 6 (without the roundabout's
   extra checks), K4, the f64 solve against ``bike3_N20.npz`` (iteration
   90, x within 5e-3 and u within 5e-2, the golden's own plateau, and
   within 1e-10 of the same solve through the plain versions on the card),
   and its sweep (outer 7 x 20; K3 and K4, not K1);
12. the quadrotor: K1 on its KKT systems, gated on the normwise backward
   error (f64 <= 1e-15, f32 <= 1e-7, each <= 10 x the plain version's) and
   on the f32 forward error (<= 30 x the f32 plain version's): its systems
   are too ill-conditioned for a 1e-3 forward gate in f32, which the f32
   plain version misses too; K4 on trial inputs with a quarter of the
   lanes exactly on the thrust kink (u = 0), and again with smoothed
   thrust, and on a double integrator in three dimensions (the kernel's
   last compiled model); the f64 solve
   against ``quad2_N15.npz`` (iteration 52, within 1e-8); its sweep (outer
   6 x 12, stationarity gate 5e-2 as ``tests/test_golden.py`` uses: the
   thrust clamp holds stationarity near 3e-2; the first 256 lanes gated
   as in 10, the reference's fraction over all 1024 not being measured;
   K1 and K4, not K3); then K3 on the quadrotor's KKT systems turned
   dense (``K3-big``: d=32, K3's LU size class), gated as K1's phase on
   them and timed beside K3's shared-memory forward kernel on the same
   operands, the f64 quadrotor solve with that route as its KKT step
   (``golden-big``: iteration 52, within 1e-8 of ``quad2_N15.npz``), one
   f32 chunk of the quadrotor sweep through it (``sweep-quad2-dense``:
   gated as ``sweep-quad2`` on its first 256 lanes; K3's launch count),
   and K3 on the 3-player quadrotor's systems turned dense (``K3-big48``:
   d=48, beyond K3's classes, B_BEYOND lanes, the same gates) on its
   per-player blocked route, its shared-memory kernel and device-memory
   route gated and timed beside it on the same operands; then the
   quadrotor preset with 3
   players (d=48): K1 on its KKT systems on its tall class (256 threads a
   lane) gated as the quadrotor's and timed beside the shared-memory
   kernel (``K1-wide``), an f64 solve of 4 scenarios against the same
   solve through the plain versions on the card (``solve-wide``: iteration
   counts equal, x and u within 1e-8), K4 on its trial inputs (``K4-quad3``:
   n=36, the quadrotor instance's second mask word), one timed f32 chunk
   of 1024 scenarios with the fused trial (``sweep-quad3``: finite, none
   diverged; K1's and K4's launch counts, K1's share of the wall); then the
   4-player quadrotor (d=64, R=193, beyond every size class): K1 on its
   systems (``K1-wide64``, B_BEYOND lanes) in f64 and f32 on its
   per-player blocked route (``csrc/thomas_blocked.cuh``) and, forced onto
   the same operands, on the device-memory route of
   ``csrc/thomas_global.cuh`` and (f32) the shared-memory kernel, each
   gated as the quadrotor's and timed; K3 on the same
   systems turned dense (``K3-big64``: its per-player blocked route, the
   device-memory route forced and timed beside it, in both precisions),
   on the 6-player unicycle's systems turned dense (``K3-wide36``: d=36,
   every route) and, forced, on the roundabout's own systems (``K3-
   blocked24``: d=24, beside its class); K4 on its trial inputs
   (``K4-quad4``: n=48), with a state bound on all 48 states
   (``K4-quad4-bound``: its 96 rows flagged in the parameter array) and
   with collision-cost pairs (``K4-quad4-cost``); f64 solves of 4
   scenarios (outer 2 x 5, fused trial) through K1's blocked route and K4
   (``solve-wide64``) and, with collision-cost pairs between the players,
   through K3's blocked route (``solve-big64``), each against the same
   solve through the plain
   versions on the card (iteration counts equal, x and u within 1e-8);
   and one timed f32 chunk of 1024 scenarios (``sweep-quad4``: finite,
   none diverged, the first 256 lanes' converged share and mean final
   residual against the reference's (REF_QUAD4), the first 64 lanes'
   mean final residual against the plain versions' on the card, K1 (every
   launch on its blocked route) and K4 launched, K4 at least once a KKT
   step; K1's blocked route on the game's own systems gated over mu = 1 ..
   1e7 and every K1 route timed at the chunk's batch, in f32 and f64; K1's
   and K4's shares of the wall); and one timed f32 chunk of 1024 scenarios
   with collision-cost pairs (``sweep-quad4-dense``: finite, none
   diverged, the first 64 lanes' mean final residual against the plain
   versions' on the card, every K3 launch on its blocked route, K1 never,
   K4 launched; K3 on the game's own systems gated at mu = 1, 1e3, 1e7
   and timed beside the device-memory route at the chunk's batch; K3's
   and K4's shares of the wall); then the 9-player flagship merge
   (``uni9_game``: n=36, m=18, d=54, R=325, 72 w vectors and 72 state
   blocks, past the caps that earlier kernels had): the f64 solve of
   B_GOLDEN9 lanes from x0 through K1 and K2 against
   ``tests/golden_torch/uni9_N20.npz`` (``golden-uni9``: iteration counts
   equal, x and u within 1e-8, every K1 launch on the route the shape
   takes, K2 launched); K1 on its systems (``K1-uni9``, B_BEYOND lanes,
   f64 and f32, mu = 1 .. 1e7) on the route the shape takes (the
   per-player blocked route: in f64 with the products Pw over K's slots)
   and forced onto the device-memory route, gated as the quadrotor's and
   timed; K2's wide unicycle instance on its trial inputs (``K2-uni9``,
   B=1024); one timed f32 chunk of 1024 scenarios at the flagship's
   budget 3 x 8 (``sweep-uni9``: as ``sweep-quad4``, against REF_UNI9,
   the converged share gated, without the plain versions' lanes; K1's
   blocked route gated over mu at B=1024 on the first 64 lanes and both
   routes timed in f32 and f64; K1's and K2's shares of the wall); then
   the widest unicycle merges (10 to 17 players): K1's route at each width
   in both precisions (``routes-wide``), K1 on its device-memory route at
   12, 15 (f64) and 17 players (``K1-uni12``, ``K1-uni15``, ``K1-uni17``)
   and K3 on the 17-player systems turned dense (``K3-uni17``), gated as
   ``K1-uni9``; K2's wide unicycle instance on the 17-player trial inputs
   (``K2-uni17``) and with a state bound of player 0 on all 68 states
   (``K2-uni17-bound``: its rows flagged in the parameter array, finite
   and infinite on both sides of the 128th); the f64 golden of
   ``uni17_N20`` as ``golden-uni9`` (``golden-uni17``) and one timed f32
   chunk of B_SWEEP17 scenarios at 3 x 8 (``sweep-uni17``, against
   REF_UNI17);
13. the heterogeneous game: K3 on its padded KKT systems as in 11
   (``K3-hetero``), K4 on its trial inputs (``K4-hetero``), the f64 solve
   through K3 and K4 against ``tests/golden_torch/hetero2_N8.npz`` (the
   reference's dense-oracle solution: iteration 23, x and u within 1e-8),
   and its sweep (outer 7 x 20, gated as in 10 on the reference's own
   fractions; K3 and K4, not K1);
14. iterative best response: K3 on the flagship's player sub-KKT systems
   (p=1, every player in every batch) as in 11 (``K3-ibr``), the f64 IBR
   solve of the flagship (outer 3 x 8 per player solve, 10 rounds) against
   ``tests/golden_torch/ibr_uni3_N20.npz`` (the reference's ``schur``
   solution: stats rows equal, x and u within 1e-8; K3 only), and the
   512-scenario f32 sweep of ``benchmarks/bench_ibr.py`` as one chunk: on
   its first 128 lanes the share stopped before 10 rounds within 0.02 of
   the reference's and the mean final residual within 1.1 x; K3 launched,
   neither K1 nor a trial kernel; its first 128 lanes with the plain
   versions, and a profile of one Gauss-Seidel round at outer 1 x 4; then K3 on the quadrotor's
   player systems (``K3-ibr-quad``: p=1, d=28, its LU class, gated as
   ``K3-big``, timed beside the shared-memory kernel), and IBR on the
   quadrotor preset (``sweep-ibr-quad2``: N_IBR_QUAD f32 scenarios, outer
   3 x 8 per player solve, IBR_QUAD_ITER rounds, gated as ``sweep-ibr`` on
   all of them against ``tests/reference_fractions.py ibr-quad``; 4 lanes
   in f64, one round at outer 1 x 8, through the kernels and the plain
   versions, stats
   rows equal, x and u within 1e-8);
15. receding-horizon MPC on the highway of ``benchmarks/bench_mpc.py``
   (BASELINE config 3: p=3 unicycles, N=20, outer 3 x 8, shift 1, duals
   carried across replans): K1 on its KKT systems at B=32 and B=1 as in 2
   (``K1-highway32``, ``K1-highway1``); K2 on highway trial inputs at
   B=32 as in 3 (``K2-highway32``); the f32 closed loop through
   ``mpc_solve`` at H=30 for one scenario and for 32 (x0 + 0.05 N(0, 1),
   numpy seed 0), each replan (solve, plant and host work) synchronised
   and timed (p50 and p95 over replans 3..30; scenario-replans/s as
   B x 30 over the loop's wall time): every state finite, the executed
   pairwise distance >= 2r = 0.2, every applied |u| <= 3 + 1e-6, the share
   of replans meeting all four 1e-3 gates >= the reference package's own
   on the same starts minus 0.01 (``tests/reference_fractions.py mpc``),
   K1 launched and K3 not (``mpc``); the f64 loop of 4 scenarios and 5
   replans through K1 against the plain versions on the card, equal stats
   rows, states within 1e-8 (``mpc-plain``); the 32-scenario loop with the
   fused trial (K2), same gates (``mpc-fused``); one flagship chunk with
   ``ls_parallel=2`` against 1, equal stats rows and accepted step sizes
   (``ls-parallel``);
16. the ring road ``ring3_eq_N20`` (``ring3_eq_game``): K4 on its trial
   inputs with duals of both signs as in 7 (``K4-eq``; the rows with
   c < 0 and lam < 0 are where the equality rule differs), and again with
   the block flagged ``"soc"`` (``K4-soc``, the inequality rule); the f64
   solve through K1 and K4 against ``tests/golden_torch/ring3_eq_N20.npz``
   (58 stats rows, x and u within 1e-8; ``golden-eq``); the f32 sweep of
   B_EQ lanes as one chunk (x0 + 0.05 N(0, 1), player 0 put back on the
   ring), finite, no divergence, the converged fraction and the feasible
   share each >= the reference's own on the first 256 minus 0.01, K1 and
   K4 launched, K3 not (``sweep-eq``);
17. the KKT ladder (``ladder``): the f32 flagship (outer 3 x 8) through
   ``"schur"``, ``"tridiag"``, ``"cr"`` on 256 lanes and ``"dense"`` on 32,
   each converged >= 0.99 with no kernel launched, its wall time per
   trip; 8 lanes in f64 through the four and ``"thomas"``, stats rows
   equal and x within 1e-8;
18. the active-set nullspace (``nullspace``) of
   ``examples/nullspace_example.py``'s game (``crossing_game``) solved in
   f64 from 8 starts through ``"tridiag"``: lane 0's dimension equal to
   the reference's, ``update_nullspace_masked`` (rank threshold NS_ATOL)
   equal to ``update_nullspace`` on every lane, |J_active v| < 1e-7,
   first-order invariance (>= 10x) at eps 1e-3; and one masked nullspace
   at the roundabout's scale (p=4, N=40, zero trajectory), timed, its
   dimension the reference's;
19. scenario sharding (``shard``): the first B_SHARD lanes of the f32
   flagship sweep (outer 3 x 8, fused trial) through
   ``sharded_monte_carlo`` over 1 rank on NCCL (trajectories and summary
   bitwise ``solve_many``'s in this process) and over 2 ranks on gloo,
   both on this card (each half bitwise ``solve_many``'s of that half;
   converged >= 0.99, none diverged); K1 and K2 launched in every rank;
   the 1-rank world then runs SPIKE's ranks' solves of 21 too;
20. K1 on the long-horizon game's systems (``spike_game``, T=256) at
   B=32 and B=1 as in 2 (``K1-long32``, ``K1-long1``);
21. SPIKE (``spike``): the long-horizon game in f64 at N=257 over 1 rank
   (NCCL) and 4 (gloo, on this card) against ``"tridiag"`` and
   ``"thomas"`` (K1): stats rows equal, x within 1e-8; in f32, one
   scenario, wall ms per solve, stats rows and dyn_vio of each method at
   N = 65, 257, 1025 (over 4 ranks shape-only: they share one card); a
   32-scenario ``"thomas"`` solve at N=257; K1 launched, neither K3 nor a
   trial kernel;
22. the checkpoint and profiling modules on the card (``aux``): a
   ``SolveResult`` round trip and a trajectory's, bitwise, on their
   device and dtype; ``timed_solve`` bitwise ``newton_solve``'s, one time
   per trip; ``device_trace`` writes a trace holding K1's kernels.

Kernel times are per wrapper call (CUDA events, host work included) and
the kernels' device time (``device_ms``: CUDA events around each kernel
launch, queued behind a short sleep kernel, so no host time; the
profiler's launch count and time are printed beside it as a cross-check).
Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its operations over 67 TFLOP/s (f32),
counted from this run's shapes.

It needs one CUDA card and exits non-zero, printing no result, without one
or when any check fails.  The last two lines are a JSON object describing
each kernel and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
"""
import concurrent.futures
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
MUS = [10.0 ** k for k in range(8)]
B_KERNEL = 1024
N_SWEEP, CHUNK = 4096, 1024
# Depth of the runs beside each preset-budget sweep, cut to keep the script
# well inside its time limit: the plain versions' chunk runs PLAIN_OUTER
# outer iterations, the profiled chunk (and each IBR player solve of the
# profiled round) one outer iteration of at most PROFILE_INNER inner ones,
# the profiled MPC loop PROFILE_REPLANS replans.
PLAIN_OUTER, PROFILE_INNER, PROFILE_REPLANS = 1, 4, 2
# Published H100 SXM peaks (NVIDIA data sheet): device-memory rate, and the
# f32 rate outside the tensor cores, which is also the f64 tensor cores'
# (DMMA computes in full f64), so it bounds the f64 rows as well.
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12
# The reference package's f32 `schur` solve of the sweep scenarios of each
# game but the flagship (`tests/roundabout_reference.py subset`,
# `tests/reference_fractions.py subset` and `full`; their outputs are in
# `tests/reference_fractions.txt`): the converged share of the first 256
# scenarios and of all the sweep's lanes, the quadrotor under its
# stationarity gate QUAD_OPT_GATE: its thrust clamp max(0, kf w) is not
# smooth at hover, which holds stationarity near 3e-2 (as
# `tests/test_golden.py` allows).  Each sweep is gated on both: the port's
# first 256 lanes against the first, all its lanes against the second.
# The roundabout sweeps all N_SWEEP scenarios, the other games their first
# GAME_SWEEP_LANES (one chunk; cut from N_SWEEP to keep the script in its
# time limit), each against the reference's share over the same lanes
# (`full`'s "lanes 0..1024" lines).  The roundabout's and the quadrotor's
# references beyond 256 lanes are not measured (the reference package
# takes over half an hour per 256 of their lanes on a CPU): the
# roundabout's lanes are all held to its 256-lane reference, the
# quadrotor's (whose first 256 converge more often than the rest) only its
# first 256.
GAME_SWEEP_LANES = 1024
REF_CONVERGED = {"round4_N40": (253 / 256, 253 / 256),
                 "di2_N10": (161 / 256, 649 / 1024),
                 "bike3_N20": (104 / 256, 457 / 1024),
                 "quad2_N15": (147 / 256, None),
                 "hetero2_N8": (241 / 256, 977 / 1024)}
QUAD_OPT_GATE = 5e-2
# Iterative best response on the flagship as benchmarks/bench_ibr.py runs
# it: N_IBR scenarios, ibr_iter rounds.  The reference package's f32
# `schur` run of the first IBR_LANES of them (`tests/reference_fractions.py
# ibr`): the share of lanes whose Gauss-Seidel loop stopped before
# IBR_ITER rounds, and the mean final residual.
N_IBR, IBR_LANES, IBR_ITER = 512, 128, 10
REF_IBR = (0 / 128, 0.0071520789206260815)
# The same on the quadrotor preset: N_IBR_QUAD scenarios, all of them held
# to the reference's run (`tests/reference_fractions.py ibr-quad`), at
# IBR_QUAD_ITER rounds: a round of the quadrotor's IBR takes 27-44 s of
# host time beside an H100 (10 rounds took 266 s), so one round (cut from
# two to keep the script in its time limit).
N_IBR_QUAD, IBR_QUAD_ITER = 128, 1
REF_IBR_QUAD = (0 / 128, 0.2552455230979831)
# The f64 bicycle solve through the kernels against the same solve through
# the plain versions on the card (measured 2.4e-15 on an H100, PERF.md).
BIKE3_PLAIN_TOL = 1e-10
# The f64 3-player quadrotor solve through K1's tall size class against
# the same solve through the plain versions on the card.
WIDE_PLAIN_TOL = 1e-8
# Lanes of the checks of the forward kernels on systems beyond the size
# classes (``K3-big48``: K3's blocked route, its shared-memory kernel and
# device-memory route; ``K1-wide64``: K1's blocked route, its
# device-memory route and, in f32, its shared-memory kernel; ``K3-big64``:
# K3's blocked and device-memory routes).
B_BEYOND = 64
# The 4-player quadrotor's f32 sweep (``sweep-quad4``, 2 x 5): the reference
# package's converged share of the first 256 scenarios and its mean final
# residual norm over them (`tests/reference_fractions.py subset
# quad4_N15`): no lane of either package converges within the cut budget,
# so the share gate cannot fail there, and the sweep is also held to the
# final residual (<= 1.1 x), and its first PLAIN_LANES lanes to the same
# solve through the plain versions on the card: the mean final residual
# within a relative PLAIN_RES_TOL, and the median lane's within
# PLAIN_LANE_TOL (most lanes take the plain versions' path; f32 rounding
# turns a few line searches).
REF_QUAD4 = (0 / 256, 0.20679336786270142)
# The 9-player flagship merge (``uni9_game``: d=54, NW=72, 72 state blocks)
# at the flagship's budget 3 x 8: the reference package's converged share of
# the first 256 f32 sweep scenarios and their mean final residual norm
# (`tests/reference_fractions.py subset uni9_N20`); the lanes of its f64
# golden solve; the forward routes that hold its systems (its f32 systems
# fit the blocked route's layout whole, 131,736 bytes a lane; its f64 ones
# with the products Pw over K's slots, 231,064 bytes; the shared-memory
# kernel holds neither).
REF_UNI9 = (256 / 256, 7.022567388048628e-06)
B_GOLDEN9 = 4
# Lanes of its dense [S, S] KKT matrices a batch (S = 7182: 413 MB a lane
# in f64), for the library call.
B_DENSE9 = 16
UNI9_ROUTES = {("structured", dt): ("blocked", "device")
               for dt in ("f32", "f64")}
# The widest unicycle merges (``flagship_unicycle(p)``, p = 10 .. 17; d = 6p
# reaches 102, NW = p (p - 1) 272 w vectors, m = 2p 34 control rows): K1's
# route for each width in both precisions (``routes-wide``; 11 players and
# more take the device-memory route, whose products Pw go 128 w vectors at
# a time; the f64 routes of 15 and 16 players did not fit a block while
# they took a panel of NW columns); the 17-player merge's f64 golden
# lanes, f32 sweep lanes and the reference package's converged share and
# mean final residual on the first REF_UNI17_LANES of them at 3 x 8
# (`tests/reference_fractions.py subset uni17_N20`: lane 219 does not
# converge, in the port's plain versions either); the lanes the library
# call solves at 12, 15 and 17 players, one batch (its dense [S, S] KKT
# matrices: S = 23,902 at 17 players, 4.57 GB a lane in f64; a lane's LU
# took 2.2 s in f64 on an H100).
UNI_WIDE_PLAYERS = range(10, 18)
UNI_DEVICE_ROUTES = {(form, dt): ("device",)
                     for form in ("structured", "dense")
                     for dt in ("f32", "f64")}
B_GOLDEN17, B_SWEEP17 = 4, 256
REF_UNI17_LANES = 256
REF_UNI17 = (255 / 256, 6.029817996022757e-06)
B_LIBRARY_WIDE = {12: 4, 15: 2, 17: 2}
# Lanes of K1's checks at 15 players (f64 only: the repaired route) and of
# K3's on the 17-player systems turned dense.
B_UNI15, B_K3_UNI17 = 16, 4
PLAIN_LANES, PLAIN_RES_TOL, PLAIN_LANE_TOL = 64, 0.02, 1e-4
# BASELINE config 3 as `benchmarks/bench_mpc.py` runs it: the highway's
# collision radius and control bound, H_MPC replans, and B_MPC scenarios in
# the batched closed loop.  REF_MPC: the reference package's f32 share of
# replans whose final violations meet all four gates, on the same starts
# (`tests/reference_fractions.py mpc`), by the number of scenarios.
HIGHWAY_R, HIGHWAY_U = 0.1, 3.0
H_MPC, B_MPC = 30, 32
REF_MPC = {1: 30 / 30, 32: 960 / 960}
# The ring road (``ring3_eq_game``): B_EQ lanes of the f32 sweep.  REF_EQ:
# the reference package's converged fraction and feasible share (dyn, con
# and sta gates) on the first 256 of the same starts
# (`tests/reference_fractions.py subset ring3_eq_N20`).  In f32 the ring's
# always-penalized rows hold stationarity near 10 (mu up to 1e7 times the
# f32 rounding of c = r^2 - |p - c|^2 at r^2 = 16), so no lane of either
# package meets the 1e-2 stationarity gate; the feasible share is the gate
# that can tell the two apart.
B_EQ = 1024
REF_EQ = (0 / 256, 153 / 256)
# The nullspace game (``crossing_game``), f64, 8 lanes: the reference
# package's stats rows and ``update_nullspace`` dimensions per lane, its
# ``update_nullspace_masked`` dimensions at the default atol 1e-10, and
# the masked dimension at the roundabout's scale on the zero trajectory
# (`tests/reference_fractions.py nullspace`).  NS_ATOL: the masked
# version's rank threshold here, between the kernel's singular values
# (<= 8.7e-10 on the CPU, the rounding floor of a matrix of norm ~2e6) and
# the next (>= 7.0e-7; the same script's port lines).
REF_NULLSPACE = {"rows": [141] * 8, "dims": [20, 20, 19, 18, 23, 22, 18, 20],
                 "masked_default": [1] * 8, "big": 468}
NS_ATOL = 1e-8
# Lanes of the f32 flagship run through each of the KKT ladder's methods
# ("dense" solves [lanes, S, S] systems).
LADDER_LANES = {"schur": 256, "tridiag": 256, "cr": 256, "dense": 32}
# Scenario sharding: lanes of the f32 flagship sweep split over the ranks.
# The long-horizon game (``spike_game``): its horizons, and the lanes of
# its batched solve and of K1-long's larger batch.  A rank's collectives
# time out after RANK_TIMEOUT_S, its world after twice that.
B_SHARD = 1024
SPIKE_NS = (65, 257, 1025)
B_LONG = 32
RANK_TIMEOUT_S = 60
# Per kernel: description, source, the TPU kernel it replaces.
KERNELS = {
    "K1": ("structured block-Thomas KKT sweep", "thomas_sq.cu",
           "algames_tpu/ops/thomas_pallas.py:566"),
    "K2": ("hand-written fused line-search trial", "trial_fused.cu",
           "algames_tpu/ops/trial_kernel.py:367"),
    "K3": ("dense-Q block-Thomas KKT sweep", "thomas_dense.cu",
           "algames_tpu/ops/thomas_pallas.py:424"),
    "K4": ("generic fused trial", "trial_fused.cu",
           "algames_tpu/ops/trial_pallas.py:167"),
}


def log(msg):
    print(msg, flush=True)


def rel_err(a, ref):
    """Per-lane max|a - ref| / max|ref| over all but the batch axis."""
    import torch
    a = a.double().flatten(1)
    ref = ref.double().flatten(1)
    scale = ref.abs().amax(dim=1).clamp_min(torch.finfo(torch.float64).tiny)
    return (a - ref).abs().amax(dim=1) / scale


def cuda_ms(fn, reps, warm=True):
    """Mean device-synchronised milliseconds per call, after one warm-up
    (``warm=False``: the caller has just made it)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


@functools.lru_cache(maxsize=None)
def _sleep_ms_per_cycle():
    """Device ms per cycle of ``torch.cuda._sleep``, measured once."""
    import torch
    cycles = 20_000_000
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / cycles


def _bracketed_launches(fn, reps, sleep_ms):
    """Run ``fn`` ``reps`` times with every kernel launch of the port's
    wrappers (each goes through ``ops.build.launch_hook``) bracketed by CUDA
    events and queued behind a ``torch.cuda._sleep`` of ``sleep_ms``:
    (per launch, the ms between its events; whether the device was still
    asleep when every launch had been queued).  For a checkout whose
    wrappers bind their launchers on every call and have no hook
    (``tests/thomas_compare.py`` times an older tree with this function),
    ``ops.build.bind`` is wrapped instead."""
    import torch
    from algames_tpu_torch.ops import build
    pairs = []
    cycles = max(1, int(sleep_ms / _sleep_ms_per_cycle()))

    def timed(launch, args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        err = launch(*args)
        stop.record()
        pairs.append((start, stop, not start.query()))
        return err
    bind = build.bind
    hooked = hasattr(build, "launch_hook")
    if hooked:
        build.launch_hook = timed
    else:
        build.bind = lambda lib, name, argtypes: functools.partial(
            lambda f, *args: timed(f, args), bind(lib, name, argtypes))
    try:
        for _ in range(reps):
            fn()
    finally:
        if hooked:
            build.launch_hook = None
        else:
            build.bind = bind
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) for a, b, _ in pairs],
            all(ok for _, _, ok in pairs))


def device_ms(fn, reps, names, per_call, tag="time"):
    """Device time per call of the kernels that ``fn`` launches (ms): each
    launch bracketed by CUDA events and queued behind a short
    ``torch.cuda._sleep`` that outlasts the host's queueing of the launch
    (checked; doubled until it does), so the gap between its events is the
    kernel's own device time, whatever host work and synchronisation the
    wrapper does around it (the padded-K3 wrapper synchronises the stream
    once per call).  Never 0: it raises unless it saw ``reps`` x
    ``per_call`` launches.  Cross-check, printed: the profiler over the same
    run, its launches of the kernels whose names contain one of ``names``
    and their device time; a note when it is short of launches or differs
    from the event reading by more than 10%."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = reps * per_call
    sleep_ms = 0.2
    while True:
        times, asleep = _bracketed_launches(fn, reps, sleep_ms)
        if len(times) != want:
            raise SystemExit(f"[{tag}] {len(times)} launches, want {want}")
        if asleep:
            break
        if sleep_ms > 1000:
            raise SystemExit(f"[{tag}] the host never got ahead of the card")
        sleep_ms *= 2
    ev_ms = sum(times) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _bracketed_launches(fn, reps, sleep_ms)
    named = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(n in e.key for n in names)]
    launches = sum(e.count for e in named)
    prof_ms = sum(e.self_device_time_total for e in named) / 1e3 / reps
    log(f"[{tag}] device time {ev_ms:.4f} ms per call (CUDA events around "
        f"each of {want} launches, each behind a {sleep_ms:g} ms sleep); "
        f"profiler cross-check: {launches} of {want} launches of "
        f"{'/'.join(names)} recorded, {prof_ms:.4f} ms per call")
    if launches < want:
        log(f"[{tag}] note: the profiler recorded {launches} of {want} "
            f"launches")
    if abs(prof_ms - ev_ms) > 0.1 * ev_ms:
        log(f"[{tag}] note: the profiler's {prof_ms:.4f} ms and the event "
            f"reading's {ev_ms:.4f} ms differ by more than 10%")
    return ev_ms


def random_iterates(prob, spec, B, rng, dev, dtype, noise=0.3):
    """Mid-solve-like iterates: the game's start perturbed per knot."""
    import torch
    from algames_tpu_torch.core.traj import PrimalDual

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    x = np.asarray(prob.x0.cpu())[None, None] + noise * rng.standard_normal(
        (B, spec.N, spec.n))
    return PrimalDual(x=t(x),
                      u=t(0.3 * rng.standard_normal((B, spec.T, spec.m))),
                      lam=t(0.3 * rng.standard_normal(
                          (B, spec.p, spec.T, spec.n))))


def al_state(gc, B, rng, dev, dtype, mu=None):
    """Per-lane AL state: positive duals (so every row is penalized) and
    penalty ``mu``, or penalties drawn from 1 .. 1e7 per lane."""
    import torch
    from algames_tpu_torch.constraints.sets import map_blocks, reset_constraints

    def upd(b):
        lam = torch.as_tensor(0.1 * rng.random(tuple(b.lam.shape)), dtype=dtype,
                              device=dev)
        if mu is None:
            m = 10.0 ** rng.integers(0, 8, size=(B, 1, 1))
            m = torch.as_tensor(np.broadcast_to(m, b.mu.shape).copy(),
                                dtype=dtype, device=dev)
        else:
            m = torch.full_like(b.mu, mu)
        return dataclasses.replace(b, lam=lam, mu=m)
    return map_blocks(reset_constraints(gc, B), upd)


def phase_build():
    """Build every kernel library, one nvcc per source, all started
    together."""
    from algames_tpu_torch.ops import build

    def one(name):
        t0 = time.perf_counter()
        so = build.build(name)
        return so, time.perf_counter() - t0
    names = ("thomas_sq", "thomas_dense", "trial_fused")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        done = dict(zip(names, pool.map(one, names)))
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} s"
        " (in parallel)")
    for name, (so, secs) in done.items():
        log(f"[build] {name}: {secs:.1f} s -> {so.name}")
        for kern, regs, spills in ptxas_report(
                so.with_suffix(".log").read_text()):
            log(f"[build]   {kern}: {regs} registers, {spills}")


def ptxas_report(text):
    """(kernel, registers, spill line) per kernel of an ``-Xptxas -v``
    report."""
    out, kern, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for \S*?([a-z][a-z_]*_kernel)"
                      r"I([fd])(?:Li(\d+)E(?:Li(\d+)E)?)?"
                      r"(?:NS_\d+([A-Za-z]+)I[fd](?:Li(\d)E)?E)?E"
                      r"(?:Li(\d+)E)?", line)
        if m:
            spills = ""
            model = (f", {m.group(5)}{m.group(6) or ''}" if m.group(5)
                     else "")
            tile = "".join(f", {g}" for g in m.group(3, 4) if g)
            tpk = f", {m.group(7)}" if m.group(7) else ""
            kern = (f"{m.group(1)}"
                    f"<{'float' if m.group(2) == 'f' else 'double'}{tile}"
                    f"{model}{tpk}>")
        elif "spill" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and kern:
            out.append((kern, int(m.group(1)), spills))
            kern = None
    return out


def bound(nbytes, flops):
    """Least time (ms) the card could take for the work: the larger of the
    bytes over the memory rate and the operations over the f32 and f64
    peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tensor_bytes(tensors):
    return sum(a.numel() * a.element_size() for a in tensors)


def thomas_flops(spec, Bsz, NW=0, dense=False):
    """Arithmetic operations of one Thomas sweep (forward + backward) over
    ``Bsz`` lanes, counted from the kernels' loops."""
    n, m, p, T = spec.n, spec.m, spec.p, spec.T
    pn, d = p * n, n + m
    R = pn + 1
    C = d + R
    f = 2 * n * n * pn                                   # F = -A G
    if dense:
        f += 2 * m * n * n + 2 * n * n * pn              # B^T Q, sum F_i Q_i
        f += 2 * pn * n                                  # Q_i x (backward)
    else:
        f += 2 * n * NW * n                              # F w
        f += m * n * (1 + (NW / p) * (2 * n + 2))        # B^T Q
        f += n * n * (2 * p + 2 * NW)                    # sum F_i Q_i
        f += 2 * NW * n + pn * (1 + 2 * NW / p)          # Q_i x (backward)
    f += 2 * m * n * n + 2 * m * n                       # B^T A^T, B^T a
    f += 2 * n * pn * n + n * (2 * n + 2 * pn + 2)       # F A^T, d0 - Ay + Fa
    f += sum((C - i - 1) + 2 * (d - 1 - i) * (C - i - 1) for i in range(d))
    f += R * d * (d - 1)                                 # back substitution
    f += 2 * d * pn + pn * (2 * n + 2)                   # x, u and lam
    return Bsz * T * f


def trial_flops(spec, obj, gc, Bsz):
    """Arithmetic operations of one fused trial over ``Bsz`` lanes, counted
    per knot from the kernel's arithmetic (trial point, dynamics and pulls
    per player, statx rows, constraint rows, collision-cost pairs)."""
    from algames_tpu_torch.constraints.kernels import BoundParams
    p, m = spec.p, spec.m
    rows = bound_rows = 0
    for b in gc.state_blocks:
        if isinstance(b.params, BoundParams):
            bound_rows += sum(b.params.mask)
        else:
            rows += b.lam.shape[-1]
    per_knot = (48 * p * p + 60 * p + 20 * rows + 6 * bound_rows
                + 14 * m * len(gc.control_blocks) + 30 * len(obj.pair_i))
    return Bsz * spec.T * per_knot


def dense_kkt(spec, jb):
    """The dense [B, S, S] KKT matrix of the per-knot blocks (rows in
    equation order [statx | statu | dyn], columns [x | u | lam] per knot):
    only the library yardstick uses it."""
    import torch
    T, n, m, p, W = spec.T, spec.n, spec.m, spec.p, spec.W
    pn = p * n
    Bsz, dtype, dev = jb.A.shape[0], jb.A.dtype, jb.A.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    D = torch.zeros((Bsz, T, W, W), dtype=dtype, device=dev)
    for i in range(p):
        D[:, :, i * n:(i + 1) * n, :n] = jb.Qblk[:, :, i]
        D[:, :, i * n:(i + 1) * n, n + m + i * n:n + m + (i + 1) * n] = -eye
    D[:, :, pn:pn + m, n:n + m] = jb.Ublk
    for i in range(p):
        for j in spec.pu[i]:
            D[:, :, pn + j, n + m + i * n:n + m + (i + 1) * n] = jb.B[..., j]
    D[:, :, pn + m:, :n] = -eye
    D[:, :, pn + m:, n:n + m] = jb.B
    K = torch.zeros((Bsz, T * W, T * W), dtype=dtype, device=dev)
    for t in range(T):
        K[:, t * W:(t + 1) * W, t * W:(t + 1) * W] = D[:, t]
        if t + 1 < T:
            At1 = jb.A[:, t + 1]
            for i in range(p):
                c0 = (t + 1) * W + n + m + i * n
                K[:, t * W + i * n:t * W + (i + 1) * n, c0:c0 + n] = \
                    At1.transpose(-1, -2)
            K[:, (t + 1) * W + pn + m:(t + 2) * W, t * W:t * W + n] = At1
    return K


def library_solve_ms(spec, jb, b, lanes):
    """``torch.linalg.solve`` on the dense KKT matrices of every system, in
    calls of ``lanes`` systems each (as many as fit on the card): (ms for
    all the systems, the solution)."""
    import torch
    Bsz = b.shape[0]
    ms, ys = 0.0, []
    for s in range(0, Bsz, lanes):
        K = dense_kkt(spec, tree_slice(jb, s + lanes, s))
        rhs = b[s:s + lanes].reshape(K.shape[0], -1, 1)
        if s == 0:
            torch.linalg.solve(K, rhs)                  # warm-up
        ms += cuda_ms(lambda: ys.append(torch.linalg.solve(K, rhs)[..., 0]),
                      1, warm=False)
        del K
        torch.cuda.empty_cache()
    return ms, torch.cat(ys)


def load_golden(name):
    """A frozen solution: ``tests/golden/<name>.npz`` (the reference
    package's equilibria) or ``tests/golden_torch/<name>.npz`` (frozen from
    the reference package for the port's checks by
    ``tests/torch_goldens.py``)."""
    for folder in ("golden", "golden_torch"):
        path = HERE / "tests" / folder / f"{name}.npz"
        if path.exists():
            return np.load(path)
    raise SystemExit(f"no frozen solution {name}")


def tree_slice(tree, stop, start=0):
    """Lanes ``start:stop`` of every leaf."""
    from algames_tpu_torch.utils import tree_map
    return tree_map(lambda a: a[start:stop].contiguous(), tree)


def golden_iterates(golden):
    """Iterates around a frozen equilibrium (``load_golden``):
    states and controls perturbed per knot, random multipliers."""
    def make(prob, spec, B, rng, dev, dtype):
        import torch
        from algames_tpu_torch.core.traj import PrimalDual
        gold = load_golden(golden)
        x = gold["x"][None] + 0.1 * rng.standard_normal((B, spec.N, spec.n))
        u = gold["u"][None] + 0.3 * rng.standard_normal((B, spec.T, spec.m))

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)
        return PrimalDual(x=t(x), u=t(u), lam=t(0.3 * rng.standard_normal(
            (B, spec.p, spec.T, spec.n))))
    return make


def flagship_iterates(prob, spec, B, rng, dev, dtype):
    return random_iterates(prob, spec, B, rng, dev, dtype, noise=0.05)


def k1_system(dev, B, mu, seed, penalize_rows=False, preset=None,
              iterates=flagship_iterates, eq_mu=False):
    """KKT systems (f64) with structured Hessians assembled by the port from
    perturbed points of ``preset`` (default: the flagship).  The AL penalty
    mu enters as late-AL-schedule curvature on the statx Hessian diagonals
    (qdiag += mu, as the reference package's kernel validation does); with
    ``penalize_rows`` it instead penalizes every constraint row at mu
    (positive duals), which makes the systems far worse conditioned; with
    ``eq_mu`` it is the equality blocks' penalty alone (their rows carry
    Irho = mu whatever their duals, as late in the AL schedule)."""
    import torch
    from algames_tpu_torch.constraints.sets import map_blocks, reset_constraints
    from algames_tpu_torch.presets import flagship_unicycle
    from algames_tpu_torch.problem import residual as R
    from algames_tpu_torch.utils import tree_map

    prob, spec = (preset or flagship_unicycle)(dev, torch.float64)
    rng = np.random.default_rng(seed)
    traj = iterates(prob, spec, B, rng, dev, torch.float64)
    gc = (al_state(prob.gc, B, rng, dev, torch.float64, mu=mu)
          if penalize_rows else reset_constraints(prob.gc, B))
    if eq_mu:
        gc = map_blocks(gc, lambda b: dataclasses.replace(
            b, mu=torch.full_like(b.mu, mu)) if b.sense == "eq" else b)
    pd = R.point_data(prob.model, spec, prob.obj, gc, traj)
    res, sq, _, _ = R.assemble_structured_from_point(
        spec, prob.obj, gc, traj, pd,
        reg=torch.full((B,), 1e-3, dtype=torch.float64, device=dev))
    if not (penalize_rows or eq_mu):
        sq = dataclasses.replace(sq, qdiag=sq.qdiag + mu)
    b = -R.residual_knot_blocks(spec, res)
    sq = tree_map(lambda a: a.contiguous(), sq)
    return spec, sq, b.contiguous(), R.structured_w_owner(gc)


def backward_errors(spec, blocks, w_owner, b, ys, lanes=256):
    """Per-lane normwise backward error |K y - b| / (|K| |y| + |b|) (infinity
    norms, K the f64 KKT matrix of ``blocks``: structured with its
    ``w_owner``, or dense ``JacBlocks`` with ``w_owner`` None) of each
    solution in ``ys``: how far from the given system the solved one lies,
    whatever the system's condition.  K is applied from its per-knot blocks,
    row by row as ``dense_kkt`` lays them out, ``lanes`` lanes at a time,
    and never formed (at 17 players it is 4.57 GB a lane in f64)."""
    import torch
    from algames_tpu_torch.core.spec import owner_map_u
    T, n, m, p = spec.T, spec.n, spec.m, spec.p
    own = torch.as_tensor(owner_map_u(spec), device=b.device)
    out = [[] for _ in ys]
    for s in range(0, b.shape[0], lanes):
        sl = tree_slice(blocks, s + lanes, s)
        jb = sl if w_owner is None else dense_of(spec, sl, w_owner)
        Q, U, A, Bm = (jb.Qblk.double(), jb.Ublk.double(), jb.A.double(),
                       jb.B.double())
        L = A.shape[0]
        zero = torch.zeros_like(A[:, :1])
        A1 = torch.cat([A[:, 1:], zero], 1)    # A_{t+1}: statx rows of t
        Ad = torch.cat([zero, A[:, 1:]], 1)    # A_t: dyn rows of t >= 1
        rows = torch.cat([
            (Q.abs().sum(-1) + 1 + A1.abs().sum(-2)[:, :, None]).reshape(
                L, T, p * n),
            U.abs().sum(-1) + Bm.abs().sum(-2),
            1 + Bm.abs().sum(-1) + Ad.abs().sum(-1)], -1)
        k_norm = rows.reshape(L, -1).amax(-1)
        bb = b[s:s + lanes].double().reshape(L, T, -1)
        for acc, y in zip(out, ys):
            yy = y[s:s + lanes].double().reshape(L, T, -1)
            x, u = yy[..., :n], yy[..., n:n + m]
            lam = yy[..., n + m:].reshape(L, T, p, n)
            lam1 = torch.cat([lam[:, 1:], torch.zeros_like(lam[:, :1])], 1)
            xp = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
            rx = (torch.einsum("btpij,btj->btpi", Q, x) - lam
                  + torch.einsum("btja,btpj->btpa", A1, lam1))
            ru = (torch.einsum("btjk,btk->btj", U, u)
                  + torch.einsum("btkj,btjk->btj", Bm, lam[:, :, own]))
            rd = (torch.einsum("btak,btk->bta", Bm, u) - x
                  + torch.einsum("btak,btk->bta", Ad, xp))
            r = torch.cat([rx.reshape(L, T, p * n), ru, rd], -1) - bb
            acc.append(r.abs().reshape(L, -1).amax(-1)
                       / (k_norm * yy.abs().reshape(L, -1).amax(-1)
                          + bb.abs().reshape(L, -1).amax(-1)))
    return [torch.cat(acc) for acc in out]


def phase_k1(dev, tag="K1", preset=None, iterates=flagship_iterates,
             seed0=0, gate="forward", B=B_KERNEL, eq_mu=False,
             shared_too=False):
    """K1 against its plain version on ``preset``'s KKT systems (default:
    the flagship), B lanes, over mu = 1 .. 1e7 (``eq_mu``: mu on the
    equality rows, ``k1_system``), on the register-tiled
    forward kernel (another route taken is a failure; systems beyond the
    size classes: :func:`phase_beyond`); then its times, bound, library
    call and forward kernel (``k1_occupancy``) in f32, and with
    ``shared_too`` the shared-memory forward kernel's device time and
    occupancy on the same operands.
    ``gate`` "forward": worst relative error against the f64 plain
    version, f64 <= 1e-9 and f32 <= 1e-3.  "backward", for systems too
    ill-conditioned for that in f32 (the f32 plain version itself misses
    it): the normwise backward error, f64 <= 1e-15 and f32 <= 1e-7, each
    also <= 10 x the plain version's own in the same precision, and the f32
    forward error <= 30 x the f32 plain version's own."""
    import torch
    from algames_tpu_torch.ops.thomas import (solve_thomas_structured,
                                              solve_thomas_structured_plain,
                                              structured_to_dense)
    from algames_tpu_torch.problem.linear_solver import JacBlocks
    from algames_tpu_torch.utils import tree_map

    def solve(sq, b, w_owner):
        return solve_thomas_structured(spec, sq, b, w_owner)

    def compare(mu, seed, penalize_rows):
        nonlocal spec
        spec, sq, b, w_owner = k1_system(dev, B, mu, seed0 + seed,
                                         penalize_rows, preset, iterates,
                                         eq_mu and not penalize_rows)
        ref = solve_thomas_structured_plain(spec, sq, b, w_owner)
        y64 = solve(sq, b, w_owner)
        sq32 = tree_map(lambda a: a.float(), sq)
        y32 = solve(sq32, b.float(), w_owner)
        torch.cuda.synchronize()
        out = (float(rel_err(y64, ref).max()), float(rel_err(y32, ref).max()),
               float((y32.double() - ref).abs().max()))
        if gate == "backward" and not penalize_rows:
            p32 = solve_thomas_structured_plain(spec, sq32, b.float(),
                                                w_owner)
            bw = backward_errors(spec, sq, w_owner, b, (y64, ref, y32, p32))
            out += (float(rel_err(p32, ref).max()),
                    *(float(e.max()) for e in bw))
        return out

    spec = None
    worst64 = worst32 = max_abs32 = 0.0
    launches = solve_thomas_structured.launches
    wide0 = solve_thomas_structured.wide_launches
    dev0 = solve_thomas_structured.global_launches
    calls = 2                                # kernel calls per compare
    for i, mu in enumerate(MUS):
        e = compare(mu, i, False)
        e64, e32, a32 = e[:3]
        if gate == "forward":
            log(f"[{tag}] mu={mu:.0e}: f64 kernel vs f64 plain {e64:.3e} (<= "
                f"1e-9), f32 kernel vs f64 plain {e32:.3e} (<= 1e-3), f32 max "
                f"abs {a32:.3e}")
            ok = e64 <= 1e-9 and e32 <= 1e-3
        else:
            p32, b64, bp64, b32, bp32 = e[3:]
            log(f"[{tag}] mu={mu:.0e}: backward error f64 kernel {b64:.3e} "
                f"(plain {bp64:.3e}; <= 1e-15 and 10 x plain), f32 kernel "
                f"{b32:.3e} (plain {bp32:.3e}; <= 1e-7 and 10 x plain); "
                f"forward vs f64 plain: f32 kernel {e32:.3e} against f32 "
                f"plain {p32:.3e} (<= 30 x plain), f64 kernel {e64:.3e} "
                f"(reported)")
            ok = (b64 <= 1e-15 and b64 <= 10 * bp64 and b32 <= 1e-7
                  and b32 <= 10 * bp32 and e32 <= 30 * p32)
        if not ok:
            raise SystemExit(f"{tag} disagrees with its plain version at "
                             f"mu={mu}")
        worst64, worst32 = max(worst64, e64), max(worst32, e32)
        max_abs32 = max(max_abs32, a32)
    if solve_thomas_structured.launches != launches + calls * len(MUS):
        raise SystemExit(f"the {tag} wrapper did not launch its kernel")
    took = (solve_thomas_structured.wide_launches - wide0
            + solve_thomas_structured.global_launches - dev0)
    if took:
        raise SystemExit(f"{tag}: K1 took the wrong forward route ({took} "
                         f"of {calls * len(MUS)} calls beyond its classes)")
    for mu in (1e3, 1e7):
        e64, e32, _ = compare(mu, 50, True)
        log(f"[{tag}] every constraint row penalized at mu={mu:.0e} "
            f"(reported, not gated: two f64 solvers differ by up to cond * "
            f"eps here): f64 {e64:.3e}, f32 {e32:.3e}")
    spec, sq, b, w_owner = k1_system(dev, B, 1e3, seed0 + 99, False,
                                     preset, iterates, eq_mu)
    sq32, b32 = tree_map(lambda a: a.float(), sq), b.float()
    ms = cuda_ms(lambda: solve(sq32, b32, w_owner), 20)
    plain_ms = cuda_ms(
        lambda: solve_thomas_structured_plain(spec, sq32, b32, w_owner), 5)
    dev_ms = device_ms(lambda: solve(sq32, b32, w_owner), 20,
                       ("thomas_sq_",), 2, tag)
    log(f"[{tag}] worst over mu: f64 {worst64:.3e}, f32 {worst32:.3e} "
        f"relative; f32 kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms at B={B} (per call, CUDA events); kernel "
        f"device time {dev_ms:.4f} ms (events, fwd + bwd)")
    jb32 = JacBlocks(Qblk=structured_to_dense(sq32, w_owner, spec.p),
                     Ublk=sq32.Ublk, A=sq32.A, B=sq32.B)
    lib_ms, y_lib = library_solve_ms(spec, jb32, b32, B)
    y = solve(sq32, b32, w_owner)
    dev_lib = float(rel_err(y_lib, y).max())
    bnd = bound(tensor_bytes([sq32.qdiag, sq32.wv, sq32.Ublk, sq32.A,
                              sq32.B, b32]) + tensor_bytes([y]),
                thomas_flops(spec, B, NW=len(w_owner)))
    log(f"[{tag}] library: torch.linalg.solve on the dense [{B}, "
        f"{spec.S}, {spec.S}] KKT matrices, f32, one call: {lib_ms:.4f} ms; "
        f"worst relative deviation from K1 {dev_lib:.3e} (not gated); bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    out = {"max_abs_err": max_abs32, "ms": ms, "plain_ms": plain_ms,
           "device_ms": dev_ms, **bnd, "library_ms": lib_ms,
           "forward_kernel": k1_occupancy(tag, spec, len(w_owner), B)}
    if shared_too:
        out["shared_device_ms"] = device_ms(
            lambda: solve_thomas_structured(spec, sq32, b32, w_owner,
                                            forward="shared"), 20,
            ("thomas_sq_",), 2, f"{tag} shared-memory kernel")
        out["shared_forward_kernel"] = k1_occupancy(
            f"{tag} shared-memory kernel", spec, len(w_owner), B, "shared")
        log(f"[{tag}] f32 device time at B={B}: register-tiled "
            f"{dev_ms:.4f} ms, the shared-memory forward kernel on the same "
            f"operands {out['shared_device_ms']:.4f} ms "
            f"({out['shared_device_ms'] / dev_ms:.2f} x)")
    return out


def k1_occupancy(tag, spec, NW, B=B_KERNEL, forward="auto",
                 dtypes=("f32", "f64")):
    """The forward kernel K1 runs at ``spec``'s widths with ``NW`` w
    vectors (``forward``: on that route, "blocked", "shared" or "device",
    instead of the one the shape takes), per dtype: its route, lanes per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), waves at B lanes,
    registers and local memory (frame) a thread (``cudaFuncGetAttributes``),
    through ``thomas_sq_occupancy_*``; printed and returned."""
    from algames_tpu_torch.ops.thomas import structured_forward
    return forward_occupancy(
        tag, lambda dt: structured_forward(spec.n, spec.m, spec.p, NW, dt,
                                           forward),
        f"d={spec.n + spec.m}, R={spec.p * spec.n + 1}, NW={NW}", B, dtypes)


def forward_occupancy(tag, query, widths, B, dtypes=("f32", "f64")):
    """Print and return, per dtype, the forward kernel that ``query(dtype)``
    (``ops.thomas.structured_forward`` or ``dense_forward``) describes:
    route, lanes per SM, waves at B lanes, registers and frame."""
    import math
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        if name not in dtypes:
            continue
        route, lanes, regs, frame = query(dt)
        if lanes < 1:
            raise SystemExit(f"[{tag}] the {name} forward kernel fits no "
                             f"lane on an SM")
        out[name] = {"route": route,
                     "lanes_per_sm": lanes,
                     "waves": math.ceil(B / (sms * lanes)),
                     "registers": regs, "frame_bytes": frame}
        log(f"[{tag}] {name} forward kernel: {out[name]['route']} "
            f"({widths}): {lanes} lanes per SM, {out[name]['waves']} wave(s) "
            f"at B={B} on {sms} SMs, {regs} registers and {frame} bytes of "
            f"local memory a thread")
    return out


def trial_inputs(preset, iterates, half_duals, dev, dtype, seed,
                 zero_u=False, smoothing=None, B=B_KERNEL, signed=False,
                 sense=None):
    """B lanes of trial inputs for one game: iterates from
    ``iterates(prob, spec, B, rng, dev, dtype)``, small random steps,
    positive duals (half of them zeroed with ``half_duals``, so that
    inactive rows go unpenalized), penalties from 1 to 1e7, per-lane alpha
    and reg, all from numpy seed ``seed``.  With ``zero_u`` the first
    quarter of the lanes has every control and control step exactly 0, so
    that the trial point sits on the quadrotor's thrust kink; ``smoothing``
    replaces the quadrotor's thrust smoothing; with ``signed`` half of the
    duals change sign (equality rows with c < 0 and lam < 0, where the
    equality and inequality rules differ); ``sense`` replaces the sense of
    the game's equality blocks."""
    import torch
    from algames_tpu_torch.constraints.sets import map_blocks
    from algames_tpu_torch.core.traj import PrimalDual

    prob, spec = preset(dev, dtype)
    if smoothing is not None:
        prob = dataclasses.replace(prob, model=dataclasses.replace(
            prob.model, thrust_smoothing=smoothing))
    rng = np.random.default_rng(seed)
    traj = iterates(prob, spec, B, rng, dev, dtype)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    dtraj = PrimalDual(x=t(0.05 * rng.standard_normal((B, spec.N, spec.n))),
                       u=t(0.05 * rng.standard_normal((B, spec.T, spec.m))),
                       lam=t(0.05 * rng.standard_normal(
                           (B, spec.p, spec.T, spec.n))))
    if zero_u:
        traj.u[:B // 4] = 0.0
        dtraj.u[:B // 4] = 0.0
    gc = al_state(prob.gc, B, rng, dev, dtype)
    if half_duals:
        gc = map_blocks(gc, lambda b: dataclasses.replace(b, lam=b.lam * t(
            rng.random(tuple(b.lam.shape)) < 0.5)))
    if signed:
        gc = map_blocks(gc, lambda b: dataclasses.replace(b, lam=b.lam * t(
            np.where(rng.random(tuple(b.lam.shape)) < 0.5, -1.0, 1.0))))
    if sense is not None:
        gc = map_blocks(gc, lambda b: dataclasses.replace(b, sense=sense)
                        if b.sense == "eq" else b)
    alpha = t(0.5 ** rng.integers(0, 6, size=B))
    reg = t(1e-3 * (1.0 + rng.integers(0, 20, size=B)) ** 4)
    return prob, spec, gc, traj, dtraj, alpha, reg


def k2_inputs(dev, dtype):
    """Flagship trial inputs around the perturbed start."""
    from algames_tpu_torch.presets import flagship_unicycle
    return trial_inputs(flagship_unicycle, random_iterates, False, dev,
                        dtype, seed=7)


def k4_inputs(dev, dtype):
    """Roundabout trial inputs with the players crowded near the island."""
    from algames_tpu_torch.presets import roundabout
    return trial_inputs(roundabout, lambda prob, *a: crowded_iterates(*a),
                        True, dev, dtype, seed=11)


def highway_trial_inputs(dev, dtype):
    """Highway trial inputs at the batched closed loop's B_MPC lanes, the
    shapes the fused trial gets in ``mpc-fused``."""
    return trial_inputs(highway_game, flagship_iterates, True, dev, dtype,
                        seed=13, B=B_MPC)


def game_trial_inputs(preset, golden, seed, **kw):
    """Trial inputs around the frozen equilibrium of ``golden``."""
    def inputs(dev, dtype):
        return trial_inputs(preset, golden_iterates(golden), True, dev, dtype,
                            seed, **kw)
    return inputs


def ring_trial_inputs(sense=None):
    """Ring-road trial inputs around its frozen equilibrium, with duals of
    both signs; ``sense`` replaces the ring block's."""
    def inputs(dev, dtype):
        return trial_inputs(ring3_eq_game, golden_iterates("ring3_eq_N20"),
                            True, dev, dtype, seed=41, signed=True,
                            sense=sense)
    return inputs


def di3_game(dev, dtype):
    """A 2-player double integrator in three dimensions (no preset uses
    one; the fused trial compiles it): spherical collision avoidance, a
    cylinder and control bounds, N=10."""
    import torch
    from algames_tpu_torch.constraints import sets as S
    from algames_tpu_torch.core.spec import spec_from_model
    from algames_tpu_torch.models.double_integrator import (
        double_integrator_game)
    from algames_tpu_torch.objective.objective import game_objective
    from algames_tpu_torch.problem.options import Options
    from algames_tpu_torch.problem.problem import game_problem
    model = double_integrator_game(p=2, d=3)
    spec = spec_from_model(model, 10, 0.1)
    obj = game_objective(spec, Q=[np.ones(6)] * 2, R=[0.1 * np.ones(3)] * 2,
                         xf=[np.r_[1.0, 0.3 * i, 0.5, np.zeros(3)]
                             for i in range(2)],
                         uf=[np.zeros(3)] * 2, dtype=dtype, device=dev)
    gc = S.game_constraints(spec, dtype=dtype, device=dev)
    gc = S.add_spherical_collision_avoidance(spec, gc, 0.1)
    gc = S.add_wall_constraint(spec, gc, [S.CylinderWall([0.5, 0.1, 0.0],
                                                         "z", 1.0, 0.2)])
    gc = S.add_control_bound(spec, gc, 2 * np.ones(6), -2 * np.ones(6))
    x0 = torch.zeros(spec.n, dtype=dtype, device=dev)
    return game_problem(10, 0.1, x0, model, Options(), obj, gc), spec


def quad3_game(dev, dtype):
    """The quadrotor preset with three players, outer 2 x inner 5: n=36,
    m=12, so its reduced KKT systems (d=48, R=109) take K1's tall
    register-tiled class, and turned dense lie beyond K3's classes."""
    from algames_tpu_torch.presets import quadrotor3d
    return quadrotor3d(dev, dtype, outer=2, inner=5, p=3)


def quad4_game(dev, dtype):
    """The quadrotor preset with four players, outer 2 x inner 5: n=48,
    m=16, so its reduced KKT systems (d=64, R=193) lie beyond K1's size
    classes: they take its per-player blocked route in f32 and f64."""
    from algames_tpu_torch.presets import quadrotor3d
    return quadrotor3d(dev, dtype, outer=2, inner=5, p=4)


def quad3_iterates(prob, spec, B, rng, dev, dtype):
    """Iterates of ``quad3_game``: its start and hover thrust perturbed per
    knot, random multipliers."""
    import torch
    from algames_tpu_torch.core.traj import PrimalDual
    hover = 0.5 * 9.81 / 4.0 / prob.model.kf

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    x = np.asarray(prob.x0.cpu())[None, None] + 0.1 * rng.standard_normal(
        (B, spec.N, spec.n))
    return PrimalDual(x=t(x), u=t(hover + 0.3 * rng.standard_normal(
        (B, spec.T, spec.m))), lam=t(0.3 * rng.standard_normal(
            (B, spec.p, spec.T, spec.n))))


def phase_solve_wide(dev):
    """The f64 ``quad3_game`` solve (4 scenarios, x0 + 0.05 N(0, 1) from
    numpy seed 0, outer 2 x inner 5) through K1, which takes its tall
    register-tiled class at d=48, against the same solve through the plain
    versions on the card: per-lane iteration counts equal, x and u within
    WIDE_PLAIN_TOL; no launch on the shared-memory (wide) route."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch.ops.thomas import kkt_solve_plain
    prob, spec = quad3_game(dev, torch.float64)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(np.asarray(prob.x0.cpu())[None]
                          + 0.05 * rng.standard_normal((4, spec.n)),
                          dtype=torch.float64, device=dev)
    counters = zero_counters()
    res = agt.newton_solve(prob, x0s)
    torch.cuda.synchronize()
    launches = read_counters(counters)
    res_p = agt.newton_solve(prob, x0s, method=kkt_solve_plain)
    it, it_p = res.stats.iter.cpu().numpy(), res_p.stats.iter.cpu().numpy()
    dx = float((res.traj.x - res_p.traj.x).abs().max())
    du = float((res.traj.u - res_p.traj.u).abs().max())
    log(f"[solve-wide] f64 3-player quadrotor (d=48), 4 scenarios: iterations "
        f"{it.tolist()} (plain versions {it_p.tolist()}), max |dx| {dx:.3e}, "
        f"max |du| {du:.3e} from the plain versions (<= {WIDE_PLAIN_TOL:g}); "
        f"launches {launches}")
    if not ((it == it_p).all() and dx <= WIDE_PLAIN_TOL
            and du <= WIDE_PLAIN_TOL and launches["K1"] > 0
            and launches["K1 shared route"] == 0
            and launches["K1 device route"] == 0):
        raise SystemExit("the 3-player quadrotor solve through K1 disagrees "
                         "with the plain versions")


def phase_sweep_quad3(dev, k1_wide, k4_quad3):
    """One timed f32 chunk of ``quad3_game``: its first CHUNK scenarios
    (x0 + 0.05 N(0, 1) from numpy seed 0), outer 2 x 5, the fused trial
    (K4's quadrotor instance, n=36), warm, counted from zero after the
    warm-up: every trajectory finite, none diverged; K1 launched on its
    tall register-tiled class (no launch beyond it), K4 launched, K3 not.
    Prints K1's and K4's shares of the chunk's wall time (their f32 device
    times per call at B=CHUNK from ``K1-wide`` and ``K4-quad3``, ``k1_wide``
    and ``k4_quad3``, times their launches).  Returns the launches."""
    import torch
    from algames_tpu_torch import parallel
    prob, spec = quad3_game(dev, torch.float32)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        (np.asarray(prob.x0.cpu(), np.float64)[None]
         + 0.05 * rng.standard_normal((N_SWEEP, spec.n)))[:CHUNK],
        dtype=torch.float32, device=dev)
    opts = prob.opts
    parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
        opts, outer_iter=1, inner_iter=2)), x0s[:64])
    counters = zero_counters()
    out, el = timed_sweep(prob, x0s, "thomas")
    launches = read_counters(counters)
    finite = bool(torch.isfinite(out.traj.x).all())
    div = float(parallel.divergence_mask(out).float().mean())
    frac = float(parallel.convergence_fraction(
        out, dataclasses.replace(opts, eps_opt=QUAD_OPT_GATE)))
    iters = out.stats.iter.cpu().numpy()
    k1_ms = k1_wide["device_ms"] * launches["K1"]
    k4_ms = k4_quad3["device_ms"] * launches["trial"]
    log(f"[sweep-quad3] f32 {CHUNK} scenarios of the 3-player quadrotor as "
        f"one chunk, outer {opts.outer_iter} x {opts.inner_iter}: {el:.3f} "
        f"s, {CHUNK / el:.1f} solves/s; converged (opt gate "
        f"{QUAD_OPT_GATE:g}) {frac:.4f} (reported), "
        f"diverged {div:.4f}, finite {finite}; stats rows "
        f"{int(iters.min())}..{int(iters.max())}; launches {launches}; K1 "
        f"device time {launches['K1']} x {k1_wide['device_ms']:.4f} = "
        f"{k1_ms:.1f} ms, {100 * k1_ms / 1e3 / el:.1f}% of the chunk's wall; "
        f"K4 {launches['trial']} x {k4_quad3['device_ms']:.4f} = "
        f"{k4_ms:.1f} ms, {100 * k4_ms / 1e3 / el:.1f}%")
    if not (finite and div == 0.0 and launches["K1"] > 0
            and launches["K1 shared route"] == 0
            and launches["K1 device route"] == 0 and launches["trial"] > 0
            and launches["K3"] == 0):
        raise SystemExit("the 3-player quadrotor chunk failed its gates")
    return launches


def quad4_bound_game(dev, dtype):
    """``quad4_game`` with a state bound of player 0 on all 48 states: upper
    bounds on every state, lower bounds on states 20.. only, so that its
    rows past the 64th (K4's second mask word) carry flags and masked rows
    alike."""
    from algames_tpu_torch.constraints.sets import add_state_bound
    prob, spec = quad4_game(dev, dtype)
    lo = np.where(np.arange(spec.n) >= 20, -5.0, -np.inf)
    gc = add_state_bound(spec, prob.gc, 0, 5.0 * np.ones(spec.n), lo)
    return dataclasses.replace(prob, gc=gc), spec


def quad4_cost_game(dev, dtype):
    """``quad4_game`` with a collision cost between every pair of players
    (radius 0.2, weight 2): its Hessian blocks are dense, so its KKT step
    is K3's (d=64, on the per-player blocked route)."""
    from algames_tpu_torch.objective.objective import add_collision_cost
    prob, spec = quad4_game(dev, dtype)
    obj = add_collision_cost(spec, prob.obj, radius=0.2 * np.ones(spec.p),
                             mu=2.0 * np.ones(spec.p))
    return dataclasses.replace(prob, obj=obj), spec


# The forward routes timed beside the route a quad4 shape takes, by form
# and precision: every other route that holds the shape (the shared-memory
# kernel needs 443 KB for K1 in f64 and 250 / 499 KB for K3).
BEYOND_ROUTES = {("structured", "f32"): ("blocked", "shared", "device"),
                 ("structured", "f64"): ("blocked", "device"),
                 ("dense", "f32"): ("blocked", "device"),
                 ("dense", "f64"): ("blocked", "device")}
# K1 and K3 at the 6-player unicycle's widths (d=36): every route holds the
# shape in both precisions (K1's shared-memory kernel 170 KB in f64).
UNI6_ROUTES = {(form, dt): ("blocked", "shared", "device")
               for form in ("structured", "dense") for dt in ("f32", "f64")}
# The blocked routes forced onto systems inside the register-tiled classes
# (K1: the flagship's, d=18; K3: the roundabout's, d=24), beside the class
# the shape takes.
BLOCKED_ROUTES = {(form, dt): ("blocked",)
                  for form in ("structured", "dense") for dt in ("f32", "f64")}


def uni6_game(dev, dtype):
    """The flagship with six players: n=24, m=12, so its reduced KKT
    systems (d=36, R=145, NW=30) lie beyond K1's size classes (d + R >
    160) at a width that is no multiple of 16."""
    from algames_tpu_torch.presets import flagship_unicycle
    return flagship_unicycle(dev, dtype, p=6)


def uni9_game(dev, dtype, outer=7, inner=20):
    """The flagship merge with nine players (``flagship_unicycle(p=9)``):
    n=36, m=18, 72 collision blocks, so its reduced KKT systems (d=54,
    R=325, NW=72) pass the 64 w vectors and its trials the 32 states and
    64 state blocks that earlier kernels capped."""
    from algames_tpu_torch.presets import flagship_unicycle
    return flagship_unicycle(dev, dtype, outer=outer, inner=inner, p=9)


def uni9_sweep_game(dev, dtype):
    """``uni9_game`` at the flagship bench's budget, outer 3 x inner 8."""
    return uni9_game(dev, dtype, outer=3, inner=8)


def uni_game(p, outer=7, inner=20):
    """The flagship merge with ``p`` players (``flagship_unicycle(p=p)``):
    n = 4p, m = 2p, p (p - 1) collision blocks; its reduced KKT systems d =
    6p, R = 4p^2 + 1, NW = p (p - 1)."""
    def game(dev, dtype):
        from algames_tpu_torch.presets import flagship_unicycle
        return flagship_unicycle(dev, dtype, outer=outer, inner=inner, p=p)
    return game


uni12_game, uni15_game, uni17_game = uni_game(12), uni_game(15), uni_game(17)
# The 17-player merge at the flagship bench's budget, outer 3 x inner 8.
uni17_sweep_game = uni_game(17, 3, 8)


def uni17_bound_game(dev, dtype):
    """``uni17_game`` with a state bound of player 0 on all 68 states: upper
    bounds on every state, lower bounds on states 20.. only, so that its
    row flags (in the parameter array past 32 states) are finite and
    infinite alike, on both sides of the 128th row."""
    from algames_tpu_torch.constraints.sets import add_state_bound
    prob, spec = uni17_game(dev, dtype)
    lo = np.where(np.arange(spec.n) >= 20, -5.0, -np.inf)
    gc = add_state_bound(spec, prob.gc, 0, 5.0 * np.ones(spec.n), lo)
    return dataclasses.replace(prob, gc=gc), spec


def phase_golden_uni9(dev, tag="golden-uni9", game=uni9_game,
                      golden="uni9_N20", lanes=B_GOLDEN9):
    """B_GOLDEN9 lanes of the f64 9-player merge from its x0 through the
    kernels (K1 on the route its shape takes, K2's wide unicycle instance),
    counted from zero just before: on every lane the frozen JAX solution's
    iteration count (``uni9_N20``), x and u within 1e-8; every K1 launch on
    that route, K2 launched on every trial (the eager trial never ran), K3
    not.  Returns the launches, with the route under "route".
    ``golden-uni17`` runs the same on ``uni17_game`` against
    ``uni17_N20``."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch.ops.trial import instance_name
    from algames_tpu_torch.problem import solver
    from algames_tpu_torch.problem.residual import structured_w_owner
    gold = load_golden(golden)
    prob, spec = game(dev, torch.float64)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    NW = len(structured_w_owner(prob.gc))
    route = shape_route(spec, torch.float64, NW)
    x0s = prob.x0[None].repeat(lanes, 1)
    eager = solver.trial_eval_plain
    eager_calls = []

    def counted(*a, **k):
        eager_calls.append(1)
        return eager(*a, **k)
    solver.trial_eval_plain = counted
    counters = zero_counters()
    t0 = time.perf_counter()
    try:
        res = agt.newton_solve(prob, x0s)
        torch.cuda.synchronize()
    finally:
        solver.trial_eval_plain = eager
    el = time.perf_counter() - t0
    launches = read_counters(counters)
    it = res.stats.iter.cpu().numpy()
    dx = float(np.abs(res.traj.x.cpu().numpy() - gold["x"][None]).max())
    du = float(np.abs(res.traj.u.cpu().numpy() - gold["u"][None]).max())
    log(f"[{tag}] f64 {spec.p}-player merge (d={spec.n + spec.m}, "
        f"NW={NW}, {len(prob.gc.state_blocks)} state blocks), {lanes} "
        f"lanes from x0, {el:.2f} s: iterations {it.tolist()} "
        f"(golden {int(gold['iter'])}), max |dx| {dx:.3e}, max |du| "
        f"{du:.3e} (<= 1e-8); K1 on its {route} route, K2 instance "
        f"{instance_name(prob.model, spec)}; launches {launches}, eager "
        f"trials {len(eager_calls)}")
    if not ((it == int(gold["iter"])).all() and dx <= 1e-8 and du <= 1e-8
            and launches["K1"] > 0
            and launches[f"K1 {route} route"] == launches["K1"]
            and launches["trial"] > 0 and not eager_calls
            and launches["K3"] == 0):
        raise SystemExit(f"the {spec.p}-player merge's f64 kernel path "
                         f"misses {golden} or its kernels")
    return {**launches, "route": route}


def phase_routes_wide(dev):
    """K1's forward route at every width of the unicycle merges of
    UNI_WIDE_PLAYERS players, in f32 and f64, as its library says: every
    one is a route (the f64 device-memory route of 15 and 16 players did
    not fit a block while its products Pw took a panel of NW columns).
    Returns {p: (f32 route, f64 route)}."""
    import torch
    from algames_tpu_torch.presets import flagship_unicycle
    from algames_tpu_torch.problem.residual import structured_w_owner
    out = {}
    for p in UNI_WIDE_PLAYERS:
        prob, spec = flagship_unicycle(torch.device("cpu"), torch.float64,
                                       outer=1, inner=1, p=p, N=3)
        NW = len(structured_w_owner(prob.gc))
        routes = []
        for dt in (torch.float32, torch.float64):
            try:
                routes.append(shape_route(spec, dt, NW))
            except ValueError as e:
                raise SystemExit(f"routes-wide: {e}")
        out[p] = tuple(routes)
        log(f"[routes-wide] {p} players (n={spec.n}, m={spec.m}, "
            f"d={spec.n + spec.m}, NW={NW}): K1 f32 {routes[0]}, f64 "
            f"{routes[1]}")
    return out


def phase_sweep_uni17(dev, lanes=B_SWEEP17):
    """One timed f32 chunk of the 17-player merge (``uni17_sweep_game``,
    outer 3 x inner 8) with the fused trial: its first ``lanes`` scenarios
    (x0 + 0.05 N(0, 1) from numpy seed 0), warm, counted from zero after
    the warm-up: every trajectory finite, none diverged, the first
    REF_UNI17_LANES lanes' converged share >= the reference's on the same
    lanes - 0.01 (REF_UNI17); every K1 launch on the route the shape takes,
    K2 launched at least once a KKT step, K3 not.  Then K1's and K2's device
    time a call at B=``lanes`` on the game's own operands (f32), and the
    chunk's wall with their shares of it (launches times device time a
    call).  Returns the launches, the wall and the rows of the kernels line
    (K1 by route)."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (solve_thomas_structured,
                                              solve_thomas_structured_plain)
    from algames_tpu_torch.ops.trial import trial_eval, trial_supported
    from algames_tpu_torch.utils import tree_leaves, tree_map
    tag = "sweep-uni17"
    prob, x0s = sweep_problem(uni17_sweep_game, dev)
    spec, x0s, opts = prob.spec, x0s[:lanes], prob.opts
    if not trial_supported(prob.model, spec, prob.obj, prob.gc):
        raise SystemExit(f"{tag}: the fused trial does not take the game")
    parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
        opts, outer_iter=1, inner_iter=1)), x0s[:8])
    counters = zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = parallel.solve_many(prob, x0s, method="thomas", chunk=lanes)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    launches = read_counters(counters)
    finite = bool(torch.isfinite(out.traj.x).all())
    div = float(parallel.divergence_mask(out).float().mean())
    first = dataclasses.replace(
        out, stats=tree_slice(out.stats, REF_UNI17_LANES),
        traj=tree_slice(out.traj, REF_UNI17_LANES))
    frac = float(parallel.convergence_fraction(first, opts))
    frac_all = float(parallel.convergence_fraction(out, opts))
    iters = out.stats.iter.cpu().numpy()
    _, sq, b, w_owner = k1_system(dev, lanes, 1e3, 2390, False,
                                  uni17_sweep_game, flagship_iterates)
    taken = shape_route(spec, torch.float32, len(w_owner))
    sq32, b32 = tree_map(lambda a: a.float(), sq), b.float()
    y = solve_thomas_structured(spec, sq32, b32, w_owner)
    ref = solve_thomas_structured_plain(spec, sq, b, w_owner)
    k1 = {"max_abs_err": float((y.double() - ref).abs().max()),
          "ms": cuda_ms(lambda: solve_thomas_structured(
              spec, sq32, b32, w_owner), 2),
          "plain_ms": cuda_ms(lambda: solve_thomas_structured_plain(
              spec, sq32, b32, w_owner), 1),
          "device_ms": device_ms(lambda: solve_thomas_structured(
              spec, sq32, b32, w_owner), 2, ("thomas_sq_",), 2,
              f"{tag} K1 f32 B={lanes}"),
          **bound(tensor_bytes(tree_leaves(sq32) + [b32, y]),
                  thomas_flops(spec, lanes, NW=len(w_owner))),
          "library_ms": None}
    del sq, b, sq32, b32, y, ref
    tprob, tspec, gc, traj, dtraj, alpha, reg = trial_inputs(
        uni17_sweep_game, flagship_iterates, True, dev, torch.float32, 2391,
        B=lanes)
    k2_ms = device_ms(lambda: trial_eval(tprob.model, tspec, tprob.obj, gc,
                                         traj, dtraj, alpha, reg), 5,
                      ("trial_fused_",), 1, f"{tag} K2 f32 B={lanes}")
    k1_share = k1["device_ms"] * launches["K1"] / 1e3 / el
    k2_share = k2_ms * launches["trial"] / 1e3 / el
    log(f"[{tag}] f32 {lanes} scenarios as one chunk, outer "
        f"{opts.outer_iter} x {opts.inner_iter}, fused trial: {el:.3f} s, "
        f"{lanes / el:.1f} solves/s; first {REF_UNI17_LANES} lanes converged "
        f"{frac:.4f} (reference {REF_UNI17[0]:.4f}; >= "
        f"{REF_UNI17[0] - 0.01:.4f}), all {lanes} {frac_all:.4f}; diverged "
        f"{div:.4f}, finite {finite}; stats rows {int(iters.min())}.."
        f"{int(iters.max())}; launches {launches}; device time: K1 ({taken} "
        f"route) {launches['K1']} x {k1['device_ms']:.4f} ms = "
        f"{100 * k1_share:.1f}% of the wall, K2 {launches['trial']} x "
        f"{k2_ms:.4f} ms = {100 * k2_share:.1f}%; K1 at B={lanes}: call "
        f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, bound "
        f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}), max |error| against "
        f"the f64 plain version {k1['max_abs_err']:.3e}")
    if not (finite and div == 0.0 and frac >= REF_UNI17[0] - 0.01
            and launches["K1"] > 0
            and launches[f"K1 {taken} route"] == launches["K1"]
            and launches["trial"] >= launches["K1"]
            and launches["K3"] == 0):
        raise SystemExit(f"{tag}: the chunk failed its gates")
    return {**launches, "wall_s": el, "k1_share": k1_share,
            "k2_share": k2_share, "route": taken, "k1_row": k1,
            "k2_device_ms": k2_ms}


def shape_route(spec, dtype, NW=None):
    """The forward route K1 (``NW`` w vectors) or K3 (``NW`` None) takes at
    ``spec``'s widths, as its library says."""
    from algames_tpu_torch.ops import thomas as TH
    if NW is None:
        return TH._shape_route(TH._LIB_DENSE, dtype,
                               (spec.n, spec.m, spec.p))
    return TH._shape_route(TH._LIB, dtype, (spec.n, spec.m, spec.p, NW))


def phase_beyond(dev, tag, form, seed0, B=B_BEYOND, game=quad4_game,
                 iterates=quad3_iterates, forced=BEYOND_ROUTES,
                 dense_system=None, dense_lanes=None, reps=10,
                 library_lanes=None, dtypes=("f64", "f32")):
    """K1 (``form`` "structured") or K3 ("dense": the same systems turned
    dense, or ``dense_system(dev, B, mu, seed)``'s own) on ``game``'s KKT
    systems around ``iterates`` (by default the 4-player quadrotor's,
    beyond the size classes: d=64, R=193), B lanes, mu = 1 .. 1e7, in f64
    and f32, on the route the shape takes and forced onto every other route
    that ``forced`` names by form and precision (by default BEYOND_ROUTES:
    K1 blocked, shared (f32 only) and device-memory; K3 blocked and
    device-memory); a launch on any other route is a failure.  Each
    solution gated as the quadrotor's systems are: normwise backward error
    f64 <= 1e-15 and f32 <= 1e-7, each <= 10 x the plain version's in the
    same precision, f32 forward error <= 30 x the f32 plain version's.  Then per precision and route its times (call,
    device), and per precision the plain version's and the library call's
    and the bound, and the forward kernels' occupancy.  Returns the f64
    numbers of the route the shape takes (the kernels line's), with every
    route's under "f64" and "f32" by route name, each with its max |error|
    against the f64 plain version over the mu schedule.  ``dense_lanes``:
    the systems whose dense KKT matrices the library call takes at once
    (default all it solves; fewer where those matrices would not fit the
    card together: the 9-player merge's are 413 MB a lane in f64, the
    17-player merge's 4.57 GB); ``reps``: the timed calls of each kernel;
    ``library_lanes``: the first lanes the library call solves (default all
    B: the 17-player merge's dense LU takes ~9e12 operations a lane);
    ``dtypes``: the precisions gated and timed ("f64" first: its numbers
    are the kernels line's)."""
    import torch
    from algames_tpu_torch.ops import thomas as TH
    from algames_tpu_torch.utils import tree_leaves, tree_map
    structured = form == "structured"
    kernel = TH.solve_thomas_structured if structured else TH.solve_thomas
    names = ("thomas_sq_",) if structured else ("thomas_dense_",)

    def system(mu, seed):
        if dense_system is not None:
            return (*dense_system(dev, B, mu, seed), None)
        spec, sq, b, w_owner = k1_system(dev, B, mu, seed, False, game,
                                         iterates)
        if structured:
            return spec, sq, b, w_owner
        return spec, dense_of(spec, sq, w_owner), b, None

    def solve(spec, blocks, b, w_owner, forward):
        if structured:
            return kernel(spec, blocks, b, w_owner, forward)
        return kernel(spec, blocks, b, forward)

    def plain(spec, blocks, b, w_owner):
        if structured:
            return TH.solve_thomas_structured_plain(spec, blocks, b, w_owner)
        return TH.solve_thomas_plain(spec, blocks, b)

    spec, blocks, b, w_owner = system(1.0, seed0)
    NW = len(w_owner) if structured else None
    all_dts = {"f64": torch.float64, "f32": torch.float32}
    taken = {all_dts[n]: shape_route(spec, all_dts[n], NW) for n in dtypes}
    routes = {all_dts[name]: ("auto",) + tuple(
                  r for r in forced[(form, name)]
                  if r != taken[all_dts[name]])
              for name in dtypes}
    log(f"[{tag}] routes the shape takes: "
        + ", ".join(f"{str(dt)[6:]} {r}" for dt, r in taken.items())
        + f"; timed beside them: "
        f"{ {str(dt)[6:]: r[1:] for dt, r in routes.items()} }")
    want = {}
    for dt, rs in routes.items():
        for r in rs:
            name = taken[dt] if r == "auto" else r
            want[name] = want.get(name, 0) + len(MUS)
    kkt = "K1" if structured else "K3"

    def route_launches():
        launches = read_counters(kernel_counters())
        return {r: launches[f"{kkt} {r} route"] for r in ROUTE_COUNTERS[kkt]}
    before = route_launches()
    max_abs = {"f64": {}, "f32": {}}
    for i, mu in enumerate(MUS):
        spec, blocks, b, w_owner = system(mu, seed0 + i)
        blocks32, b32 = tree_map(lambda a: a.float(), blocks), b.float()
        ref = plain(spec, blocks, b, w_owner)
        p32 = plain(spec, blocks32, b32, w_owner)
        y64 = [solve(spec, blocks, b, w_owner, r)
               for r in routes.get(torch.float64, ())]
        y32 = [solve(spec, blocks32, b32, w_owner, r)
               for r in routes.get(torch.float32, ())]
        torch.cuda.synchronize()
        bws = [float(e.max()) for e in backward_errors(
            spec, blocks, w_owner, b, (ref, p32, *y64, *y32),
            lanes=B)]
        bp64, bp32 = bws[:2]
        ep32 = float(rel_err(p32, ref).max())
        ok = True
        line = (f"[{tag}] mu={mu:.0e}: backward error plain f64 {bp64:.3e}, "
                f"f32 {bp32:.3e}; f32 plain forward {ep32:.3e}")
        for r, y, bw in zip(routes.get(torch.float64, ()), y64, bws[2:]):
            name = taken[torch.float64] if r == "auto" else r
            ok = ok and bw <= 1e-15 and bw <= 10 * bp64
            line += (f"; f64 {name} {bw:.3e} (<= 1e-15 and 10 x plain)")
            max_abs["f64"][name] = max(max_abs["f64"].get(name, 0.0),
                                       float((y - ref).abs().max()))
        for r, y, bw in zip(routes.get(torch.float32, ()), y32,
                            bws[2 + len(y64):]):
            name = taken[torch.float32] if r == "auto" else r
            e32 = float(rel_err(y, ref).max())
            ok = ok and bw <= 1e-7 and bw <= 10 * bp32 and e32 <= 30 * ep32
            max_abs["f32"][name] = max(max_abs["f32"].get(name, 0.0),
                                       float((y.double() - ref).abs().max()))
            line += (f"; f32 {name} {bw:.3e} (<= 1e-7 and 10 x plain), "
                     f"forward {e32:.3e} (<= 30 x plain)")
        log(line)
        if not ok:
            raise SystemExit(f"{tag} disagrees with its plain version at "
                             f"mu={mu}")
    after = route_launches()
    took = {r: after[r] - before[r] for r in after}
    if any(took[r] != want.get(r, 0) for r in took):
        raise SystemExit(f"{tag}: wrong forward routes ({took}; want "
                         f"{want})")

    spec, blocks, b, w_owner = system(1e3, seed0 + 99)
    out = {}
    L = library_lanes or B
    for name in dtypes:
        dtype = all_dts[name]
        bl = tree_map(lambda a: a.to(dtype), blocks)
        bb = b.to(dtype)
        plain_ms = cuda_ms(lambda: plain(spec, bl, bb, w_owner), 3)
        lib_ms, y_lib = library_solve_ms(
            spec, (dense_of(spec, tree_slice(bl, L), w_owner) if structured
                   else tree_slice(bl, L)), bb[:L], dense_lanes or L)
        per = {}
        for r in routes[dtype]:
            rname = taken[dtype] if r == "auto" else r
            ms = cuda_ms(lambda: solve(spec, bl, bb, w_owner, r), reps)
            dev_ms = device_ms(lambda: solve(spec, bl, bb, w_owner, r), reps,
                               names, 2, f"{tag} {name} {rname} route")
            y = solve(spec, bl, bb, w_owner, r)
            bnd = bound(tensor_bytes(tree_leaves(bl) + [bb, y]),
                        thomas_flops(spec, B, NW=NW or 0,
                                     dense=not structured))
            log(f"[{tag}] {name} {rname} route at B={B}: call {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms (CUDA events); device time "
                f"{dev_ms:.4f} ms (events, fwd + bwd); bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); library "
                f"(torch.linalg.solve on the dense [{L}, {spec.S}, {spec.S}]"
                f" KKT matrices of the first {L} lanes) {lib_ms:.4f} ms, "
                f"worst relative deviation "
                f"{float(rel_err(y_lib, y[:L]).max()):.3e} (not gated)")
            per[rname] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                          **bnd, "library_ms": lib_ms,
                          "max_abs_err": max_abs[name][rname]}
            if L != B:
                per[rname]["library_lanes"] = L
        out[name] = per
        if len(per) > 1:
            log(f"[{tag}] {name} device time at B={B}: " + ", ".join(
                f"{r} {v['device_ms']:.4f} ms" for r, v in per.items()))
    first = all_dts[dtypes[0]]
    out.update(out[dtypes[0]][taken[first]])
    occupancy = k1_occupancy if structured else (
        lambda t, sp, nw, *a, **k: k3_occupancy(t, sp, *a, **k))
    out["forward_kernel"] = occupancy(tag, spec, NW or 0, B, dtypes=dtypes)
    for r in ("blocked", "device", "shared"):
        dts = tuple(str(dt)[6:].replace("float", "f") for dt in routes
                    if r in routes[dt][1:])
        if dts:
            out[f"{r}_forward_kernel"] = occupancy(
                f"{tag} {r} route", spec, NW, B, r, dtypes=dts)
    return out


def phase_wide36(dev):
    """K1 at the 6-player unicycle's widths (``uni6_game``: d=36, R=145,
    beyond the size classes, no multiple of 16): ``phase_beyond`` with
    every route gated and timed at B_BEYOND lanes in f64 and f32
    (UNI6_ROUTES), then every route timed on the same f32 operands at
    B_KERNEL lanes (device time, fwd + bwd): the evidence for the route
    rule below d = 64."""
    import torch
    from algames_tpu_torch.ops.thomas import solve_thomas_structured
    from algames_tpu_torch.utils import tree_map
    phase_beyond(dev, "K1-wide36", "structured", 980, B_BEYOND, uni6_game,
                 flagship_iterates, UNI6_ROUTES)
    spec, sq, b, w_owner = k1_system(dev, B_KERNEL, 1e3, 989, False,
                                     uni6_game)
    sq32, b32 = tree_map(lambda a: a.float(), sq), b.float()
    del sq, b
    wide = {r: device_ms(lambda: solve_thomas_structured(
                spec, sq32, b32, w_owner, r), 3, ("thomas_sq_",), 2,
                f"K1-wide36 f32 {r} route B={B_KERNEL}")
            for r in UNI6_ROUTES[("structured", "f32")]}
    taken = shape_route(spec, torch.float32, len(w_owner))
    log(f"[K1-wide36] f32 device time at B={B_KERNEL} on the same operands "
        f"(fwd + bwd): " + ", ".join(f"{r} {v:.4f} ms"
                                     for r, v in wide.items())
        + f"; the shape takes the {taken} route")


def phase_solve_beyond(dev, tag, game, kkt):
    """An f64 solve of 4 scenarios of ``game`` (``quad4_game``: K1;
    ``quad4_cost_game``: K3; x0 + 0.05 N(0, 1) from numpy seed 0, outer 2 x
    inner 5) through the kernels with the fused trial (``kkt`` K1 or K3 on
    the route the shape takes, the per-player blocked route; and K4's
    quadrotor instance at n=48) against the
    same solve through the plain versions on the card (eager trial):
    per-lane iteration counts equal, x and u within WIDE_PLAIN_TOL; every
    KKT step on that route, the other KKT kernel not launched.  Returns the
    launches, with the route under "route"."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch.ops.thomas import kkt_solve_plain
    from algames_tpu_torch.problem.residual import structured_w_owner
    prob, spec = game(dev, torch.float64)
    route = shape_route(spec, torch.float64,
                        len(structured_w_owner(prob.gc)) if kkt == "K1"
                        else None)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(np.asarray(prob.x0.cpu())[None]
                          + 0.05 * rng.standard_normal((4, spec.n)),
                          dtype=torch.float64, device=dev)
    counters = zero_counters()
    t0 = time.perf_counter()
    res = agt.newton_solve(prob, x0s)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    launches = read_counters(counters)
    plain = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=False))
    res_p = agt.newton_solve(plain, x0s, method=kkt_solve_plain)
    it, it_p = res.stats.iter.cpu().numpy(), res_p.stats.iter.cpu().numpy()
    dx = float((res.traj.x - res_p.traj.x).abs().max())
    du = float((res.traj.u - res_p.traj.u).abs().max())
    other = "K3" if kkt == "K1" else "K1"
    log(f"[{tag}] f64 4-player quadrotor (d=64), 4 scenarios, {el:.2f} s: "
        f"iterations {it.tolist()} (plain versions {it_p.tolist()}), max "
        f"|dx| {dx:.3e}, max |du| {du:.3e} from the plain versions (<= "
        f"{WIDE_PLAIN_TOL:g}); {kkt} on its {route} route; launches "
        f"{launches}")
    if not ((it == it_p).all() and dx <= WIDE_PLAIN_TOL
            and du <= WIDE_PLAIN_TOL and launches[kkt] > 0
            and launches[f"{kkt} {route} route"] == launches[kkt]
            and launches["trial"] > 0 and launches[other] == 0):
        raise SystemExit(f"the {tag} solve disagrees with the plain "
                         f"versions or missed its kernels")
    return {**launches, "route": route}


def phase_sweep_beyond(dev, trial_row, tag="sweep-quad4", game=None,
                      iterates=None, reference=REF_QUAD4,
                      opt_gate=QUAD_OPT_GATE,
                      routes=BEYOND_ROUTES, seeds=(990, 1000),
                      plain_lanes=PLAIN_LANES, k4_name="K4",
                      dense_lanes=None, library=True):
    """One timed f32 chunk of ``quad4_game`` with the fused trial: its first
    CHUNK scenarios (x0 + 0.05 N(0, 1) from numpy seed 0), outer 2 x 5,
    warm, counted from zero after the warm-up: every trajectory finite,
    none diverged; the first 256 lanes' converged share (stationarity gate
    QUAD_OPT_GATE) >= the reference's own - 0.01 and their mean final
    residual norm <= 1.1 x the reference's (REF_QUAD4); the first
    PLAIN_LANES lanes' mean final residual within PLAIN_RES_TOL of the same
    solve's through the plain versions on the card, the median lane's
    within PLAIN_LANE_TOL; every K1 launch on the route the shape takes
    (f32, d=64: the per-player blocked route), K4 launched at least once a
    KKT step (so the eager trial never ran), K3 not.  Then K1 on the game's
    own systems at B=CHUNK: the route the shape takes gated over mu = 1 ..
    1e7 on the first PLAIN_LANES lanes (normwise backward error f64 <=
    1e-15 and f32 <= 1e-7, each <= 10 x the plain version's, f32 forward
    error <= 30 x the f32 plain version's), and every route that holds the
    shape timed on the same operands (f32: blocked, shared-memory,
    device-memory; f64: blocked, device-memory).  Prints the chunk's wall
    and K1's and K4's device time shares of it: launches times the device
    time per call at B=CHUNK (K4 from ``K4-quad4``, ``trial_row``).
    Returns the launches, with K1's numbers at B=CHUNK by route for the
    kernels line under "k1_rows" (f32) and "k1_f64" (device times).
    ``sweep-uni9`` runs the same on ``game`` (``uni9_game``, ``iterates``
    around its start, ``routes`` the routes that hold its shape, K1's
    systems from numpy seeds ``seeds``) at the flagship's budget 3 x 8 with
    its reference ``reference`` and stationarity gate ``opt_gate``: where the
    reference converges on some lanes the residual gate is left out (lanes
    that converged stop at residuals f32 rounding sets), and with
    ``plain_lanes`` 0 the plain versions' lanes are left out (the share
    gate holds the chunk to the reference lane by lane's outcome);
    ``dense_lanes``: the lanes of a dense KKT matrix batch of the library
    call, by default 128; without ``library`` the library
    call is not timed (the 9-player merge's dense matrices take 35 s at
    B=1024; ``K1-uni9`` times it at B=64)."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (
        kkt_solve_plain, solve_thomas_structured,
        solve_thomas_structured_plain)
    from algames_tpu_torch.ops.trial import trial_supported
    from algames_tpu_torch.utils import tree_leaves, tree_map
    game = game or quad4_game
    iterates = iterates or quad3_iterates
    prob, x0s = sweep_problem(game, dev)
    spec, x0s = prob.spec, x0s[:CHUNK]
    opts = prob.opts
    if not trial_supported(prob.model, spec, prob.obj, prob.gc):
        raise SystemExit(f"{tag}: the fused trial does not take the game")
    parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
        opts, outer_iter=1, inner_iter=2)), x0s[:64])
    counters = zero_counters()
    out, el = timed_sweep(prob, x0s, "thomas")
    launches = read_counters(counters)
    finite = bool(torch.isfinite(out.traj.x).all())
    div = float(parallel.divergence_mask(out).float().mean())
    first = dataclasses.replace(out, stats=tree_slice(out.stats, 256),
                                traj=tree_slice(out.traj, 256))
    conv_opts = dataclasses.replace(opts, eps_opt=opt_gate)
    frac = float(parallel.convergence_fraction(first, conv_opts))
    last = (first.stats.iter - 1).clamp_min(0).long()
    res = float(first.stats.res.gather(1, last[:, None]).double().mean())
    iters = out.stats.iter.cpu().numpy()
    # The first plain_lanes lanes again through the plain versions on the
    # card (plain K1, eager trial): their final residuals against the
    # kernels', lane by lane.
    plain_ok = True
    if plain_lanes:
        plain = dataclasses.replace(prob, opts=dataclasses.replace(
            opts, ls_fused=False))
        out_p = parallel.solve_batch(plain, x0s[:plain_lanes],
                                     method=kkt_solve_plain)

        def final_res(o, lanes):
            last = (o.stats.iter[:lanes] - 1).clamp_min(0).long()
            return o.stats.res[:lanes].gather(1, last[:, None])[:, 0].double()
        rk, rp = final_res(out, plain_lanes), final_res(out_p, plain_lanes)
        lane_dev = (rk - rp).abs() / rp
        mean_ratio = float(rk.mean() / rp.mean())
        same_iters = float((out.stats.iter[:plain_lanes]
                            == out_p.stats.iter).float().mean())
        log(f"[{tag}] first {plain_lanes} lanes against the plain "
            f"versions on the card: mean final residual "
            f"{float(rk.mean()):.6f} against {float(rp.mean()):.6f} (ratio "
            f"{mean_ratio:.6f}; within 1 +- {PLAIN_RES_TOL:g}); per-lane "
            f"relative deviation median {float(lane_dev.median()):.3e} (<= "
            f"{PLAIN_LANE_TOL:g}), max {float(lane_dev.max()):.3e}; "
            f"iteration counts equal on {same_iters:.4f} of the lanes")
        plain_ok = (abs(mean_ratio - 1) <= PLAIN_RES_TOL
                    and float(lane_dev.median()) <= PLAIN_LANE_TOL)
    _, sq, b, w_owner = k1_system(dev, CHUNK, 1e3, seeds[0], False, game,
                                  iterates)
    NW = len(w_owner)
    taken = shape_route(spec, torch.float32, NW)
    taken64 = shape_route(spec, torch.float64, NW)

    # The route the shape takes, gated over mu on the game's own systems.
    for i, mu in enumerate(MUS):
        _, sqm, bm, wo = k1_system(dev, CHUNK, mu, seeds[1] + i, False,
                                   game, iterates)
        y64 = solve_thomas_structured(spec, sqm, bm, wo)
        sqm32 = tree_map(lambda a: a.float(), sqm)
        y32 = solve_thomas_structured(spec, sqm32, bm.float(), wo)
        sub, bsub = tree_slice(sqm, PLAIN_LANES), bm[:PLAIN_LANES]
        sub32 = tree_map(lambda a: a.float(), sub)
        ref = solve_thomas_structured_plain(spec, sub, bsub, wo)
        p32 = solve_thomas_structured_plain(spec, sub32, bsub.float(), wo)
        bw = [float(e.max()) for e in backward_errors(
            spec, sub, wo, bsub, (ref, p32, y64[:PLAIN_LANES],
                                  y32[:PLAIN_LANES]),
            lanes=PLAIN_LANES)]
        e32 = float(rel_err(y32[:PLAIN_LANES], ref).max())
        ep32 = float(rel_err(p32, ref).max())
        log(f"[{tag}] K1 {taken} route at B={CHUNK}, mu={mu:.0e}, "
            f"first {PLAIN_LANES} lanes: backward error f64 {bw[2]:.3e} "
            f"(plain {bw[0]:.3e}; <= 1e-15 and 10 x plain), f32 {bw[3]:.3e} "
            f"(plain {bw[1]:.3e}; <= 1e-7 and 10 x plain); f32 forward "
            f"{e32:.3e} (plain {ep32:.3e}; <= 30 x plain)")
        if not (bw[2] <= 1e-15 and bw[2] <= 10 * bw[0] and bw[3] <= 1e-7
                and bw[3] <= 10 * bw[1] and e32 <= 30 * ep32):
            raise SystemExit(f"{tag}: K1 disagrees with its plain "
                             f"version at mu={mu}")
        del sqm, sqm32, y64, y32

    # Every route that holds the shape, timed on the same operands: K1's
    # rows of the kernels line at the sweep's own batch (call, device time,
    # max |error| against the f64 plain version by route; the plain version,
    # bound and library call once).
    sq32, b32 = tree_map(lambda a: a.float(), sq), b.float()
    ref = solve_thomas_structured_plain(spec, sq, b, w_owner)
    common = {
        "plain_ms": cuda_ms(lambda: solve_thomas_structured_plain(
            spec, sq32, b32, w_owner), 2),
        **bound(tensor_bytes(tree_leaves(sq32) + [b32, ref.float()]),
                thomas_flops(spec, CHUNK, NW=NW))}
    common["library_ms"], y_lib = (library_solve_ms(
        spec, dense_of(spec, sq32, w_owner), b32, dense_lanes or 128)
        if library else (None, None))
    rows = {}
    for r in routes[("structured", "f32")]:
        y = solve_thomas_structured(spec, sq32, b32, w_owner, r)
        rows[r] = {
            "max_abs_err": float((y.double() - ref).abs().max()),
            "ms": cuda_ms(lambda: solve_thomas_structured(
                spec, sq32, b32, w_owner, r), 3),
            "device_ms": device_ms(lambda: solve_thomas_structured(
                spec, sq32, b32, w_owner, r), 3, ("thomas_sq_",), 2,
                f"{tag} K1 f32 {r} route B={CHUNK}"),
            **common}
        log(f"[{tag}] K1 f32 {r} route at B={CHUNK}: call "
            f"{rows[r]['ms']:.4f} ms, device time {rows[r]['device_ms']:.4f}"
            f" ms; plain {common['plain_ms']:.4f} ms (CUDA events); bound "
            f"{common['bound_ms']:.4f} ms ({common['bound_by']}); "
            + (f"library (torch.linalg.solve on the dense KKT matrices, "
               f"{dense_lanes or 128} lanes a call) "
               f"{common['library_ms']:.4f} ms, worst relative deviation "
               f"{float(rel_err(y_lib, y).max()):.3e} (not gated); "
               if library else "library not timed here; ")
            + f"max |error| against the f64 plain version "
            f"{rows[r]['max_abs_err']:.3e}")
    del y_lib, ref
    f64 = {}
    for r in routes[("structured", "f64")]:
        f64[r] = {"ms": cuda_ms(lambda: solve_thomas_structured(
                      spec, sq, b, w_owner, r), 2),
                  "device_ms": device_ms(lambda: solve_thomas_structured(
                      spec, sq, b, w_owner, r), 3, ("thomas_sq_",), 2,
                      f"{tag} K1 f64 {r} route B={CHUNK}")}
    log(f"[{tag}] K1 device time at B={CHUNK} on the same operands: "
        f"f32 " + ", ".join(f"{r} {v['device_ms']:.4f} ms"
                            for r, v in rows.items())
        + "; f64 " + ", ".join(f"{r} {v['device_ms']:.4f} ms"
                               for r, v in f64.items()))
    k1_ms = rows[taken]["device_ms"]
    k1_share = k1_ms * launches["K1"] / 1e3 / el
    k4_share = trial_row["device_ms"] * launches["trial"] / 1e3 / el
    res_gate = reference[0] == 0
    log(f"[{tag}] f32 {CHUNK} scenarios as one chunk, outer "
        f"{opts.outer_iter} x {opts.inner_iter}, fused trial: {el:.3f} s, "
        f"{CHUNK / el:.1f} solves/s; first 256 lanes converged (opt gate "
        f"{opt_gate:g}) {frac:.4f} (reference {reference[0]:.4f}; >= "
        f"{reference[0] - 0.01:.4f}), mean final residual {res:.6g} "
        f"(reference {reference[1]:.6g}; "
        + ("<= 1.1 x" if res_gate else "not gated")
        + f"); diverged {div:.4f}, finite {finite}; stats rows "
        f"{int(iters.min())}..{int(iters.max())}; launches {launches}; "
        f"device time: K1 ({taken} route) {launches['K1']} x {k1_ms:.4f} ms"
        f" = {100 * k1_share:.1f}% of the wall, {k4_name} "
        f"{launches['trial']} x {trial_row['device_ms']:.4f} ms = "
        f"{100 * k4_share:.1f}%")
    if not (finite and div == 0.0 and frac >= reference[0] - 0.01
            and (res <= 1.1 * reference[1] or not res_gate) and plain_ok
            and launches["K1"] > 0
            and launches[f"K1 {taken} route"] == launches["K1"]
            and launches["trial"] >= launches["K1"]
            and launches["K3"] == 0):
        raise SystemExit(f"{tag}: the chunk failed its gates")
    return {**launches, "wall_s": el, "k1_share": k1_share,
            "k4_share": k4_share, "route": taken, "route_f64": taken64,
            "k1_rows": rows, "k1_f64": f64}


def phase_sweep_quad4_dense(dev, k4_cost):
    """One timed f32 chunk of ``quad4_cost_game`` with the fused trial: its
    first CHUNK scenarios (x0 + 0.05 N(0, 1) from numpy seed 0), outer 2 x
    5, warm, counted from zero after the warm-up: every trajectory finite,
    none diverged; every K3 launch on the route the shape takes (f32, d=64:
    the per-player blocked route), K1 never launched, K4 launched; the first
    PLAIN_LANES lanes' mean final residual within PLAIN_RES_TOL of the same
    solve's through the plain versions on the card (the median lane's
    deviation printed).  Then K3 on the game's own systems at B=CHUNK
    (dense Q_i with the collision-cost pairs): the route the shape takes
    gated at mu = 1, 1e3, 1e7 on the first PLAIN_LANES lanes (the
    quadrotor's backward- and forward-error gates), and timed beside the
    device-memory route on the same operands in f32 and f64.  Prints the
    chunk's wall and K3's and K4's device time shares of it: launches times
    the device time per call at B=CHUNK (K4 from ``K4-quad4-cost``,
    ``k4_cost``).  Returns the launches, with K3's f32 numbers at B=CHUNK
    by route under "k3_rows" and the f64 device times under "k3_f64"."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (kkt_solve_plain, solve_thomas,
                                              solve_thomas_plain)
    from algames_tpu_torch.ops.trial import trial_supported
    from algames_tpu_torch.utils import tree_leaves, tree_map
    prob, x0s = sweep_problem(quad4_cost_game, dev)
    spec, x0s = prob.spec, x0s[:CHUNK]
    opts = prob.opts
    if not trial_supported(prob.model, spec, prob.obj, prob.gc):
        raise SystemExit("the fused trial does not take the 4-player "
                         "quadrotor with collision-cost pairs")
    parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
        opts, outer_iter=1, inner_iter=2)), x0s[:64])
    counters = zero_counters()
    out, el = timed_sweep(prob, x0s, "thomas")
    launches = read_counters(counters)
    finite = bool(torch.isfinite(out.traj.x).all())
    div = float(parallel.divergence_mask(out).float().mean())
    iters = out.stats.iter.cpu().numpy()
    plain = dataclasses.replace(prob, opts=dataclasses.replace(
        opts, ls_fused=False))
    out_p = parallel.solve_batch(plain, x0s[:PLAIN_LANES],
                                 method=kkt_solve_plain)

    def final_res(o, lanes):
        last = (o.stats.iter[:lanes] - 1).clamp_min(0).long()
        return o.stats.res[:lanes].gather(1, last[:, None])[:, 0].double()
    rk, rp = final_res(out, PLAIN_LANES), final_res(out_p, PLAIN_LANES)
    lane_dev = (rk - rp).abs() / rp
    mean_ratio = float(rk.mean() / rp.mean())
    log(f"[sweep-quad4-dense] first {PLAIN_LANES} lanes against the plain "
        f"versions on the card: mean final residual {float(rk.mean()):.6f} "
        f"against {float(rp.mean()):.6f} (ratio {mean_ratio:.6f}; within "
        f"1 +- {PLAIN_RES_TOL:g}); per-lane relative deviation median "
        f"{float(lane_dev.median()):.3e}, max {float(lane_dev.max()):.3e}")
    del out_p
    taken = shape_route(spec, torch.float32)
    taken64 = shape_route(spec, torch.float64)

    def system(mu, seed):
        return k3_system(dev, CHUNK, mu, seed, False, None, quad4_cost_game,
                         quad3_iterates)[1:]

    # The route the shape takes, gated over mu on the game's own systems.
    for i, mu in enumerate((1.0, 1e3, 1e7)):
        jb, b = system(mu, 1200 + i)
        y64 = solve_thomas(spec, jb, b)
        y32 = solve_thomas(spec, tree_map(lambda a: a.float(), jb),
                           b.float())
        sub, bsub = tree_slice(jb, PLAIN_LANES), b[:PLAIN_LANES]
        sub32 = tree_map(lambda a: a.float(), sub)
        ref = solve_thomas_plain(spec, sub, bsub)
        p32 = solve_thomas_plain(spec, sub32, bsub.float())
        bw = [float(e.max()) for e in backward_errors(
            spec, sub, None, bsub, (ref, p32, y64[:PLAIN_LANES],
                                    y32[:PLAIN_LANES]), lanes=PLAIN_LANES)]
        e32 = float(rel_err(y32[:PLAIN_LANES], ref).max())
        ep32 = float(rel_err(p32, ref).max())
        log(f"[sweep-quad4-dense] K3 {taken} route at B={CHUNK}, "
            f"mu={mu:.0e}, first {PLAIN_LANES} lanes: backward error f64 "
            f"{bw[2]:.3e} (plain {bw[0]:.3e}; <= 1e-15 and 10 x plain), f32 "
            f"{bw[3]:.3e} (plain {bw[1]:.3e}; <= 1e-7 and 10 x plain); f32 "
            f"forward {e32:.3e} (plain {ep32:.3e}; <= 30 x plain)")
        if not (bw[2] <= 1e-15 and bw[2] <= 10 * bw[0] and bw[3] <= 1e-7
                and bw[3] <= 10 * bw[1] and e32 <= 30 * ep32):
            raise SystemExit(f"sweep-quad4-dense: K3 disagrees with its "
                             f"plain version at mu={mu}")
        del jb, b, y64, y32

    # Every route that holds the shape, timed on the same operands: K3's
    # rows of the kernels line at the sweep's own batch.
    jb, b = system(1e3, 1210)
    jb32, b32 = tree_map(lambda a: a.float(), jb), b.float()
    ref = solve_thomas_plain(spec, jb, b)
    common = {
        "plain_ms": cuda_ms(lambda: solve_thomas_plain(spec, jb32, b32), 2),
        **bound(tensor_bytes(tree_leaves(jb32) + [b32, ref.float()]),
                thomas_flops(spec, CHUNK, dense=True))}
    common["library_ms"], y_lib = library_solve_ms(spec, jb32, b32, 128)
    rows = {}
    for r in BEYOND_ROUTES[("dense", "f32")]:
        y = solve_thomas(spec, jb32, b32, r)
        rows[r] = {
            "max_abs_err": float((y.double() - ref).abs().max()),
            "ms": cuda_ms(lambda: solve_thomas(spec, jb32, b32, r), 3),
            "device_ms": device_ms(lambda: solve_thomas(spec, jb32, b32, r),
                                   3, ("thomas_dense_",), 2,
                                   f"sweep-quad4-dense K3 f32 {r} route "
                                   f"B={CHUNK}"),
            **common}
        log(f"[sweep-quad4-dense] K3 f32 {r} route at B={CHUNK}: call "
            f"{rows[r]['ms']:.4f} ms, device time {rows[r]['device_ms']:.4f}"
            f" ms; plain {common['plain_ms']:.4f} ms (CUDA events); bound "
            f"{common['bound_ms']:.4f} ms ({common['bound_by']}); library "
            f"(torch.linalg.solve on the dense KKT matrices, 128 lanes a "
            f"call) {common['library_ms']:.4f} ms, worst relative deviation "
            f"{float(rel_err(y_lib, y).max()):.3e} (not gated); max |error| "
            f"against the f64 plain version {rows[r]['max_abs_err']:.3e}")
    del y_lib, ref, jb32, b32
    f64 = {r: {"device_ms": device_ms(
        lambda: solve_thomas(spec, jb, b, r), 3, ("thomas_dense_",), 2,
        f"sweep-quad4-dense K3 f64 {r} route B={CHUNK}")}
        for r in BEYOND_ROUTES[("dense", "f64")]}
    log(f"[sweep-quad4-dense] K3 device time at B={CHUNK} on the same "
        f"operands: f32 " + ", ".join(f"{r} {v['device_ms']:.4f} ms"
                                      for r, v in rows.items())
        + "; f64 " + ", ".join(f"{r} {v['device_ms']:.4f} ms"
                               for r, v in f64.items()))
    del jb, b
    k3_ms = rows[taken]["device_ms"]
    k3_share = k3_ms * launches["K3"] / 1e3 / el
    k4_share = k4_cost["device_ms"] * launches["trial"] / 1e3 / el
    log(f"[sweep-quad4-dense] f32 {CHUNK} scenarios of the 4-player "
        f"quadrotor with collision-cost pairs as one chunk, outer "
        f"{opts.outer_iter} x {opts.inner_iter}, fused trial: {el:.3f} s, "
        f"{CHUNK / el:.1f} solves/s; diverged {div:.4f}, finite {finite}; "
        f"stats rows {int(iters.min())}..{int(iters.max())}; launches "
        f"{launches}; device time: K3 ({taken} route) {launches['K3']} x "
        f"{k3_ms:.4f} ms = {100 * k3_share:.1f}% of the wall, K4 "
        f"{launches['trial']} x {k4_cost['device_ms']:.4f} ms = "
        f"{100 * k4_share:.1f}%")
    if not (finite and div == 0.0 and abs(mean_ratio - 1) <= PLAIN_RES_TOL
            and launches["K3"] > 0
            and launches[f"K3 {taken} route"] == launches["K3"]
            and launches["trial"] > 0 and launches["K1"] == 0):
        raise SystemExit("the 4-player quadrotor chunk with collision-cost "
                         "pairs failed its gates")
    return {**launches, "wall_s": el, "k3_share": k3_share,
            "k4_share": k4_share, "route": taken, "route_f64": taken64,
            "k3_rows": rows, "k3_f64": f64}


def hetero_game(dev, dtype, outer=7, inner=20):
    """The heterogeneous double-integrator game ``hetero2_N8`` of the
    reference package's tests (``tests/test_hetero.py``): two planar
    players, the first actuating both axes and the second only x
    (mi = (2, 1)), player-blocked layout, N=8, pairwise collision avoidance
    (r = 0.15) and control bounds of +-2; stationarity gate 1e-2 in f32,
    1e-3 in f64."""
    import torch
    from algames_tpu_torch.constraints import sets as S
    from algames_tpu_torch.core.spec import spec_from_model
    from algames_tpu_torch.models.hetero import hetero_double_integrator_game
    from algames_tpu_torch.objective.objective import game_objective
    from algames_tpu_torch.problem.options import Options
    from algames_tpu_torch.problem.problem import game_problem
    model = hetero_double_integrator_game(mi=(2, 1))
    N, p = 8, 2
    spec = spec_from_model(model, N, 0.1)
    obj = game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(k) for k in spec.mi],
        xf=[np.asarray([1.0, 0.4 * (p - 1 - i), 0.0, 0.0]) for i in range(p)],
        uf=[np.zeros(k) for k in spec.mi], dtype=dtype, device=dev)
    gc = S.game_constraints(spec, dtype=dtype, device=dev)
    gc = S.add_collision_avoidance(spec, gc, 0.15)
    gc = S.add_control_bound(spec, gc, 2 * np.ones(spec.m),
                             -2 * np.ones(spec.m))
    x0 = torch.as_tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0],
                         dtype=dtype, device=dev)
    opts = Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=1e-2 if dtype == torch.float32 else 1e-3)
    return game_problem(N, 0.1, x0, model, opts, obj, gc), spec


def highway_game(dev, dtype, N=20):
    """BASELINE config 3, the 3-player highway of
    ``benchmarks/bench_mpc.py::make_problem``: unicycles in parallel lanes,
    N=20, dt 0.1, Q diag (0, 5, 1, 2) (lane, heading and speed tracking), R
    0.1, targets at x = 10 in lanes y = 0.4 i with speeds 0.8 + 0.3 i,
    pairwise collision avoidance (r = 0.1), controls within +-3;
    ``Options(outer_iter=3, inner_iter=8, shift=1, dual_reset=False)`` (the
    reference's gates, 1e-3 on all four violations; upsampling 2).  ``N``
    cuts the horizon for the CPU tests."""
    import torch
    from algames_tpu_torch.constraints import sets as S
    from algames_tpu_torch.core.spec import spec_from_model
    from algames_tpu_torch.models.unicycle import unicycle_game
    from algames_tpu_torch.objective.objective import game_objective
    from algames_tpu_torch.problem.options import Options
    from algames_tpu_torch.problem.problem import game_problem
    p, dt = 3, 0.1
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec, Q=[np.asarray([0.0, 5.0, 1.0, 2.0])] * p,
        R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([10.0, 0.4 * i, 0.0, 0.8 + 0.3 * i]) for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=dev)
    gc = S.game_constraints(spec, dtype=dtype, device=dev)
    gc = S.add_collision_avoidance(spec, gc, HIGHWAY_R)
    gc = S.add_control_bound(spec, gc, HIGHWAY_U * np.ones(2 * p),
                             -HIGHWAY_U * np.ones(2 * p))
    x0 = torch.as_tensor(np.concatenate([[0.0, -0.5, -1.0], 0.4 * np.arange(p),
                                         np.zeros(p), 0.8 + 0.3 * np.arange(p)]),
                         dtype=dtype, device=dev)
    opts = Options(outer_iter=3, inner_iter=8, shift=1, dual_reset=False)
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def spike_game(dev, dtype, N=257):
    """The long-horizon game of ``benchmarks/bench_spike.py::make_problem``:
    a 2-player unicycle overtaking game, dt 0.05, Q 1, R 0.1, targets at
    x = 6 in lanes y = 0.3 i at speed 0.5, pairwise collision avoidance
    (r = 0.1), controls within +-2, ``Options(outer_iter=2, inner_iter=6)``
    with the stationarity gate 1e-2 in f32 (1e-3 in f64); N in {65, 257,
    1025} there (T = 64, 256, 1024; W = 28)."""
    import torch
    from algames_tpu_torch.constraints import sets as S
    from algames_tpu_torch.core.spec import spec_from_model
    from algames_tpu_torch.models.unicycle import unicycle_game
    from algames_tpu_torch.objective.objective import game_objective
    from algames_tpu_torch.problem.options import Options
    from algames_tpu_torch.problem.problem import game_problem
    p, dt = 2, 0.05
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([6.0, 0.3 * i, 0.0, 0.5]) for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=dev)
    gc = S.game_constraints(spec, dtype=dtype, device=dev)
    gc = S.add_collision_avoidance(spec, gc, 0.1)
    gc = S.add_control_bound(spec, gc, 2 * np.ones(spec.m),
                             -2 * np.ones(spec.m))
    opts = Options(outer_iter=2, inner_iter=6,
                   eps_opt=1e-2 if dtype == torch.float32 else 1e-3)
    x0 = torch.as_tensor([0.0, -0.5, 0.0, 0.3, 0.0, 0.0, 0.6, 0.4],
                         dtype=dtype, device=dev)
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def ring3_eq_game(dev, dtype, N=20, outer=7, inner=20):
    """``ring3_eq_N20``: the flagship (``flagship_unicycle``) with player 0
    held on a ring road by an equality block: the circle of radius 4
    centred at (0, -4), through its start and tangent to its heading
    (``tests/torch_goldens.py::ring3_eq_problem``)."""
    from algames_tpu_torch.constraints import sets as S
    from algames_tpu_torch.presets import flagship_unicycle
    prob, spec = flagship_unicycle(dev, dtype, outer=outer, inner=inner, N=N)
    gc = S.add_circle_constraint(spec, prob.gc, [0.0], [-4.0], [4.0], i=0)
    ring = dataclasses.replace(gc.state_blocks[-1], sense="eq")
    gc = S.set_constraint_params(dataclasses.replace(
        gc, state_blocks=gc.state_blocks[:-1] + (ring,)), prob.opts)
    return dataclasses.replace(prob, gc=gc), spec


def crossing_game(dev, dtype, p=3, N=20, r=0.25):
    """The game of ``examples/nullspace_example.py``: unicycles with
    crossing targets (x = 2, y = 0.4 (p - 1 - 2i), speed 0.3), Q = 1,
    R = 0.1, pairwise collision avoidance of radius ``r``, ``Options()``;
    its collision rows are active at the equilibrium
    (``tests/reference_fractions.py::crossing_problem``)."""
    import torch
    from algames_tpu_torch.constraints import sets as S
    from algames_tpu_torch.core.spec import spec_from_model
    from algames_tpu_torch.models.unicycle import unicycle_game
    from algames_tpu_torch.objective.objective import game_objective
    from algames_tpu_torch.problem.options import Options
    from algames_tpu_torch.problem.problem import game_problem
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, 0.1)
    obj = game_objective(
        spec, Q=[np.ones(4)] * p, R=[0.1 * np.ones(2)] * p,
        xf=[np.asarray([2.0, 0.4 * (p - 1 - i) - 0.4 * i, 0.0, 0.3])
            for i in range(p)],
        uf=[np.zeros(2)] * p, dtype=dtype, device=dev)
    gc = S.add_collision_avoidance(
        spec, S.game_constraints(spec, dtype=dtype, device=dev), r)
    x0 = torch.as_tensor(np.concatenate([np.zeros(p), 0.4 * np.arange(p),
                                         np.zeros(p), 0.3 * np.ones(p)]),
                         dtype=dtype, device=dev)
    return game_problem(N, 0.1, x0, model, Options(), obj, gc), spec


def invariance_ratio(prob, traj, v, eps, rng):
    """|r(z + eps w) - r(z)| / |r(z + eps v) - r(z)| for the extended
    residual (``active_set.extended_residual`` with the appended duals) at
    ``traj`` (one lane), v [Sh] a nullspace vector and w a random direction
    of equal norm (numpy ``rng``): first-order invariance along v makes it
    O(1 / eps)."""
    import torch
    from algames_tpu_torch.active_set import extended_residual
    from algames_tpu_torch.core.traj import unpack_step, update_traj
    spec = prob.spec
    S, T = spec.S, spec.T
    nop = spec.p * (spec.p - 1)

    def step(d):
        dtraj = unpack_step(spec, d[None, :S])
        t = update_traj(traj, torch.full((1,), eps, dtype=d.dtype,
                                         device=d.device), dtraj)
        return extended_residual(prob, t, eps * d[S:].reshape(1, T, nop))
    r0 = extended_residual(prob, traj, v.new_zeros((1, T, nop)))
    w = torch.as_tensor(rng.standard_normal(v.shape[0]), dtype=v.dtype,
                        device=v.device)
    w = w * (v.norm() / w.norm())
    return float((step(w) - r0).norm() / (step(v) - r0).norm())


def phase_trial(tag, inputs, dev):
    """The fused trial (K2 or K4) against its plain version on
    ``inputs(dev, dtype)``: tn and every carried leaf, f64 <= 1e-12 and f32 <=
    1e-5 relative; then its times and bound in f32."""
    import torch
    from algames_tpu_torch.ops.trial import (instance_name, trial_eval,
                                             trial_eval_plain,
                                             trial_occupancy,
                                             trial_supported)
    from algames_tpu_torch.utils import tree_leaves

    max_abs32 = 0.0
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        prob, spec, gc, traj, dtraj, alpha, reg = inputs(dev, dtype)
        if not trial_supported(prob.model, spec, prob.obj, gc):
            raise SystemExit(f"the {tag} inputs lie outside the fused trial")
        args = (prob.model, spec, prob.obj, gc, traj, dtraj, alpha, reg)
        launches = trial_eval.launches
        tn_k, lite_k = trial_eval(*args)
        if trial_eval.launches != launches + 1:
            raise SystemExit(f"the {tag} wrapper did not launch its kernel")
        tn_p, lite_p = trial_eval_plain(*args)
        torch.cuda.synchronize()
        errs = [float(rel_err(tn_k[:, None], tn_p[:, None]).max())]
        abs_errs = [float((tn_k - tn_p).abs().max())]
        for a, r in zip(tree_leaves(lite_k), tree_leaves(lite_p)):
            errs.append(float(rel_err(a, r).max()))
            abs_errs.append(float((a - r).abs().max()))
        name = str(dtype).split(".")[-1]
        log(f"[{tag}] {name}: worst relative error over tn and "
            f"{len(errs) - 1} carried leaves {max(errs):.3e} (<= {tol:g}), "
            f"max abs {max(abs_errs):.3e}")
        if not max(errs) <= tol:
            raise SystemExit(f"{tag} disagrees with its plain version in "
                             f"{name}")
        if dtype == torch.float32:
            max_abs32 = max(abs_errs)
            ms = cuda_ms(lambda: trial_eval(*args), 20)
            plain_ms = cuda_ms(lambda: trial_eval_plain(*args), 5)
            dev_ms = device_ms(lambda: trial_eval(*args), 20,
                               ("trial_fused_",), 1, tag)
            bnd = trial_bound(*args, lite_k, tn_k)
            lanes = trial_occupancy(prob.model, spec, prob.obj, dtype,
                                    len(gc.state_blocks),
                                    len(gc.control_blocks))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            B = alpha.shape[0]
            log(f"[{tag}] kernel instance {instance_name(prob.model, spec)}: "
                f"{lanes} lanes per SM in f32, "
                f"{-(-B // (sms * lanes))} wave(s) at B={B}")
            log(f"[{tag}] f32 B={B}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms (per call, CUDA events); kernel device "
                f"time {dev_ms:.4f} ms (events); bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); no single "
                f"PyTorch call computes the trial")
    return {"max_abs_err": max_abs32, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, **bnd, "library_ms": None}


def trial_bound(model, spec, obj, gc, traj, dtraj, alpha, reg, lite, tn):
    """Bound of one fused trial: iterate, step, per-lane scalars and the AL
    state read once (a state bound's only at its finite rows, the others
    being masked out), the carried point and tn written once."""
    from algames_tpu_torch.constraints.kernels import BoundParams
    from algames_tpu_torch.utils import tree_leaves
    nbytes = tensor_bytes(tree_leaves((traj, dtraj)) + [alpha, reg])
    for b in gc.state_blocks + gc.control_blocks:
        share = 1.0
        if b.is_state and isinstance(b.params, BoundParams):
            share = sum(b.params.mask) / len(b.params.mask)
        nbytes += share * tensor_bytes([b.lam, b.mu])
    nbytes += tensor_bytes(tree_leaves(lite) + [tn])
    return bound(nbytes, trial_flops(spec, obj, gc, alpha.shape[0]))


def phase_golden(tag, preset, golden, kernels, dev, atol=(1e-8, 1e-8),
                 plain_tol=None):
    """One f64 solve of ``preset`` through the kernels against the frozen
    solution ``golden`` (``load_golden``): the same iteration count, x and u
    within
    ``atol``, and only the game's own kernels (``kernels`` = (KKT wrapper,
    other KKT wrapper)) launched, with the fused trial, and K1 never on its
    shared-memory route.  With ``plain_tol``,
    the same solve through the plain versions on the card too: the same
    iteration count, x and u within ``plain_tol`` of the kernels'."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch.ops.thomas import (kkt_solve_plain,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval

    kkt, other = kernels
    gold = load_golden(golden)
    prob, _ = preset(dev, torch.float64)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    counters = (kkt, trial_eval, other)
    before = [c.launches for c in counters]
    wide0 = solve_thomas_structured.wide_launches
    t0 = time.perf_counter()
    res = agt.newton_solve(prob)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    ran = [c.launches - b for c, b in zip(counters, before)]
    wide = solve_thomas_structured.wide_launches - wide0
    it = int(res.stats.iter[0])
    x, u = res.traj.x[0].cpu().numpy(), res.traj.u[0].cpu().numpy()
    dx = float(np.abs(x - gold["x"]).max())
    du = float(np.abs(u - gold["u"]).max())
    log(f"[{tag}] f64 kernel path: iter {it} (golden {int(gold['iter'])}), "
        f"max |dx| {dx:.3e} (<= {atol[0]:g}), max |du| {du:.3e} (<= "
        f"{atol[1]:g}), {el:.2f} s; launches: KKT {ran[0]}, trial {ran[1]}, "
        f"the other KKT kernel {ran[2]}, K1 on its shared-memory route {wide}")
    ok = (it == int(gold["iter"]) and dx <= atol[0] and du <= atol[1]
          and ran[0] > 0 and ran[1] > 0 and ran[2] == 0 and wide == 0)
    if plain_tol is not None:
        plain = dataclasses.replace(
            prob, opts=dataclasses.replace(prob.opts, ls_fused=False))
        res_p = agt.newton_solve(plain, method=kkt_solve_plain)
        it_p = int(res_p.stats.iter[0])
        dxp = float(np.abs(x - res_p.traj.x[0].cpu().numpy()).max())
        dup = float(np.abs(u - res_p.traj.u[0].cpu().numpy()).max())
        log(f"[{tag}] f64 plain versions on the card: iter {it_p}, max |dx| "
            f"{dxp:.3e}, max |du| {dup:.3e} from the kernel path (<= "
            f"{plain_tol:g})")
        ok = ok and it_p == it and dxp <= plain_tol and dup <= plain_tol
    if not ok:
        raise SystemExit(f"the f64 kernel-path solve misses {golden}")


def sweep_problem(preset, dev, **budget):
    """An f32 sweep of ``preset`` with the fused trial: N_SWEEP scenarios,
    x0 + 0.05 N(0, 1) from numpy seed 0."""
    import torch
    prob, spec = preset(dev, torch.float32, **budget)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    rng = np.random.default_rng(0)
    x0s = (np.asarray(prob.x0.cpu(), np.float64)[None]
           + 0.05 * rng.standard_normal((N_SWEEP, spec.n)))
    return prob, torch.as_tensor(x0s, dtype=torch.float32, device=dev)


def timed_sweep(prob, x0s, method):
    import torch
    from algames_tpu_torch import parallel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = parallel.solve_many(prob, x0s, method=method, chunk=CHUNK)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sweep(dev):
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (solve_thomas,
                                              solve_thomas_structured,
                                              solve_thomas_structured_plain)
    from algames_tpu_torch.ops.trial import trial_eval
    from algames_tpu_torch.presets import flagship_unicycle

    prob, x0s = sweep_problem(flagship_unicycle, dev, outer=3, inner=8)
    parallel.solve_batch(prob, x0s[:64])             # warm-up, untimed
    solve_thomas_structured.launches = 0
    solve_thomas_structured.wide_launches = 0
    trial_eval.launches = 0
    solve_thomas.launches = 0
    out, el = timed_sweep(prob, x0s, "thomas")
    launches = {"K1": solve_thomas_structured.launches,
                "K2": trial_eval.launches, "K3": solve_thomas.launches,
                "K1 shared route": solve_thomas_structured.wide_launches}
    sps = N_SWEEP / el
    iters = out.stats.iter.cpu().numpy()
    cap = prob.opts.outer_iter * prob.opts.inner_iter
    hist = np.bincount(iters, minlength=cap + 2)
    frac = float(parallel.convergence_fraction(out, prob.opts))
    div = float(parallel.divergence_mask(out).float().mean())
    finite = bool(torch.isfinite(out.traj.x).all())
    log(f"[sweep] f32 {N_SWEEP} scenarios, chunk {CHUNK}, outer 3 x 8, "
        f"kernels: {el:.3f} s, {sps:.1f} solves/s")
    log(f"[sweep] converged {frac:.4f}, diverged {div:.4f}, finite {finite}, "
        f"launches {launches}")
    log("[sweep] iteration histogram (stats rows per lane): "
        + " ".join(f"{i}:{c}" for i, c in enumerate(hist) if c))
    if not (finite and frac >= 0.99 and div == 0.0
            and launches["K1"] > 0 and launches["K2"] > 0
            and launches["K3"] == 0 and launches["K1 shared route"] == 0):
        raise SystemExit("the flagship sweep failed its gates")

    plain = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=False))
    parallel.solve_batch(plain, x0s[:64], method=solve_thomas_structured_plain)
    # One chunk, to keep the script's time as the games grew (PERF.md).
    out_p, el_p = timed_sweep(plain, x0s[:CHUNK],
                              solve_thomas_structured_plain)
    frac_p = float(parallel.convergence_fraction(out_p, prob.opts))
    log(f"[sweep] one {CHUNK}-lane chunk with the plain versions on the card: "
        f"{el_p:.3f} s, {CHUNK / el_p:.1f} solves/s, converged {frac_p:.4f}")

    profile_chunk("profile", prob, x0s[:CHUNK], ("thomas_sq_",
                                                 "trial_fused_"))
    return launches


def profile_chunk(tag, prob, x0s, names, solve=None, what=None):
    """Host/launch overhead of the eager per-iteration loop: device time of
    one chunk (``solve()``, default ``parallel.solve_batch(prob, x0s)``;
    ``what`` names it in the log) against its wall time, under the
    profiler.  Only device-side events count (a CPU op's own device time
    repeats its kernels' time), so the profiler records only those: host
    events took most of its processing time."""
    import torch
    from algames_tpu_torch import parallel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if solve is None:
            parallel.solve_batch(prob, x0s)
        else:
            solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    trace_s = time.perf_counter() - t0 - wall
    dev_us = sum(e.self_device_time_total for e in evs)
    n_kern = sum(e.count for e in evs)
    what = what or (f"one {x0s.shape[0]}-lane chunk at outer "
                    f"{prob.opts.outer_iter} x {prob.opts.inner_iter}")
    log(f"[{tag}] {what}: wall "
        f"{wall * 1e3:.1f} ms "
        f"under the profiler, device busy {dev_us / 1e3:.1f} ms "
        f"({100 * dev_us / 1e6 / wall:.1f}%), {n_kern} device kernels and "
        f"copies; the profiler's trace processing {trace_s:.1f} s")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)
    for e in top[:6] + [e for e in top[6:] if any(n in e.key for n in names)]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"x{e.count:6d}  {e.key[:70]}")


def crowded_iterates(spec, B, rng, dev, dtype, v_band=(0.3, 1.5)):
    """Roundabout iterates: controls around the golden trajectory's, every
    player's position drawn near the island (so that the collision
    constraints and costs and the island circle are active in many lanes)
    and speeds drawn uniformly from ``v_band`` (default: from the entry
    speeds up to the speed limit).  Near zero speed a unicycle loses its
    heading's controllability and the KKT systems become ill-conditioned:
    the K3 phase reports that band ungated."""
    import torch
    from algames_tpu_torch.core.traj import PrimalDual
    gold = np.load(HERE / "tests" / "golden" / "round4_N40.npz")
    x = gold["x"][None] + 0.1 * rng.standard_normal((B, spec.N, spec.n))
    pos = [i for ix in spec.px for i in ix]
    x[:, :, pos] = 0.3 * rng.standard_normal((B, spec.N, len(pos)))
    speed = [spec.pz[i][3] for i in range(spec.p)]
    x[:, :, speed] = rng.uniform(*v_band, (B, spec.N, spec.p))
    u = gold["u"][None] + 0.3 * rng.standard_normal((B, spec.T, spec.m))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return PrimalDual(x=t(x), u=t(u), lam=t(0.3 * rng.standard_normal(
        (B, spec.p, spec.T, spec.n))))


def k3_system(dev, B, mu, seed, penalize_rows=False, v_band=(0.3, 1.5),
              preset=None, iterates=None):
    """KKT systems (f64) with dense Hessians assembled by the port from
    perturbed points of ``preset`` (default: the roundabout, from crowded
    points with speeds in ``v_band``); mu enters as for K1 (Qblk += mu I on
    the statx diagonals, or every constraint row penalized at mu)."""
    import torch
    from algames_tpu_torch.constraints.sets import reset_constraints
    from algames_tpu_torch.presets import roundabout
    from algames_tpu_torch.problem import residual as R
    from algames_tpu_torch.utils import tree_map

    prob, spec = (preset or roundabout)(dev, torch.float64)
    rng = np.random.default_rng(seed)
    if iterates is None:
        traj = crowded_iterates(spec, B, rng, dev, torch.float64, v_band)
    else:
        traj = iterates(prob, spec, B, rng, dev, torch.float64)
    gc = (al_state(prob.gc, B, rng, dev, torch.float64, mu=mu)
          if penalize_rows else reset_constraints(prob.gc, B))
    pd = R.point_data(prob.model, spec, prob.obj, gc, traj)
    res, jb, _, _ = R.assemble_from_point(
        spec, prob.obj, gc, traj, pd,
        reg=torch.full((B,), 1e-3, dtype=torch.float64, device=dev))
    if not penalize_rows:
        eye = torch.eye(spec.n, dtype=torch.float64, device=dev)
        jb = dataclasses.replace(jb, Qblk=jb.Qblk + mu * eye)
    b = -R.residual_knot_blocks(spec, res)
    return spec, tree_map(lambda a: a.contiguous(), jb), b.contiguous()


def ibr_player_system(dev, B, mu, seed, penalize_rows=False, v_band=None,
                      preset=None, iterates=None):
    """The flagship's player sub-KKT systems of iterative best response
    (p=1, W = 2n + mi; f64): :func:`k3_system` on flagship points, lane b
    sliced to player b mod p (the players share their widths), so that every
    player's systems are in every batch."""
    import torch
    from algames_tpu_torch.presets import flagship_unicycle
    from algames_tpu_torch.problem import ibr
    from algames_tpu_torch.problem.linear_solver import JacBlocks
    from algames_tpu_torch.utils import tree_map
    spec, jb, b = k3_system(dev, B, mu, seed, penalize_rows,
                            preset=preset or flagship_unicycle,
                            iterates=iterates or flagship_iterates)
    n, m, pn = spec.n, spec.m, spec.p * spec.n
    parts = []
    for i in range(spec.p):
        ix = torch.arange(i, B, spec.p, device=dev)
        rows = (list(range(i * n, (i + 1) * n)) + [pn + j for j in spec.pu[i]]
                + list(range(pn + m, pn + m + n)))
        parts.append((ix, ibr.player_jac_blocks(
            spec, tree_map(lambda a: a[ix], jb), i), b[ix][..., rows]))
    order = torch.argsort(torch.cat([ix for ix, _, _ in parts]))
    jbi = JacBlocks(*[torch.cat([getattr(pj, f) for _, pj, _ in parts])[order]
                      .contiguous() for f in ("Qblk", "Ublk", "A", "B")])
    bi = torch.cat([pb for _, _, pb in parts])[order].contiguous()
    return ibr.player_spec(spec, 0), jbi, bi


def phase_k3(dev, tag="K3", preset=None, iterates=None, seed0=100,
             lib_lanes=128, system=k3_system):
    """K3 against its plain version on ``preset``'s KKT systems (default:
    the roundabout, with its speed-band and K3-vs-K1 checks), B=1024, over
    mu = 1 .. 1e7; then its times, bound and library call in f32, the
    library solving ``lib_lanes`` systems per call.  ``system`` builds the
    systems (default :func:`k3_system`)."""
    import torch
    from algames_tpu_torch.ops.thomas import solve_thomas, solve_thomas_plain
    from algames_tpu_torch.utils import tree_map

    def compare(mu, seed, penalize_rows, v_band=(0.3, 1.5), plain32=False):
        spec, jb, b = system(dev, B_KERNEL, mu, seed0 + seed, penalize_rows,
                             v_band, preset, iterates)
        ref = solve_thomas_plain(spec, jb, b)
        y64 = solve_thomas(spec, jb, b)
        jb32, b32 = tree_map(lambda a: a.float(), jb), b.float()
        y32 = solve_thomas(spec, jb32, b32)
        torch.cuda.synchronize()
        out = (float(rel_err(y64, ref).max()), float(rel_err(y32, ref).max()),
               float((y32.double() - ref).abs().max()))
        if plain32:
            out += (float(rel_err(solve_thomas_plain(spec, jb32, b32), ref)
                          .max()),)
        return out

    worst64 = worst32 = max_abs32 = 0.0
    launches = solve_thomas.launches
    for i, mu in enumerate(MUS):
        e64, e32, a32 = compare(mu, i, False)
        log(f"[{tag}] mu={mu:.0e}: f64 kernel vs f64 plain {e64:.3e} (<= "
            f"1e-9), f32 kernel vs f64 plain {e32:.3e} (<= 1e-3), f32 max abs "
            f"{a32:.3e}")
        if not (e64 <= 1e-9 and e32 <= 1e-3):
            raise SystemExit(f"{tag} disagrees with its plain version at "
                             f"mu={mu}")
        worst64, worst32 = max(worst64, e64), max(worst32, e32)
        max_abs32 = max(max_abs32, a32)
    if solve_thomas.launches != launches + 2 * len(MUS):
        raise SystemExit(f"the {tag} wrapper did not launch its kernel")
    for mu in (1e3, 1e7):
        e64, e32, _, p32 = compare(mu, 50, True, plain32=True)
        log(f"[{tag}] every constraint row penalized at mu={mu:.0e} "
            f"(reported, not gated): f64 {e64:.3e}, f32 {e32:.3e} (f32 plain "
            f"{p32:.3e})")
    if preset is None:
        roundabout_k3_checks(dev, compare)

    spec, jb, b = system(dev, B_KERNEL, 1e3, seed0 + 99, False, (0.3, 1.5),
                         preset, iterates)
    jb32, b32 = tree_map(lambda a: a.float(), jb), b.float()
    ms = cuda_ms(lambda: solve_thomas(spec, jb32, b32), 20)
    plain_ms = cuda_ms(lambda: solve_thomas_plain(spec, jb32, b32), 5)
    dev_ms = device_ms(lambda: solve_thomas(spec, jb32, b32), 20,
                       ("thomas_dense_",), 2, tag)
    y = solve_thomas(spec, jb32, b32)
    bnd = bound(tensor_bytes([jb32.Qblk, jb32.Ublk, jb32.A, jb32.B, b32])
                + tensor_bytes([y]), thomas_flops(spec, B_KERNEL, dense=True))
    log(f"[{tag}] worst over mu: f64 {worst64:.3e}, f32 {worst32:.3e} "
        f"relative; f32 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at "
        f"B={B_KERNEL} (per call, CUDA events); kernel device time "
        f"{dev_ms:.4f} ms (events, fwd + bwd); bound {bnd['bound_ms']:.4f} "
        f"ms ({bnd['bound_by']})")
    occ = k3_occupancy(tag, spec)
    # The roundabout's B dense [S, S] matrices (48 GB in f32) do not fit
    # twice on an 80 GB card: the library solves them 128 lanes per call.
    lanes = min(lib_lanes, B_KERNEL)
    lib_ms, y_lib = library_solve_ms(spec, jb32, b32, lanes)
    log(f"[{tag}] library: torch.linalg.solve on the dense [{B_KERNEL}, "
        f"{spec.S}, {spec.S}] KKT matrices, f32, {B_KERNEL // lanes} calls "
        f"of {lanes} lanes: {lib_ms:.4f} ms; worst relative deviation from "
        f"K3 {float(rel_err(y_lib, y).max()):.3e} (not gated)")
    return {"max_abs_err": max_abs32, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, **bnd, "library_ms": lib_ms,
            "forward_kernel": occ}


def k3_occupancy(tag, spec, B=B_KERNEL, forward="auto",
                 dtypes=("f32", "f64")):
    """The forward kernel K3 runs at ``spec``'s widths (``forward``: on that
    route instead of the one the shape takes), per dtype, as
    :func:`forward_occupancy` prints it."""
    from algames_tpu_torch.ops.thomas import dense_forward
    ms = spec.p * max(spec.mi)
    return forward_occupancy(
        tag, lambda dt: dense_forward(spec.n, ms, spec.p, dt, forward),
        f"d={spec.n + ms}, R={spec.p * spec.n + 1}", B, dtypes)


def roundabout_k3_checks(dev, compare):
    """The roundabout's extra K3 checks: the whole speed band (near zero
    speed the systems are ill-conditioned and f32 itself loses digits: the
    kernel is held to the f32 plain version's own error there), and K3
    against K1 on the same flagship systems, the Q blocks turned dense."""
    from algames_tpu_torch.ops.thomas import (solve_thomas,
                                              solve_thomas_structured,
                                              structured_to_dense)
    from algames_tpu_torch.problem.linear_solver import JacBlocks
    for mu in (1.0, 1e7):
        e64, e32, _, p32 = compare(mu, 60, False, v_band=(-0.2, 1.5),
                                   plain32=True)
        log(f"[K3] speeds over the whole band [-0.2, 1.5] at mu={mu:.0e}: "
            f"f64 kernel {e64:.3e} (<= 1e-9), f32 kernel {e32:.3e} against "
            f"f32 plain {p32:.3e} (<= max(1e-3, 10 x plain))")
        if not (e64 <= 1e-9 and e32 <= max(1e-3, 10 * p32)):
            raise SystemExit(f"K3 disagrees with its plain version over the "
                             f"whole speed band at mu={mu}")
    worst_k1 = 0.0
    for i, mu in enumerate((1.0, 1e3, 1e7)):
        fspec, sq, fb, w_owner = k1_system(dev, B_KERNEL, mu, 200 + i)
        jb = JacBlocks(Qblk=structured_to_dense(sq, w_owner, fspec.p)
                       .contiguous(), Ublk=sq.Ublk, A=sq.A, B=sq.B)
        e = float(rel_err(solve_thomas(fspec, jb, fb),
                          solve_thomas_structured(fspec, sq, fb, w_owner))
                  .max())
        worst_k1 = max(worst_k1, e)
    log(f"[K3] K3 vs K1 on flagship systems turned dense, f64, mu = 1, 1e3, "
        f"1e7: {worst_k1:.3e} (<= 1e-9)")
    if not worst_k1 <= 1e-9:
        raise SystemExit("K3 disagrees with K1 on the flagship systems")


def dense_of(spec, sq, w_owner):
    """Structured KKT blocks turned dense (JacBlocks), contiguous."""
    from algames_tpu_torch.ops.thomas import structured_to_dense
    from algames_tpu_torch.problem.linear_solver import JacBlocks
    return JacBlocks(Qblk=structured_to_dense(sq, w_owner, spec.p)
                     .contiguous(), Ublk=sq.Ublk, A=sq.A, B=sq.B)


def quad_dense_system(dev, B, mu, seed, preset=None):
    """The quadrotor's KKT systems (``k1_system`` on ``preset``, default
    the 2-player quadrotor, around its golden equilibrium; with a preset,
    around ``quad3_iterates``) turned dense (JacBlocks)."""
    from algames_tpu_torch.presets import quadrotor3d
    spec, sq, b, w_owner = k1_system(
        dev, B, mu, seed, False, preset or quadrotor3d,
        quad3_iterates if preset else golden_iterates("quad2_N15"))
    return spec, dense_of(spec, sq, w_owner), b


def ibr_quad_system(dev, B, mu, seed):
    """Iterative best response's quadrotor player systems (p=1, n=24,
    mi=4: d=28, R=25): :func:`ibr_player_system` on ``quadrotor3d``
    around its golden equilibrium."""
    from algames_tpu_torch.presets import quadrotor3d
    return ibr_player_system(dev, B, mu, seed, preset=quadrotor3d,
                             iterates=golden_iterates("quad2_N15"))


def phase_k3_quad(dev, tag, system, seed0, B=B_KERNEL, beyond=False):
    """K3 against its plain version on quadrotor systems ``system(dev, B,
    mu, seed)``, too ill-conditioned for a forward gate in f32, B lanes,
    mu = 1 .. 1e7, gated as K1's quadrotor phases are: normwise backward
    error f64 <= 1e-15 and f32 <= 1e-7, each <= 10 x the plain version's
    own; f32 forward error <= 30 x the f32 plain version's.  With
    ``beyond`` the systems lie beyond K3's size classes and must take its
    per-player blocked route, and the shared-memory kernel and the
    device-memory route are gated (backward error <= 1e-7 and 10 x the
    blocked route's) and timed beside it on the same operands; without, a
    register-tiled class, and the shared-memory kernel is timed beside it.
    Then its times, bound, library call and forward kernel in f32."""
    import torch
    from algames_tpu_torch.ops.thomas import solve_thomas, solve_thomas_plain
    from algames_tpu_torch.utils import tree_map

    worst64 = worst32 = max_abs32 = 0.0
    counters = kernel_counters()
    before = read_counters(counters)
    for i, mu in enumerate(MUS):
        spec, jb, b = system(dev, B, mu, seed0 + i)
        jb32, b32 = tree_map(lambda a: a.float(), jb), b.float()
        ref = solve_thomas_plain(spec, jb, b)
        y64 = solve_thomas(spec, jb, b)
        y32 = solve_thomas(spec, jb32, b32)
        p32 = solve_thomas_plain(spec, jb32, b32)
        torch.cuda.synchronize()
        e64 = float(rel_err(y64, ref).max())
        e32 = float(rel_err(y32, ref).max())
        ep32 = float(rel_err(p32, ref).max())
        b64, bp64, bw32, bp32 = (float(e.max()) for e in backward_errors(
            spec, jb, None, b, (y64, ref, y32, p32), lanes=min(B, 256)))
        log(f"[{tag}] mu={mu:.0e}: backward error f64 kernel {b64:.3e} "
            f"(plain {bp64:.3e}; <= 1e-15 and 10 x plain), f32 kernel "
            f"{bw32:.3e} (plain {bp32:.3e}; <= 1e-7 and 10 x plain); forward "
            f"vs f64 plain: f32 kernel {e32:.3e} against f32 plain {ep32:.3e} "
            f"(<= 30 x plain), f64 kernel {e64:.3e} (reported)")
        if not (b64 <= 1e-15 and b64 <= 10 * bp64 and bw32 <= 1e-7
                and bw32 <= 10 * bp32 and e32 <= 30 * ep32):
            raise SystemExit(f"{tag}: K3 disagrees with its plain version at "
                             f"mu={mu}")
        worst64, worst32 = max(worst64, e64), max(worst32, e32)
        max_abs32 = max(max_abs32, float((y32.double() - ref).abs().max()))
    after = read_counters(counters)
    took = {r: after[f"K3 {r} route"] - before[f"K3 {r} route"]
            for r in ROUTE_COUNTERS["K3"]}
    if took != {r: 2 * len(MUS) if beyond and r == "blocked" else 0
                for r in took}:
        raise SystemExit(f"{tag}: K3 took the wrong forward route ({took} of "
                         f"{2 * len(MUS)} calls by route)")
    ms = cuda_ms(lambda: solve_thomas(spec, jb32, b32), 20)
    plain_ms = cuda_ms(lambda: solve_thomas_plain(spec, jb32, b32), 5)
    dev_ms = device_ms(lambda: solve_thomas(spec, jb32, b32), 20,
                       ("thomas_dense_",), 2, tag)
    y = solve_thomas(spec, jb32, b32)
    bnd = bound(tensor_bytes([jb32.Qblk, jb32.Ublk, jb32.A, jb32.B, b32])
                + tensor_bytes([y]), thomas_flops(spec, B, dense=True))
    out = {"max_abs_err": max_abs32, "ms": ms, "plain_ms": plain_ms,
           "device_ms": dev_ms, **bnd,
           "forward_kernel": k3_occupancy(tag, spec, B)}
    lib_ms, y_lib = library_solve_ms(spec, jb32, b32, B)
    out["library_ms"] = lib_ms
    log(f"[{tag}] worst over mu: f64 {worst64:.3e}, f32 {worst32:.3e} "
        f"relative; f32 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at "
        f"B={B} (per call, CUDA events); device time {dev_ms:.4f} ms "
        f"(events, fwd + bwd); bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}); library {lib_ms:.4f} ms (worst relative "
        f"deviation from K3 {float(rel_err(y_lib, y).max()):.3e}, not gated)")
    if beyond:
        # The older routes forced onto the same operands, gated as the
        # route the shape takes: is either still faster where it runs?
        for r, name in (("shared", "shared-memory kernel"),
                        ("device", "device-memory route")):
            yr = solve_thomas(spec, jb32, b32, forward=r)
            bwr, bwk = (float(e.max()) for e in backward_errors(
                spec, jb, None, b, (yr, y), lanes=min(B, 256)))
            if not (bwr <= 1e-7 and bwr <= 10 * bwk):
                raise SystemExit(f"{tag}: K3's {name} disagrees with its "
                                 f"blocked route")
            out[f"{r}_route_ms"] = device_ms(
                lambda: solve_thomas(spec, jb32, b32, forward=r), 20,
                ("thomas_dense_",), 2, f"{tag} {name}")
            out[f"{r}_route_kernel"] = k3_occupancy(
                f"{tag} {name}", spec, B, r)
            log(f"[{tag}] f32 device time at B={B}: the blocked route "
                f"{dev_ms:.4f} ms, the {name} on the same operands "
                f"{out[f'{r}_route_ms']:.4f} ms "
                f"({out[f'{r}_route_ms'] / dev_ms:.2f} x); backward error "
                f"{bwr:.3e} (blocked route {bwk:.3e}; <= 1e-7 and 10 x)")
    else:
        out["shared_device_ms"] = device_ms(
            lambda: solve_thomas(spec, jb32, b32, forward="shared"), 20,
            ("thomas_dense_",), 2, f"{tag} shared-memory kernel")
        out["shared_forward_kernel"] = k3_occupancy(
            f"{tag} shared-memory kernel", spec, B, "shared")
        log(f"[{tag}] f32 device time at B={B}: register-tiled "
            f"{dev_ms:.4f} ms, the shared-memory forward kernel on the same "
            f"operands {out['shared_device_ms']:.4f} ms "
            f"({out['shared_device_ms'] / dev_ms:.2f} x)")
    return out


def dense_k3(spec, blocks, b, w_owner):
    """A KKT method for ``newton_solve``: the structured blocks turned
    dense and solved by K3 (on the quadrotor, its LU class for d <= 32)."""
    from algames_tpu_torch.ops.thomas import solve_thomas
    return solve_thomas(spec, dense_of(spec, blocks, w_owner), b)


def phase_golden_big(dev):
    """The f64 quadrotor solve (``newton_solve`` with :func:`dense_k3` as
    its KKT step: K3 on the systems turned dense, d=32, its register-tiled
    LU class) against ``quad2_N15.npz``: iteration 52, x and u within 1e-8;
    K3 launched, never on its shared-memory route."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch.presets import quadrotor3d

    gold = load_golden("quad2_N15")
    prob, _ = quadrotor3d(dev, torch.float64)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    counters = zero_counters()
    res = agt.newton_solve(prob, method=dense_k3)
    torch.cuda.synchronize()
    launches = read_counters(counters)
    it = int(res.stats.iter[0])
    dx = float(np.abs(res.traj.x[0].cpu().numpy() - gold["x"]).max())
    du = float(np.abs(res.traj.u[0].cpu().numpy() - gold["u"]).max())
    log(f"[golden-big] f64 quadrotor through K3 on its systems turned dense: "
        f"iter {it} (golden {int(gold['iter'])}), max |dx| {dx:.3e}, max "
        f"|du| {du:.3e} (<= 1e-8); launches {launches}")
    if not (it == int(gold["iter"]) and dx <= 1e-8 and du <= 1e-8
            and launches["K3"] > 0 and launches["K3 shared route"] == 0
            and launches["K1"] == 0):
        raise SystemExit("the quadrotor solve through K3 misses quad2_N15")


def phase_sweep_quad2_dense(dev):
    """One f32 chunk of the quadrotor sweep (its first CHUNK scenarios, the
    preset budget 6 x 12, the fused trial) with :func:`dense_k3` as the KKT
    step, warm, counted from zero after the warm-up: every trajectory
    finite, none diverged, the first 256 lanes converged (stationarity
    gate QUAD_OPT_GATE) >= the reference's own - 0.01 (as ``sweep-quad2``);
    K3 launched on its register-tiled class (no shared-memory route), K1
    not.  Returns the launches."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.presets import quadrotor3d

    prob, x0s = sweep_problem(quadrotor3d, dev)
    x0s = x0s[:CHUNK]
    opts = prob.opts
    conv_opts = dataclasses.replace(opts, eps_opt=QUAD_OPT_GATE)
    parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
        opts, outer_iter=1, inner_iter=2)), x0s[:64], method=dense_k3)
    counters = zero_counters()
    out, el = timed_sweep(prob, x0s, dense_k3)
    launches = read_counters(counters)
    finite = bool(torch.isfinite(out.traj.x).all())
    div = float(parallel.divergence_mask(out).float().mean())
    first = float(parallel.convergence_fraction(
        dataclasses.replace(out, stats=tree_slice(out.stats, 256),
                            traj=tree_slice(out.traj, 256)), conv_opts))
    ref256 = REF_CONVERGED["quad2_N15"][0]
    frac = float(parallel.convergence_fraction(out, conv_opts))
    log(f"[sweep-quad2-dense] f32 {CHUNK} scenarios as one chunk, outer "
        f"{opts.outer_iter} x {opts.inner_iter}, K3 on the systems turned "
        f"dense: {el:.3f} s, {CHUNK / el:.1f} solves/s; converged (opt gate "
        f"{QUAD_OPT_GATE:g}) all {frac:.4f}, "
        f"first 256 lanes {first:.4f} (reference {ref256:.4f}; >= "
        f"{ref256 - 0.01:.4f}); diverged {div:.4f}, finite {finite}, "
        f"launches {launches}")
    if not (finite and div == 0.0 and first >= ref256 - 0.01
            and launches["K3"] > 0 and launches["K3 shared route"] == 0
            and launches["K1"] == 0):
        raise SystemExit("the quadrotor chunk through K3 failed its gates")
    return launches


def phase_game_sweep(tag, preset, ref, dev, dense=False, opt_gate=None,
                     lanes=GAME_SWEEP_LANES):
    """The f32 sweep of one game at its preset budget: the first ``lanes``
    of the N_SWEEP scenarios, chunk 1024, through K1 (or K3 with
    ``dense``) and K4; every trajectory
    finite, no divergence, the converged fraction (stationarity gate
    ``opt_gate``, default the preset's) of the first 256 lanes and of all
    lanes each >= the reference package's own on the same inputs minus 0.01
    (``ref`` = (its fraction of the first 256 lanes, of all lanes or None
    where that is not measured)); the
    game's KKT kernel and K4 launched and the other KKT kernel not; one
    chunk with the plain versions on the card through the first PLAIN_OUTER
    outer iterations (its per-lane stats rows compared with the kernels'
    rows of the same outer iterations), and a profile of one chunk's first
    PROFILE_INNER inner iterations (both cut so, from the whole budget and
    two outer iterations, then from half the outer budget and a whole
    outer iteration, to keep the script in its time limit)."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (kkt_solve_plain, solve_thomas,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval

    prob, x0s = sweep_problem(preset, dev)
    x0s = x0s[:lanes]
    opts = prob.opts
    gate = opt_gate if opt_gate is not None else opts.eps_opt
    conv_opts = dataclasses.replace(opts, eps_opt=gate)
    parallel.solve_batch(
        dataclasses.replace(prob, opts=dataclasses.replace(
            opts, outer_iter=1, inner_iter=2)), x0s[:64])   # warm-up
    solve_thomas_structured.launches = 0
    solve_thomas_structured.wide_launches = 0
    solve_thomas.launches = 0
    trial_eval.launches = 0
    out, el = timed_sweep(prob, x0s, "thomas")
    launches = {"K1": solve_thomas_structured.launches,
                "K3": solve_thomas.launches, "K4": trial_eval.launches,
                "K1 shared route": solve_thomas_structured.wide_launches}
    kkt, other = ("K3", "K1") if dense else ("K1", "K3")
    iters = out.stats.iter.cpu().numpy()
    hist = np.bincount(iters, minlength=opts.outer_iter * opts.inner_iter + 2)
    frac = float(parallel.convergence_fraction(out, conv_opts))
    div = float(parallel.divergence_mask(out).float().mean())
    finite = bool(torch.isfinite(out.traj.x).all())
    first = float(parallel.convergence_fraction(
        dataclasses.replace(out, stats=tree_slice(out.stats, 256),
                            traj=tree_slice(out.traj, 256)), conv_opts))
    log(f"[{tag}] f32 {lanes} scenarios, chunk {CHUNK}, outer "
        f"{opts.outer_iter} x {opts.inner_iter}, kernels: {el:.3f} s, "
        f"{lanes / el:.1f} solves/s")
    ref256, ref_all = ref
    gate_all = -1.0 if ref_all is None else ref_all - 0.01
    all_ref = ("not measured" if ref_all is None
               else f"reference {ref_all:.4f}; >= {gate_all:.4f}")
    log(f"[{tag}] converged (opt gate {gate:g}): all {lanes} lanes "
        f"{frac:.4f} ({all_ref}), first 256 lanes {first:.4f} (reference "
        f"{ref256:.4f}; >= {ref256 - 0.01:.4f}); diverged {div:.4f}, finite "
        f"{finite}, launches {launches}")
    log(f"[{tag}] iteration histogram (stats rows per lane): "
        + " ".join(f"{i}:{c}" for i, c in enumerate(hist) if c))
    if not (finite and frac >= gate_all and first >= ref256 - 0.01
            and div == 0.0
            and launches[kkt] > 0 and launches["K4"] > 0
            and launches[other] == 0 and launches["K1 shared route"] == 0):
        raise SystemExit(f"the {tag} sweep failed its gates")

    plain = dataclasses.replace(prob, opts=dataclasses.replace(
        opts, ls_fused=False, outer_iter=PLAIN_OUTER))
    out_p, el_p = timed_sweep(plain, x0s[:CHUNK], kkt_solve_plain)
    it_p = out_p.stats.iter.cpu().numpy()
    # The rows a lane of the kernels' run would have had at the cut budget:
    # its rows of the first PLAIN_OUTER outer iterations (the outer column
    # counts from 1) and the record that closes the budget, unless the lane
    # finished within it.
    it_k = iters[:CHUNK]
    rows_k = np.arange(out.stats.outer.shape[1])[None] < it_k[:, None]
    want = np.minimum(((out.stats.outer[:CHUNK].cpu().numpy() <= PLAIN_OUTER)
                       & rows_k).sum(1) + 1, it_k)
    log(f"[{tag}] one {CHUNK}-lane chunk with the plain versions on the "
        f"card, outer {PLAIN_OUTER} of {opts.outer_iter}: {el_p:.3f} s for "
        f"{int(it_p.max())} stats rows; per-lane stats rows equal to the "
        f"kernels' rows of the same outer iterations on "
        f"{int((it_p == want).sum())} of {it_p.size} lanes")
    profile_chunk(f"profile-{tag}", dataclasses.replace(
        prob, opts=dataclasses.replace(
            opts, outer_iter=1, inner_iter=min(opts.inner_iter,
                                               PROFILE_INNER))), x0s[:CHUNK],
        ("thomas_dense_" if dense else "thomas_sq_", "trial_fused_"))
    return launches


def phase_golden_ibr(dev):
    """One f64 IBR solve of the flagship (outer 3 x 8 per player solve,
    ``ibr_iter`` 10) through K3 against the reference package's frozen
    ``schur`` solution ``ibr_uni3_N20``: the same number of stats rows, x
    and u within 1e-8; K3 launched, neither K1 nor the trial kernel."""
    import torch
    from algames_tpu_torch import IBROptions, ibr_newton_solve
    from algames_tpu_torch.ops.thomas import (solve_thomas,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval
    from algames_tpu_torch.presets import flagship_unicycle

    gold = load_golden("ibr_uni3_N20")
    prob, _ = flagship_unicycle(dev, torch.float64, outer=3, inner=8)
    counters = (solve_thomas, solve_thomas_structured, trial_eval)
    before = [c.launches for c in counters]
    t0 = time.perf_counter()
    res = ibr_newton_solve(prob, IBROptions(ibr_iter=IBR_ITER))
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    ran = [c.launches - b for c, b in zip(counters, before)]
    it = int(res.stats.iter[0])
    q = int(res.stats.outer[0, it - 1])
    dx = float(np.abs(res.traj.x[0].cpu().numpy() - gold["x"]).max())
    du = float(np.abs(res.traj.u[0].cpu().numpy() - gold["u"]).max())
    log(f"[golden-ibr] f64 K3 path: {it} stats rows (golden "
        f"{int(gold['iter'])}), {q} rounds (golden {int(gold['q'])}), max "
        f"|dx| {dx:.3e}, max |du| {du:.3e} (<= 1e-8), {el:.2f} s; launches: "
        f"K3 {ran[0]}, K1 {ran[1]}, trial {ran[2]}")
    if not (it == int(gold["iter"]) and dx <= 1e-8 and du <= 1e-8
            and ran[0] > 0 and ran[1] == 0 and ran[2] == 0):
        raise SystemExit("the f64 IBR solve misses ibr_uni3_N20")


def ibr_finals(out, lanes):
    """Per lane of the first ``lanes``: the round count (the final record's
    outer column) and the final residual."""
    import torch
    it = out.stats.iter[:lanes].long() - 1
    ix = torch.arange(lanes, device=it.device)
    return (out.stats.outer[:lanes][ix, it].cpu().numpy(),
            out.stats.res[:lanes][ix, it].double().cpu().numpy())


def phase_sweep_ibr(dev):
    """The IBR sweep of ``benchmarks/bench_ibr.py`` in f32: N_IBR flagship
    scenarios (x0 + 0.05 N(0, 1), numpy seed 0) as one chunk, outer 3 x 8
    per player solve, ``ibr_iter`` 10, through K3.  Gates: every trajectory
    finite; on the first IBR_LANES lanes, the share whose Gauss-Seidel loop
    stopped before ``ibr_iter`` rounds within 0.02 of the reference
    package's own and the mean final residual at most 1.1 x its own
    (``tests/reference_fractions.py ibr``); K3 launched, neither K1 nor the
    trial kernel.  Then the chunk's first IBR_LANES lanes through the plain
    versions on the card (cut from the whole chunk to keep the script in
    its time limit), and a profile of one Gauss-Seidel round at a cut player budget
    (outer 1 x PROFILE_INNER)."""
    import torch
    from algames_tpu_torch import IBROptions, ibr_newton_solve
    from algames_tpu_torch.ops.thomas import (kkt_solve_plain, solve_thomas,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval
    from algames_tpu_torch.presets import flagship_unicycle

    prob, spec = flagship_unicycle(dev, torch.float32, outer=3, inner=8)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        np.asarray(prob.x0.cpu(), np.float64)[None]
        + 0.05 * rng.standard_normal((N_IBR, spec.n)), dtype=torch.float32,
        device=dev)
    opts = IBROptions(ibr_iter=IBR_ITER)
    ibr_newton_solve(prob, IBROptions(ibr_iter=1), x0s=x0s[:64])  # warm-up
    solve_thomas.launches = 0
    solve_thomas_structured.launches = 0
    trial_eval.launches = 0

    def run(method, lanes=N_IBR):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ibr_newton_solve(prob, opts, x0s=x0s[:lanes], method=method)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    out, el = run("thomas")
    launches = {"K3": solve_thomas.launches,
                "K1": solve_thomas_structured.launches,
                "trial": trial_eval.launches}
    q, res = ibr_finals(out, IBR_LANES)
    stopped = float((q < IBR_ITER).mean())
    mean_res = float(res.mean())
    finite = bool(torch.isfinite(out.traj.x).all())
    q_all, _ = ibr_finals(out, N_IBR)
    ref_stop, ref_res = REF_IBR
    log(f"[sweep-ibr] f32 {N_IBR} scenarios as one chunk, outer 3 x 8 per "
        f"player solve, ibr_iter {IBR_ITER}, K3: {el:.3f} s, "
        f"{N_IBR / el:.1f} solves/s")
    log(f"[sweep-ibr] first {IBR_LANES} lanes: stopped before {IBR_ITER} "
        f"rounds {stopped:.4f} (reference {ref_stop:.4f}; within 0.02), "
        f"mean final residual {mean_res:.6g} (reference {ref_res:.6g}; <= "
        f"1.1 x); all lanes: rounds histogram "
        f"{np.bincount(q_all, minlength=IBR_ITER + 1).tolist()}; finite "
        f"{finite}, launches {launches}")
    if not (finite and abs(stopped - ref_stop) <= 0.02
            and mean_res <= 1.1 * ref_res and launches["K3"] > 0
            and launches["K1"] == 0 and launches["trial"] == 0):
        raise SystemExit("the IBR sweep failed its gates")

    out_p, el_p = run(kkt_solve_plain, IBR_LANES)
    it = out.stats.iter[:IBR_LANES].cpu().numpy()
    it_p = out_p.stats.iter.cpu().numpy()
    log(f"[sweep-ibr] the chunk's first {IBR_LANES} lanes with the plain "
        f"versions on the card: {el_p:.3f} s, {IBR_LANES / el_p:.1f} "
        f"solves/s; stats rows equal to the kernel's on "
        f"{int((it == it_p).sum())} of {IBR_LANES} lanes")
    short = dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, outer_iter=1, inner_iter=min(prob.opts.inner_iter,
                                                PROFILE_INNER)))
    profile_chunk("profile-ibr", prob, x0s, ("thomas_dense_",),
                  solve=lambda: ibr_newton_solve(
                      short, IBROptions(ibr_iter=1), x0s=x0s),
                  what=f"one Gauss-Seidel round over {N_IBR} lanes, outer "
                       f"1 x {short.opts.inner_iter} per player solve")
    return launches


def phase_sweep_ibr_quad(dev, k3_ibr_quad):
    """Iterative best response on the quadrotor preset (p=2, N=15) at the
    IBR flagship's per-player budget, outer 3 x 8, ``ibr_iter``
    IBR_QUAD_ITER, through K3 on the player systems (d=28, its
    register-tiled LU class):
    N_IBR_QUAD f32 scenarios (x0 + 0.05 N(0, 1), numpy seed 0) as one
    chunk, warm, counted from zero after the warm-up.  Gates: every
    trajectory finite; the share stopped before IBR_QUAD_ITER rounds within
    0.02 of the reference package's own on the same lanes and the mean
    final residual at most 1.1 x its own (REF_IBR_QUAD); K3 launched, never
    on its shared-memory route, neither K1 nor a trial kernel.  Prints K3's
    device time (its f32 device time per call at B=1024 from
    ``K3-ibr-quad``, ``k3_ibr_quad``, times its launches).  Then 4 lanes in
    f64, one round at outer 1 x 8 per player solve (cut from 3 x 8 to keep
    the script in its time limit), through the kernels and through the
    plain versions on the card: stats rows and their round column equal, x and u within 1e-8.
    Returns the f32 run's launches."""
    import torch
    from algames_tpu_torch import IBROptions, ibr_newton_solve
    from algames_tpu_torch.ops.thomas import kkt_solve_plain
    from algames_tpu_torch.presets import quadrotor3d

    def starts(prob, spec, dtype):
        rng = np.random.default_rng(0)
        return torch.as_tensor(
            np.asarray(prob.x0.cpu(), np.float64)[None]
            + 0.05 * rng.standard_normal((N_IBR_QUAD, spec.n)), dtype=dtype,
            device=dev)

    def run(prob, x0s, rounds, method="thomas"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ibr_newton_solve(prob, IBROptions(ibr_iter=rounds), x0s=x0s,
                               method=method)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    prob, spec = quadrotor3d(dev, torch.float32, outer=3, inner=8)
    x0s = starts(prob, spec, torch.float32)
    ibr_newton_solve(dataclasses.replace(prob, opts=dataclasses.replace(
        prob.opts, outer_iter=1, inner_iter=2)), IBROptions(ibr_iter=1),
        x0s=x0s[:8])                                       # warm-up
    counters = zero_counters()
    out, el = run(prob, x0s, IBR_QUAD_ITER)
    launches = read_counters(counters)
    q, res = ibr_finals(out, N_IBR_QUAD)
    stopped = float((q < IBR_QUAD_ITER).mean())
    mean_res = float(res.mean())
    finite = bool(torch.isfinite(out.traj.x).all())
    ref_stop, ref_res = REF_IBR_QUAD
    k3_ms = k3_ibr_quad["device_ms"] * launches["K3"]
    log(f"[sweep-ibr-quad2] f32 {N_IBR_QUAD} quadrotor scenarios as one "
        f"chunk, outer 3 x 8 per player solve, ibr_iter {IBR_QUAD_ITER}, "
        f"K3: {el:.3f} s, {N_IBR_QUAD / el:.1f} solves/s; stopped before "
        f"{IBR_QUAD_ITER} rounds {stopped:.4f} (reference {ref_stop:.4f}; "
        f"within 0.02), mean final residual {mean_res:.6g} (reference "
        f"{ref_res:.6g}; <= 1.1 x); rounds histogram "
        f"{np.bincount(q, minlength=IBR_QUAD_ITER + 1).tolist()}; finite "
        f"{finite}; launches {launches}; K3 device time {launches['K3']} x "
        f"{k3_ibr_quad['device_ms']:.4f} (at B=1024) = {k3_ms:.1f} ms")
    if not (finite and abs(stopped - ref_stop) <= 0.02
            and mean_res <= 1.1 * ref_res and launches["K3"] > 0
            and launches["K3 shared route"] == 0 and launches["K1"] == 0
            and launches["trial"] == 0):
        raise SystemExit("the quadrotor IBR sweep failed its gates")

    prob64, _ = quadrotor3d(dev, torch.float64, outer=1, inner=8)
    x64 = starts(prob64, spec, torch.float64)[:4]
    out_k, _ = run(prob64, x64, 1)
    out_p, _ = run(prob64, x64, 1, kkt_solve_plain)
    it, it_p = out_k.stats.iter.cpu().numpy(), out_p.stats.iter.cpu().numpy()
    rows = int(it.max())
    same_q = bool((out_k.stats.outer[:, :rows]
                   == out_p.stats.outer[:, :rows]).all())
    dx = float((out_k.traj.x - out_p.traj.x).abs().max())
    du = float((out_k.traj.u - out_p.traj.u).abs().max())
    log(f"[sweep-ibr-quad2] f64, 4 lanes, one round at outer 1 x 8 per "
        f"player solve: stats rows "
        f"{it.tolist()} (plain "
        f"versions {it_p.tolist()}), round columns equal {same_q}, max |dx| "
        f"{dx:.3e}, max |du| {du:.3e} (<= 1e-8)")
    if not ((it == it_p).all() and same_q and dx <= 1e-8 and du <= 1e-8):
        raise SystemExit("the f64 quadrotor IBR through K3 disagrees with "
                         "the plain versions")
    return launches


def mpc_starts(prob, spec, B, dev, dtype):
    """The closed loop's starts: ``prob.x0`` for one scenario, else
    x0 + 0.05 N(0, 1) from numpy seed 0 (``tests/reference_fractions.py
    mpc`` feeds the reference the same)."""
    import torch
    x0 = np.asarray(prob.x0.cpu(), np.float64)
    if B > 1:
        x0 = x0[None] + 0.05 * np.random.default_rng(0).standard_normal(
            (B, spec.n))
    return torch.as_tensor(x0.reshape(B, spec.n), dtype=dtype, device=dev)


def final_violations(out):
    """Each lane's four final violations (dyn, con, sta, opt) [B, 4]."""
    import torch
    s = out.stats
    last = torch.clamp(s.iter.long() - 1, min=0)[:, None]
    return torch.stack([c.gather(1, last)[:, 0] for c in
                        (s.dyn_vio, s.con_vio, s.sta_vio, s.opt_vio)], dim=1)


def timed_mpc(prob, x0s, horizon, method="thomas"):
    """``mpc_solve`` on the host's clock, the card synchronised around the
    loop and at the start of each replan's solve: (result, the loop's
    seconds, each replan's seconds [H] from the start of its solve to the
    start of the next or the loop's end, so with its plant substeps,
    penalty reset and host work, final violations [H, B, 4] per replan).
    The replans are seen by rebinding ``mpc.newton_solve``, the function
    ``mpc_solve`` calls once per replan; the script stops if it is not."""
    import torch
    import algames_tpu_torch.mpc as mpc
    from algames_tpu_torch.problem.solver import newton_solve
    if mpc.newton_solve is not newton_solve:
        raise SystemExit("mpc_solve no longer calls the solver's "
                         "newton_solve; the replans cannot be timed")
    starts, outs = [], []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        outs.append(newton_solve(*args, **kw))
        return outs[-1]
    mpc.newton_solve = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mpc.mpc_solve(prob, x0s, horizon=horizon, method=method)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        mpc.newton_solve = newton_solve
    if len(starts) != horizon:
        raise SystemExit(f"mpc_solve made {len(starts)} solves for "
                         f"{horizon} replans")
    vios = torch.stack([final_violations(o) for o in outs]).cpu().numpy()
    return res, t1 - t0, np.diff(np.asarray(starts + [t1])), vios


def closed_loop(tag, res, vios, spec, opts, ref_share):
    """The closed loop's checks (as ``benchmarks/bench_mpc.py`` writes them
    to ``mpc_closedloop.json``): every state and control finite, the
    executed pairwise distance >= 2 r, every applied |u| <= the bound, and
    the share of replans whose final violations meet all four gates >= the
    reference package's share on the same inputs minus 0.01.  Returns
    (min distance, max |u|, share)."""
    import torch
    X, U = res.states.double(), res.controls.double()
    finite = bool(torch.isfinite(X).all() and torch.isfinite(U).all())
    dmin = min(float((X[:, :, list(spec.px[a])] - X[:, :, list(spec.px[b])])
                     .norm(dim=-1).min())
               for a in range(spec.p) for b in range(a + 1, spec.p))
    umax = float(U.abs().max())
    eps = np.asarray([opts.eps_dyn, opts.eps_con, opts.eps_sta, opts.eps_opt])
    share = float((vios < eps).all(axis=-1).mean())
    log(f"[{tag}] closed loop: finite {finite}, min pairwise executed "
        f"distance {dmin:.4f} (>= {2 * HIGHWAY_R:g}), max applied |u| "
        f"{umax:.6f} (<= {HIGHWAY_U:g} + 1e-6), replans meeting all four "
        f"gates {share:.4f} (>= reference {ref_share:.4f} - 0.01)")
    if not (finite and dmin >= 2 * HIGHWAY_R and umax <= HIGHWAY_U + 1e-6
            and share >= ref_share - 0.01):
        raise SystemExit(f"the {tag} closed loop failed its gates")
    return dmin, umax, share


def kernel_counters():
    from algames_tpu_torch.ops.thomas import solve_thomas, solve_thomas_structured
    from algames_tpu_torch.ops.trial import trial_eval
    return {"K1": solve_thomas_structured, "K3": solve_thomas,
            "trial": trial_eval}


# The launch counters of each KKT kernel's forward routes beyond its size
# classes, by the route names of ``ops.thomas._ROUTES``.
ROUTE_COUNTERS = {"K1": {"blocked": "blocked_launches",
                         "shared": "wide_launches",
                         "device": "global_launches"},
                  "K3": {"blocked": "blocked_launches",
                         "shared": "big_launches",
                         "device": "global_launches"}}


def zero_counters():
    """Every kernel count set to 0; returns the counters."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    for kkt, attrs in ROUTE_COUNTERS.items():
        for attr in attrs.values():
            setattr(counters[kkt], attr, 0)
    return counters


def read_counters(counters):
    """{kernel: launches}, and each route's of K1 and K3 under "<kernel>
    <route> route" ("K1 blocked route", "K3 shared route", ...)."""
    launches = {k: c.launches for k, c in counters.items()}
    for kkt, attrs in ROUTE_COUNTERS.items():
        for route, attr in attrs.items():
            launches[f"{kkt} {route} route"] = getattr(counters[kkt], attr)
    return launches


def run_mpc(tag, prob, spec, B, dev, ref_share):
    """One closed loop of H_MPC replans over B scenarios, its counts zeroed
    just before: replan wall times, launches, closed-loop gates."""
    import torch
    counters = zero_counters()
    x0s = mpc_starts(prob, spec, B, dev, torch.float32)
    res, wall, secs, vios = timed_mpc(prob, x0s, H_MPC)
    launches = read_counters(counters)
    lat = secs[2:] * 1e3
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    rate = B * H_MPC / wall
    iters = res.iters.cpu().numpy()
    log(f"[{tag}] B={B}, H={H_MPC}: replan wall time (solve, plant and "
        f"host work, synchronised, replans 3..{H_MPC}) p50 {p50:.3f} ms, "
        f"p95 {p95:.3f} ms, mean {float(lat.mean()):.3f} ms; the loop "
        f"{wall * 1e3:.3f} ms, {rate:.1f} scenario-replans/s; stats "
        f"rows per replan {int(iters.min())}..{int(iters.max())} (mean "
        f"{float(iters.mean()):.2f}); launches {launches}, K1 per replan "
        f"{launches['K1'] / H_MPC:.2f}")
    dmin, umax, share = closed_loop(tag, res, vios, spec, prob.opts,
                                    ref_share)
    return {"B": B, "p50_ms": p50, "p95_ms": p95, "rate": rate,
            "launches": launches, "min_distance": dmin, "max_u": umax,
            "share": share}


def phase_mpc(dev, k1_by_lanes):
    """BASELINE config 3: the highway's closed loop through ``mpc_solve`` in
    f32 at H_MPC replans, one scenario and B_MPC, K1 as every replan's KKT
    step (the trial eager, K3 never, K1 never on its wide route)."""
    import torch
    import algames_tpu_torch as agt
    prob, spec = highway_game(dev, torch.float32)
    agt.mpc_solve(prob, horizon=2)                      # warm-up, untimed
    out = {}
    for B in (1, B_MPC):
        r = run_mpc("mpc", prob, spec, B, dev, REF_MPC[B])
        k1 = k1_by_lanes[B]
        log(f"[mpc] K1 at B={B}: device time {k1['device_ms']:.4f} ms per "
            f"call (fwd + bwd), {r['launches']['K1'] / H_MPC:.2f} calls per "
            f"replan, bound {k1['bound_ms']:.4f} ms")
        lk = r["launches"]
        if not (lk["K1"] > 0 and lk["K3"] == 0 and lk["trial"] == 0
                and lk["K1 shared route"] == 0):
            raise SystemExit("the highway's closed loop took the wrong "
                             "kernels")
        out[B] = r
    x0s = mpc_starts(prob, spec, B_MPC, dev, torch.float32)
    profile_chunk("profile-mpc", prob, x0s, ("thomas_sq_",),
                  solve=lambda: agt.mpc_solve(prob, x0s,
                                              horizon=PROFILE_REPLANS),
                  what=f"a closed loop of {PROFILE_REPLANS} replans over "
                       f"{B_MPC} scenarios")
    return out


def phase_mpc_plain(dev):
    """The f64 closed loop (4 scenarios, 5 replans) through the kernels
    against the same loop through the plain versions on the card: equal
    stats rows per replan, states within 1e-8."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch.ops.thomas import kkt_solve_plain
    prob, spec = highway_game(dev, torch.float64)
    x0s = mpc_starts(prob, spec, 4, dev, torch.float64)
    k1 = kernel_counters()["K1"]
    before = k1.launches
    res = agt.mpc_solve(prob, x0s, horizon=5)
    ran = k1.launches - before
    res_p = agt.mpc_solve(prob, x0s, horizon=5, method=kkt_solve_plain)
    it, it_p = res.iters.cpu().numpy(), res_p.iters.cpu().numpy()
    dx = float((res.states - res_p.states).abs().max())
    log(f"[mpc-plain] f64, 4 scenarios, 5 replans: stats rows {it.tolist()} "
        f"(plain versions {it_p.tolist()}), max |dx| of the states "
        f"{dx:.3e} (<= 1e-8), K1 launches {ran}")
    if not ((it == it_p).all() and dx <= 1e-8 and ran > 0):
        raise SystemExit("the closed loop through K1 disagrees with the "
                         "plain versions")


def phase_mpc_fused(dev):
    """The B_MPC closed loop again with ``ls_fused=True``: the trial takes
    the fused kernel (K2's unicycle instance) where ``trial_supported``
    holds; the same closed-loop gates."""
    import torch
    from algames_tpu_torch.ops.trial import trial_supported
    prob, spec = highway_game(dev, torch.float32)
    prob = dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, ls_fused=True))
    supported = trial_supported(prob.model, spec, prob.obj, prob.gc)
    r = run_mpc("mpc-fused", prob, spec, B_MPC, dev, REF_MPC[B_MPC])
    lk = r["launches"]
    log(f"[mpc-fused] trial_supported {supported}: the trial took the fused "
        f"kernel {lk['trial']} times ({lk['trial'] / H_MPC:.2f} per replan)")
    if not (supported and lk["trial"] > 0 and lk["K1"] > 0
            and lk["K3"] == 0):
        raise SystemExit("the fused closed loop took the wrong kernels")
    return r


def phase_ls_parallel(dev):
    """One flagship chunk (CHUNK lanes, f32, outer 3 x 8, K1 + K2) with
    ``ls_parallel=2`` against ``ls_parallel=1``: per-lane stats rows and
    accepted step sizes equal."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.presets import flagship_unicycle
    prob, x0s = sweep_problem(flagship_unicycle, dev, outer=3, inner=8)
    trial = kernel_counters()["trial"]
    outs = {}
    for K in (1, 2):
        pk = dataclasses.replace(
            prob, opts=dataclasses.replace(prob.opts, ls_parallel=K))
        before = trial.launches
        outs[K], el = timed_sweep(pk, x0s[:CHUNK], "thomas")
        log(f"[ls-parallel] K={K}: {el:.3f} s for {CHUNK} lanes, fused "
            f"trial launches {trial.launches - before}")
    it1, it2 = (outs[k].stats.iter.cpu().numpy() for k in (1, 2))
    same_alpha = bool(torch.equal(outs[1].stats.column("alpha"),
                                  outs[2].stats.column("alpha")))
    dx = float((outs[1].traj.x - outs[2].traj.x).abs().max())
    log(f"[ls-parallel] stats rows equal on {int((it1 == it2).sum())} of "
        f"{CHUNK} lanes; accepted alphas equal {same_alpha}; max |dx| {dx:.3e}")
    if not ((it1 == it2).all() and same_alpha):
        raise SystemExit("ls_parallel=2 changed the line search's decisions")


def phase_k4_eq(dev):
    """K4 on ring-road trial inputs (``ring_trial_inputs``): the equality
    rows, then the same block flagged ``"soc"`` (inequality rule), each
    against the plain version as in ``phase_trial``; returns the equality
    run's numbers."""
    import torch
    from algames_tpu_torch.constraints.sets import block_values
    _, _, gc, traj, *_ = ring_trial_inputs()(dev, torch.float64)
    ring = gc.state_blocks[-1]
    mixed = int(((ring.lam < 0) & (block_values(ring, traj) < 0)).sum())
    log(f"[K4-eq] ring block rows with c < 0 and lam < 0 (the rows where "
        f"the equality and inequality rules differ): {mixed} of "
        f"{ring.lam.numel()}")
    if ring.sense != "eq" or mixed == 0:
        raise SystemExit("the K4-eq inputs miss the rows the equality rule "
                         "changes")
    numbers = phase_trial("K4-eq", ring_trial_inputs(), dev)
    phase_trial("K4-soc", ring_trial_inputs("soc"), dev)
    return numbers


def onto_ring(x0s, p):
    """Starts of the ring-road game: player 0's position put back on the
    ring (radius 4 about (0, -4)) along its radius, its heading along the
    ring, so that the equality rows can hold from the first knot on (the
    perturbed start leaves the ring farther than one step's controls can
    correct, and no lane of either package converges)."""
    x0s = x0s.copy()
    d = np.stack([x0s[:, 0], x0s[:, p] + 4.0], axis=1)
    e = d / np.linalg.norm(d, axis=1, keepdims=True)
    x0s[:, 0], x0s[:, p] = 4.0 * e[:, 0], -4.0 + 4.0 * e[:, 1]
    x0s[:, 2 * p] = np.arctan2(-e[:, 0], e[:, 1])
    return x0s


def phase_sweep_eq(dev):
    """The f32 ring-road sweep: the first B_EQ of the sweep starts (x0 +
    0.05 N(0, 1), numpy seed 0, player 0 put back on the ring,
    ``onto_ring``) as one chunk, outer 7 x 20, through K1 and K4 (the
    equality rows); every trajectory finite, no divergence, the converged
    fraction and the feasible share (the dyn, con and sta gates) each >=
    the reference package's own on the first 256 minus 0.01 (REF_EQ); K1
    and K4 launched, K3 not.  Then the first 256 lanes through the plain
    versions on the card in f64 (each lane's outcome without f32
    rounding) and in f32, and through the kernels in f64: the f64 kernel
    path has the f64 plain path's stats rows on every lane and x within
    1e-8; the f32 kernel path's feasibility agrees with the f64 outcome on
    at least as many lanes as the f32 plain versions' does, minus 0.01."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (kkt_solve_plain, solve_thomas,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval

    prob, spec = ring3_eq_game(dev, torch.float32)
    opts = dataclasses.replace(prob.opts, ls_fused=True)
    prob = dataclasses.replace(prob, opts=opts)
    rng = np.random.default_rng(0)
    x0s = onto_ring(np.asarray(prob.x0.cpu(), np.float64)[None]
                    + 0.05 * rng.standard_normal((N_SWEEP, spec.n)), spec.p)
    x0s = torch.as_tensor(x0s[:B_EQ], dtype=torch.float32, device=dev)
    parallel.solve_batch(dataclasses.replace(prob, opts=dataclasses.replace(
        opts, outer_iter=1, inner_iter=2)), x0s[:64])          # warm-up
    counters = (solve_thomas_structured, trial_eval, solve_thomas)
    for c in counters:
        c.launches = 0
    out, el = timed_sweep(prob, x0s, "thomas")
    k1, k4, k3 = (c.launches for c in counters)
    frac = float(parallel.convergence_fraction(out, opts))
    feas_opts = dataclasses.replace(opts, eps_opt=float("inf"))
    feas = float(parallel.convergence_fraction(out, feas_opts))
    div = float(parallel.divergence_mask(out).float().mean())
    finite = bool(torch.isfinite(out.traj.x).all())
    iters = out.stats.iter.cpu().numpy()
    log(f"[sweep-eq] f32 {B_EQ} scenarios, one chunk, outer "
        f"{opts.outer_iter} x {opts.inner_iter}, kernels: {el:.3f} s, "
        f"{B_EQ / el:.1f} solves/s, stats rows {iters.min()}..{iters.max()} "
        f"(mean {iters.mean():.2f})")
    log(f"[sweep-eq] converged {frac:.4f} (reference {REF_EQ[0]:.4f}; >= "
        f"{REF_EQ[0] - 0.01:.4f}), feasible {feas:.4f} (reference "
        f"{REF_EQ[1]:.4f}; >= {REF_EQ[1] - 0.01:.4f}), diverged {div:.4f}, "
        f"finite {finite}; launches K1 {k1}, K4 {k4}, K3 {k3}")
    if not (finite and div == 0.0 and frac >= REF_EQ[0] - 0.01
            and feas >= REF_EQ[1] - 0.01 and k1 > 0 and k4 > 0 and k3 == 0):
        raise SystemExit("the ring-road sweep failed its gates")
    lanes = 256
    first = dataclasses.replace(out, stats=tree_slice(out.stats, lanes),
                                traj=tree_slice(out.traj, lanes))
    prob64, _ = ring3_eq_game(dev, torch.float64)
    prob64 = dataclasses.replace(prob64, opts=dataclasses.replace(
        prob64.opts, ls_fused=True))
    x64 = x0s[:lanes].double()
    k64, _ = timed_sweep(prob64, x64, "thomas")
    plain64 = dataclasses.replace(prob64, opts=dataclasses.replace(
        prob64.opts, ls_fused=False))
    p64, el64 = timed_sweep(plain64, x64, kkt_solve_plain)
    rows = bool((k64.stats.iter == p64.stats.iter).all())
    dx64 = float((k64.traj.x - p64.traj.x).abs().max())
    plain32 = dataclasses.replace(prob, opts=dataclasses.replace(
        opts, ls_fused=False))
    p32, el32 = timed_sweep(plain32, x0s[:lanes], kkt_solve_plain)
    ok64 = parallel.convergence_mask(p64, feas_opts)
    ok_k = parallel.convergence_mask(first, feas_opts)
    ok_p = parallel.convergence_mask(p32, feas_opts)
    agree_k = float((ok_k == ok64).float().mean())
    agree_p = float((ok_p == ok64).float().mean())
    log(f"[sweep-eq] first {lanes} lanes, f64: kernels and plain versions on "
        f"the card ({el64:.3f} s) with equal stats rows on every lane "
        f"{rows}, max |dx| {dx64:.3e} (<= 1e-8); feasible "
        f"{float(ok64.float().mean()):.4f} in f64 (plain)")
    log(f"[sweep-eq] first {lanes} lanes, f32: feasible "
        f"{float(ok_k.float().mean()):.4f} through the kernels, "
        f"{float(ok_p.float().mean()):.4f} through the plain versions on the "
        f"card ({el32:.3f} s); feasibility as in f64 on {agree_k:.4f} of the "
        f"lanes through the kernels, {agree_p:.4f} through the plain "
        f"versions (kernels >= plain - 0.01)")
    if not (rows and dx64 <= 1e-8 and agree_k >= agree_p - 0.01):
        raise SystemExit("the ring-road sweep's kernel path disagrees with "
                         "the plain versions")
    return {"K1": k1, "K4": k4}


def phase_ladder(dev):
    """The KKT ladder's plain solves on the card: the f32 flagship (outer 3
    x 8, the sweep's first starts) through ``"schur"``, ``"tridiag"`` and
    ``"cr"`` on 256 lanes and ``"dense"`` on 32 ([32, S, S] systems), each
    converged >= 0.99 with no kernel launched; then 8 lanes in f64 (the
    eager trial on all five) through the four and ``"thomas"``: stats rows
    equal, x within 1e-8 of ``"thomas"``'s.  Prints each method's wall time
    per trip of the solver loop (one Newton step for every lane)."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch import parallel
    from algames_tpu_torch.ops.thomas import (solve_thomas,
                                              solve_thomas_structured)
    from algames_tpu_torch.ops.trial import trial_eval
    from algames_tpu_torch.presets import flagship_unicycle

    prob, x0s = sweep_problem(flagship_unicycle, dev, outer=3, inner=8)
    counters = (solve_thomas_structured, trial_eval, solve_thomas)
    out = {}
    for method, lanes in LADDER_LANES.items():
        agt.newton_solve(dataclasses.replace(prob, opts=dataclasses.replace(
            prob.opts, outer_iter=1, inner_iter=1)), x0s[:lanes],
            method=method)                                     # warm-up
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = agt.newton_solve(prob, x0s[:lanes], method=method)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        ran = sum(c.launches - b for c, b in zip(counters, before))
        trips = int(res.stats.iter.max()) - 1
        frac = float(parallel.convergence_fraction(res, prob.opts))
        out[method] = 1e3 * el / trips
        log(f"[ladder] f32 {method}, {lanes} lanes: {el:.3f} s, {trips} "
            f"trips, {out[method]:.2f} ms per trip (one Newton step of every "
            f"lane), converged {frac:.4f} (>= 0.99), kernel launches {ran}")
        if not (frac >= 0.99 and ran == 0
                and bool(torch.isfinite(res.traj.x).all())):
            raise SystemExit(f"the ladder's {method} solve failed its gates")
    p64, _ = flagship_unicycle(dev, torch.float64, outer=3, inner=8)
    x64 = x0s[:8].double()
    ref = agt.newton_solve(p64, x64, method="thomas")
    for method in ("schur", "tridiag", "dense", "cr"):
        res = agt.newton_solve(p64, x64, method=method)
        rows = bool((res.stats.iter == ref.stats.iter).all())
        dx = float((res.traj.x - ref.traj.x).abs().max())
        log(f"[ladder] f64 {method}, 8 lanes: stats rows equal to thomas's "
            f"{rows}, max |x - x_thomas| {dx:.3e} (<= 1e-8)")
        if not (rows and dx <= 1e-8):
            raise SystemExit(f"the f64 {method} solve disagrees with thomas")
    return out


def phase_nullspace(dev):
    """The active-set nullspace on the card.  The game of
    ``examples/nullspace_example.py`` (``crossing_game``), f64, from its
    start and 7 starts + 0.01 N(0, 1) (numpy seed 0), solved through
    ``"tridiag"``: lane 0's ``update_nullspace`` dimension equals the
    reference package's (REF_NULLSPACE); ``update_nullspace_masked`` over
    the 8 lanes, with the rank threshold NS_ATOL, gives each lane's host
    dimension; the flagged vectors satisfy |J_active v| < 1e-7; lane 0's
    basis is first-order invariant (the extended residual moves >= 10x
    less along a basis vector than along a random direction of equal
    norm, eps = 1e-3).  Then one ``update_nullspace_masked`` at the
    roundabout's scale (p=4, N=40, r=0.5, zero trajectory), timed, whose
    dimension equals the reference's."""
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch import active_set as A

    prob, spec = crossing_game(dev, torch.float64)
    rng = np.random.default_rng(0)
    x0s = np.repeat(np.asarray(prob.x0.cpu())[None], 8, axis=0)
    x0s[1:] += 0.01 * rng.standard_normal((7, spec.n))
    t0 = time.perf_counter()
    res = agt.newton_solve(prob, torch.as_tensor(x0s, device=dev),
                           method="tridiag")
    torch.cuda.synchronize()
    log(f"[nullspace] f64 tridiag solve of 8 lanes: "
        f"{time.perf_counter() - t0:.2f} s, stats rows "
        f"{res.stats.iter.tolist()} (reference {REF_NULLSPACE['rows']})")
    prob = dataclasses.replace(prob, gc=res.gc)
    t0 = time.perf_counter()
    host = [A.update_nullspace(prob, res.traj, lane=k) for k in range(8)]
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    dims = [h.mat.shape[1] for h in host]
    t0 = time.perf_counter()
    masked = A.update_nullspace_masked(prob, res.traj, atol=NS_ATOL)
    torch.cuda.synchronize()
    t_masked = time.perf_counter() - t0
    default = A.update_nullspace_masked(prob, res.traj).dim.tolist()
    gc = agt.update_active_set(res.gc, res.traj)
    J = A.extended_jacobian(dataclasses.replace(prob, gc=gc), res.traj)
    worst = 0.0
    for k in range(8):
        vmask, hmask = A.active_masks(prob, gc, lane=k)
        Ja = J[k][torch.as_tensor(vmask, device=dev)][
            :, torch.as_tensor(hmask, device=dev)]
        worst = max(worst, float((Ja @ host[k].mat).abs().max()))
        v = masked.vec[k][masked.mask[k]]
        # Masked vectors: active rows of J, inactive columns pinned.
        ok_rows = torch.ones(J.shape[1], dtype=torch.bool, device=dev)
        ok_rows[spec.S:] = False
        ok_rows[torch.as_tensor(vmask, device=dev)] = True
        worst = max(worst, float((J[k][ok_rows] @ v.T).abs().max()))
    lane0 = dataclasses.replace(prob, gc=A.lane_slice(prob.gc, 0))
    one = agt.PrimalDual(x=res.traj.x[:1], u=res.traj.u[:1],
                         lam=res.traj.lam[:1])
    ratio = invariance_ratio(lane0, one, host[0].vec[0], 1e-3,
                             np.random.default_rng(1))
    log(f"[nullspace] update_nullspace dimensions {dims} (reference "
        f"{REF_NULLSPACE['dims']}; lane 0 gated), {t_host:.2f} s for 8 "
        f"lanes; update_nullspace_masked (atol {NS_ATOL:g}) "
        f"{masked.dim.tolist()}, {t_masked:.2f} s for the batch of 8; at the "
        f"default atol 1e-10 {default} (the reference package's on the CPU: "
        f"{REF_NULLSPACE['masked_default']}, its kernel's singular values "
        f"at ~3e-10, the rounding floor of this matrix); max |J_active v| "
        f"{worst:.3e} "
        f"(< 1e-7); residual change random / basis at eps 1e-3: "
        f"{ratio:.1f} (>= 10)")
    if not (dims[0] == REF_NULLSPACE["dims"][0]
            and masked.dim.tolist() == dims and worst < 1e-7
            and ratio >= 10.0):
        raise SystemExit("the nullspace phase failed its gates")
    big, bspec = crossing_game(dev, torch.float64, p=4, N=40, r=0.5)
    z = agt.PrimalDual(
        x=torch.zeros((1, bspec.N, bspec.n), dtype=torch.float64, device=dev),
        u=torch.zeros((1, bspec.T, bspec.m), dtype=torch.float64, device=dev),
        lam=torch.zeros((1, bspec.p, bspec.T, bspec.n), dtype=torch.float64,
                        device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nb = A.update_nullspace_masked(big, z)
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t0
    Sv, Sh = A.sizes(bspec)
    log(f"[nullspace] roundabout scale (p=4, N=40, Sh={Sh}, masked system "
        f"[{Sv + Sh - bspec.S}, {Sh}] f64): update_nullspace_masked "
        f"{t_big:.2f} s, dimension {int(nb.dim[0])} (reference "
        f"{REF_NULLSPACE['big']})")
    if int(nb.dim[0]) != REF_NULLSPACE["big"]:
        raise SystemExit("the roundabout-scale nullspace dimension differs")
    return {"host_s": t_host, "masked_s": t_masked, "big_s": t_big}


def lane_summary(res, opts):
    """The summary ``parallel.sharded_monte_carlo`` reduces, of one
    result on its own (f32 counts)."""
    import torch
    from algames_tpu_torch import parallel
    B = float(res.traj.x.shape[0])
    it = torch.clamp(res.stats.iter.long() - 1, min=0)[:, None]
    return {"converged_frac": float(
                parallel.convergence_mask(res, opts).float().sum() / B),
            "worst_dyn_vio": float(res.stats.dyn_vio.gather(1, it).max()),
            "divergence_frac": float(
                parallel.divergence_mask(res).float().sum() / B),
            "mean_iters": float(res.stats.iter.float().sum() / B)}


def shard_rank(rank, dev, lanes, runs=()):
    """One rank of the ``shard`` phase: the f32 flagship sweep's first
    ``lanes`` starts through ``sharded_monte_carlo`` over a mesh of the
    world (``"thomas"``, fused trial), its counts zeroed just before and
    read just after: (trajectories on the CPU, summary, launches, wall
    seconds of the call, mesh shape, ``spike_rank``'s results for
    ``runs`` in the same world afterwards, so that the ``spike`` phase
    spawns no world of this size again)."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.presets import flagship_unicycle
    torch.backends.cuda.matmul.allow_tf32 = False
    prob, x0s = sweep_problem(flagship_unicycle, dev, outer=3, inner=8)
    mesh = parallel.make_mesh(device_type=dev.type)
    # Warm-up, untimed: one trip at the same shapes (the group's
    # communicators, the wrappers' per-shape tables, the allocator).
    parallel.sharded_monte_carlo(dataclasses.replace(
        prob, opts=dataclasses.replace(prob.opts, outer_iter=1,
                                       inner_iter=1)), mesh, x0s[:lanes])
    counters = zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trajs, summary = parallel.sharded_monte_carlo(prob, mesh, x0s[:lanes])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shard = (trajs.cpu(), {k: float(v) for k, v in summary.items()},
             read_counters(counters), wall, tuple(mesh.mesh.shape))
    del trajs, summary, prob, x0s
    torch.cuda.empty_cache()
    return shard + (spike_rank(rank, dev, runs),)


def phase_shard(dev, spike_world=1):
    """Scenario sharding (``parallel.sharded_monte_carlo``) on the card:
    B_SHARD lanes of the f32 flagship sweep (outer 3 x 8, ``"thomas"``,
    fused trial).  World 1 on NCCL: trajectories and summary bitwise
    ``solve_many``'s on the same lanes in this process, K1 and K2
    launched.  World 2 on gloo, both ranks on this card: each rank's half
    bitwise ``solve_many`` of the same half; converged >= 0.99, none
    diverged.  Walls of world 2 are shape-only: its ranks share one card.
    The world of ``spike_world`` ranks then runs the ``spike`` phase's
    ranks' solves (``spike_runs``) too, one spawn for both: returns
    ``{"spike": {spike_world: their results by rank}}`` beside the worlds'
    launches and walls."""
    import torch
    from algames_tpu_torch import parallel
    from algames_tpu_torch.presets import flagship_unicycle
    prob, x0s = sweep_problem(flagship_unicycle, dev, outer=3, inner=8)
    x0s = x0s[:B_SHARD]
    parallel.solve_batch(prob, x0s[:64])             # warm-up, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = parallel.solve_many(prob, x0s)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    halves = [parallel.solve_many(prob, x0s[h * B_SHARD // 2:
                                             (h + 1) * B_SHARD // 2])
              for h in range(2)]
    torch.cuda.empty_cache()
    out = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        runs = spike_runs() if world == spike_world else ()
        ranks = parallel.run_ranks(shard_rank, world, backend, "cuda",
                                   B_SHARD, runs, timeout_s=RANK_TIMEOUT_S)
        spawn = time.perf_counter() - t0
        trajs, summary, launches, wall, shape, _ = ranks[0]
        if runs:
            out["spike"] = {world: [r[5] for r in ranks]}
        same_ranks = all(torch.equal(r[0], trajs) and r[1] == summary
                         for r in ranks[1:])
        if world == 1:
            want = lane_summary(ref, prob.opts)
            bitwise = (torch.equal(trajs, ref.traj.x.cpu())
                       and summary == want)
        else:
            want = None
            bitwise = all(torch.equal(
                trajs[h * B_SHARD // 2:(h + 1) * B_SHARD // 2],
                halves[h].traj.x.cpu()) for h in range(2))
        k1 = [r[2]["K1"] for r in ranks]
        k2 = [r[2]["trial"] for r in ranks]
        log(f"[shard] world {world} ({backend}, mesh {shape}): "
            f"{B_SHARD} lanes in {wall:.3f} s ({B_SHARD / wall:.1f} solves/s"
            f"{'; shape-only: the ranks share one card' if world > 1 else ''}"
            f"; solve_many in this process {el:.3f} s); the call with its "
            f"spawn {spawn:.1f} s{' and the spike ranks' if runs else ''}; "
            f"summary {summary}; bitwise "
            f"{'solve_many' if world == 1 else 'each half'}'s {bitwise}"
            f"{f' (summary {want})' if want else ''}; ranks agree "
            f"{same_ranks}; K1 launches per rank {k1}, K2 {k2}")
        if not (bitwise and same_ranks and min(k1) > 0 and min(k2) > 0
                and all(r[2]["K3"] == 0 for r in ranks)
                and summary["converged_frac"] >= 0.99
                and summary["divergence_frac"] == 0.0):
            raise SystemExit(f"the world-{world} sharded sweep failed its "
                             "gates")
        out[world] = {"launches": {"K1": sum(k1), "K2": sum(k2)},
                      "wall": wall}
    return out


def spike_rank(rank, dev, runs):
    """One rank of the ``spike`` phase: ``newton_solve`` of ``spike_game``
    through ``spike_kkt_method`` over the world, per (N, dtype, timed)
    of ``runs``; a timed run solves once at outer 1 x inner 1 first
    (warm-up) and is timed between barriers.  Per run: (x on the CPU,
    stats rows, final dyn_vio, seconds)."""
    import torch
    import torch.distributed as dist
    import algames_tpu_torch as agt
    from algames_tpu_torch.parallel import spike_kkt_method
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for N, dtype, timed in runs:
        prob, _ = spike_game(dev, dtype, N)
        method = spike_kkt_method()
        if timed:
            agt.newton_solve(dataclasses.replace(prob, opts=dataclasses.replace(
                prob.opts, outer_iter=1, inner_iter=1)), method=method)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = agt.newton_solve(prob, method=method)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        it = int(res.stats.iter[0])
        out.append((res.traj.x.cpu(), it,
                    float(res.stats.dyn_vio[0, it - 1]), el))
    return out


def spike_solve(prob, method, timed, x0s=None):
    """(result, seconds, launches) of ``newton_solve``.  A timed solve runs
    once at outer 1 x inner 1 first (warm-up); the kernel counts are zeroed
    after it, just before the solve, and read just after."""
    import torch
    import algames_tpu_torch as agt
    if timed:
        agt.newton_solve(dataclasses.replace(prob, opts=dataclasses.replace(
            prob.opts, outer_iter=1, inner_iter=1)), x0s, method=method)
    torch.cuda.synchronize()
    counters = zero_counters()
    t0 = time.perf_counter()
    res = agt.newton_solve(prob, x0s, method=method)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    return res, el, read_counters(counters)


def spike_path_ok(method, launches):
    """A long-horizon solve's launches: K1 (narrow route) for ``"thomas"``
    and no kernel for the plain methods; never K3 or a trial kernel."""
    return (launches["K3"] == launches["trial"] == 0
            and launches["K1 shared route"] == 0
            and (launches["K1"] > 0) == (method == "thomas"))


def spike_runs():
    """The (N, dtype, timed) runs of every rank of the ``spike`` phase:
    f64 at N=257, untimed, then f32 at each N of SPIKE_NS, timed."""
    import torch
    return [(257, torch.float64, False)] + [(N, torch.float32, True)
                                            for N in SPIKE_NS]


def phase_spike(dev, worlds=((1, "nccl"), (4, "gloo")), done=None):
    """The long-horizon game (``spike_game``) with its KKT step split over
    the horizon (``parallel.spike_kkt_method``), on the card, over each
    (ranks, backend) of ``worlds`` (rank r on card r % device_count).  f64
    at N=257: SPIKE against ``"tridiag"`` and ``"thomas"`` (K1) here:
    equal stats rows, x within 1e-8.  f32, one scenario, N in SPIKE_NS:
    wall ms per solve, stats rows and final dyn_vio of ``"thomas"``,
    ``"tridiag"`` and SPIKE over each world (recorded, not gated lane by
    lane; shape-only where ranks share a card); and ``"thomas"`` on B_LONG
    scenarios at N=257 (x0 + 0.05 N(0, 1), numpy seed 0), all finite.
    Each sequential solve is counted from zero after its warm-up: K1 for
    ``"thomas"``, no kernel for ``"tridiag"``, never K3 or a trial kernel.
    ``done`` maps a world size of ``worlds`` to its ranks' results where
    another phase's world already ran them (``phase_shard``); that world is
    not spawned again.  Returns the rows and K1's launches in the timed f32
    N=257 ``"thomas"`` solves, by lanes (1 and B_LONG)."""
    import torch
    from algames_tpu_torch import parallel
    rows = []
    runs = spike_runs()
    done = done or {}
    torch.cuda.empty_cache()
    spike = {}
    for world, backend in worlds:
        t0 = time.perf_counter()
        if world in done:
            ranks, how = done[world], "in the shard phase's world"
        else:
            ranks = parallel.run_ranks(spike_rank, world, backend, "cuda",
                                       runs, timeout_s=RANK_TIMEOUT_S)
            how = f"in {time.perf_counter() - t0:.1f} s with the spawn"
        same = all(torch.equal(a[0], b[0]) for r in ranks[1:]
                   for a, b in zip(r, ranks[0]))
        log(f"[spike] world {world} ({backend}): {len(runs)} solves per "
            f"rank {how}; every rank's x equal to rank 0's {same}")
        if not same:
            raise SystemExit("the SPIKE ranks disagree")
        spike[world] = ranks[0]
    paths_ok = True
    prob64, _ = spike_game(dev, torch.float64, 257)
    ok = True
    for method in ("tridiag", "thomas"):
        res, _, launches = spike_solve(prob64, method, False)
        paths_ok = paths_ok and spike_path_ok(method, launches)
        it = int(res.stats.iter[0])
        for world in spike:
            x, it_s, _, _ = spike[world][0]
            dx = float((x - res.traj.x.cpu()).abs().max())
            log(f"[spike] f64 N=257: SPIKE over {world} rank(s) against "
                f"{method!r}: stats rows {it_s} / {it}, max |dx| {dx:.3e} "
                f"(<= 1e-8)")
            ok = ok and it_s == it and dx <= 1e-8
    if not ok:
        raise SystemExit("SPIKE disagrees with the sequential solves in f64")
    k1_long = {}
    for k, N in enumerate(SPIKE_NS):
        prob, spec = spike_game(dev, torch.float32, N)
        for m in ("thomas", "tridiag"):
            res, el, launches = spike_solve(prob, m, True)
            paths_ok = paths_ok and spike_path_ok(m, launches)
            if N == 257 and m == "thomas":
                k1_long[1] = launches["K1"]
            it = int(res.stats.iter[0])
            rows.append({"N": N, "T": spec.T, "method": m, "ranks": 1,
                         "ms": el * 1e3, "iters": it,
                         "dyn_vio": float(res.stats.dyn_vio[0, it - 1]),
                         "converged": bool(parallel.convergence_fraction(
                             res, prob.opts) == 1)})
        for world in spike:
            _, it, dyn, el = spike[world][k + 1]
            rows.append({"N": N, "T": spec.T, "method": "spike",
                         "ranks": world, "ms": el * 1e3, "iters": it,
                         "dyn_vio": dyn,
                         **({"note": "shape-only: the ranks share one card"}
                            if world > torch.cuda.device_count() else {})})
    for r in rows:
        log(f"[spike] f32 N={r['N']} (T={r['T']}), B=1: {r['method']} over "
            f"{r['ranks']} rank(s): {r['ms']:.1f} ms per solve, stats rows "
            f"{r['iters']}, dyn_vio {r['dyn_vio']:.3e}"
            f"{', converged %s' % r['converged'] if 'converged' in r else ''}"
            f"{' (' + r['note'] + ')' if 'note' in r else ''}")
    prob, spec = spike_game(dev, torch.float32, 257)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(np.asarray(prob.x0.cpu(), np.float64)[None]
                          + 0.05 * rng.standard_normal((B_LONG, spec.n)),
                          dtype=torch.float32, device=dev)
    res, el, launches = spike_solve(prob, "thomas", True, x0s)
    paths_ok = paths_ok and spike_path_ok("thomas", launches)
    k1_long[B_LONG] = launches["K1"]
    frac = float(parallel.convergence_fraction(res, prob.opts))
    log(f"[spike] f32 N=257, B={B_LONG} through 'thomas': {el * 1e3:.1f} ms, "
        f"stats rows {int(res.stats.iter.min())}..{int(res.stats.iter.max())},"
        f" converged {frac:.4f} (reported); K1 launches in the timed f32 "
        f"N=257 'thomas' solve, counted from zero after its warm-up: "
        f"{k1_long[1]} at B=1, {k1_long[B_LONG]} at B={B_LONG}; every "
        f"sequential solve on its kernels {paths_ok}")
    if not (bool(torch.isfinite(res.traj.x).all()) and paths_ok):
        raise SystemExit("the long-horizon solves failed their checks")
    return {"rows": rows, "launches": k1_long}


def phase_aux(dev):
    """The auxiliary modules on the card: a ``SolveResult`` checkpoint
    round trip (``save_pytree`` / ``restore_pytree``; device, dtype and
    values kept bitwise) and a trajectory's (``save_traj`` /
    ``load_traj``); ``profiling.timed_solve`` bitwise ``newton_solve``'s,
    one wall time per trip; ``profiling.device_trace`` writes a Chrome
    trace that holds K1's kernels.  8 lanes of the f32 flagship sweep."""
    import os
    import tempfile
    import torch
    import algames_tpu_torch as agt
    from algames_tpu_torch import checkpoint, profiling
    from algames_tpu_torch.presets import flagship_unicycle
    from algames_tpu_torch.utils import tree_leaves
    prob, x0s = sweep_problem(flagship_unicycle, dev, outer=3, inner=8)
    x0s = x0s[:8]
    res = agt.newton_solve(prob, x0s)
    out, t_elap = profiling.timed_solve(prob, x0s)
    timed_same = all(torch.equal(a, b) for a, b in
                     zip(tree_leaves(out), tree_leaves(res)))
    trips = int(res.stats.iter.max()) - 1
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_pytree(os.path.join(tmp, "res"), res)
        back = checkpoint.restore_pytree(os.path.join(tmp, "res"), res)
        pairs = list(zip(tree_leaves(res), tree_leaves(back)))
        ckpt_same = all(a.device == b.device and a.dtype == b.dtype
                        and torch.equal(a, b) for a, b in pairs)
        checkpoint.save_traj(os.path.join(tmp, "t.npz"), res.traj)
        t = checkpoint.load_traj(os.path.join(tmp, "t.npz"), device=dev)
        traj_same = all(torch.equal(getattr(t, k), getattr(res.traj, k))
                        for k in ("x", "u", "lam"))
        with profiling.device_trace(os.path.join(tmp, "trace")):
            agt.newton_solve(prob, x0s)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace", "trace.json")
        trace = open(path).read()
        has_k1 = "thomas_sq_" in trace
        size = os.path.getsize(path)
    log(f"[aux] checkpoint round trip of a SolveResult ({len(pairs)} leaves, "
        f"{res.traj.x.device}, {res.traj.x.dtype}): bitwise {ckpt_same}; "
        f"trajectory .npz bitwise {traj_same}; timed_solve bitwise "
        f"newton_solve's {timed_same}, {len(t_elap)} times for {trips} trips "
        f"(median {1e3 * float(np.median(t_elap)):.2f} ms a trip); "
        f"device_trace wrote {size} bytes, K1 kernels in it {has_k1}")
    if not (ckpt_same and traj_same and timed_same and len(t_elap) == trips
            and has_k1):
        raise SystemExit("the auxiliary modules failed their checks")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from algames_tpu_torch.ops.thomas import (solve_thomas,
                                              solve_thomas_structured)
    from algames_tpu_torch.presets import (flagship_unicycle, intro_bicycle,
                                           intro_di, quadrotor3d, roundabout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] {label}: {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s so far)")
        return out
    flag_kkt = (solve_thomas_structured, solve_thomas)
    phase("build", phase_build)
    k1 = phase("K1", phase_k1, dev)
    k2 = phase("K2", phase_trial, "K2", k2_inputs, dev)
    phase("golden", phase_golden, "golden", flagship_unicycle, "uni3_N20",
          flag_kkt, dev)
    launches = phase("sweep", phase_sweep, dev)
    k3 = phase("K3", phase_k3, dev)
    k4 = phase("K4", phase_trial, "K4", k4_inputs, dev)
    phase("golden4", phase_golden, "golden4", roundabout, "round4_N40",
          flag_kkt[::-1], dev)
    launches4 = phase("sweep4", phase_game_sweep, "sweep4", roundabout,
                      REF_CONVERGED["round4_N40"], dev, True, None, N_SWEEP)

    # The double integrator (K1 + K4), the bicycle (dense Q: K3 + K4) and
    # the quadrotor (K1 + K4, the thrust kink at u = 0).
    k1_di = phase("K1-di2", phase_k1, dev, "K1-di2", intro_di,
                  golden_iterates("di2_N10"), 300)
    k4_di = phase("K4-di2", phase_trial, "K4-di2",
                  game_trial_inputs(intro_di, "di2_N10", 13), dev)
    phase("golden-di2", phase_golden, "golden-di2", intro_di, "di2_N10",
          flag_kkt, dev)
    launches_di = phase("sweep-di2", phase_game_sweep, "sweep-di2", intro_di,
                        REF_CONVERGED["di2_N10"], dev)
    k3_bike = phase("K3-bike3", phase_k3, dev, "K3-bike3", intro_bicycle,
                    golden_iterates("bike3_N20"), 400, B_KERNEL)
    k4_bike = phase("K4-bike3", phase_trial, "K4-bike3",
                    game_trial_inputs(intro_bicycle, "bike3_N20", 17), dev)
    phase("golden-bike3", phase_golden, "golden-bike3", intro_bicycle,
          "bike3_N20", flag_kkt[::-1], dev, (5e-3, 5e-2), BIKE3_PLAIN_TOL)
    launches_bike = phase("sweep-bike3", phase_game_sweep, "sweep-bike3",
                          intro_bicycle, REF_CONVERGED["bike3_N20"], dev, True)
    k1_quad = phase("K1-quad2", phase_k1, dev, "K1-quad2", quadrotor3d,
                    golden_iterates("quad2_N15"), 500, "backward")
    k4_quad = phase("K4-quad2", phase_trial, "K4-quad2",
                    game_trial_inputs(quadrotor3d, "quad2_N15", 19,
                                      zero_u=True), dev)
    phase("K4-quad2-smooth", phase_trial, "K4-quad2-smooth",
          game_trial_inputs(quadrotor3d, "quad2_N15", 23, zero_u=True,
                            smoothing=100.0), dev)
    phase("K4-di3", phase_trial, "K4-di3", lambda d, t: trial_inputs(
        di3_game, random_iterates, True, d, t, seed=29), dev)
    phase("golden-quad2", phase_golden, "golden-quad2", quadrotor3d,
          "quad2_N15", flag_kkt, dev)
    # K3 on the quadrotor's systems turned dense (its LU class for d <= 32)
    # and, beyond its classes, on the 3-player quadrotor's (d=48).
    k3_big = phase("K3-big", phase_k3_quad, dev, "K3-big", quad_dense_system,
                   800)
    phase("golden-big", phase_golden_big, dev)
    launches_big = phase("sweep-quad2-dense", phase_sweep_quad2_dense, dev)
    phase("K3-big48", phase_k3_quad, dev, "K3-big48",
          functools.partial(quad_dense_system, preset=quad3_game), 850,
          B_BEYOND, True)
    launches_quad = phase("sweep-quad2", phase_game_sweep, "sweep-quad2",
                          quadrotor3d, REF_CONVERGED["quad2_N15"], dev, False,
                          QUAD_OPT_GATE)
    # The 3-player quadrotor (d=48): K1's tall class, K4 at n=36; beyond
    # the classes, the 4-player quadrotor (d=64): K1 on its per-player
    # blocked route in f64 and f32, K3 (with collision-cost pairs) on its
    # own, K4 at n=48.
    k1_wide = phase("K1-wide", lambda: phase_k1(
        dev, "K1-wide", quad3_game, quad3_iterates, 900, "backward",
        shared_too=True))
    phase("solve-wide", phase_solve_wide, dev)
    k4_quad3 = phase("K4-quad3", phase_trial, "K4-quad3", lambda d, t:
                     trial_inputs(quad3_game, quad3_iterates, True, d, t,
                                  seed=43), dev)
    launches_quad3 = phase("sweep-quad3", phase_sweep_quad3, dev, k1_wide,
                           k4_quad3)
    k1_wide64 = phase("K1-wide64", phase_beyond, dev, "K1-wide64",
                      "structured", 950)
    # K1's blocked route where d is no multiple of 16: beyond the classes
    # at the 6-player unicycle's widths (d=36) beside the other routes, and
    # forced onto the flagship's systems (d=18) beside their class.
    phase("K1-wide36", phase_wide36, dev)
    phase("K1-blocked18", phase_beyond, dev, "K1-blocked18", "structured",
          970, B_BEYOND, None, flagship_iterates, BLOCKED_ROUTES)
    k3_big64 = phase("K3-big64", phase_beyond, dev, "K3-big64", "dense",
                     960)
    # K3's blocked route where d is no multiple of 16 (the 6-player
    # unicycle's systems turned dense, d=36, beside both older routes) and
    # forced onto the roundabout's own systems (d=24) beside their class.
    phase("K3-wide36", phase_beyond, dev, "K3-wide36", "dense", 1900,
          B_BEYOND, uni6_game, flagship_iterates, UNI6_ROUTES)
    phase("K3-blocked24", phase_beyond, dev, "K3-blocked24", "dense", 1950,
          B_BEYOND, None, None, BLOCKED_ROUTES, k3_system)
    k4_quad4 = phase("K4-quad4", phase_trial, "K4-quad4", lambda d, t:
                     trial_inputs(quad4_game, quad3_iterates, True, d, t,
                                  seed=47), dev)
    phase("K4-quad4-bound", phase_trial, "K4-quad4-bound", lambda d, t:
          trial_inputs(quad4_bound_game, quad3_iterates, True, d, t,
                       seed=53), dev)
    k4_cost = phase("K4-quad4-cost", phase_trial, "K4-quad4-cost",
                    lambda d, t: trial_inputs(quad4_cost_game, quad3_iterates,
                                              True, d, t, seed=59), dev)
    launches_wide64 = phase("solve-wide64", phase_solve_beyond, dev,
                            "solve-wide64", quad4_game, "K1")
    launches_big64 = phase("solve-big64", phase_solve_beyond, dev,
                           "solve-big64", quad4_cost_game, "K3")
    launches_quad4 = phase("sweep-quad4", phase_sweep_beyond, dev, k4_quad4)
    launches_cost = phase("sweep-quad4-dense", phase_sweep_quad4_dense, dev,
                          k4_cost)

    # The 9-player flagship merge (d=54, NW=72, n=36, 72 state blocks): K1
    # past 64 w vectors (f32 on the blocked route, f64 with its products
    # over K's slots), K2's wide unicycle instance.
    launches_g9 = phase("golden-uni9", phase_golden_uni9, dev)
    k1_uni9 = phase("K1-uni9", phase_beyond, dev, "K1-uni9", "structured",
                    2200, B_BEYOND, uni9_game, flagship_iterates, UNI9_ROUTES,
                    None, B_DENSE9)
    k2_uni9 = phase("K2-uni9", phase_trial, "K2-uni9", lambda d, t:
                    trial_inputs(uni9_game, flagship_iterates, True, d, t,
                                 seed=61), dev)
    launches_uni9 = phase("sweep-uni9", phase_sweep_beyond, dev, k2_uni9,
                          "sweep-uni9", uni9_sweep_game, flagship_iterates,
                          REF_UNI9, 1e-2, UNI9_ROUTES, (2290, 2300), 0, "K2",
                          B_DENSE9, False)

    # The widest unicycle merges: K1's route at 10 .. 17 players; K1 on its
    # device-memory route at 12 (the first past 128 w vectors), 15 (f64:
    # the route that did not fit a block before) and 17 players (d=102,
    # m=34, NW=272); K3 on the 17-player systems turned dense; K2's wide
    # unicycle instance (n=68, 272 state blocks; and with a state bound,
    # its rows flagged in the parameter array past the 128th); the f64
    # golden and an f32 sweep of the 17-player merge.
    phase("routes-wide", phase_routes_wide, dev)
    k1_uni12 = phase("K1-uni12", phase_beyond, dev, "K1-uni12", "structured",
                     2400, B_BEYOND, uni12_game, flagship_iterates,
                     UNI_DEVICE_ROUTES, None, B_LIBRARY_WIDE[12], 3,
                     B_LIBRARY_WIDE[12])
    k1_uni15 = phase("K1-uni15", phase_beyond, dev, "K1-uni15", "structured",
                     2500, B_UNI15, uni15_game, flagship_iterates,
                     UNI_DEVICE_ROUTES, None, B_LIBRARY_WIDE[15], 3,
                     B_LIBRARY_WIDE[15], ("f64",))
    k1_uni17 = phase("K1-uni17", phase_beyond, dev, "K1-uni17", "structured",
                     2600, B_BEYOND, uni17_game, flagship_iterates,
                     UNI_DEVICE_ROUTES, None, B_LIBRARY_WIDE[17], 3,
                     B_LIBRARY_WIDE[17])
    k3_uni17 = phase("K3-uni17", phase_beyond, dev, "K3-uni17", "dense", 2700,
                     B_K3_UNI17, uni17_game, flagship_iterates,
                     UNI_DEVICE_ROUTES, None, 1, 3, 1)
    k2_uni17 = phase("K2-uni17", phase_trial, "K2-uni17", lambda d, t:
                     trial_inputs(uni17_game, flagship_iterates, True, d, t,
                                  seed=67), dev)
    phase("K2-uni17-bound", phase_trial, "K2-uni17-bound", lambda d, t:
          trial_inputs(uni17_bound_game, flagship_iterates, True, d, t,
                       seed=71), dev)
    launches_g17 = phase("golden-uni17", phase_golden_uni9, dev,
                         "golden-uni17", uni17_game, "uni17_N20", B_GOLDEN17)
    sweep17 = phase("sweep-uni17", phase_sweep_uni17, dev)

    # The heterogeneous double integrator (K3 padded + K4's player-blocked
    # instance) and iterative best response (K3 at p=1).
    k3_het = phase("K3-hetero", phase_k3, dev, "K3-hetero", hetero_game,
                   golden_iterates("hetero2_N8"), 600, B_KERNEL)
    k4_het = phase("K4-hetero", phase_trial, "K4-hetero",
                   game_trial_inputs(hetero_game, "hetero2_N8", 37), dev)
    phase("golden-hetero", phase_golden, "golden-hetero", hetero_game,
          "hetero2_N8", flag_kkt[::-1], dev)
    launches_het = phase("sweep-hetero", phase_game_sweep, "sweep-hetero",
                         hetero_game, REF_CONVERGED["hetero2_N8"], dev, True)
    k3_ibr = phase("K3-ibr", phase_k3, dev, "K3-ibr", flagship_unicycle,
                   flagship_iterates, 700, B_KERNEL, ibr_player_system)
    phase("golden-ibr", phase_golden_ibr, dev)
    launches_ibr = phase("sweep-ibr", phase_sweep_ibr, dev)
    k3_ibr_quad = phase("K3-ibr-quad", phase_k3_quad, dev, "K3-ibr-quad",
                        ibr_quad_system, 1700)
    launches_ibr_quad = phase("sweep-ibr-quad2", phase_sweep_ibr_quad, dev,
                              k3_ibr_quad)

    # BASELINE config 3: the highway's receding-horizon closed loop, K1 at
    # B_MPC lanes and at one; then the ls_parallel window on the flagship.
    k1_hw = {B: phase(f"K1-highway{B}", phase_k1, dev, f"K1-highway{B}",
                      highway_game, flagship_iterates, 1100 + B, "forward",
                      B) for B in (B_MPC, 1)}
    k2_hw = phase(f"K2-highway{B_MPC}", phase_trial, f"K2-highway{B_MPC}",
                  highway_trial_inputs, dev)
    mpc = phase("mpc", phase_mpc, dev, k1_hw)
    phase("mpc-plain", phase_mpc_plain, dev)
    mpc_fused = phase("mpc-fused", phase_mpc_fused, dev)
    phase("ls-parallel", phase_ls_parallel, dev)

    # The ring road (an equality block: K1 with its w vector, the
    # equality rows penalized at mu in K1-ring-eq, and K4's equality rows),
    # the KKT ladder's plain solves and the active-set nullspace.
    k1_ring = phase("K1-ring", phase_k1, dev, "K1-ring", ring3_eq_game,
                    golden_iterates("ring3_eq_N20"), 1300)
    phase("K1-ring-eq", phase_k1, dev, "K1-ring-eq", ring3_eq_game,
          golden_iterates("ring3_eq_N20"), 1400, "backward", B_KERNEL,
          True)
    k4_eq = phase("K4-eq", phase_k4_eq, dev)
    phase("golden-eq", phase_golden, "golden-eq", ring3_eq_game,
          "ring3_eq_N20", flag_kkt, dev)
    launches_eq = phase("sweep-eq", phase_sweep_eq, dev)
    phase("ladder", phase_ladder, dev)
    phase("nullspace", phase_nullspace, dev)

    # Scenario sharding and the long-horizon game: K1 at T=256, SPIKE over
    # ranks (the 1-rank world of both spawned once, in ``shard``); then the
    # checkpoint and profiling modules.
    shard = phase("shard", phase_shard, dev)
    long_game = functools.partial(spike_game, N=257)
    k1_long = {B: phase(f"K1-long{B}", phase_k1, dev, f"K1-long{B}",
                        long_game, flagship_iterates, 1500 + B, "forward",
                        B) for B in (B_LONG, 1)}
    spike = phase("spike", phase_spike, dev, ((1, "nccl"), (4, "gloo")),
                  shard["spike"])
    phase("aux", phase_aux, dev)

    def entry(kernel, game, launches, numbers, source=None):
        name, src, replaces = KERNELS[kernel]
        return {"name": f"{kernel} {name} ({game})", "route": "cuda",
                "source": f"algames_tpu_torch/csrc/{source or src}",
                "replaces": replaces, "launches": launches, **numbers}
    kernels = [
        entry("K1", "uni3_N20", launches["K1"], k1),
        entry("K1", "di2_N10", launches_di["K1"], k1_di),
        entry("K1", "quad2_N15", launches_quad["K1"], k1_quad),
        entry("K1", "quad3 (3-player quadrotor, d=48): the tall "
              "register-tiled class", launches_quad3["K1"], k1_wide),
        entry("K1", "quad4 (4-player quadrotor, d=64), f64: the "
              "per-player blocked route; launches at B=4, times at "
              f"B={B_BEYOND}", launches_wide64["K1 blocked route"],
              {**k1_wide64["f64"]["blocked"], "launches_lanes": 4,
               "timed_lanes": B_BEYOND}, "thomas_blocked.cuh"),
        entry("K1", "quad4 (4-player quadrotor, d=64), f64: the "
              "device-memory route, timed beside the route the shape "
              "takes; launches at B=4, times at "
              f"B={B_BEYOND}", launches_wide64["K1 device route"],
              {**k1_wide64["f64"]["device"], "launches_lanes": 4,
               "timed_lanes": B_BEYOND}, "thomas_global.cuh"),
        entry("K1", f"quad4 (4-player quadrotor, d=64), f32 sweep, B={CHUNK}"
              ": the per-player blocked route",
              launches_quad4["K1 blocked route"],
              {**launches_quad4["k1_rows"]["blocked"],
               "launches_lanes": CHUNK, "timed_lanes": CHUNK},
              "thomas_blocked.cuh"),
        entry("K1", f"quad4 (4-player quadrotor, d=64), f32 sweep, B={CHUNK}"
              ": the shared-memory kernel, timed beside the route the "
              "shape takes", launches_quad4["K1 shared route"],
              {**launches_quad4["k1_rows"]["shared"],
               "launches_lanes": CHUNK, "timed_lanes": CHUNK}),
        entry("K1", f"quad4 (4-player quadrotor, d=64), f32 sweep, B={CHUNK}"
              ": the device-memory route, timed beside the route the shape "
              "takes", launches_quad4["K1 device route"],
              {**launches_quad4["k1_rows"]["device"],
               "launches_lanes": CHUNK, "timed_lanes": CHUNK},
              "thomas_global.cuh"),
        entry("K1", "uni9_N20 (9-player merge, d=54, NW=72), f32: the "
              f"per-player blocked route; launches in the B={CHUNK} sweep, "
              f"times at B={B_BEYOND} (the library call on the sweep's "
              "dense matrices takes over half a minute)",
              launches_uni9["K1 blocked route"],
              {**k1_uni9["f32"]["blocked"], "launches_lanes": CHUNK,
               "timed_lanes": B_BEYOND,
               "device_ms_sweep_batch": launches_uni9["k1_rows"]["blocked"][
                   "device_ms"]}, "thomas_blocked.cuh"),
        entry("K1", "uni9_N20 (9-player merge, d=54, NW=72), f32: the "
              "device-memory route, timed beside the route the shape takes; "
              f"launches in the B={CHUNK} sweep, times at B={B_BEYOND}",
              launches_uni9["K1 device route"],
              {**k1_uni9["f32"]["device"], "launches_lanes": CHUNK,
               "timed_lanes": B_BEYOND,
               "device_ms_sweep_batch": launches_uni9["k1_rows"]["device"][
                   "device_ms"]}, "thomas_global.cuh"),
        entry("K1", "uni9_N20 (9-player merge, d=54, NW=72), f64: the "
              "per-player blocked route with Pw over K's slots; launches at "
              f"B={B_GOLDEN9}, times at B={B_BEYOND}",
              launches_g9["K1 blocked route"],
              {**k1_uni9["f64"]["blocked"], "launches_lanes": B_GOLDEN9,
               "timed_lanes": B_BEYOND}, "thomas_blocked.cuh"),
        entry("K1", "uni9_N20 (9-player merge, d=54, NW=72), f64: the "
              "device-memory route, timed beside the route the shape takes; "
              f"launches at B={B_GOLDEN9}, times at B={B_BEYOND}",
              launches_g9["K1 device route"],
              {**k1_uni9["f64"]["device"], "launches_lanes": B_GOLDEN9,
               "timed_lanes": B_BEYOND}, "thomas_global.cuh"),
        entry("K2", f"uni9_N20 (9-player merge, n=36, 72 state blocks): the "
              f"wide unicycle instance, B={CHUNK}", launches_uni9["trial"],
              k2_uni9),
        entry("K1", "uni12 (12-player merge, d=72, NW=132), f64: the "
              f"device-memory route; no main path, times at B={B_BEYOND}",
              0, {**k1_uni12["f64"]["device"], "timed_lanes": B_BEYOND},
              "thomas_global.cuh"),
        entry("K1", "uni12 (12-player merge, d=72, NW=132), f32: the "
              f"device-memory route; no main path, times at B={B_BEYOND}",
              0, {**k1_uni12["f32"]["device"], "timed_lanes": B_BEYOND},
              "thomas_global.cuh"),
        entry("K1", "uni15 (15-player merge, d=90, NW=210), f64: the "
              f"device-memory route; no main path, times at B={B_UNI15}",
              0, {**k1_uni15["f64"]["device"], "timed_lanes": B_UNI15},
              "thomas_global.cuh"),
        entry("K1", "uni17_N20 (17-player merge, d=102, m=34, NW=272), f64: "
              f"the device-memory route; launches at B={B_GOLDEN17}, times "
              f"at B={B_BEYOND}", launches_g17["K1 device route"],
              {**k1_uni17["f64"]["device"], "launches_lanes": B_GOLDEN17,
               "timed_lanes": B_BEYOND}, "thomas_global.cuh"),
        entry("K1", "uni17_N20 (17-player merge, d=102, m=34, NW=272), f32: "
              f"the device-memory route; launches in the B={B_SWEEP17} sweep, "
              f"times at B={B_BEYOND}", sweep17["K1 device route"],
              {**k1_uni17["f32"]["device"], "launches_lanes": B_SWEEP17,
               "timed_lanes": B_BEYOND,
               "device_ms_sweep_batch": sweep17["k1_row"]["device_ms"]},
              "thomas_global.cuh"),
        entry("K3", "uni17 turned dense (d=102, m=34), f64: the "
              f"device-memory route; no main path, times at B={B_K3_UNI17}",
              0, {**k3_uni17["f64"]["device"], "timed_lanes": B_K3_UNI17},
              "thomas_global.cuh"),
        entry("K2", "uni17_N20 (17-player merge, n=68, m=34, 272 state "
              f"blocks): the wide unicycle instance; launches in the "
              f"B={B_SWEEP17} sweep, times at B={B_KERNEL}",
              sweep17["trial"], {**k2_uni17, "launches_lanes": B_SWEEP17,
                                 "timed_lanes": B_KERNEL,
                                 "device_ms_sweep_batch":
                                     sweep17["k2_device_ms"]}),
        entry("K1", f"highway_mpc, B={B_MPC}", mpc[B_MPC]["launches"]["K1"],
              k1_hw[B_MPC]),
        entry("K1", "highway_mpc, B=1", mpc[1]["launches"]["K1"], k1_hw[1]),
        entry("K2", "uni3_N20", launches["K2"], k2),
        entry("K2", f"highway_mpc, B={B_MPC}",
              mpc_fused["launches"]["trial"], k2_hw),
        entry("K3", "round4_N40", launches4["K3"], k3),
        entry("K3", "bike3_N20", launches_bike["K3"], k3_bike),
        entry("K3", "hetero2_N8, padded", launches_het["K3"], k3_het),
        entry("K3", "ibr_uni3_N20, p=1 player systems", launches_ibr["K3"],
              k3_ibr),
        entry("K3", "quad2_N15 turned dense (d=32): the LU class",
              launches_big["K3"], k3_big),
        entry("K3", "ibr_quad2_N15, p=1 player systems (d=28): the LU class",
              launches_ibr_quad["K3"], k3_ibr_quad),
        entry("K3", "quad4 with collision-cost pairs (d=64), f64: the "
              "per-player blocked route; launches at B=4, times at "
              f"B={B_BEYOND} on quad4's systems turned dense",
              launches_big64["K3 blocked route"],
              {**k3_big64["f64"]["blocked"], "launches_lanes": 4,
               "timed_lanes": B_BEYOND}, "thomas_blocked.cuh"),
        entry("K3", "quad4 with collision-cost pairs (d=64), f64: the "
              "device-memory route, timed beside the route the shape "
              f"takes; launches at B=4, times at B={B_BEYOND}",
              launches_big64["K3 device route"],
              {**k3_big64["f64"]["device"], "launches_lanes": 4,
               "timed_lanes": B_BEYOND}, "thomas_global.cuh"),
        entry("K3", "quad4 with collision-cost pairs (d=64), f32 sweep, "
              f"B={CHUNK}: the per-player blocked route",
              launches_cost["K3 blocked route"],
              {**launches_cost["k3_rows"]["blocked"],
               "launches_lanes": CHUNK, "timed_lanes": CHUNK},
              "thomas_blocked.cuh"),
        entry("K3", "quad4 with collision-cost pairs (d=64), f32 sweep, "
              f"B={CHUNK}: the device-memory route, timed beside the route "
              "the shape takes", launches_cost["K3 device route"],
              {**launches_cost["k3_rows"]["device"],
               "launches_lanes": CHUNK, "timed_lanes": CHUNK},
              "thomas_global.cuh"),
        entry("K4", "round4_N40", launches4["K4"], k4),
        entry("K4", "di2_N10", launches_di["K4"], k4_di),
        entry("K4", "bike3_N20", launches_bike["K4"], k4_bike),
        entry("K4", "quad2_N15", launches_quad["K4"], k4_quad),
        entry("K4", "quad3 (n=36)", launches_quad3["trial"], k4_quad3),
        entry("K4", "quad4 (n=48)", launches_quad4["trial"], k4_quad4),
        entry("K4", "quad4 with collision-cost pairs (n=48)",
              launches_cost["trial"], k4_cost),
        entry("K4", "hetero2_N8", launches_het["K4"], k4_het),
        entry("K1", "ring3_eq_N20", launches_eq["K1"], k1_ring),
        entry("K4", "ring3_eq_N20", launches_eq["K4"], k4_eq),
        entry("K1", f"long horizon, spike_uni2_N257 (T=256), B={B_LONG}",
              spike["launches"][B_LONG], k1_long[B_LONG]),
        entry("K1", "long horizon, spike_uni2_N257 (T=256), B=1",
              spike["launches"][1], k1_long[1]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
