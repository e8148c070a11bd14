#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``trajopt_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # about twelve minutes on one H100

Phases, each of which must pass (the float64 reference solves of phases 4, 8,
15, 17 and 18 run on the CPU in worker processes beside the GPU phases).
Phases 1 to 5 run in their order; from the end of the build on, the
kernel phases 21, 32, 26, 29 and 35 run in two worker processes on the card
(``KERNEL_WORKER_PHASES``; no two processes time a kernel at once) while
the main process runs phases 6, 7, 8, 10 to 15, 17 and 20, then collects
them and runs the profiles 9, 16, 19 and 24; from there on the host-bound
paths run side by side on the card, each in a worker process of its own
(slice 4's pool 18, the kuka pool 23, slice 6's paths 27 in two, slice 7's
path (a) in three and its phase-split arms, slice 8's paths in two, slice
9's in three), while the main process runs phases 22, 25, 30 and 28 and
then collects the workers' results in the order 18, 23, 27, 31, 30, 33, 34,
36 (``PHASES``):

1. device and build: the card's name and power limit from ``nvidia-smi``,
   TF32 off (``precise``), the CUDA kernels' build from ``csrc/`` by nvcc
   started, one compiler per source side by side (each phase waits for its
   own kernels' libraries only, so phases 2 to 5 run while the slowest
   sources still compile; phase ``build_report``, after phase 5, waits for
   every library and prints each compiler's seconds and ptxas's register
   and spill report, for every K2, K3, K4 and K7b instantiation its
   registers, stack and spill), each wrapper refusing a
   float64 CUDA input, and what has no kernel refused (a shape K5 is not
   built for, ballonbeam and a chain's minimum-time model in a fused
   kernel, a model under rk4);
2. kernel K1 (``csrc/sqrt_sweep.cu``) against its plain version on the
   card, float32, at the main path's shapes (B=128, N=101, error state
   n=12, m=4), on error-state linearizations of ``quadrotor_line`` around
   128 perturbed starts, for rho in {0, 1e-2}; at rho = 0 one problem needs
   the equilibrated Cholesky fallback and one fails outright; its block
   (Wc consumer and Wp producer warps, the ring's S slots, G knots a
   producer step) and its launch shapes (B = 128, 1024, 1152 and 33,
   bitwise equal, the branch problems among them); its time at B = 1024;
   and the cartpole's (4, 1) and the car's (3, 2) sweeps and two at
   (5, 3) and (13, 17), which no model gives, against the plain version;
3. kernel K2 (``csrc/rollout.cu``, the quadrotor's error state) against its plain version on
   the card, float32, B=128, N=101, with two lanes forced to diverge, and on
   stiff gains against the plain version in float64; and its launch shapes:
   the same problems at B = 128, 1024 and 1152 (tiled) and 33, bitwise
   equal;
4. slice 1: ``solve_batch_queued`` on ``quadrotor_line(N=101)`` in float32
   with the quadrotor benchmark's options, a pool of 256 perturbed starts
   over 128 lanes. K1's and K2's launch counters must move, the outcome
   bars must hold, and the first problems of the pool must agree with a
   float64 solve of the same problems by the plain versions on the CPU;
5. profile of one slice-1 round of 3 iLQR iterations on 128 lanes, timed
   plainly and then under ``torch.profiler``: device busy share, launches
   and host syncs per iteration, and the kernels that take the device time;
6. kernel K3 (``csrc/fused_al_backward.cu``) against its plain version on
   the card, float32, B=128, N=101, on the infeasible-start maze stack
   (P = 89): benign duals, late-schedule duals, a problem made indefinite,
   and the in-kernel Jacobians against ``jacobian_traj``; its block (Wc
   consumer and Wp producer warps, the ring's S slots, shared memory) and
   its launch shapes (B = 128, 1024, 1152 and 33, bitwise equal; the block
   differs between them);
7. kernel K4 (``csrc/fused_al_forward.cu``) against its plain version on
   the card, same shapes, gains from K3, with lanes forced to diverge and
   one whose search runs out, the warps W a problem and the rounds of W
   candidates the launch took, and its launch shapes (B = 128, 1024, 1152
   and 33, bitwise equal; W differs between them);
8. slice 2: ``solve_batch_queued_altro_retry`` on ``quadrotor_maze`` in
   float32 with the maze benchmark's options, a pool of 512 perturbed
   starts over 128 lanes. K3's and K4's counters must move, K1's and K2's must
   not, the quality gates must hold, and one of the first problems must
   agree in outcome with a float64 solve by the plain versions on the CPU;
9. profile of one maze round of 10 iLQR iterations on 128 lanes;
10. kernel K5 (``csrc/riccati_sweep.cu``) against its plain version
    ``scan_sweep`` on the card, float32, B=128, N=101, on full-state
    linearizations of the quadrotor (13, 4) and of the cartpole (4, 1): with
    control and state regularization, a problem made indefinite, a problem
    whose controls are scaled over 12 decades, and every other shape the
    kernel is built for (slice 7's on the linearizations of the forms that
    run them: the Euler-angle quadrotor with slacks, the minimum-time
    forms); its block (Wc consumer and Wp producer warps, the
    ring's S slots), its time at B = 1024 (slice 3's batch) and the
    quadrotor's launch shapes (B = 128, 1024, 1152 and 33, bitwise equal);
11. kernel K7a (``csrc/fused_backward.cu``) against its plain version and
    against K5 fed the ``torch.func`` Jacobians, and its in-kernel Jacobians
    against ``jacobian_traj``, for all five models; its block (and G, the
    knots a producer warp expands at once), the quadrotor's time at
    B = 1024 (slice 3 arm (a)) and its launch shapes;
12. kernel K7b (``csrc/fused_forward.cu``) against its plain version, with
    lanes forced to diverge and one whose search runs out, for all five
    models, the rounds of W candidates each launch took, and the
    quadrotor's launch shapes;
13. kernel K2's new instantiations (the full state of the quadrotor, of the
    slack-augmented quadrotor and of the four scalar models) against
    ``rollout_closed_loop``;
14. kernels K3 and K4 for the nine instantiations beside the maze's (car,
    cartpole, pendulum, double integrator with and without slacks, the
    plain quadrotor) against their plain versions at B=128 and each
    problem's own N; for the slack car on the ``car_escape`` stack (P = 180)
    also late-schedule duals and an indefinite problem; every K4 with
    diverging lanes and one search that runs out; the in-kernel Jacobians
    against ``jacobian_traj``; and with them K2's slack instantiations and
    K5's (n, m + n) shapes;
15. slice 3 through ``solve_batch`` in float32, 1024 problems in one call:
    (a) the unconstrained ``quadrotor_line`` with ``fused=True`` (K7a and
    K7b only), (b) the same with ``fused=False`` (K5 and K2 only), (c) the
    constrained ``cartpole`` with the default options (fused: K3 and K4
    only) and with ``fused_al=False`` (K5 and K2, the AL terms as torch
    ops), (d) 128 starts of ``pendulum``, ``doubleintegrator``,
    ``parallel_park`` and ``car_3obs``, constrained (fused and
    ``fused_al=False``, held to each other by outcome) and, without their
    constraints, fused and phase-split, (e) three outer iterations of the
    maze with ``fused_al=False``. The outcome gates come from the JAX
    package (``tools/slice3_gates_jax.py``, ``tools/slice4_gates_jax.py``),
    and problems 0 and 1 of (a)/(b) and of (c) are also solved in float64 by
    the plain versions on the CPU;
16. profile of one round of arm (a) and of arm (b);
17. slice 4, path 1: ``altro_solve(car_escape())`` in float32 with the
    options of the JAX package's flagship test, with the projected-Newton
    polish in float32, with the polish of the float32 AL result in float64
    (held to that test's bars: c_max < 1e-6, goal within 1e-4), and with the
    feasible re-solve. K3 and K4 must run for the slack car and, in the
    re-solve, for the car; K5 and K2 only in the TVLQR projection;
18. slice 4, path 2 (``escape_pool``, in a worker process):
    ``solve_batch_queued_altro_retry`` on 512
    ``car_escape`` starts over 128 lanes, then ``pn_polish_batch`` on the
    result in float64 and in float32 (the first 128 each); outcome bars
    from the JAX package
    (``tools/slice4_gates_jax.py``);
19. profile of one ``car_escape`` round of 10 fused iterations on 128 lanes;
20. the instantiations no other path reaches, through
    ``solve_batch_queued_altro`` on 128 starts: line-seeded cartpole,
    pendulum and double integrator with slacks, fused and phase-split;
    ``car_escape`` phase-split; the maze without the transform;
21.–25. slice 5 (``kuka_kernels``, ``kuka``, ``kuka_pool``,
    ``kuka_profile``, ``kuka_slack``): every kuka instantiation against its
    plain version (with K3's, K4's and K2's launch shapes on the arm),
    ``altro_solve(kuka_obstacles())``, its pool in two
    arms (in a worker process), their profile, the slack instantiations;
26. slice 6's kernels (``rig_kernels``): K7a and K7b for kuka and the three
    URDF rigs (K7b's launch shapes on the cartpole rig), K3, K4, K2 and K5
    for the rigs with and without slacks, each against its plain version;
27. slice 6's paths (``slice6``, in a worker process): ``solve_batch`` on
    the unconstrained kuka and on the rigs' zoo problems, fused and
    phase-split, held to the JAX
    package's outcomes (``tools/slice6_gates_jax.py``) and to float64 CPU
    references;
28. the rigs' other instantiations (``slice6models``);
29. slice 7's kernels (``slice7_kernels``, after phase 21): K2 for each
    scalar model under
    ``MinTime`` with and without slacks and for ballonbeam and the
    Euler-angle quadrotor plain and with slacks, on K5's gains, against
    ``rollout_closed_loop`` at B = 128 and the form's problem's own N with
    two lanes forced to diverge; K3 and K4 of the quadrotor on
    ``quad_obs()``'s stack (cylinder rows with D = 2 beside sphere rows
    with D = 3) against their plain versions;
30. slice 7's paths (``slice7``), float32: (b)
    ``solve_batch`` on 128 perturbed
    ``quad_obs()`` starts fused (K3/K4) and, at a cut depth, fused and with
    ``fused_al=False`` (K5/K2); (c) ``solve_batch`` on 128
    ``quadrotor_line(N=101, constrained=True)`` starts at the cut depth,
    phase-split (its goal row is a custom constraint), each held to the JAX
    package's float32 shares at its depth (the two phase-split arms run in
    a worker process and are collected after phase 31, ``slice7_split``);
    and the other forms' launch-only drives through
    ``altro_solve`` and ``solve_batch`` with ``fused=True``, which these
    models and forms do not take (no K3, K4, K7a or K7b launch);
31. slice 7's path (a) (``slice7_mintime``), collected from its
    worker processes: ``altro_solve_batch``
    with ``minimum_time=True`` on the reference's minimum-time pendulum
    (tests/test_altro.py:64-82) from its start and 8 perturbed ones,
    feasible (K5 (3, 2), K2 ``pendulum_mintime``) and line-seeded (also K5
    (3, 4), K2 ``pendulum_slack_mintime``), held to that test's bars and to
    the JAX package's float32 solves of the same starts
    (``tools/slice7_gates_jax.py``);
32. slice 8's kernels (``slice8_kernels``, after phase 29): K2 for kuka and
    the three URDF rigs under ``MinTime`` with and without slacks and for
    the analytic double pendulum and acrobot in all four forms, on K5's
    gains, against ``rollout_closed_loop`` at B = 128 and each form's
    problem's own N (kuka 41, the double pendulums 101, the acrobots 151,
    the cartpole rig 101) with two lanes forced to diverge; K5's four new
    shapes ((15, 8), (15, 22), (5, 3), (5, 7)) in phase 10's loop;
33. slice 8's paths (``slice8``, collected from its worker process),
    float32: (a)
    ``solve_batch`` on 128 perturbed starts of ``doublependulum_problem()``
    (N = 101) and of ``acrobot_problem()`` (N = 151) with the analytic
    models, phase-split on K5 and K2 (``TwoLink``), held to the JAX
    package's float32 shares on the same starts (the acrobot's to the lower
    of its float32 and float64 ones; ``tools/slice8_gates_jax.py``); and
    the launch-only drives of the other slice-8 forms: the minimum-time
    ``altro_solve`` of kuka on ``kuka_obstacles()``, of each URDF rig on its
    zoo problem and of the two analytic models, feasible and line-seeded,
    and the analytic models' line-seeded ``altro_solve``;
34. slice 8's path (b) (``slice8_mintime``, last), collected from a worker
    process of its own: ``altro_solve_batch`` with
    ``minimum_time=True`` on ``doublependulum_problem()`` with the
    double-pendulum rig's model, |u| ≤ 20 and the goal constraint, from its
    start and 7 perturbed ones (K5 (5, 3), K2
    ``doublependulum_urdf_mintime``), held to the JAX package's float32
    share of starts that meet c_max < 1e-3 and the goal within 1e-3 and to
    its median total time (``tools/slice8_gates_jax.py``);
35. slice 9's kernels (``slice9_kernels``, after phase 32): K2 under euler,
    midpoint, rk4, midpoint_implicit and rk3_implicit (``rollout_<rule>.cu``)
    for every base model and the slack, minimum-time and minimum-time
    slack forms of the pendulum, the quadrotor and the acrobot rig, at
    B = 32 (N = 11, 6 under the implicit rules and for kuka) with random
    gains on every control (the slacks and h among them; not on the
    quadrotor's h, ``SLICE9_H_SEEDED``), against ``rollout_closed_loop``;
    and the pendulum's implicit steps at dt = 2 from states where the
    Newton loop does not converge, NaN and the problem dead in K2 as in the
    plain version (run on the CPU in worker processes meanwhile);
36. slice 9's path (``slice9``, last), collected from two worker
    processes: ``solve_batch`` on 128 perturbed starts of the pendulum
    swing-up (tests/test_ilqr.py:36-50) under each of the five rules,
    phase-split on K5 (2, 1) and K2, held to the JAX package's float32
    shares of c_max < 1e-3 and the goal within 2e-3 on the same starts
    less GATE_MARGIN (``tools/slice9_gates_jax.py``), and the minimum-time
    ``altro_solve`` under rk3_implicit cut to three outer iterations; and
    the launch-only ``solve_batch`` drives of the other slice-9 forms.

Every log line is stamped with the seconds since the start. The last two
lines of standard output are the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``; the line before them is a JSON summary of
the kernels. Without a CUDA device, or without the package beside this
script, it prints no result and exits non-zero.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# f32 tolerances of the kernel-vs-twin comparisons (the f32 row of
# tests/test_pallas.py): K to 2e-3 of its scale; d only to 1e-1 of its
# scale, because the feedforward is not f32-determined at stiff knots
# (kappa(Quu) ~ 1e9); dV at rtol 3e-2, atol 1e-5; rollouts at atol 1e-4.
K_TOL, D_TOL, DV_RTOL, DV_ATOL, X_ATOL = 2e-3, 1e-1, 3e-2, 1e-5, 1e-4
# the quadrotor pool: the first 1024 of the benchmark's 4096 starts; slice 1
# drives the first 256 of them (512 until slice 8, cut for time: 53.6 s of
# a 1,095 s run of this script before slice 8 on the H100, 18 rounds over
# 128 lanes),
# slice 3 all 1024
B, N, POOL, SLICE1_POOL = 128, 101, 1024, 256
GOAL = (0.0, 60.0, 10.0)
# small-input agreement with the CPU float64 twins: problems and the bar on
# their final positions
N_REF, REF_TOL = 8, 1e-2
# the share of the slice's 256 starts within 5 mm of the goal by the JAX
# package in float32 on the CPU, same starts and options
# (tools/slice1_gates_jax.py 256: 0.890625; within 0.5 m 0.984375, median
# 2.68e-4 m; on 512: 0.88671875, 0.986328125, 2.93e-4 m); the card must
# reach it less GATE_MARGIN (ROADMAP Q3-22)
JAX_SLICE1_5MM = 0.890625
# K1's branch problems (phase 2, rho = 0): (lane, knot) of a stage whose
# control Hessian is made mildly indefinite, so the plain float32 factor
# breaks down and the equilibrated one succeeds on its pivot floor, and of
# one made strongly indefinite, so both break down and the problem fails
EQ_AT, FAIL_AT = (5, 7), (9, 12)
# the kernel's rollout error against the twin in float64 on stiff gains,
# at most this multiple of the float32 twin's (phase 3)
STIFF_RATIO = 1.5

# --- slice 2 (the maze) ---
# The maze benchmark's pool: 2048 starts (seed 0, 0.05 m position noise),
# the first 512 of them driven here, over 128 lanes (1024 until slice 6,
# cut for time)
MAZE_POOL = 512
# the instantiations of K3 and K4 that the maze runs on
MAZE_KERNELS = ("fused_al_backward_quadrotor_slack",
                "fused_al_forward_quadrotor_slack")
# Quality gates after the failed-lane retry, from the JAX package's bars
# (ROADMAP "Recent"): share with c_max < 1e-2, share with c_max < 1e-3,
# median c_max.
MAZE_GATES = (0.97, 0.93, 1e-3)
# Pool problems also solved in float64 by the plain versions on the CPU and
# compared in outcome: of the first four, the one that a float64 solve
# finishes soonest (75 inner iterations, about a minute of CPU time;
# problems 0 and 2 take several times as long)
MAZE_REF = (3,)
# K3 against its plain version. The float32 plain version itself sits up to
# 3e-3 (K) and 2e-2 (d) of scale from the float64 one on the maze stack
# (R_inf = 1e-8 against Qf = 1e3 and penalties up to 1e8: kappa(Quu) ~ 1e9),
# and two float32 results that far from float64 may sit twice that apart.
# So K and d are held to the plain version at K3_K_TOL and K3_D_TOL of
# scale and, the sharper check, as K2 on stiff gains, to the float64 plain
# version at K3_RATIO times the float32 plain version's own distance; dV, a
# sum the conditioning does not amplify, at the JAX test's 1e-3.
K3_K_TOL, K3_D_TOL, K3_DV_TOL, K3_RATIO = 1e-2, 1e-1, 1e-3, 1.5
JAC_TOL = 1e-5
# K4 against its plain version (tests/test_fused_al.py:306-314): alpha equal
# on at least this share of the problems, and on those J within
# 1e-3 max(1, |J|) and X within 1e-4 max(1, |X|)
K4_ALPHA_SHARE, K4_J_TOL, K4_X_TOL = 0.97, 1e-3, 1e-4
# K4's branch problems: lanes whose feedforward is scaled by 1e6, so their
# first candidates diverge, and a lane given a cost no candidate can beat,
# so its search runs out
K4_DIVERGE, K4_EXHAUST = (3, 77), 11
# peaks of one H100 SXM for the bounds (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12
# iLQROptions' line-search defaults as the fused forward kernel takes them:
# lower and upper bound on z, candidates, bp_reg_min, bp_reg_increase_factor,
# bp_reg_fp
LS_OPTS = (1e-8, 10.0, 20, 1e-8, 1.6, 10.0)
# ... with 5, for the chain instantiations' K4 and K7b checks: the lane
# whose search runs out takes 6 candidates instead of 21, and so does the
# plain version's batched search, whose Python loop over the knots walks
# the chain in torch ops (22.7 s for the acrobot's K7b check on the H100
# with 21). Not fewer: the cartpole rig's K7b check holds J to three times
# the float32 plain version's distance from float64 over the lanes that
# accept a step, and the lane that sets it accepts at the sixth candidate
# (α = 1/32); with 3 it runs out, and the kernel's 1.35e-3 from the plain
# version stood above the remaining lanes' 3 × 4.4e-4 on the H100.
LS_OPTS_CHAIN = (1e-8, 10.0, 5, 1e-8, 1.6, 10.0)

# --- slice 3 (the default path and its fused variant) ---
# K5 and K7a against their plain versions: K and d within KD_TOL of scale
# and ΔV within DV_TOL (tests/test_fused.py holds two Pallas kernels to each
# other at these), or, where the sweep is worse conditioned than that,
# within three times the float32 plain version's own distance eps from
# float64 (a kernel up to 2 eps from float64, on the other side of it); and K, as K3's, no further from float64 than K3_RATIO times the
# float32 plain version is, unless it is within the tolerance of float64
# anyway
KD_TOL, DV_TOL = 1e-3, 1e-4
# K7b against its plain version (tests/test_fused.py:101-108): alpha, rho
# and drho equal on every problem, J within 1e-4 relative, X within 1e-5 of
# scale or, where float32 rounding of the state times the gains puts a
# higher floor under any float32 rollout, within three times the float32
# plain version's own distance from float64; the same X bar for K2's new
# instantiations
K7B_J_TOL, K7B_X_TOL = 1e-4, 1e-5
# the five models whose RK3 step the kernels carry
MODELS = ("quadrotor", "cartpole", "car", "pendulum", "doubleintegrator")
# Outcome bars of slice 3 from the JAX package in float32 on the CPU
# (tools/slice3_gates_jax.py, run before the first GPU run). On the first 16
# problems of each pool: unconstrained quadrotor_line within 0.5 m 1.0 and
# within 5 mm 0.4375 (median 7.7e-3 m); cartpole c_max < 1e-3 1.0 (median
# goal error 5.7e-4). The 5 mm share sits on the chaotic tail of the
# full-state solve and 16 problems estimate it badly: on the first 64 it is
# 0.359375 (the other shares stay 1.0), and that is the bar taken. The card
# must reach each less GATE_MARGIN, and arms (a) and (b) must agree with
# each other within GATE_MARGIN on the share within 0.5 m.
JAX_QUAD_SHARES, JAX_CARTPOLE_SHARE, GATE_MARGIN = (1.0, 0.359375), 1.0, 0.03
# arm (d): 128 starts of each small problem; at least this share must reach
# c_max < 1e-3 (every one does in float64, tests/test_torch_solve.py)
SMALL_SHARE = 0.9
# the same problems by the JAX package in float32 on the CPU, 16 starts
# (tools/slice4_gates_jax.py): the share with c_max < 1e-3
JAX_SMALL_SHARES = dict(pendulum=1.0, doubleintegrator=1.0,
                        parallel_park=1.0, car_3obs=1.0)

# --- slice 4 (the whole ALTRO solve on car_escape; K3/K4 for every model) ---
# K3 and K4 for the instantiations beside the maze's, (model, with slacks):
# on the car_escape stacks (P = 180 and 177), the cartpole's, pendulum's and
# double integrator's control box and goal (with slacks from a line seed),
# and the maze without the transform for the plain quadrotor
AL_CASES = (("car", True), ("car", False), ("cartpole", True),
            ("cartpole", False), ("pendulum", True), ("pendulum", False),
            ("doubleintegrator", True), ("doubleintegrator", False),
            ("quadrotor", False))
# K3 against its plain version on these stacks (R_inf = 1e-1 or 1, far
# better conditioned than the maze's 1e-8): K and d at 2e-3 of scale and ΔV
# at 1e-3, the bars of tests/test_fused_al.py:261-267 (or three times the
# float32 plain version's own distance from float64, where that is more)
AL_KD_TOL, AL_DV_TOL = 2e-3, 1e-3
# the car_escape pool: 1024 starts (seed 0, 0.05 m normal noise on x and y),
# the first ESCAPE_POOL_RUN of them driven (1024 until slice 6, cut for time)
ESCAPE_POOL, ESCAPE_POOL_RUN = 1024, 512
# pn_polish_batch on the pool's result: in float64 the first POLISH_F64
# problems, POLISH_CHUNK at a time, in float32 the first POLISH_CHUNK (256
# in float64 until slice 5, cut for time: 65 s of an 867 s run of this
# script on the H100; 128 until slice 6, cut for time again: the gate is
# the JAX package's share on its first 16)
POLISH_F64, POLISH_CHUNK = 64, 128
# Outcomes of the JAX package on the CPU (tools/slice4_gates_jax.py, run
# before the first GPU run). altro_solve(car_escape()) in float32: c_max
# 1.5e-10 with the polish (8 outer, 84 inner iterations) and 8.8e-9 with the
# re-solve (30, 139); in float64 1.5e-10 (7, 72) and 5.8e-6 (30, 225). Both
# float32 figures are goal rows that happen to round to nothing, so the
# card's float32 solves are held to the polish's hand-off tolerance
# instead, and the float64 polish to the bars of tests/test_altro.py:96-97.
JAX_ESCAPE_F32, ESCAPE_F32_BAR, ESCAPE_BARS = (1.5e-10, 8.8e-9), 1e-3, \
    (1e-6, 1e-4)
# The pool, first 16 problems: c_max < 1e-3 on 1.0 (40 to 126 inner
# iterations, no retry), which the card must reach less GATE_MARGIN. After
# pn_polish_batch c_max < 1e-6 on JAX_ESCAPE_POLISH of them (in float64
# three of the 16 use up their ten projection iterations and end between
# 1e-6 and 1e-5): estimates from 16 problems (one sigma 0.1 to 0.125), so
# the card must reach each less POLISH_MARGIN.
JAX_ESCAPE_POOL_SHARE = 1.0
JAX_ESCAPE_POLISH = {"float32": 0.5, "float64": 0.8125}
POLISH_MARGIN = 0.25
# The launch-only drives of slice 4's phase-split instantiations (K5
# (n, m + n), K2 ``*_slack``): one outer iteration of at most this many
# inner ones, as slices 5 and 6 drive theirs; their outcomes are printed,
# not held, and three outer iterations took 27 s of the script on the
# slower H100 host
SLICE4_SPLIT_INNER = 10

# --- slice 5 (kuka_obstacles: the chain step and the fk rows) ---
# the kuka stack's K3 Jacobians: within this share of their scale of
# jacobian_traj's (or three times the float32 plain version's distance from
# float64)
KUKA_JAC_RTOL = 1e-5
# K2 on stiff gains against the float64 plain version: the arm's rollouts
# amplify float32 rounding, so two float32 orders of operations land at
# distances from float64 that differ by about 2x (H100: kernel 2.8e-3, plain
# version 1.5e-3 of scale, |K| up to 48); the kernel is held to three times
# the plain version's distance, as the other kuka checks are
KUKA_STIFF_RATIO = 3.0
# Path 1's bars, tests/test_altro.py:110-111: c_max < 1e-3 and the goal
# within 1e-3. The JAX package on the CPU (tools/slice5_gates_jax.py) meets
# them in float32 (c_max 5.47e-4, goal error 3.8e-5, 7 outer and 459 inner
# iterations; 5.17e-4, 2.4e-5 and 461 inner with XLA's CPU threads
# limited, a different order of float32 sums) and in float64 (5.61e-4,
# 1.1e-5, 6 and 191).
KUKA_BARS = (1e-3, 1e-3)
JAX_KUKA_F32 = (5.47e-4, 3.8e-5, 7, 459)
# Path 2: KUKA_POOL starts (seed 0, q perturbed by N(0, 0.05²) rad, q̇ = 0),
# the first KUKA_POOL_RUN of them driven over 128 lanes (one round) in each
# arm, with the tuned options cut to KUKA_POOL_DEPTH = (outer iterations,
# inner cap). At the tuned options' own depth (20, 300) the pool does not
# fit the run: 256 starts took 26,138 batched iterations and 1,427 s in the
# phase-split arm on the H100 (c_max < 1e-3 on 0.199; the JAX package in
# float32 and in float64 on the CPU solves 2 of the first 16 starts there,
# after 1,087 and 1,453 inner iterations in float32). The cut keeps the
# inner cap and takes the first 5 outer iterations: the first depth at
# which the JAX package brings some of the first 16 starts to the goal
# within 1e-3 (starts 4 and 7; c_max < 1e-3 takes 8). The JAX package in
# float32 at this depth on the first KUKA_GATE_COUNT starts
# (tools/slice5_gates_jax.py): the shares with c_max < 1e-3, with the goal
# within 1e-3 and with c_max < 1e-1, which each arm must reach on the same
# starts less GATE_MARGIN; the arms must agree on all of their starts
# within KUKA_ARM_MARGIN. There 10 of the 64 reach the goal within 1e-3
# with c_max between 0.0045 and 0.03 after at most 385 inner iterations; the
# other 54 stop at c_max ~1.6. (KUKA_POOL_RUN was 128 until slice 6, cut for
# time to the KUKA_GATE_COUNT starts the gates read.)
KUKA_POOL, KUKA_POOL_RUN, KUKA_POOL_DEPTH = 1024, 64, (5, 300)
KUKA_GATE_COUNT = 64
JAX_KUKA_POOL = dict(cmax_1e3=0.0, goal_1e3=0.15625, cmax_1e1=0.15625)
# Path 3 (the slack instantiations): the inner cap of its one outer iteration
KUKA_SLACK_INNER = 10
KUKA_ARM_MARGIN = 0.03

# --- slice 6 (the chain step in K7a/K7b; the three URDF rigs) ---
# the three rigs, each driven on its zoo problem, its model replaced by the
# rig's (``problems.zoo.rig_problem``)
RIGS = ("acrobot_urdf", "doublependulum_urdf", "cartpole_urdf")
# the starts of path (a) (the kuka pool's first) and of each rig pool of
# path (b) (0.02 noise on every state entry, seed 0: slice 3's cartpole
# pool)
SLICE6_POOL = 128
# ... the constrained cartpole's pool too, but at a cut depth: the first
# SLICE6_CARTPOLE_DEPTH = (outer iterations, inner cap) of ``ALOptions()``'s
# (30, 300). The rig cannot swing up in its box (ROADMAP Q3-25), and at the
# full depth its 30 outer iterations reach thousands of inner ones (2,074 on
# one of the JAX package's first 16), which a solve_batch runs for every
# problem: 8 starts took the card's arms 801 and 485 batched iterations, 77
# s of a 1,227 s run. At the cut depth an arm runs at most 300 batched
# iterations on all 128 starts, and the penalty still climbs to 1e8
# (factor 10 an outer iteration from 1).
SLICE6_CARTPOLE_DEPTH = (10, 30)
# the problems of each pool solved in float64 by the plain versions on the
# CPU: 0 and 1; 0 only of the unconstrained cartpole, whose problem 1 runs
# to the 300-iteration cap, at ~2 s an iteration through the plain chain
# step in Python; none of the constrained cartpole, whose float64 solve of
# problems 0 and 1 at the cut depth took 18 minutes on a CPU core (its
# outcome is the JAX package's: not solved)
SLICE6_REFS = dict(kuka=2, doublependulum=2, acrobot=2, cartpole=0,
                   acrobot_free=2, cartpole_free=1)
# the launch-only drives of the rigs' other instantiations: one outer
# iteration of at most this many inner ones (as slice 5's path 3)
SLICE6_MODELS_INNER = 10
# path (b)'s pools and the rig each drives (``_free``: without the zoo
# problem's constraints)
SLICE6_RIG = dict(doublependulum="doublependulum_urdf",
                  acrobot="acrobot_urdf", cartpole="cartpole_urdf",
                  acrobot_free="acrobot_urdf", cartpole_free="cartpole_urdf")
# The outcome gates of both paths, from the JAX package in float32 on the
# CPU on the same starts (tools/slice6_gates_jax.py, its lines in
# tools/slice6_gates_jax.jsonl: each start's final J, c_max and terminal
# error; 64 starts). Each arm is held, on the JAX package's starts, to its
# shares less GATE_MARGIN (c_max < 1e-3: "cmax_1e3"; terminal error within
# a bar: "err_<bar>", of the joints for the arm), chosen where they can
# fail: the unconstrained arm stops ~1.3 rad short of the goal (its start
# ~2.7 rad away: within 1.5 rad on 1.0, and on 0 if the solve does not
# move), the unconstrained double pendulum within 0.03 on 1.0 (median
# 0.0195), the acrobot with c_max < 1e-3 and at its goal within 1e-2 and
# within 1e-3. Where the JAX package has a float64 line for the pool too
# (the acrobot), a share is held to the lower of its two types' less
# GATE_MARGIN: the AL stops once c_max < 1e-3, and which starts then land
# past the goal's 1e-3 bar in the 2-norm is set by rounding (ROADMAP Q3-26:
# float32 leaves starts 24 and 34 of the first 64 past it, 0.96875 within;
# float64 starts 12, 24, 36 and 43, 0.9375, at 1.02e-3 to 1.13e-3 with
# c_max 7.7e-4 to 9.8e-4). And the median over those starts of the
# relative difference
# of its final J from the JAX package's within the pool's bar of
# SLICE6_J_MEDIAN; and, on the unconstrained pools whose descents are
# smooth (SLICE6_J_EACH), each start's J within SLICE6_J_RTOL on at least
# 1 − GATE_MARGIN of them. The cartpole rig (a 10 kg pole, its box ±3 N)
# cannot swing up (ROADMAP Q3-25): the JAX package leaves the unconstrained
# pool in local minima that a start's rounding picks (J from 105 to
# 23,651), a third of its starts at the 300-iteration cap, and the
# constrained one far from its goal (c_max 2.5 to 20 at the full depth);
# neither has a share that can fail, and both are held by their final J:
# the constrained pool's J, penalties included, at SLICE6_J_RTOL; the
# unconstrained pool's at SLICE6_J_RTOL_CARTPOLE, about three times the largest
# median the card read in its first runs (9.2e-3 against the JAX package,
# 1.26e-2 between the arms, where about half of the starts agree within
# 1e-2 and the others sit in other minima or at other points of a capped
# descent).
SLICE6_SHARES = dict(kuka=("err_1.5",), doublependulum=("err_0.03",),
                     acrobot=("cmax_1e3", "err_0.01", "err_0.001"),
                     cartpole=(), acrobot_free=(), cartpole_free=())
SLICE6_ERR_BARS = (1.5, 0.1, 0.03, 0.01, 1e-3)
SLICE6_J_RTOL = 1e-2
SLICE6_J_RTOL_CARTPOLE = 4e-2
SLICE6_J_MEDIAN = dict(kuka=SLICE6_J_RTOL, doublependulum=SLICE6_J_RTOL,
                       acrobot=SLICE6_J_RTOL, acrobot_free=SLICE6_J_RTOL,
                       cartpole=SLICE6_J_RTOL,
                       cartpole_free=SLICE6_J_RTOL_CARTPOLE)
SLICE6_J_EACH = ("kuka", "doublependulum", "acrobot_free")
# the pools of the two worker processes that run them (about 55 s and 58 s
# on the H100 alone)
SLICE6_SPLIT = (("kuka", "doublependulum", "acrobot", "acrobot_free"),
                ("cartpole", "cartpole_free"))


# --- slice 7 (the minimum-time transform, custom constraints, the rest of
# the zoo) ---
# The scalar models, each in the forms K2 gained: every one under MinTime,
# with and without the slacks; ballonbeam and the Euler-angle quadrotor also
# plain and with the slacks. Each is checked on the problem that model
# meets (``form_base_problem``) at its own N.
SLICE7_MODELS = ("quadrotor", "cartpole", "car", "pendulum",
                 "doubleintegrator", "ballonbeam", "quadrotor_euler")
SLICE7_FORMS = tuple((name, slack, True) for name in SLICE7_MODELS
                     for slack in (False, True)) + tuple(
    (name, slack, False) for name in ("ballonbeam", "quadrotor_euler")
    for slack in (False, True))
# path (a): the reference's minimum-time pendulum (tests/test_altro.py:
# 64-82) from its own start and 8 starts perturbed by N(0, 0.05²)
# (tools/slice7_gates_jax.py), in one ``altro_solve_batch`` per arm
# (feasible; line-seeded, starts 0-4 and 5-8), each in a worker process on
# the card, because the solve is bound by the host (about 20 line-search
# candidates an iteration, a launch of K2 and the AL cost of each: 66.9 s
# feasible and 142.7 s line-seeded for all 9 in one call on the H100):
# the workers start after the last phase that times a kernel
# (``rig_kernels``), run beside slice 7's other paths and slice 6's, and
# phase ``slice7_mintime`` collects them.
# Gates: every start meets every bar of that test in the JAX package's
# float32 solves (tools/slice7_gates_jax.jsonl, share_bars 1.0 in both
# arms); the card's share must reach it less MINTIME_MARGIN, one start in 9
# (the solve is chaotic, ROADMAP Q3-27: in float64 the JAX package's own
# total time spreads 0.816–0.945 when x0 moves by 1e-13), and the nominal
# start must meet every bar; the median total time within MINTIME_TT_RTOL of
# the JAX package's float32 median.
MINTIME_MARGIN, MINTIME_TT_RTOL = 1.0 / 9.0 + 1e-9, 0.15
# paths (b) and (c): 128 starts with the position perturbed by N(0, 0.1²)
# (seed 0) of ``quad_obs()`` (fused on K3/K4 and with ``fused_al=False`` on
# K5/K2) and of ``quadrotor_line(N=101, constrained=True)`` (phase-split:
# its goal row is a custom constraint), ``ALOptions()``; held to the JAX
# package's float32 shares on the same starts, the first 64
# (tools/slice7_gates_jax.jsonl), less GATE_MARGIN: c_max < 1e-3
# ("share_cmax_1e3") and the final position within 0.5 m
# ("share_pos_0p5"). The phase-split arms run at the cut depth
# SLICE7_DEPTH (outer iterations, inner cap) of ALOptions()'s (30, 300),
# as tools/slice7_gates_jax.py's ``*_cut`` pools do: at the full depth
# quad_obs's phase-split arm took 184 s on 128 starts (2,187 batched
# iterations: one start runs 30 outer iterations to 2,100 inner ones, and a
# ``solve_batch`` lasts as long as its slowest problem), its fused arm 4.8
# s; (c) 46.5 s (H100). quad_obs also runs fused at the cut
# depth, and the arms of (b) at it are held to each other within
# SLICE7_ARMS_MARGIN over all 128 starts: at that depth about 30% of the
# starts stop before the AL converges, and which ones near the edge is
# float32 rounding's choice (the full-state quadrotor, ROADMAP Q3-9): the
# arms read 0.6953 fused and 0.6641 phase-split on the same 128, 0.7656
# and 0.7188 on the first 64 (the JAX package 0.7031; H100).
SLICE7_POOL = 128
SLICE7_DEPTH = (10, 30)
SLICE7_ARMS_MARGIN = 0.05
# K5's shapes of slice 7, each checked in phase 10 on the form that runs it:
# (n, m) -> (model, slack, minimum time)
SLICE7_K5 = {(12, 16): ("quadrotor_euler", True, False),
             (5, 2): ("cartpole", False, True), (4, 3): ("car", False, True),
             (14, 5): ("quadrotor", False, True),
             (13, 5): ("quadrotor_euler", False, True),
             (3, 4): ("pendulum", True, True), (5, 6): ("cartpole", True, True),
             (14, 18): ("quadrotor", True, True)}
SLICE7_SHARES = ("share_cmax_1e3", "share_pos_0p5")
# the launch-only drives of the other forms: one outer iteration of at most
# this many inner ones a stage
SLICE7_MODELS_INNER = 10


# --- slice 8 (every model on the card: minimum time for the chains, the
# analytic two-link models in K2) ---
# K2's new forms: kuka and the three URDF rigs under MinTime with and
# without the slacks; the analytic double pendulum and acrobot in all four
# forms. Each is checked on the problem its model meets
# (``form_base_problem``: kuka on ``kuka_obstacles()``, N = 41; each rig on
# its zoo problem, the double pendulums N = 101, the acrobots N = 151, the
# cartpole rig N = 101), at B = 128.
SLICE8_CHAINS = ("kuka", "acrobot_urdf", "doublependulum_urdf",
                 "cartpole_urdf")
SLICE8_TWO_LINK = ("doublependulum", "acrobot")
SLICE8_FORMS = tuple((name, slack, True) for name in SLICE8_CHAINS
                     + SLICE8_TWO_LINK for slack in (False, True)) + tuple(
    (name, slack, False) for name in SLICE8_TWO_LINK
    for slack in (False, True))
# K5's shapes of slice 8, each checked in phase 10 on the form that runs it
SLICE8_K5 = {(15, 8): ("kuka", False, True), (15, 22): ("kuka", True, True),
             (5, 3): ("doublependulum", False, True),
             (5, 7): ("doublependulum", True, True)}
# path (a): ``doublependulum_problem()`` and ``acrobot_problem()`` with the
# analytic models, 128 starts with 0.02 noise on every state entry (seed 0,
# ``cartpole_starts``) in one ``solve_batch`` call each, ``ALOptions()``
# (phase-split on K5 and K2: no fused kernel takes them); held to the JAX
# package's float32 shares on the same 128 starts
# (tools/slice8_gates_jax.jsonl) less GATE_MARGIN, the acrobot's to the
# lower of its float32 and float64 shares (ROADMAP Q3-26): the double
# pendulum's terminal error within 0.03 (its median 0.0195 in JAX), the
# acrobot's c_max < 1e-3 and its terminal error within 1e-2 and 1e-3.
SLICE8_POOL = 128
SLICE8_SHARES = dict(doublependulum=("err_0.03",),
                     acrobot=("cmax_1e3", "err_0.01", "err_0.001"))
# path (b): the double-pendulum rig's minimum-time solve
# (``mintime_rig``: ``doublependulum_problem()`` with the rig's model,
# |u| ≤ 20 and the goal constraint), ``altro_solve_batch`` from its nominal
# start and 7 perturbed ones (tools/slice8_gates_jax.py) in a worker
# process on the card beside the last path phases, as slice 7's path (a):
# the share of starts with c_max < 1e-3 and the goal within 1e-3 at least
# the JAX package's float32 share less one start, and the median total
# time within MINTIME_RIG_TT_RTOL of the JAX package's float32 median.
MINTIME_RIG_STARTS, MINTIME_RIG_TT_RTOL = 8, 0.2


# --- slice 9 (every integrator on the card: K2 under euler, midpoint, rk4
# and the implicit midpoint and RK3 steps) ---
SLICE9_RULES = ("euler", "midpoint", "rk4", "midpoint_implicit",
                "rk3_implicit")
# the models whose slack and minimum-time forms K2's checks take under every
# rule (every base model is checked in its plain form)
SLICE9_FORM_MODELS = ("pendulum", "quadrotor", "acrobot_urdf")
# K2's checks: B problems of N knots (N_IMPLICIT under the implicit rules
# and for kuka, whose plain versions cost ~0.1 s a knot: a batched jacfwd
# and solve every Newton trip, a chain's linearization in torch ops), each
# model's problem's dt; under the explicit rules lanes DIVERGE with the
# feedforward blown up
SLICE9_B, SLICE9_N, SLICE9_N_IMPLICIT = 32, 11, 6
SLICE9_DIVERGE = (3, 17)
# the models whose minimum-time forms take no random gain on h (h follows
# its seed; the slacks take theirs): with one, a 1-ulp move of the
# quadrotor's starts moves its float32 plain rollout by up to 1.6e-4 of
# scale, past the bar its kernel is held to (tools/slice9_sensitivity.py
# on the H100: 4.2e-5 against a bar of 4.4e-5 under midpoint, where the
# kernel sat at 6.2e-5; 1.6e-4 under rk4; 7e-7 at most without the gain
# on h, and the pendulum's and the acrobot rig's 3.1e-7 at most with it)
SLICE9_H_SEEDED = ("quadrotor",)
# kuka's steps: kuka_obstacles' 0.125 s is a step whose implicit Newton
# loop fails from most perturbed starts in float64 too (the undamped arm on
# its gravity hold, ROADMAP Q3-18); 0.02 s as its minimum-time forms of
# slice 8
SLICE9_DT_KUKA = 0.02
# the non-converging step: the pendulum's implicit steps at dt = 2 from
# these states poison (NaN) in float32 and float64 alike (the plain
# version's and the JAX package's Newton loop runs its 1000 trips or meets
# a NaN), beside a benign state that converges
SLICE9_POISON_X = ((3.0, 40.0), (0.0, 100.0), (0.1, 0.0))
# path 9: solve_batch on the pendulum swing-up of tests/test_ilqr.py:36-50
# under each rule, SLICE9_POOL starts (seed 0, N(0, 0.02²) on both states,
# tools/slice9_gates_jax.py), held to the JAX package's float32 shares of
# c_max < 1e-3 and the goal within 2e-3 on the same starts less
# GATE_MARGIN; and one minimum-time altro_solve of the reference pendulum
# (tests/test_altro.py:64-82) under rk3_implicit, cut to
# SLICE9_MINTIME_OUTER outer iterations, as a drive that only checks the
# run completes
SLICE9_POOL, SLICE9_MINTIME_OUTER = 128, 3
# the launch-only drives of the other forms: inner iterations
SLICE9_DRIVE_INNER = 1


T0 = time.perf_counter()


# a worker process's log lines, kept for the main process to print
# (``slice8_job``); None: print them
LOG_LINES = None


def log(*a):
    """Print, each line stamped with the seconds since the script (or the
    worker process) began."""
    line = " ".join([f"[{time.perf_counter() - T0:7.1f}]", *map(str, a)])
    if LOG_LINES is None:
        print(line, flush=True)
    else:
        LOG_LINES.append(line)


def check(ok, what):
    """A failed check raises (``assert`` would vanish under ``-O``)."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# while kernel phases run in worker processes beside the main process
# (``KERNEL_WORKER_PHASES``), a kernel is timed by one process at a time
# with the others stopped (``timing_turn``): TIMING_LOCK is the turn,
# GPU_PIDS (a shared array, 0 for an empty slot) the processes to stop;
# None: this process times alone
TIMING_LOCK = GPU_PIDS = None


@contextlib.contextmanager
def timing_turn():
    """This process's turn to time a kernel alone on the card: TIMING_LOCK
    held (waited for up to 120 s; past that the timing goes on, logged) and
    every other process of GPU_PIDS stopped (SIGSTOP) until the timing
    ends, their queued device work given 20 ms to drain. Only the holder
    of the lock stops others, so no stopped process holds it."""
    got = TIMING_LOCK is None or TIMING_LOCK.acquire(timeout=120)
    if not got:
        log("timing: the timing lock was held past 120 s; timing anyway")
    stopped = []
    try:
        if got and GPU_PIDS is not None:
            for pid in GPU_PIDS[:]:
                if pid and pid != os.getpid():
                    with contextlib.suppress(ProcessLookupError):
                        os.kill(pid, signal.SIGSTOP)
                        stopped.append(pid)
            time.sleep(0.02)
        yield
    finally:
        for pid in stopped:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGCONT)
        if got and TIMING_LOCK is not None:
            TIMING_LOCK.release()


def cuda_time_ms(fn, reps, warmup=2):
    """Mean device time of one call: CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with timing_turn():
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, moved):
    """The least time (ms) the card could take: the larger of the
    operations over its float32 peak and the bytes (each input read once,
    each output written once) over its memory rate, and which of the two."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, moved / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def mm(p, q, r):
    """Operations of a (p x r)(r x q) product."""
    return 2 * p * q * r


def linearization(x0s, error_state=True):
    """Linearizations of quadrotor_line (N=101) around the open-loop
    rollouts from the starts ``x0s`` (B, 13) under the hover seed, computed
    in float64 on the card, projected onto the quaternion error state
    (n = 12) or, with ``error_state=False``, on the full state (n = 13).
    Returns the float32 sweep inputs (A, B, lx, lu, lxx, luu, lux), the
    rollouts X, the controls U and dt."""
    import torch
    from trajopt_tpu_torch.models.quaternions import project_error_state
    from trajopt_tpu_torch.ops.cost import cost_expansion
    from trajopt_tpu_torch.ops.rollout import rollout
    from trajopt_tpu_torch.problems.zoo import quadrotor_line

    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=N, dtype=torch.float64, device=dev)
    x0s = torch.as_tensor(x0s, dtype=torch.float64, device=dev)
    U = prob.U.expand(x0s.shape[0], -1, -1)
    dt = prob.dt_traj()
    X = rollout(prob.model, x0s, U, dt)
    A, Bm = prob.model.jacobian_traj(X[:, :-1], U, dt)
    exp = cost_expansion(prob.obj, X, U, dt)
    if error_state:
        A, Bm, exp = project_error_state(X, A, Bm, exp, (3, 7))
    f32 = [t.float().contiguous() for t in
           (A, Bm, exp.x, exp.u, exp.xx, exp.uu, exp.ux)]
    return f32, X.float().contiguous(), U.float().contiguous(), prob.dt


def indefinite(luu, at, off):
    """Replace the control Hessian of stage ``at`` = (lane, knot) by
    c·[[1, off], [off, 1]] ⊕ c·I (tests/test_torch_sqrt.py): indefinite for
    off > 1, with eigenvalue c·(1 − off)."""
    import torch

    c = luu[at][0, 0]
    M = c * torch.eye(4, dtype=luu.dtype, device=luu.device)
    M[0, 1] = M[1, 0] = c * off
    luu[at] = M


def wrappers():
    """The kernels' wrappers, and the prefix of their names in the
    ``kernels`` line. A wrapper that serves several instantiations of its
    kernel also counts its launches by instantiation (``launches_by``), and
    each instantiation has its own entry in the line."""
    from trajopt_tpu_torch.ops.cuda_al_fused import (
        fused_al_backward_cuda, fused_al_forward_cuda)
    from trajopt_tpu_torch.ops.cuda_fused import (
        fused_backward_cuda, fused_forward_cuda)
    from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda

    return {"sqrt_sweep": sqrt_sweep_cuda,
            "rollout_closed_loop": rollout_closed_loop_cuda,
            "riccati_sweep": riccati_sweep_cuda,
            "fused_backward": fused_backward_cuda,
            "fused_forward": fused_forward_cuda,
            "fused_al_backward": fused_al_backward_cuda,
            "fused_al_forward": fused_al_forward_cuda}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_by"):
            w.launches_by.clear()


def read_counts():
    """Launches by name of the ``kernels`` line: ``sqrt_sweep``,
    ``rollout_closed_loop_quadrotor_error_state``, ``riccati_sweep_13x4``,
    ``fused_backward_cartpole``, ..."""
    out = {}
    for name, w in wrappers().items():
        if hasattr(w, "launches_by"):
            out.update({f"{name}_{k}": v for k, v in w.launches_by.items()})
            check(sum(w.launches_by.values()) == w.launches,
                  f"{name}: launch counts do not add up")
        else:
            out[name] = w.launches
    return out


def record_launches(report, counts, ran):
    """Write the main path's launch counts into the kernels' entries and
    check that the path went through every kernel of ``ran`` and through no
    other."""
    for k in report["kernels"]:
        if k["name"] in ran:
            k["launches"] = k.get("launches", 0) + counts[k["name"]]
    report.setdefault("recorded", []).append((counts, ran))
    check(all(counts.get(name, 0) > 0 for name in ran),
          f"a kernel never launched: {counts}")
    other = {k: v for k, v in counts.items() if v and k not in ran}
    check(not other, f"a kernel of another path was launched: {other}")


def run_worker(name, *args):
    """The phase function ``name`` of this module, run on ``report``-like
    state in a worker process on the card (host-bound path phases run
    side by side after every phase that times a kernel): its result, its
    log lines, its launch counts and the report entries it made, or the
    traceback of its failure with the log lines so far."""
    global LOG_LINES
    LOG_LINES = []
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.utils.tree import precise_context

    _build.load()
    wreport = {"kernels": []}
    try:
        with precise_context():
            result, error = globals()[name](wreport, *args), None
    except Exception:
        result, error = None, traceback.format_exc()
    return dict(result=result, error=error, log=LOG_LINES,
                recorded=wreport.pop("recorded", []),
                kernels=wreport.pop("kernels"), entries=wreport)


def init_kernel_worker(lock, pids, t0):
    """A kernel phases' worker process: the main process's timing lock and
    stop list (``timing_turn``), this process's pid entered in it, and the
    main process's clock for the log's stamps."""
    global TIMING_LOCK, GPU_PIDS, T0
    TIMING_LOCK, GPU_PIDS, T0 = lock, pids, t0
    with lock:
        pids[list(pids).index(0)] = os.getpid()


def kernel_phase_job(report, name, checked_elsewhere=()):
    """The kernel phase ``phase_<name>`` in a worker process beside the
    main process (``run_worker``); ``checked_elsewhere``: the ``kernels``
    entries the main process has made, which this process cannot see (a K5
    shape checked once, ``al_case``)."""
    report["checked_elsewhere"] = list(checked_elsewhere)
    t0 = time.perf_counter()
    log(f"--- phase {name}: started in a kernel worker")
    globals()[f"phase_{name}"](report)
    report.pop("checked_elsewhere")
    log(f"--- phase {name} in its kernel worker: "
        f"{time.perf_counter() - t0:.1f} s")


def collect_kernel_worker(report, jobs, who):
    """The results of a kernel phase's ``kernel_phase_job`` jobs: each as
    ``collect_worker``, then its ``kernels`` entries added to the line (an
    instantiation checked a second time keeps its first entry)."""
    for job in jobs:
        collect_worker(report, job, who)
        have = {k["name"] for k in report["kernels"]}
        for entry in job.result()["kernels"]:
            if entry["name"] in have:
                log(f"[{who} worker] {entry['name']} was checked twice: the "
                    "line keeps the first entry")
                continue
            have.add(entry["name"])
            report["kernels"].append(entry)


def collect_worker(report, job, who):
    """A ``run_worker`` job's result: its log lines printed, its launch
    counts written into the kernels' entries (``record_launches``) and its
    report entries merged; its failure raised."""
    out = job.result()
    for line in out["log"]:
        log(f"[{who} worker]", line)
    if out["error"]:
        raise RuntimeError(f"the {who} worker failed:\n{out['error']}")
    for counts, ran in out["recorded"]:
        record_launches(report, counts, ran)
    report.update(out["entries"])
    return out["result"]


def kernel_entry(report, **entry):
    """Add one kernel (or instantiation) to the ``kernels`` line."""
    report["kernels"].append(dict(route="cuda", library_ms=None, **entry))


def phase_build(report):
    import torch
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.models import zoo
    from trajopt_tpu_torch.models.base import Model, discretize
    from trajopt_tpu_torch.ops.cuda_al_fused import (
        fused_al_backward_cuda, fused_al_forward_cuda)
    from trajopt_tpu_torch.ops.cuda_fused import (
        fused_backward_cuda, fused_forward_cuda)
    from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda

    log("device:", torch.cuda.get_device_name(0), "count",
        torch.cuda.device_count(), "| torch", torch.__version__, "cuda",
        torch.version.cuda)
    log("nvidia-smi:", report["smi"])
    log("tf32: matmul", torch.backends.cuda.matmul.allow_tf32, "cudnn",
        torch.backends.cudnn.allow_tf32)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    libs = _build.start_build()
    log(f"build: {len(libs)} libraries, each compiler started side by side "
        "(each kernel's phases wait for their own library; "
        "phase build_report reads the compilers' seconds): "
        + ", ".join(p.name for p in libs.values()))

    dev = torch.device("cuda", 0)
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=dev)  # noqa
    maze = maze_setup(torch.float64, 2)
    for name, call in (
            ("sqrt_sweep_cuda", lambda: sqrt_sweep_cuda(
                z(2, 3, 12, 12), z(2, 3, 12, 4), z(2, 4, 12), z(2, 3, 4),
                z(2, 4, 12, 12), z(2, 3, 4, 4), z(2, 3, 4, 12), z(2))),
            ("rollout_closed_loop_cuda", lambda: rollout_closed_loop_cuda(
                discretize(zoo.quadrotor, "rk3"), z(2, 13), z(2, 4, 13),
                z(2, 3, 4), z(2, 3, 4, 12), z(2, 3, 4), z(2), 0.05,
                quat_slice=(3, 7))),
            ("fused_al_backward_cuda", lambda: fused_al_backward_cuda(
                maze["prob"].model, maze["canon"], maze["X"], maze["U"],
                maze["lam"], maze["mu"], maze["dt"], maze["prob"].obj, z(2))),
            ("fused_al_forward_cuda", lambda: fused_al_forward_cuda(
                maze["prob"].model, maze["canon"], maze["X"][:, 0], maze["X"],
                maze["U"], z(2, N - 1, 17, 13), z(2, N - 1, 17), z(2), z(2),
                z(2), z(2), z(2), None, maze["lam"], maze["mu"], maze["dt"],
                maze["prob"].obj, LS_OPTS))):
        try:
            call()
        except ValueError as e:
            log(f"{name}: float64 CUDA input refused ({e})")
        else:
            raise AssertionError(f"{name} accepted a float64 CUDA input")
    quad = discretize(zoo.quadrotor, "rk3")
    qobj = quadrotor_objective(torch.float64)
    for name, call in (
            ("riccati_sweep_cuda", lambda: riccati_sweep_cuda(
                z(2, 3, 13, 13), z(2, 3, 13, 4), z(2, 4, 13), z(2, 3, 4),
                z(2, 4, 13, 13), z(2, 3, 4, 4), z(2, 3, 4, 13), z(2))),
            ("fused_backward_cuda", lambda: fused_backward_cuda(
                quad, z(2, N, 13), z(2, N - 1, 4), z(N - 1), qobj, z(2))),
            ("fused_forward_cuda", lambda: fused_forward_cuda(
                quad, z(2, 13), z(2, N, 13), z(2, N - 1, 4),
                z(2, N - 1, 4, 13), z(2, N - 1, 4), z(2), z(2), z(2), z(2),
                z(2), None, z(N - 1), qobj, LS_OPTS)),
            ("rollout_closed_loop_cuda (full state)",
             lambda: rollout_closed_loop_cuda(
                 quad, z(2, 13), z(2, 4, 13), z(2, 3, 4), z(2, 3, 4, 13),
                 z(2, 3, 4), z(2), 0.05))):
        try:
            call()
        except ValueError as e:
            log(f"{name}: float64 CUDA input refused ({e})")
        else:
            raise AssertionError(f"{name} accepted a float64 CUDA input")

    # what has no kernel raises NotImplementedError: a model without a CUDA
    # step, an (n, m) the Riccati kernel is not built for, a per-interval dt
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa
    other = discretize(Model(zoo.quadrotor_dynamics, 13, 4, name="custom"),
                       "rk3")
    obj32 = quadrotor_objective(torch.float32)
    beam_obj = ballonbeam_problem(torch.float32).obj
    chain_mt = tt.minimum_time_problem(rig_problem(
        "acrobot_urdf", torch.float32)).model
    for name, call in (
            ("rollout_closed_loop_cuda: a model without a CUDA step",
             lambda: rollout_closed_loop_cuda(
                 other, f(2, 13), f(2, 4, 13), f(2, 3, 4), f(2, 3, 4, 12),
                 f(2, 3, 4), f(2), 0.05, quat_slice=(3, 7))),
            ("fused_backward_cuda: a model without a CUDA step",
             lambda: fused_backward_cuda(other, f(2, N, 13), f(2, N - 1, 4),
                                         f(N - 1), obj32, f(2))),
            ("fused_backward_cuda: the analytic acrobot (its URDF rig has "
             "the chain step)", lambda: fused_backward_cuda(
                 discretize(zoo.acrobot, "rk3"), f(2, N, 4), f(2, N - 1, 1),
                 f(N - 1), obj32, f(2))),
            ("riccati_sweep_cuda: (n, m) = (6, 2)",
             lambda: riccati_sweep_cuda(
                 f(2, 3, 6, 6), f(2, 3, 6, 2), f(2, 4, 6), f(2, 3, 2),
                 f(2, 4, 6, 6), f(2, 3, 2, 2), f(2, 3, 2, 6), f(2))),
            ("fused_backward_cuda: ballonbeam (K2 only: no lane step in "
             "the JAX package)", lambda: fused_backward_cuda(
                 discretize(zoo.ballonbeam, "rk3"), f(2, N, 4),
                 f(2, N - 1, 1), f(N - 1), beam_obj, f(2))),
            ("fused_backward_cuda: the minimum-time acrobot rig (K2 only: "
             "MinTime<Chain>)", lambda: fused_backward_cuda(
                 chain_mt, f(2, N, 5), f(2, N - 1, 2), f(N - 1), obj32,
                 f(2))),
            ("fused_backward_cuda: the pendulum under rk4 (K2 only: no "
             "lane step in the JAX package)", lambda: fused_backward_cuda(
                 discretize(zoo.pendulum, "rk4"), f(2, N, 2),
                 f(2, N - 1, 1), f(N - 1), obj32, f(2))),
            ("rollout_closed_loop_cuda: a per-interval dt",
             lambda: rollout_closed_loop_cuda(
                 quad, f(2, 13), f(2, 4, 13), f(2, 3, 4), f(2, 3, 4, 13),
                 f(2, 3, 4), f(2), f(3)))):
        try:
            call()
        except NotImplementedError as e:
            log(f"{name}: refused ({e})")
        else:
            raise AssertionError(f"{name}: accepted")


def phase_build_report(report):
    """Every library built (waited for): the seconds of each nvcc from the
    start of the build, side by side, nvcc's output and ptxas's registers,
    stack and spill for every kernel."""
    from trajopt_tpu_torch.kernels import _build

    libs = _build.build()
    log(f"build: {len(libs)} libraries: "
        + ", ".join(p.name for p in libs.values()))
    log("build: seconds of each nvcc (side by side, from the start of the "
        "build): " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
            _build.build.seconds.items())))
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if line.strip():
                log("nvcc:", line.strip())
    for stem in sorted(libs):
        for name, regs, stack, spill in ptxas_report(
                libs[stem].with_suffix(".log").read_text()):
            log(f"ptxas {stem}: {name}: {regs} registers, {stack} B stack, "
                f"{spill} B spilled")
    log("K2 launch shape: one warp a problem, blocks of "
        "32 threads (csrc/rollout.cu kWarpsPerBlock = 1); K4 and K7b: a "
        "block of 32·W threads a problem, W from the batch (printed by each "
        "K4 and K7b check); K1, K3, K5 and K7a: Wc consumer and Wp "
        "producer warps a problem (printed by each K3 check, the K1, K5 and "
        "K7a launch-shape checks and each K1, K5 and K7a timing)")


def ptxas_report(text):
    """(kernel, registers, stack bytes, spill-store bytes) of every entry
    function in an nvcc ``-Xptxas -v`` report, the names demangled by the
    toolkit's ``cu++filt`` where it is found and cut to the template."""
    import re
    import shutil

    rows, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = [m.group(1), None, None, None]
            rows.append(entry)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and entry is not None and entry[2] is None:
            entry[2], entry[3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None and entry[1] is None:
            entry[1] = int(m.group(1))
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and Path(filt).exists():
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                name = re.sub(r"\(anonymous namespace\)::|trajopt::", "",
                              name)
                r[0] = re.sub(r"\((const )?float \*.*$|\(Args.*$", "", name)
    return [tuple(r) for r in rows]


def launch_shapes(tag, fn, args, batched, shape_of=None, **kw):
    """The kernel behind the wrapper ``fn`` at B = 128 on ``args`` (its
    positions ``batched`` batch-first), at B = 1024 and 1152 (the 128
    problems tiled 8 and 9 times) and at the ragged B = 33 (the first 33):
    every output of every problem bitwise equal across the launches. The
    launch shape differs between them: K4's and K7b's W is 8 at B = 128
    and 33; at B = 1024 2 where a thread takes at most 128 registers, and
    1 at B = 1152, the serial search; K3's (Wc, Wp) is (4, 4) at B = 128
    and 33, at B = 1024 (1, 1) where a thread takes at most 128 registers,
    else the lone warp (1, 0), and (1, 0) at B = 1152. ``shape_of(B)``,
    where given, names the launch shape (K5's and K7a's)."""
    import torch

    base = torch.arange(B, device=args[min(batched)].device)
    outs, shapes = {}, {}
    for count, idx in ((128, base), (1024, base.repeat(8)),
                       (1152, base.repeat(9)), (33, base[:33])):
        a = [t[idx].contiguous() if i in batched else t
             for i, t in enumerate(args)]
        outs[count] = (idx, fn(*a, **kw))
        shapes[count] = shape_of(count) if shape_of else \
            getattr(fn, "warps", 1)
    torch.cuda.synchronize()

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    ref = outs[128][1]
    for count, (idx, out) in outs.items():
        for k, (o, r) in enumerate(zip(out, ref)):
            check(torch.equal(bits(o), bits(r[idx])),
                  f"{tag}: output {k} at B={count} differs bitwise from "
                  "B=128")
    log(f"{tag} launch shapes: B=128, 1024, 1152, 33 bitwise equal per "
        f"problem (warps a problem: {shapes})")


def log_rounds(tag, alpha0, alpha_used, ls_iters, fn=None):
    """Print the launch shape of the last launch of the line-search wrapper
    ``fn`` (K4's by default, or K7b's) and the rounds of W candidates its
    searches took, each from its step: the candidate j = log2(α0/α) that
    was accepted, or all ls_iters + 1 where the search ran out (α = 0)."""
    import torch
    from trajopt_tpu_torch.ops.cuda_al_fused import fused_al_forward_cuda

    W = (fn or fused_al_forward_cuda).warps
    j = torch.log2(alpha0 / alpha_used.clamp(min=1e-30)).round()
    rounds = torch.where(alpha_used > 0,
                         torch.div(j, W, rounding_mode="floor") + 1,
                         torch.full_like(j, -(-(ls_iters + 1) // W)))
    hist = {int(r): int((rounds == r).sum()) for r in rounds.unique()}
    log(f"{tag}: W = {W} warps a problem (blocks of {32 * W} threads, "
        f"{alpha_used.shape[0]} blocks); the launch took "
        f"{int(rounds.max())} rounds of {W} candidates (problems by rounds: "
        f"{hist})")


def ring_shape_text(sh):
    """A K5 or K7a block (``riccati_sweep_shape``, ``fused_backward_shape``)
    as one line: consumer and producer warps, slots, knots a producer step,
    threads and shared memory."""
    g = f", G = {sh['knots_a_step']}" if "knots_a_step" in sh else ""
    return (f"(Wc, Wp, S) = ({sh['consumers']}, {sh['producers']}, "
            f"{sh['slots']}){g}, "
            f"{32 * (sh['consumers'] + sh['producers'])} threads and "
            f"{sh['smem_bytes']} B of shared memory a block")


def log_k3_shape(tag):
    """Print the block of the last K3 launch (the check's own, at B = 128):
    its consumer and producer warps, the slots of its ring and its
    shared-memory bytes."""
    from trajopt_tpu_torch.ops.cuda_al_fused import fused_al_backward_cuda

    sh = fused_al_backward_cuda.shape
    log(f"{tag}: (Wc, Wp, S) = ({sh['consumers']}, {sh['producers']}, "
        f"{sh['slots']}), {32 * (sh['consumers'] + sh['producers'])} "
        f"threads and {sh['smem_bytes']} B of shared memory a block")


def quadrotor_objective(dtype):
    from trajopt_tpu_torch.problems.zoo import quadrotor_line

    return quadrotor_line(N=N, dtype=dtype).obj


def k1_inputs():
    """K1's inputs on the recipe of tests/test_pallas.py: open-loop rollouts
    from starts with 0.02 noise on every state entry, with two stages made
    indefinite (``EQ_AT``, ``FAIL_AT``) so that the kernel's equilibrated
    fallback and its fail branch run at rho = 0. Returns the sweep inputs
    (A, B, lx, lu, lxx, luu, lux) and the linearization."""
    rng = np.random.default_rng(3)
    lin = linearization(quad_x0_np()[None]
                        + rng.normal(size=(B, 13)) * 0.02)
    (A, Bm, lx, lu, lxx, luu, lux), _, _, _ = lin
    luu = luu.clone()
    indefinite(luu, EQ_AT, 1.0 + 2e-4)
    indefinite(luu, FAIL_AT, 1.5)
    return [A, Bm, lx, lu, lxx, luu, lux], lin


def k1_any_shape_inputs(n=5, m=3, steps=20, seed=11):
    """K1's inputs at an (n, m) that no model gives, (5, 3) by default (the
    kernel's instantiation with run-time sizes, which every shape but
    (12, 4) runs): B problems of ``steps``
    knots, random dynamics near the identity, positive definite stage
    Hessians, in float64 on the card."""
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.as_tensor(rng.normal(size=shape), device=dev)

    eye = lambda k: torch.eye(k, dtype=torch.float64, device=dev)  # noqa
    L = r(n, n) * 0.3
    Q = L @ L.T + 0.1 * eye(n)
    return [eye(n) + 0.1 * r(B, steps, n, n), 0.1 * r(B, steps, n, m),
            0.1 * r(B, steps + 1, n), 0.1 * r(B, steps, m),
            Q.expand(B, steps + 1, n, n).contiguous(),
            eye(m).expand(B, steps, m, m).contiguous(),
            0.01 * r(B, steps, m, n)]


def phase_k1(report):
    """K1 against its plain version on ``k1_inputs``, its launch shapes
    (bitwise, the branch problems among them), its time at B = 128 (slice
    1) and 1024, and the cartpole's (4, 1) and the car's (3, 2) sweeps
    against the plain version."""
    import torch
    from trajopt_tpu_torch.ops.cost import Expansion
    from trajopt_tpu_torch.ops.cuda_sqrt import (
        equilibrated_chol_upper, plain_chol_upper, sqrt_sweep,
        sqrt_sweep_cuda, sqrt_sweep_shape)

    ins, lin = k1_inputs()
    A, Bm, lx, lu, lxx, luu, lux = ins
    check(A.shape == (B, N - 1, 12, 12) and Bm.shape == (B, N - 1, 12, 4),
          "K1 input shapes")
    # the EQ_AT stage at rho = 0: the plain factor breaks down, the
    # equilibrated one holds, so the problem fails unless that branch runs
    joint = torch.cat([torch.cat([luu[EQ_AT], lux[EQ_AT]], -1),
                       torch.cat([lux[EQ_AT].T, lxx[EQ_AT]], -1)], -2)
    check(bool(plain_chol_upper(joint)[1])
          and not bool(equilibrated_chol_upper(joint)[1]),
          "the EQ_AT stage does not need the equilibrated factor")
    exp = Expansion(x=lx, u=lu, xx=lxx, uu=luu, ux=lux)
    worst = 0.0
    for rho_val in (0.0, 1e-2):
        rho = torch.full((B,), rho_val, device=A.device)
        K1, d1, v11, v21, f1 = sqrt_sweep_cuda(*ins, rho)
        torch.cuda.synchronize()
        K0, d0, v10, v20, f0 = sqrt_sweep(A, Bm, exp, rho)
        check(K1.shape == K0.shape and d1.shape == d0.shape, "K1 shapes")
        # both against the twin in float64 on the same (float32) inputs,
        # on the problems that do not fail in float64 (EQ_AT does: float64
        # has no pivot floor): how much of the disagreement is float32
        # conditioning
        out64 = sqrt_sweep(*(t.double() for t in (A, Bm)),
                           Expansion(*(t.double() for t in (lx, lu, lxx, luu,
                                                            lux))),
                           rho.double())
        K64, live = out64[0], ~out64[4]
        log(f"K1 rho={rho_val:g}: max|K - K_f64| kernel "
            f"{float((K1 - K64)[live].abs().max()):.3e}, twin f32 "
            f"{float((K0 - K64)[live].abs().max()):.3e}")
        check(torch.equal(f1, f0), "K1 fail flags differ from the twin")
        if rho_val == 0.0:
            check(f1.nonzero().flatten().tolist() == [FAIL_AT[0]],
                  "K1 did not fail exactly the FAIL_AT problem")
            check(not bool(K1[FAIL_AT].any()) and not bool(d1[FAIL_AT].any()),
                  "K1 left gains at the failed stage")
            eq = EQ_AT[0]
            log(f"K1 rho=0: fail flags {f1.nonzero().flatten().tolist()} "
                f"(FAIL_AT {FAIL_AT}, gains zeroed there); EQ_AT {EQ_AT} "
                f"factored by the equilibrated fallback, max|dK| on that "
                f"problem {float((K1[eq] - K0[eq]).abs().max()):.3e}")
        eK = float((K1 - K0).abs().max())
        ed = float((d1 - d0).abs().max())
        sK, sd = float(K0.abs().max()), float(d0.abs().max()) + 1e-12
        log(f"K1 rho={rho_val:g}: fail {int(f1.sum())}/{B}, "
            f"max|dK| {eK:.3e} (scale {sK:.3e}, tol {K_TOL * sK:.3e}), "
            f"max|dd| {ed:.3e} (scale {sd:.3e}, tol {D_TOL * sd:.3e})")
        check(eK < K_TOL * sK, "K1 gains disagree with the twin")
        check(ed < D_TOL * sd, "K1 feedforward disagrees with the twin")
        for a, b in ((v11, v10), (v21, v20)):
            torch.testing.assert_close(a, b, rtol=DV_RTOL, atol=DV_ATOL)
        worst = max(worst, eK)
        # the same problems at B = 1024, 1152 and 33: other blocks, the
        # same bits, the branch problems' among them
        launch_shapes(f"K1 rho={rho_val:g}", sqrt_sweep_cuda, [*ins, rho],
                      range(8), shape_of=lambda c: ring_shape_text(
                          sqrt_sweep_shape(12, 4, c)))

    rho = torch.zeros(B, device=A.device)
    ms = cuda_time_ms(lambda: sqrt_sweep_cuda(*ins, rho), reps=20)
    plain_ms = cuda_time_ms(lambda: sqrt_sweep(A, Bm, exp, rho), reps=3,
                            warmup=1)
    big = [t.repeat((8,) + (1,) * (t.ndim - 1)) for t in (*ins, rho)]
    ms8 = cuda_time_ms(lambda: sqrt_sweep_cuda(*big), reps=10)
    # per knot (n = 12, m = 4, p = n + m): the joint factor's Cholesky, the
    # product Ssqrt [B A], the Householder QR of the (p + n) x p stack, and
    # the small solves and updates
    n_, m_, p_ = 12, 4, 16
    per_knot = (p_ ** 3 / 3 + mm(n_, p_, n_)
                + 2 * p_ * p_ * (p_ + n_ - p_ / 3)
                + mm(m_, n_, m_) + 3 * mm(n_, 1, m_) + mm(m_, n_, m_))
    bound_ms, bound_by = bound(
        B * (N - 1) * per_knot,
        nbytes(*ins, rho) + 4 * B * (N - 1) * (m_ * n_ + m_) + 9 * B)
    log(f"K1 time per sweep: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms by {bound_by}; "
        + ring_shape_text(sqrt_sweep_shape(n_, m_, B)))
    log(f"K1 at B={8 * B}: kernel {ms8:.4f} ms per sweep, bound "
        f"{8 * bound_ms:.5f} ms; " + ring_shape_text(
            sqrt_sweep_shape(n_, m_, 8 * B)))

    # other shapes, all on the instantiation with run-time sizes: the
    # cartpole's (4, 1) and the car's (3, 2) (bp_type='sqrt' is an option of
    # any model), and (5, 3) and (13, 17), which no model gives (one knot a
    # producer step at p = 30), held to the plain version as K5's sweeps are
    smalls = [(name, sweep_inputs(model_setup(name), torch.float64))
              for name in ("cartpole", "car")]
    smalls += [("any shape", k1_any_shape_inputs()),
               ("any shape", k1_any_shape_inputs(13, 17))]
    for name, small64 in smalls:
        small = [t.float().contiguous() for t in small64]
        n, m = small[1].shape[-2:]
        for rho_val in (0.0, 1e-2):
            r = torch.full((B,), rho_val, device=A.device)
            k = sqrt_sweep_cuda(*small, r)
            torch.cuda.synchronize()
            p = sqrt_sweep(small[0], small[1], Expansion(*small[2:]), r)
            p64 = sqrt_sweep(small64[0], small64[1],
                             Expansion(*small64[2:]), r.double())
            compare_sweeps(f"K1 {name} ({n},{m}) rho={rho_val:g}", k, p,
                           p64)
        log(f"K1 {name} ({n},{m}): " + ring_shape_text(
            sqrt_sweep_shape(n, m, B)))
    report["kernels"].append(dict(
        name="sqrt_sweep", route="cuda",
        source="trajopt_tpu_torch/csrc/sqrt_sweep.cu",
        replaces="trajopt_tpu/ops/pallas_sqrt.py:321", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, batch=B, ms_b1024=ms8))
    return lin


def rollout_inputs():
    """Line-search candidates around hover: the benchmark pool's first 128
    starts (position noise only, so the hover seed holds them still), the
    K1 gains at rho = 1e-2 (|K| ~ 40), steps alpha = 2^-8 .. 2^-15 (|d| is
    ~2e3 here), and a 1e9 x feedforward on lanes 3 and 77 that trips the
    guard. The state sits near z = 10 m, so float32 rounding of x times
    |K| puts a ~4e-5 floor under any float32 rollout's control error."""
    import torch
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda

    (A, Bm, lx, lu, lxx, luu, lux), X, U, dt = linearization(
        pool_starts(quad_x0_np())[:B])
    K, d, _, _, _ = sqrt_sweep_cuda(A, Bm, lx, lu, lxx, luu, lux,
                                    torch.full((B,), 1e-2, device=A.device))
    d[3] *= 1e9
    d[77] *= 1e9
    alpha = (0.5 ** (8 + torch.arange(B, device=X.device) % 8)).float()
    return [X[:, 0].contiguous(), X, U, K, d, alpha], dt


def phase_k2(report, lin):
    import torch
    from trajopt_tpu_torch.models import zoo
    from trajopt_tpu_torch.models.base import discretize
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    model = discretize(zoo.quadrotor, "rk3")
    kw = dict(quat_slice=(3, 7))
    ins, dt = rollout_inputs()
    Xk, Uk, okk = rollout_closed_loop_cuda(model, *ins, dt, **kw)
    torch.cuda.synchronize()
    Xt, Ut, okt = rollout_closed_loop(model, *ins, dt, **kw)
    check(Xk.shape == (B, N, 13) and Uk.shape == (B, N - 1, 4), "K2 shapes")
    check(torch.equal(okk, okt), "K2 ok masks differ from the twin")
    check(not bool(okk[3]) and not bool(okk[77]) and int(okk.sum()) == B - 2,
          "K2 divergence guard")
    eX = float((Xk[okk] - Xt[okk]).abs().max())
    eU = float((Uk[okk] - Ut[okk]).abs().max())
    log(f"K2: ok {int(okk.sum())}/{B}, max|dX| {eX:.3e}, max|dU| {eU:.3e} "
        f"(atol {X_ATOL:g})")
    check(eX < X_ATOL and eU < X_ATOL, "K2 disagrees with the twin")
    ms = cuda_time_ms(lambda: rollout_closed_loop_cuda(model, *ins, dt, **kw),
                      reps=50)
    plain_ms = cuda_time_ms(lambda: rollout_closed_loop(model, *ins, dt, **kw),
                            reps=3, warmup=1)
    log(f"K2 time per rollout: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    # per knot: the error state (~60), K dx, and three dynamics evaluations
    # of the RK3 step (~120 each) with its combinations (~100)
    bound_ms, bound_by = bound(
        B * (N - 1) * (60 + mm(4, 1, 12) + 3 * 120 + 100),
        nbytes(*ins) + nbytes(Xk, Uk, okk))
    log(f"K2 bound: {bound_ms:.5f} ms by {bound_by}")
    launch_shapes("K2 quadrotor_error_state", rollout_closed_loop_cuda,
                  [model, *ins, dt], range(1, 7), **kw)
    report["kernels"].append(dict(
        name="rollout_closed_loop_quadrotor_error_state", route="cuda",
        source="trajopt_tpu_torch/csrc/rollout.cu",
        replaces="trajopt_tpu/ops/pallas_rollout.py:260",
        max_abs_err=max(eX, eU), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None))

    # The stiff gains of phase 2's open-loop linearizations (|K| ~ 7e2,
    # rho = 0) amplify float32 rounding of the state past the atol above,
    # so there kernel and twin are both held to the twin in float64 on the
    # same inputs, with the steps a search would try (|d| ~ 4e4): the ok
    # masks must agree, and the kernel must come within STIFF_RATIO of the
    # float32 twin's error.
    (A, Bm, lx, lu, lxx, luu, lux), X, U, _ = lin
    K, d, _, _, _ = sqrt_sweep_cuda(A, Bm, lx, lu, lxx, luu, lux,
                                    torch.zeros(B, device=A.device))
    x0 = X[:, 0].contiguous()
    alpha = ins[5]
    Xk, Uk, okk = rollout_closed_loop_cuda(model, x0, X, U, K, d, alpha, dt,
                                           **kw)
    Xt, Ut, okt = rollout_closed_loop(model, x0, X, U, K, d, alpha, dt, **kw)
    X64, U64, ok64 = rollout_closed_loop(
        model, *(t.double() for t in (x0, X, U, K, d, alpha)), dt, **kw)
    both = okk & okt & ok64
    errs = [float((a[both] - X64[both]).abs().max()) for a in (Xk, Xt)]
    log(f"K2 stiff gains: ok kernel {int(okk.sum())}, twin f32 "
        f"{int(okt.sum())}, twin f64 {int(ok64.sum())} of {B}; on lanes ok "
        f"in all three, max|X - X_f64| kernel {errs[0]:.3e}, twin f32 "
        f"{errs[1]:.3e} (bar {STIFF_RATIO:g}x the twin's)")
    check(torch.equal(okk, okt), "K2 ok masks differ from the twin on "
          "stiff gains")
    check(int(both.sum()) >= B // 2, "too few lanes ok on stiff gains")
    check(errs[0] <= STIFF_RATIO * errs[1], "K2 is further from the float64 "
          "twin than the float32 twin on stiff gains")


def bench_options():
    import trajopt_tpu_torch as tt

    return tt.ALOptions(iterations=16, opts_uncon=tt.iLQROptions(
        iterations=25, error_state=True, bp_type="sqrt"))


def pool_starts(x0):
    """The quadrotor benchmark's pool: seed 0, 0.1 m position noise."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    return (np.tile(x0[None], (POOL, 1))
            + np.concatenate([rng.normal(size=(POOL, 3)) * 0.1,
                              np.zeros((POOL, 10))], axis=1))


def phase_slice(report, refs):
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued
    from trajopt_tpu_torch.problems.zoo import quadrotor_line
    import trajopt_tpu_torch as tt

    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=N, dtype=torch.float32, device=dev)
    x0s_np = pool_starts(prob.x0.cpu())[:SLICE1_POOL]
    check(np.array_equal(x0s_np[0], pool_starts(quad_x0_np())[0]),
          "the reference solves start elsewhere than the card's")
    x0s = torch.as_tensor(x0s_np, dtype=torch.float32, device=dev)
    opts = bench_options()
    goal = torch.tensor(GOAL, device=dev)

    # warm-up: one short round (library handles, allocator), not timed
    warm = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=2, error_state=True, bp_type="sqrt"))
    solve_batch_queued(prob, warm, x0s[:B], lanes=B)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res = solve_batch_queued(prob, opts, x0s, lanes=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"slice: launches {launches}")
    record_launches(report, launches, ran=(
        "sqrt_sweep", "rollout_closed_loop_quadrotor_error_state"))

    check(res.X.shape == (SLICE1_POOL, N, 13)
          and res.U.shape == (SLICE1_POOL, N - 1, 4), "slice output shapes")
    check(bool(torch.isfinite(res.X).all()), "non-finite final states")
    perr = (res.X[:, -1, :3] - goal).norm(dim=-1).cpu().numpy()
    conv = float(np.mean(perr < 0.5))
    conv_ref = float(np.mean(perr < 5e-3))
    med = float(np.median(perr))
    its = res.iterations_total.float().mean().item()
    log(f"slice: {SLICE1_POOL} problems over {B} lanes in {wall:.3f} s = "
        f"{SLICE1_POOL / wall:.2f} solves/s | rounds {res.rounds}, host "
        f"syncs {res.host_syncs} ({res.host_syncs / res.rounds:.2f} per "
        "round)")
    log(f"slice: converged_frac(<0.5 m) {conv:.4f}, "
        f"converged_frac_ref_tol(<5e-3 m) {conv_ref:.4f}, "
        f"median final pos err {med:.3e} m, mean iterations_total {its:.2f}")
    report["slice"] = dict(
        solves_per_s=SLICE1_POOL / wall, wall_s=wall, rounds=res.rounds,
        host_syncs=res.host_syncs, converged_frac=conv,
        converged_frac_ref_tol=conv_ref, median_final_pos_err_m=med,
        mean_iterations_total=its)
    check(conv >= 0.98, "fewer than 98% of the pool within 0.5 m")
    check(med < 5e-3, "median final position error above 5e-3 m")
    log(f"slice: within 5 mm {conv_ref:.4f} (the JAX package in float32 on "
        f"the CPU, same starts: {JAX_SLICE1_5MM}; gate: less {GATE_MARGIN})")
    check(conv_ref >= JAX_SLICE1_5MM - GATE_MARGIN,
          "the share within 5 mm is below the JAX package's")

    # the same first problems, solved in float64 by the plain versions on
    # the CPU (the path the CPU tests hold to the JAX package)
    ref = refs.pop("ref_slice1").result()
    p_gpu = res.X[:N_REF, -1, :3].double().cpu().numpy()
    dp = np.linalg.norm(p_gpu - ref["pos"], axis=-1)
    log(f"reference: first {N_REF} problems in float64 on the CPU "
        f"({ref['seconds']:.1f} s, beside the GPU phases): |p_gpu - p_cpu| "
        f"max {dp.max():.3e} m, median {np.median(dp):.3e} m (bar "
        f"{REF_TOL:g})")
    check(np.median(dp) < REF_TOL, "the card disagrees with the CPU twins")


def device_events(prof):
    """(start µs, end µs, name) of every kernel and copy on the device in a
    ``torch.profiler`` trace: from the profiler's raw events, which the
    trace's event tree is built from (building it takes seconds for a
    round's ~1e5 host and device events); from the tree where the raw
    events are not there or hold no device event."""
    from torch.autograd import DeviceType

    raw = getattr(prof.profiler, "kineto_results", None)
    out = [] if raw is None else [
        (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()) for e in raw.events()
        if e.device_type() == DeviceType.CUDA
        and e.name() not in ("[memory]", "[OutOfMemory]")
        and not getattr(e, "is_hidden_event", lambda: False)()]
    return out or [(e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile_round(tag, one_round, iters, names, lanes=B):
    """Where one round's time goes: ``one_round()`` (warmed up) is timed
    plainly, then again under torch.profiler. The busy share is the union of
    the device's kernel and copy intervals in the profiled run over the
    plain run's wall time. ``names``: the kernels whose launches to count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one_round()
    before = read_counts()
    t0 = time.perf_counter()
    res = one_round()
    wall = time.perf_counter() - t0
    counts = {k: read_counts().get(k, 0) - before.get(k, 0) for k in names}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()
    wall_prof = time.perf_counter() - t0
    log(f"{tag}: one round of {iters} iterations on {lanes} lanes: "
        f"{wall * 1e3:.1f} ms plain ({wall_prof * 1e3:.1f} ms profiled), "
        f"launches {counts}, {res.host_syncs} host syncs")
    dev_evts = device_events(prof)
    if not dev_evts:
        log(f"{tag}: device time not measured (no device events traced)")
        return
    spans = sorted((a, b) for a, b, _ in dev_evts)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3  # ms
    by_name = {}
    for a, b, name in dev_evts:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (b - a) / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    log(f"{tag}: device busy {busy:.1f} ms of {wall * 1e3:.1f} ms plain "
        f"wall = busy share {busy / (wall * 1e3):.3f}, idle share "
        f"{1 - busy / (wall * 1e3):.3f}; {len(dev_evts)} device launches "
        f"= {len(dev_evts) / iters:.0f} per iteration, "
        f"{res.host_syncs / iters:.1f} host syncs per iteration")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"{tag}:   {100 * t / total:5.1f}% of device time, {c:5d} x "
            f"{1e3 * t / c:8.1f} us  {name[:90]}")


def phase_profile(report):
    """One slice-1 AL round of 3 iLQR iterations on the first 128 pool
    problems (6 until slice 8, cut for time: the profiler's events of 6
    iterations took 22.9 s of a run before slice 8 on the H100)."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued
    from trajopt_tpu_torch.problems.zoo import quadrotor_line
    import trajopt_tpu_torch as tt

    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=N, dtype=torch.float32, device=dev)
    x0s = torch.as_tensor(pool_starts(prob.x0.cpu())[:B],
                          dtype=torch.float32, device=dev)
    iters = 3
    opts = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=iters, error_state=True, bp_type="sqrt"))

    def one_round():
        res = solve_batch_queued(prob, opts, x0s, lanes=B)
        torch.cuda.synchronize()
        return res

    profile_round("profile", one_round, iters,
                  ("sqrt_sweep", "rollout_closed_loop_quadrotor_error_state"))


# ------------------------------------------------------------- slice 2

def maze_options():
    """The maze benchmark's schedule: penalty scaling 25, inner iLQR cap 10,
    intermediate cost tolerance 1e-3, R_inf = 1e-8, fused iterations."""
    import trajopt_tpu_torch as tt

    al = tt.ALOptions(
        iterations=40, opts_uncon=tt.iLQROptions(iterations=10, fused=True),
        cost_tolerance=1e-5, cost_tolerance_intermediate=1e-3,
        constraint_tolerance=1e-3, penalty_initial=1.0, penalty_scaling=25.0)
    return tt.ALTROOptions(R_inf=1e-8, opts_al=al)


def maze_starts(x0, count):
    """The maze benchmark's pool: seed 0, 0.05 m position noise on 2048
    starts; the first ``count`` of them."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    pool = (np.tile(x0[None], (2048, 1))
            + np.concatenate([rng.normal(size=(2048, 3)) * 0.05,
                              np.zeros((2048, 10))], axis=1))
    return pool[:count]


def maze_setup(dtype, batch):
    """The infeasible-start maze problem (n = 13, m = 17, P = 89), its
    canonical stack, and a batch of kernel inputs: X and U the transform's
    seeds plus noise (0.05 on the states, 0.02 on the controls), duals
    λ in [0, 0.5] and penalties μ in [0.5, 20] on the valid rows."""
    import torch
    from trajopt_tpu_torch.ops.canonical import canonical_stack
    from trajopt_tpu_torch.problems.zoo import quadrotor_maze
    from trajopt_tpu_torch.solvers.altro import infeasible_problem

    dev = torch.device("cuda", 0)
    prob = infeasible_problem(quadrotor_maze(dtype=dtype, device=dev), 1e-8)
    canon = canonical_stack(prob.constraints, prob.model.n, prob.model.m,
                            dtype=dtype)
    rng = np.random.default_rng(5)
    P = prob.constraints.P

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    mask = prob.constraints.mask
    X = (prob.X[None] + t(rng.normal(size=(batch, N, 13)) * 0.05)).contiguous()
    U = (prob.U[None]
         + t(rng.normal(size=(batch, N - 1, 17)) * 0.02)).contiguous()
    lam = (t(rng.uniform(0.0, 0.5, size=(batch, N, P))) * mask).contiguous()
    mu = (t(rng.uniform(0.5, 20.0, size=(batch, N, P))) * mask).contiguous()
    return dict(prob=prob, canon=canon, X=X, U=U, lam=lam, mu=mu,
                dt=prob.dt_traj(), rng=rng)


def to64(ms):
    """The float64 copy of a maze set-up, same values."""
    import torch
    from trajopt_tpu_torch.ops.canonical import canonical_stack
    from trajopt_tpu_torch.problems.zoo import quadrotor_maze
    from trajopt_tpu_torch.solvers.altro import infeasible_problem

    dev = ms["X"].device
    prob = infeasible_problem(
        quadrotor_maze(dtype=torch.float64, device=dev), 1e-8)
    return dict(prob=prob, canon=canonical_stack(
        prob.constraints, 13, 17, dtype=torch.float64), dt=prob.dt_traj())


def phase_k3(report):
    import torch
    from trajopt_tpu_torch.ops.cuda_al_fused import (
        fused_al_backward, fused_al_backward_cuda)
    from trajopt_tpu_torch.solvers.ilqr import reg_noise_scale

    ms = maze_setup(torch.float32, B)
    m64 = to64(ms)
    prob, canon, X, U, dt = ms["prob"], ms["canon"], ms["X"], ms["U"], ms["dt"]
    dev = X.device

    def three(lam, mu, rho):
        """Kernel, float32 plain version, float64 plain version."""
        k = fused_al_backward_cuda(prob.model, canon, X, U, lam, mu, dt,
                                   prob.obj, rho, return_jacobians=True)
        torch.cuda.synchronize()
        p = fused_al_backward(prob.model, canon, X, U, lam, mu, dt, prob.obj,
                              rho, return_jacobians=True)
        p64 = fused_al_backward(m64["prob"].model, m64["canon"], X.double(),
                                U.double(), lam.double(), mu.double(),
                                m64["dt"], m64["prob"].obj, rho.double())
        return k, p, p64

    def compare(tag, k, p, p64):
        """Fail flags, then K, d, dV on the problems that pass everywhere."""
        check(torch.equal(k[4], p[4]),
              f"K3 {tag}: fail flags differ from the plain version")
        live = ~(k[4] | p[4] | p64[4])
        log(f"K3 {tag}: fail kernel {int(k[4].sum())}, plain f32 "
            f"{int(p[4].sum())}, plain f64 {int(p64[4].sum())} of {B}")
        if not bool(live.any()):
            return 0.0
        sK = float(p64[0][live].abs().max())
        sd = max(1e-3, float(p64[1][live].abs().max()))
        eK, ed = (float((k[i] - p[i])[live].abs().max()) for i in (0, 1))
        eK64, ed64 = (float((k[i] - p64[i])[live].abs().max()) for i in (0, 1))
        pK64, pd64 = (float((p[i] - p64[i])[live].abs().max()) for i in (0, 1))
        log(f"K3 {tag}: scale K {sK:.3e} d {sd:.3e} | kernel - plain f32: "
            f"K {eK / sK:.2e} (tol {K3_K_TOL:g}) d {ed / sd:.2e} (tol "
            f"{K3_D_TOL:g}) of scale | to plain f64: kernel K "
            f"{eK64 / sK:.2e} d {ed64 / sd:.2e}, plain f32 K {pK64 / sK:.2e} "
            f"d {pd64 / sd:.2e} (bar {K3_RATIO:g}x the plain f32's)")
        check(eK < K3_K_TOL * sK, f"K3 {tag}: gains disagree")
        check(ed < K3_D_TOL * sd, f"K3 {tag}: feedforward disagrees")
        check(eK64 <= K3_RATIO * pK64, f"K3 {tag}: gains further from the "
              "float64 plain version than the float32 plain version's")
        for i in (2, 3):
            e = float(((k[i] - p[i]).abs() / p[i].abs().clamp(min=1e-6))
                      [live].max())
            log(f"K3 {tag}: dV{i - 1} max rel err {e:.2e} (tol "
                f"{K3_DV_TOL:g})")
            check(e < K3_DV_TOL, f"K3 {tag}: dV{i - 1} disagrees")
        return eK

    # (a) benign duals, rho = 1, and the Jacobians of the in-kernel dual RK3
    rho1 = torch.ones(B, device=dev)
    k, p, p64 = three(ms["lam"], ms["mu"], rho1)
    check(k[0].shape == (B, N - 1, 17, 13) and k[1].shape == (B, N - 1, 17),
          "K3 output shapes")
    worst = compare("(a) benign duals, rho = 1", k, p, p64)
    check(not bool(k[4].any()), "K3 (a): a benign problem failed")
    eA = float((k[5] - p[5]).abs().max())
    eB = float((k[6] - p[6]).abs().max())
    log(f"K3 Jacobians against jacobian_traj: max|dA| {eA:.2e}, max|dB| "
        f"{eB:.2e} (tol {JAC_TOL:g})")
    check(eA < JAC_TOL and eB < JAC_TOL, "K3 Jacobians disagree")

    # (b) late-schedule duals: a penalty of 1e6..1e8 on every valid row
    # (one value per row of the stack, as a schedule that multiplies by 25
    # each round leaves them). At rho = 0 only the fail flags are compared
    # (float32 is expected to fail where float64 does not: that is what the
    # retry is for); then at the retry's jump rho = reg_noise_scale(mu)
    rng = ms["rng"]
    row_mu = torch.as_tensor(10.0 ** rng.uniform(6, 8, size=canon.P),
                             dtype=torch.float32, device=dev)
    mu_late = (row_mu * prob.constraints.mask).expand(B, N, -1).contiguous()
    k, p, p64 = three(ms["lam"], mu_late, torch.zeros(B, device=dev))
    check(torch.equal(k[4], p[4]), "K3 (b) rho = 0: fail flags differ")
    log(f"K3 (b) late duals, rho = 0: fail kernel {int(k[4].sum())}, plain "
        f"f32 {int(p[4].sum())}, plain f64 {int(p64[4].sum())} of {B}")
    jump = reg_noise_scale(mu_late, torch.float32).contiguous()
    k, p, p64 = three(ms["lam"], mu_late, jump)
    worst = max(worst, compare(
        f"(b) late duals, rho = {float(jump.min()):.3g}..."
        f"{float(jump.max()):.3g}", k, p, p64))

    # (c) problem 7 made indefinite (negative penalties on its slack rows
    # at knot 40): the fail branch runs, gains there are zero
    mu_bad = ms["mu"].clone()
    r0, r1 = prob.constraints.row_slice("infeasible")
    mu_bad[7, 40, r0:r1] = -1e3
    k, p, p64 = three(ms["lam"], mu_bad, rho1)
    check(k[4].nonzero().flatten().tolist() == [7]
          and torch.equal(k[4], p[4]), "K3 (c): fail flags")
    check(not bool(k[0][7, 40].any()) and not bool(k[1][7, 40].any()),
          "K3 (c): gains left at the failed stage")
    compare("(c) problem 7 indefinite at knot 40", k, p, p64)

    args = (prob.model, canon, X, U, ms["lam"], ms["mu"], dt, prob.obj, rho1)
    log_k3_shape("K3 quadrotor_slack")
    launch_shapes("K3 quadrotor_slack", fused_al_backward_cuda, args,
                  (2, 3, 4, 5, 8))
    ms_k = cuda_time_ms(lambda: fused_al_backward_cuda(*args), reps=20)
    plain_ms = cuda_time_ms(lambda: fused_al_backward(*args), reps=2,
                            warmup=1)
    # per knot (n = 13, m = 17, 17 dual directions through three dynamics
    # evaluations of ~360 operations with their tangents, the stage and AL
    # expansion, the Riccati products, the 17-pivot elimination with 14
    # right-hand sides and the value update)
    n_, m_, P = 13, 17, canon.P
    per_knot = (17 * (3 * 360 + 100) + 2 * (n_ * n_ + m_ * m_ + 2 * m_ * n_)
                + 14 * P
                + mm(n_, n_, n_) + mm(n_, m_, n_) + mm(n_, 1, n_)
                + mm(m_, 1, n_) + mm(n_, n_, n_) + mm(m_, m_, n_)
                + mm(m_, n_, n_) + m_ * m_ * (m_ + n_ + 1)
                + mm(m_, n_ + 1, m_) + mm(m_, 1, m_) + mm(m_, n_, m_)
                + 3 * mm(n_, 1, m_) + 3 * mm(n_, n_, m_))
    obj = prob.obj
    bound_ms, bound_by = bound(
        B * (N - 1) * per_knot,
        nbytes(X, U, ms["lam"], ms["mu"], dt, obj.Q, obj.R, obj.H, obj.q,
               obj.r, rho1, canon.row_i, canon.row_f)
        + nbytes(k[0], k[1]) + 9 * B)
    log(f"K3 time per sweep: kernel {ms_k:.4f} ms, plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    report["kernels"].append(dict(
        name="fused_al_backward_quadrotor_slack", route="cuda",
        source="trajopt_tpu_torch/csrc/fused_al_backward.cu",
        replaces="trajopt_tpu/ops/pallas_al_fused.py:564", max_abs_err=worst,
        ms=ms_k, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    return ms


def phase_k4(report, ms):
    import torch
    from trajopt_tpu_torch.ops.canonical import canon_al_cost, pad_terminal
    from trajopt_tpu_torch.ops.cost import total_cost
    from trajopt_tpu_torch.ops.cuda_al_fused import (
        fused_al_backward_cuda, fused_al_forward, fused_al_forward_cuda)

    prob, canon, X, U, dt = ms["prob"], ms["canon"], ms["X"], ms["U"], ms["dt"]
    lam, mu = ms["lam"], ms["mu"]
    dev = X.device
    rho = torch.ones(B, device=dev)
    drho = torch.ones(B, device=dev)
    K, d, dV1, dV2, fail = fused_al_backward_cuda(
        prob.model, canon, X, U, lam, mu, dt, prob.obj, rho)
    check(not bool(fail.any()), "K4 inputs: a backward sweep failed")
    x0 = X[:, 0].contiguous()
    J_prev = (total_cost(prob.obj, X, U, dt)
              + canon_al_cost(canon, X, pad_terminal(U), lam,
                              mu)).contiguous()
    d = d.clone()
    for lane in K4_DIVERGE:
        d[lane] *= 1e6
    J_prev[K4_EXHAUST] = -1e30
    # The searches start at alpha0 = 2^-6 .. 2^-9, as a warm-started search
    # would: from this set-up (a seed that is not a trajectory, plus noise)
    # the full Newton step sends the quadrotor tumbling, and a float32
    # rollout of a tumbling quadrotor amplifies rounding by orders of
    # magnitude, in the kernel and in the plain version alike
    alpha0 = (0.5 ** (6 + torch.arange(B, device=dev) % 4)).float()
    args = (prob.model, canon, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho,
            alpha0, lam, mu, dt, prob.obj, LS_OPTS)
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args)
    torch.cuda.synchronize()
    Xp, Up, Jp, rp, drp, ap = fused_al_forward(*args)
    check(Xk.shape == X.shape and Uk.shape == U.shape, "K4 output shapes")
    same = ak == ap
    share = float(same.float().mean())
    # values are compared on the problems that took the same step, without
    # the lanes whose feedforward was blown up: their accepted candidate
    # follows a 1e6 x feedforward at alpha ~ 1e-6, which amplifies float32
    # rounding past any tolerance (their steps and flags are checked below)
    calm = same.clone()
    calm[list(K4_DIVERGE)] = False
    eJ = float(((Jk - Jp).abs() / Jp.abs().clamp(min=1.0))[calm].max())
    eX = float((Xk - Xp)[calm].abs().max()
               / max(1.0, float(Xp[calm].abs().max())))
    eU = float((Uk - Up)[calm].abs().max()
               / max(1.0, float(Up[calm].abs().max())))
    wild = list(K4_DIVERGE)
    log(f"K4: alpha equal on {int(same.sum())}/{B} problems (share "
        f"{share:.3f}, bar {K4_ALPHA_SHARE}); on those J rel err {eJ:.2e} "
        f"(tol {K4_J_TOL:g}), X {eX:.2e} and U {eU:.2e} of scale (tol "
        f"{K4_X_TOL:g}); steps used {sorted(set(ak.tolist()))}; on the "
        f"blown-up lanes {wild}: max|dX| "
        f"{float((Xk - Xp)[wild].abs().max()):.2e}")
    check(share >= K4_ALPHA_SHARE, "K4 takes other steps than the plain "
          "version")
    check(eJ < K4_J_TOL and eX < K4_X_TOL and eU < K4_X_TOL,
          "K4 disagrees with the plain version")
    # the forced branches: a diverging search still ends like the plain one,
    # and the exhausted one restores X, U, J_prev and bumps rho
    ex = K4_EXHAUST
    for lane in K4_DIVERGE + (ex,):
        check(float(ak[lane]) == float(ap[lane]),
              f"K4 lane {lane}: step differs from the plain version")
    check(float(ak[ex]) == 0.0 and torch.equal(Xk[ex], X[ex])
          and torch.equal(Uk[ex], U[ex])
          and float(Jk[ex]) == float(J_prev[ex]),
          "K4 exhausted search did not restore its inputs")
    check(torch.equal(rk[same], rp[same]) and torch.equal(drk[same], drp[same])
          and float(rk[ex]) > 10,
          "K4 rho bump differs from the plain version")
    log(f"K4 branches: lanes {K4_DIVERGE} (diverging first candidates) took "
        f"alpha {[float(ak[i]) for i in K4_DIVERGE]}; lane {ex} ran out: "
        f"alpha 0, rho {float(rk[ex]):g}, drho {float(drk[ex]):g}")
    log_rounds("K4 quadrotor_slack", alpha0, ak, LS_OPTS[2])
    launch_shapes("K4 quadrotor_slack", fused_al_forward_cuda, args,
                  range(2, 15))

    ms_k = cuda_time_ms(lambda: fused_al_forward_cuda(*args), reps=10)
    plain_ms = cuda_time_ms(lambda: fused_al_forward(*args), reps=1, warmup=0)
    # candidates this run's data needs: one per halving down to the step
    # used, all of them where the search ran out; per candidate and knot the
    # gain product, the stage cost, the AL rows and the RK3 step
    n_, m_, P = 13, 17, canon.P
    cands = torch.where(ak > 0,
                        torch.log2(alpha0 / ak.clamp(min=1e-30)).round() + 1,
                        torch.full_like(ak, LS_OPTS[2] + 1.0))
    per_knot = (mm(m_, 1, n_) + 2 * (n_ * n_ + m_ * m_ + m_ * n_) + 10 * P
                + 3 * 120 + 100)
    obj = prob.obj
    bound_ms, bound_by = bound(
        float(cands.sum()) * (N - 1) * per_knot,
        nbytes(x0, X, U, K, d, lam, mu, dt, obj.Q, obj.R, obj.H, obj.q, obj.r,
               obj.c, canon.row_i, canon.row_f, Xk, Uk) + 40 * B)
    log(f"K4 time per line search ({float(cands.mean()):.2f} candidates a "
        f"problem, {int(cands.max())} at most): kernel {ms_k:.4f} ms, plain "
        f"version {plain_ms:.1f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    report["kernels"].append(dict(
        name="fused_al_forward_quadrotor_slack", route="cuda",
        source="trajopt_tpu_torch/csrc/fused_al_forward.cu",
        replaces="trajopt_tpu/ops/pallas_al_fused.py:828",
        max_abs_err=float((Xk - Xp)[calm].abs().max()), ms=ms_k,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))


def maze_shares(c_max):
    c = c_max.double().cpu().numpy()
    return (float(np.mean(c < 1e-2)), float(np.mean(c < 1e-3)),
            float(np.median(c)))


def phase_maze(report, refs):
    import torch
    from trajopt_tpu_torch.parallel.batch import (
        solve_batch_queued_altro, solve_batch_queued_altro_retry)
    from trajopt_tpu_torch.problems.zoo import quadrotor_maze
    import trajopt_tpu_torch as tt

    prob = quadrotor_maze(dtype=torch.float32)      # on the card by default
    dev = prob.device
    check(dev.type == "cuda", "quadrotor_maze() did not build on the card")
    x0s_np = maze_starts(prob.x0.cpu(), MAZE_POOL)
    x0s = torch.as_tensor(x0s_np, dtype=torch.float32, device=dev)
    opts = maze_options()

    # warm-up: one short round, not timed
    warm = tt.ALTROOptions(R_inf=1e-8, opts_al=tt.ALOptions(
        iterations=1, opts_uncon=tt.iLQROptions(iterations=2, fused=True)))
    solve_batch_queued_altro(prob, warm, x0s[:B], lanes=B, infeasible=True)
    torch.cuda.synchronize()

    # the pass before the retry, for its three shares (not timed)
    first = solve_batch_queued_altro(prob, opts, x0s, lanes=B,
                                     infeasible=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res, n_retried = solve_batch_queued_altro_retry(
        prob, opts, x0s, lanes=B, infeasible=True, tol=1e-3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"maze: launches {launches}")
    record_launches(report, launches, ran=MAZE_KERNELS)

    check(res.X.shape == (MAZE_POOL, N, 13)
          and res.U.shape == (MAZE_POOL, N - 1, 4), "maze output shapes")
    check(bool(torch.isfinite(res.X).all()), "non-finite final states")
    before, after = maze_shares(first.c_max), maze_shares(res.c_max)
    its = res.iterations_total.float().mean().item()
    total_its = int(res.iterations_total.sum())
    k3, k4 = (launches[k] for k in MAZE_KERNELS)
    log(f"maze: {MAZE_POOL} problems over {B} lanes in {wall:.3f} s = "
        f"{MAZE_POOL / wall:.2f} solves/s with the retry | rounds "
        f"{res.rounds}, host syncs {res.host_syncs} "
        f"({res.host_syncs / res.rounds:.2f} per round), n_retried "
        f"{n_retried}")
    log(f"maze: before the retry c_max<1e-2 {before[0]:.4f}, c_max<1e-3 "
        f"{before[1]:.4f}, median c_max {before[2]:.3e}; after it "
        f"{after[0]:.4f}, {after[1]:.4f}, {after[2]:.3e} (gates "
        f"{MAZE_GATES})")
    log(f"maze: mean inner iterations {its:.2f} (of the kept solves), K3 "
        f"sweeps per K4 line search {k3 / k4:.3f} (rho retries), "
        f"{k4} batched iterations")
    report["maze"] = dict(
        solves_per_s=MAZE_POOL / wall, wall_s=wall, rounds=res.rounds,
        host_syncs=res.host_syncs, n_retried=n_retried, before_retry=before,
        after_retry=after, mean_iterations_total=its,
        total_iterations=total_its)
    check(after[0] >= MAZE_GATES[0], "maze: share with c_max < 1e-2 too low")
    check(after[1] >= MAZE_GATES[1], "maze: share with c_max < 1e-3 too low")
    check(after[2] < MAZE_GATES[2], "maze: median c_max too high")

    check(np.array_equal(x0s_np[0], maze_starts(quad_x0_np(), 1)[0]),
          "the reference solve starts elsewhere than the card's")
    maze_reference(res, refs.pop("ref_maze").result())


def maze_reference(res, ref):
    """The problems ``MAZE_REF`` in float64 by the plain versions on the CPU
    must agree in outcome (c_max < 1e-3) with the card's float32 solves."""
    idx = list(MAZE_REF)
    ok_ref = [c < 1e-3 for c in ref["c_max"]]
    ok_gpu = (res.c_max[idx] < 1e-3).tolist()
    log(f"reference: maze problems {idx} in float64 on the CPU "
        f"({ref['seconds']:.1f} s, beside the GPU phases): c_max "
        f"{ref['c_max']} (card: {res.c_max[idx].tolist()}), inner iterations "
        f"{ref['iterations']} (card: "
        f"{res.iterations_total[idx].tolist()})")
    check(ok_ref == ok_gpu, "the card disagrees in outcome with the CPU "
          "plain versions")


def phase_maze_profile(report):
    """One maze AL round of 10 iLQR iterations on the first 128 problems."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    from trajopt_tpu_torch.problems.zoo import quadrotor_maze
    import trajopt_tpu_torch as tt

    prob = quadrotor_maze(dtype=torch.float32)
    x0s = torch.as_tensor(maze_starts(prob.x0.cpu(), B), dtype=torch.float32,
                          device=prob.device)
    iters = 10
    opts = tt.ALTROOptions(R_inf=1e-8, opts_al=tt.ALOptions(
        iterations=1, opts_uncon=tt.iLQROptions(iterations=iters,
                                                fused=True),
        cost_tolerance_intermediate=0.0, penalty_initial=1.0,
        penalty_scaling=25.0))

    def one_round():
        res = solve_batch_queued_altro(prob, opts, x0s, lanes=B,
                                       infeasible=True)
        torch.cuda.synchronize()
        return res

    profile_round("maze profile", one_round, iters, MAZE_KERNELS)

# ------------------------------------------------------------- slice 3

def riccati_flops(n, m):
    """Operations of one knot of the standard Riccati step."""
    return (mm(n, n, n) + mm(n, m, n) + mm(n, 1, n) + mm(m, 1, n)
            + mm(n, n, n) + mm(m, m, n) + mm(m, n, n) + m * m * (m + n + 1)
            + mm(m, n + 1, m) + mm(m, 1, m) + mm(m, n, m) + 3 * mm(n, 1, m)
            + 3 * mm(n, n, m))


# operations of one evaluation of a model's dynamics (a count by hand of
# csrc/models.cuh; with one tangent three times that); a rigid-body chain's
# are counted from its table by chain_dyn_ops
DYN_OPS = dict(quadrotor=120, cartpole=40, car=8, pendulum=8,
               doubleintegrator=1, ballonbeam=30, quadrotor_euler=420,
               doublependulum=45, acrobot=45)


def chain_dyn_ops(table):
    """Operations that one evaluation of a rigid-body chain's dynamics needs
    (``Chain::dynamics`` of csrc/models.cuh), counted from the chain table
    the kernels read (``models/rigidbody_lanes.py::chain_table``): only
    products of two entries that are not structurally zero, as the JAX lane
    code leaves out its zero coefficients. Xup(q) has the nonzeros of its
    affine coefficients; the composite inertias, velocities, accelerations
    and forces carry the nonzero pattern that their products give. A
    product term is two operations (multiply, add), as is each sin/cos
    coefficient term of Xup; the spatial cross products count 30 each, the
    7x7 equilibrated solve its loops."""
    t = np.asarray(table, np.float64)
    D = 8                                   # kChainMaxDof
    C = t[:D * 108].reshape(D, 3, 6, 6)
    o = D * 108
    S, o = t[o:o + D * 6].reshape(D, 6) != 0, o + D * 6
    Inert, o = t[o:o + D * 36].reshape(D, 6, 6) != 0, o + D * 36
    Bact, o = t[o:o + D * D].reshape(D, D) != 0, o + D * D
    o += D                                  # damping
    parent = t[o:o + D].astype(int)
    nd = int(t[-2])

    def prod(a, b):
        """Operations of a @ b on patterns, and the pattern of the result."""
        k = a.astype(int) @ b.astype(int)
        return 2 * int(k.sum()), k > 0

    Xp = [(C[k] != 0).any(0) for k in range(nd)]
    ops = sum(2 * int((C[k, 1:] != 0).sum()) for k in range(nd))
    # CRBA: composite inertias from the leaves in, then H's columns
    Ic = [Inert[i].copy() for i in range(nd)]
    for i in range(nd - 1, -1, -1):
        if parent[i] >= 0:
            a, XtI = prod(Xp[i].T, Ic[i])
            b, add = prod(XtI, Xp[i])
            ops += a + b + int(add.sum())
            Ic[parent[i]] = Ic[parent[i]] | add
        a, F = prod(Ic[i], S[i][:, None])
        ops += a + 2 * int((S[i] & F[:, 0]).sum())
        j = i
        while parent[j] >= 0:
            a, F = prod(Xp[j].T, F)
            j = parent[j]
            ops += a + 2 * int((S[j] & F[:, 0]).sum())
    # RNEA with q̈ = 0: out, then the forces back in
    v, acc, f = [None] * nd, [None] * nd, [None] * nd
    grav = np.zeros((6, 1), bool)
    grav[5] = True
    for i in range(nd):
        vJ = S[i][:, None]
        ops += int(vJ.sum())
        p = parent[i]
        if p >= 0:
            a, v[i] = prod(Xp[i], v[p])
            b, acc[i] = prod(Xp[i], acc[p])
            ops += a + b + int(vJ.sum())
            v[i] = v[i] | vJ
        else:
            b, acc[i] = prod(Xp[i], grav)
            v[i] = vJ
            ops += b
        acc[i] = np.ones((6, 1), bool)      # + (v ×) vJ fills it
        a, _ = prod(Inert[i], acc[i])
        b, _ = prod(Inert[i], v[i])
        ops += 30 + 6 + a + b + 30 + 6
        f[i] = np.ones((6, 1), bool)
    for i in range(nd - 1, -1, -1):
        ops += 2 * int(S[i].sum())
        if parent[i] >= 0:
            a, _ = prod(Xp[i].T, f[i])
            ops += a + 6
    # τ = Bact u − bias − damping q̇, and the solve
    ops += 2 * int(Bact[:nd, :nd].sum()) + 3 * nd
    M = nd
    ops += 2 * M + 2 * M * M + M
    ops += sum(1 + (M - i - 1) * (1 + 2 * (M - i - 1) + 2) for i in range(M))
    ops += sum(2 * (M - i - 1) + 1 for i in range(M)) + M
    return ops


def step_ops(label, n, model):
    """Operations of one RK3 step of ``model`` (with slack controls,
    ``label`` has ``_slack``: n more additions; in minimum time, ``_mintime``:
    one more product, h²): three dynamics evaluations and the
    combinations."""
    mintime = label.endswith("_mintime")
    slack = label.removesuffix("_mintime")
    base = slack.removesuffix("_slack")
    table = getattr(model, "chain_table", None)
    dyn = DYN_OPS[base] if table is None else chain_dyn_ops(table)
    n = n - mintime
    return 3 * dyn + 8 * n + (n if base != slack else 0) + mintime


def model_setup(name, batch=B, seed=7):
    """Model ``name`` at the shapes its main path has: the zoo problem that
    uses it (``quadrotor_line`` N=101 without constraints, ``cartpole``
    N=101, ``parallel_park`` N=51 for the car, ``pendulum`` N=31,
    ``doubleintegrator`` N=21, a URDF rig on its ``rig_problem``),
    ``batch`` starts with 0.02 noise on every
    state entry, the problem's control seed (for the scalar models plus 0.02
    noise) and the open-loop rollouts, computed in float64 on the card and
    handed out in float32."""
    import torch
    from trajopt_tpu_torch.ops.rollout import rollout
    from trajopt_tpu_torch.problems import zoo

    factory = dict(quadrotor=lambda **kw: zoo.quadrotor_line(N=N, **kw),
                   cartpole=zoo.cartpole, car=zoo.parallel_park,
                   pendulum=zoo.pendulum,
                   doubleintegrator=zoo.doubleintegrator).get(
        name, lambda **kw: rig_problem(name, **kw))
    p64, p32 = factory(dtype=torch.float64), factory(dtype=torch.float32)
    dev = p64.device
    rng = np.random.default_rng(seed)
    x0s = p64.x0[None] + torch.as_tensor(
        rng.normal(size=(batch, p64.n)) * 0.02, device=dev)
    U = p64.U.expand(batch, -1, -1)
    if name != "quadrotor":
        U = U + torch.as_tensor(rng.normal(size=tuple(U.shape)) * 0.02,
                                device=dev)
    X = rollout(p64.model, x0s, U, p64.dt_traj())
    return dict(name=name, p64=p64, p32=p32, model=p32.model, obj=p32.obj,
                X64=X, U64=U.contiguous(), X=X.float().contiguous(),
                U=U.float().contiguous(), dt=p32.dt, dt_traj=p32.dt_traj(),
                Nk=p32.N)


def sweep_inputs(ms, dtype):
    """A, B and the LQR expansion of a ``model_setup`` as the contiguous
    sweep inputs (A, B, lx, lu, lxx, luu, lux), computed in float64."""
    from trajopt_tpu_torch.ops.cost import cost_expansion

    p64 = ms["p64"]
    A, Bm = p64.model.jacobian_traj(ms["X64"][:, :-1], ms["U64"],
                                    p64.dt_traj())
    e = cost_expansion(p64.obj, ms["X64"], ms["U64"], p64.dt_traj())
    return [t.to(dtype).contiguous() for t in (A, Bm, e.x, e.u, e.xx, e.uu,
                                               e.ux)]


def compare_sweeps(tag, k, p, p64, weight=None, same_flags=True,
                   kd_tol=None, dv_tol=None, hold_d=True):
    """Kernel ``k`` against the float32 plain version ``p`` and the float64
    one ``p64`` (each K, d, dV1, dV2, fail): fail flags equal; on the
    problems that pass everywhere K and d within KD_TOL of scale and ΔV
    within DV_TOL, or within three times the plain version's own distance
    from float64; and K no further from float64 than K3_RATIO times the plain
    version is (or within the tolerance of it). ``weight`` (m,) scales the rows of K and d before they are
    compared. Without ``same_flags`` the flags are only counted: where
    float32 has run out of information, rounding decides them. ``kd_tol``
    and ``dv_tol`` stand in for KD_TOL and DV_TOL. Without ``hold_d`` the
    feedforward d, and ΔV, which sums dᵀQu, are printed and not held (two
    reductions of a chain's Jacobians at stiff knots: CLAUDE.md's float32
    rules). Returns max|ΔK| against the plain version."""
    import torch

    kd_tol = KD_TOL if kd_tol is None else kd_tol
    dv_tol = DV_TOL if dv_tol is None else dv_tol

    differ = (k[4] != p[4]).nonzero().flatten().tolist()
    if differ:
        log(f"{tag}: fail flags differ from the plain version on problems "
            f"{differ}")
    check(not (same_flags and differ),
          f"{tag}: fail flags differ from the plain version")
    live = ~(k[4] | p[4] | p64[4])
    worst = 0.0
    if not bool(live.any()):
        log(f"{tag}: no problem passes in all three, nothing more to "
            "compare")
        return worst
    for i, (what, tol) in enumerate((("K", kd_tol), ("d", kd_tol),
                                     ("dV1", dv_tol), ("dV2", dv_tol))):
        a, b, c = k[i][live], p[i][live], p64[i][live]
        if weight is not None and i < 2:
            w = weight[:, None] if i == 0 else weight
            a, b, c = a * w, b * w, c * w.double()
        scale = max(float(c.abs().max()), 1e-12)
        e_kp = float((a - b).abs().max()) / scale
        e_k64 = float((a.double() - c).abs().max()) / scale
        e_p64 = float((b.double() - c).abs().max()) / scale
        log(f"{tag}: {what} scale {scale:.3e} | kernel - plain f32 "
            f"{e_kp:.2e} (bar {max(tol, 3 * e_p64):.2e}) | to plain f64: "
            f"kernel {e_k64:.2e}, plain f32 {e_p64:.2e}")
        check(e_kp < max(tol, 3 * e_p64) or (what != "K" and not hold_d),
              f"{tag}: {what} disagrees with the plain version")
        # the bar K3's gains are held to
        check(i > 0 or e_k64 <= max(K3_RATIO * e_p64, tol),
              f"{tag}: K is further from the float64 plain version than "
              f"{K3_RATIO} times the float32 plain version's distance")
        if i == 0:
            worst = float((a - b).abs().max())
    return worst


def phase_k5(report, lin):
    import torch
    from trajopt_tpu_torch.ops.cost import Expansion
    from trajopt_tpu_torch.ops.cuda_riccati import (
        riccati_sweep_cuda, riccati_sweep_shape)
    from trajopt_tpu_torch.ops.riccati import scan_sweep
    from trajopt_tpu_torch.solvers.al import al_cost_fns

    dev = torch.device("cuda", 0)

    def three(ins, rho, reg_state=False, plain_ms=None):
        """Kernel, float32 plain version (its time appended to the list
        ``plain_ms``), float64 plain."""
        k = riccati_sweep_cuda(*ins, rho, reg_state=reg_state)
        torch.cuda.synchronize()
        p, ms = timed(lambda: scan_sweep(ins[0], ins[1], Expansion(*ins[2:]),
                                         rho, reg_state=reg_state))
        if plain_ms is not None:
            plain_ms.append(ms)
        p64 = scan_sweep(ins[0].double(), ins[1].double(),
                         Expansion(*(t.double() for t in ins[2:])),
                         rho.double(), reg_state=reg_state)
        return k, p, p64

    def full(v, batch=B):
        return torch.full((batch,), v, device=dev)

    for name in ("quadrotor", "cartpole"):
        ms = model_setup(name)
        ins = sweep_inputs(ms, torch.float32)
        n, m = ins[1].shape[-2:]
        check(ins[0].shape == (B, N - 1, n, n), "K5 input shapes")
        tag = f"K5 {name} ({n},{m})"
        worst = 0.0
        # at rho = 0 and 1e-2 the full-state quadrotor's float32 sweep fails
        # on nearly every problem where the float64 one does not (that is
        # what the rho retry is for), and on a few of them rounding decides:
        # there the flags are counted, and held equal only at rho = 1
        for rho_val in (0.0, 1e-2, 1.0):
            k, p, p64 = three(ins, full(rho_val))
            check(k[0].shape == (B, N - 1, m, n) and k[1].shape ==
                  (B, N - 1, m), "K5 output shapes")
            log(f"{tag} rho={rho_val:g}: fail kernel {int(k[4].sum())}, "
                f"plain f32 {int(p[4].sum())}, plain f64 "
                f"{int(p64[4].sum())} of {B}")
            worst = max(worst, compare_sweeps(
                f"{tag} rho={rho_val:g}", k, p, p64,
                same_flags=rho_val == 1.0))
        k_rs, p, p64 = three(ins, full(1.0), reg_state=True)
        compare_sweeps(f"{tag} reg_state, rho=1", k_rs, p, p64)

        # problem 9 made indefinite at knot 12: it fails alone in both, and
        # its gains at that stage are zero
        bad = [t.clone() for t in ins]
        bad[5][9, 12] = -50.0 * torch.eye(m, device=dev)
        k, p, p64 = three(bad, full(1.0))
        check(k[4].nonzero().flatten().tolist() == [9],
              f"{tag}: the indefinite problem did not fail alone")
        check(not bool(k[0][9, 12].any()) and not bool(k[1][9, 12].any()),
              f"{tag}: gains left at the failed stage")
        compare_sweeps(f"{tag} problem 9 indefinite at knot 12", k, p, p64)
        log(f"{tag}: problem 9 fails alone in kernel and plain version, "
            "gains zero at the failed stage")

        if name == "quadrotor":
            # the controls of every problem scaled over 12 decades of Quu
            # (u = D u', D = 1e-3 .. 1e3) under state regularization, which
            # scales with them: the equilibration must carry it, the same
            # problems must pass as unscaled, and the gains, scaled back,
            # must be those of the plain version
            D = 10.0 ** torch.linspace(-3.0, 3.0, m, device=dev)
            sc = list(ins)
            sc[1] = (ins[1] * D).contiguous()
            sc[3] = (ins[3] * D).contiguous()
            sc[5] = (ins[5] * D[:, None] * D).contiguous()
            sc[6] = (ins[6] * D[:, None]).contiguous()
            k, p, p64 = three(sc, full(1.0), reg_state=True)
            check(torch.equal(k[4], k_rs[4]) and not bool(k[4].all()),
                  f"{tag}: scaling the controls changed which problems fail")
            compare_sweeps(f"{tag} controls scaled 1e-3..1e3, reg_state, "
                           "rho=1", k, p, p64, weight=D)

        rho = full(1.0)
        ms_k = cuda_time_ms(lambda: riccati_sweep_cuda(*ins, rho), reps=20)
        exp = Expansion(*ins[2:])
        plain_ms = cuda_time_ms(lambda: scan_sweep(ins[0], ins[1], exp, rho),
                                reps=3, warmup=1)
        kk = riccati_sweep_cuda(*ins, rho)
        bound_ms, bound_by = bound(
            B * (N - 1) * riccati_flops(n, m),
            nbytes(*ins, rho) + nbytes(kk[0], kk[1]) + 9 * B)
        log(f"{tag} time per sweep: kernel {ms_k:.4f} ms, plain version "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}; "
            + ring_shape_text(riccati_sweep_shape(n, m, B)))
        # slice 3 runs both shapes at B = 1024: (13,4) in arm (b), where
        # all its launches are, (4,1) in the cartpole's phase-split arm (c);
        # most of (4,1)'s come from the rigs' pools and slice 3 (d), at
        # B = 128
        big = [t.repeat((8,) + (1,) * (t.ndim - 1)) for t in ins]
        rho8 = full(1.0, 8 * B)
        ms8 = cuda_time_ms(lambda: riccati_sweep_cuda(*big, rho8), reps=10)
        log(f"{tag} at B={8 * B}: kernel {ms8:.4f} ms per sweep, bound "
            f"{8 * bound_ms:.5f} ms; "
            + ring_shape_text(riccati_sweep_shape(n, m, 8 * B)))
        if name == "quadrotor":
            launch_shapes(f"{tag} rho=1", riccati_sweep_cuda, [*ins, rho],
                          range(8), shape_of=lambda c: ring_shape_text(
                              riccati_sweep_shape(n, m, c)))
        if name == "quadrotor":
            main = dict(main_batch=8 * B, ms_main_batch=ms8,
                        bound_ms_main_batch=8 * bound_ms)
        else:
            main = dict(main_batch=B, ms_main_batch=ms_k,
                        bound_ms_main_batch=bound_ms)
        kernel_entry(report, name=f"riccati_sweep_{n}x{m}",
                     source="trajopt_tpu_torch/csrc/riccati_sweep.cu",
                     replaces="trajopt_tpu/ops/pallas_riccati.py:278",
                     max_abs_err=worst, ms=ms_k, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by, batch=B,
                     ms_b1024=ms8, **main)

    # the other shapes the kernel is built for, once each at rho = 1: the
    # car (3,2), the pendulum (2,1), the quadrotor's error state (12,4) and
    # the slack-augmented quadrotor of the maze (13,17) with the AL terms of
    # al_cost_fns in its expansion
    others = [(f"K5 {nm}", sweep_inputs(model_setup(nm), torch.float32), 1.0)
              for nm in ("car", "pendulum")]
    others.append(("K5 quadrotor error state", list(lin[0]), 1.0))
    mz = maze_setup(torch.float64, B)
    A, Bm = mz["prob"].model.jacobian_traj(mz["X"][:, :-1], mz["U"], mz["dt"])
    e = al_cost_fns(mz["prob"].obj, mz["prob"].constraints, mz["dt"],
                    mz["lam"], mz["mu"])[1](mz["X"], mz["U"])
    others.append(("K5 quadrotor with slacks", [
        t.float().contiguous() for t in (A, Bm, e.x, e.u, e.xx, e.uu, e.ux)],
        1.0))
    # slice 7's and slice 8's shapes, each on the linearization of a form
    # that runs it (``form_setup``): the Euler-angle quadrotor with slacks,
    # and the minimum-time forms
    for n_m, form in {**SLICE7_K5, **SLICE8_K5}.items():
        fs = form_setup(*form)
        check(tuple(fs["ins"][1].shape[-2:]) == n_m, "K5 slice 7/8 shapes")
        others.append((f"K5 {fs['label']}", fs["ins"], fs["rho"]))
    for tag, ins, rho_v in others:
        n, m = ins[1].shape[-2:]
        Nk = ins[2].shape[1]
        rho = full(rho_v)
        # (the plain version timed in its comparison run: scan_sweep has
        # run before, so this is not its first call)
        times = []
        k, p, p64 = three(ins, rho, plain_ms=times)
        plain_ms = times[0]
        worst = compare_sweeps(f"{tag} ({n},{m}) rho={rho_v:g}", k, p, p64)
        check(int(k[4].sum()) <= B // 4, f"{tag}: most problems fail")
        ms_k = cuda_time_ms(lambda: riccati_sweep_cuda(*ins, rho), reps=10)
        bound_ms, bound_by = bound(
            B * (Nk - 1) * riccati_flops(n, m),
            nbytes(*ins, rho) + nbytes(k[0], k[1]) + 9 * B)
        log(f"{tag} ({n},{m}), N={Nk}: kernel {ms_k:.4f} ms per sweep, plain "
            f"version {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
            f"{bound_by}")
        if (n, m) != (12, 4):       # no main path of this script runs it
            kernel_entry(report, name=f"riccati_sweep_{n}x{m}",
                         source="trajopt_tpu_torch/csrc/riccati_sweep.cu",
                         replaces="trajopt_tpu/ops/pallas_riccati.py:278",
                         max_abs_err=worst, ms=ms_k, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)


def phase_k7a(report):
    """K7a for each model against its plain version, against K5 fed the
    ``torch.func`` Jacobians, and its in-kernel Jacobians against
    ``jacobian_traj``. Returns the set-ups with the kernel's gains at
    rho = 1 for the forward phases."""
    return {name: k7a_case(report, model_setup(name),
                           shapes=name == "quadrotor") for name in MODELS}


def k7a_case(report, ms, kd_tol=None, dv_tol=None, jac_rtol=None,
             hold_d=True, shapes=False):
    """K7a on one ``model_setup`` (or ``kuka_free_setup``) against its plain
    version, against K5 fed the ``torch.func`` Jacobians, its in-kernel
    Jacobians against ``jacobian_traj`` (within JAC_TOL, or with
    ``jac_rtol`` within that share of their scale or three times the
    float32 plain version's own distance from float64); ``kd_tol`` and
    ``dv_tol`` and ``hold_d`` as ``compare_sweeps``; with ``shapes`` its
    launch shapes (the gains, ΔV, fail flags and Jacobians). Returns the
    set-up with the kernel's gains at rho = 1."""
    import torch
    from trajopt_tpu_torch.ops.cuda_fused import (
        fused_backward, fused_backward_cuda, fused_backward_shape)
    from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda

    name = ms["name"]
    model, obj, X, U, dtt = (ms[k] for k in ("model", "obj", "X", "U",
                                             "dt_traj"))
    Nk, n, m = ms["Nk"], model.n, model.m
    rho = torch.ones(B, device=X.device)
    tag = f"K7a {name} (N={Nk})"
    k = fused_backward_cuda(model, X, U, dtt, obj, rho,
                            return_jacobians=True)
    torch.cuda.synchronize()
    check(k[0].shape == (B, Nk - 1, m, n), "K7a output shapes")
    p = fused_backward(model, X, U, dtt, obj, rho, return_jacobians=True)
    p64 = fused_backward(ms["p64"].model, ms["X64"], ms["U64"],
                         ms["p64"].dt_traj(), ms["p64"].obj, rho.double(),
                         return_jacobians=jac_rtol is not None)
    check(not bool(k[4].any()), f"{tag}: a benign problem failed")
    worst = compare_sweeps(f"{tag} rho=1", k[:5], p[:5], p64[:5],
                           kd_tol=kd_tol, dv_tol=dv_tol, hold_d=hold_d)
    eA = float((k[5] - p[5]).abs().max())
    eB = float((k[6] - p[6]).abs().max())
    jac_tol = JAC_TOL
    if jac_rtol is not None:
        own = max(float((p[5].double() - p64[5]).abs().max()),
                  float((p[6].double() - p64[6]).abs().max()))
        scale = max(1.0, float(p64[5].abs().max()),
                    float(p64[6].abs().max()))
        jac_tol = max(jac_rtol * scale, 3 * own)
        log(f"{tag} Jacobians: scale {scale:.3e}, the float32 plain version "
            f"{own:.2e} from float64")
    log(f"{tag} Jacobians against jacobian_traj: max|dA| {eA:.2e}, "
        f"max|dB| {eB:.2e} (tol {jac_tol:.2e})")
    check(eA < jac_tol and eB < jac_tol, f"{tag}: Jacobians disagree")
    # against K5 fed the torch Jacobians (tests/test_fused.py:50-72)
    ins = sweep_inputs(ms, torch.float32)
    k5 = riccati_sweep_cuda(*ins, rho)
    compare_sweeps(f"{tag} against K5", k[:5], k5, p64[:5], kd_tol=kd_tol,
                   dv_tol=dv_tol, hold_d=hold_d)

    args = (model, X, U, dtt, obj, rho)
    ms_k = cuda_time_ms(lambda: fused_backward_cuda(*args), reps=20)
    plain_ms = cuda_time_ms(lambda: fused_backward(*args), reps=2,
                            warmup=1)
    per_knot = ((n + m) * 3 * step_ops(name, n, model)
                + 2 * (n * n + m * m + 2 * m * n) + riccati_flops(n, m))
    bound_ms, bound_by = bound(
        B * (Nk - 1) * per_knot,
        nbytes(X, U, dtt, obj.Q, obj.R, obj.H, obj.q, obj.r, rho)
        + nbytes(k[0], k[1]) + 9 * B)
    log(f"{tag} time per sweep: kernel {ms_k:.4f} ms, plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}; "
        + ring_shape_text(fused_backward_shape(model, B)))
    main = dict(batch=B, main_batch=B, ms_main_batch=ms_k,
                bound_ms_main_batch=bound_ms)
    if name == "quadrotor":     # slice 3 arm (a) runs it at B = 1024
        X8, U8 = X.repeat(8, 1, 1), U.repeat(8, 1, 1)
        rho8 = torch.ones(8 * B, device=X.device)
        ms8 = cuda_time_ms(lambda: fused_backward_cuda(
            model, X8, U8, dtt, obj, rho8), reps=10)
        log(f"{tag} at B={8 * B}: kernel {ms8:.4f} ms per sweep, bound "
            f"{8 * bound_ms:.5f} ms; "
            + ring_shape_text(fused_backward_shape(model, 8 * B)))
        main.update(main_batch=8 * B, ms_main_batch=ms8,
                    bound_ms_main_batch=8 * bound_ms)
    if shapes:
        launch_shapes(f"{tag} rho=1", fused_backward_cuda, list(args),
                      (1, 2, 5), shape_of=lambda c: ring_shape_text(
                          fused_backward_shape(model, c)),
                      return_jacobians=True)
    kernel_entry(report, name=f"fused_backward_{name}",
                 source="trajopt_tpu_torch/csrc/fused_backward.cu",
                 replaces="trajopt_tpu/ops/pallas_fused.py:227",
                 max_abs_err=worst, ms=ms_k, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, **main)
    return dict(ms, K=k[0], d=k[1], dV1=k[2], dV2=k[3])


def search_inputs(st):
    """Line-search inputs of a K7a set-up. The quadrotor's searches start at
    alpha0 = 2^-6 .. 2^-9 (from hover the full Newton step towards a goal
    60 m away tumbles the quadrotor, and a float32 rollout of that is
    chaotic in kernel and plain version alike), the others at 1. Lanes
    ``K4_DIVERGE`` get a feedforward blown up until their first candidates
    trip the guard or are refused, lane ``K4_EXHAUST`` a cost no candidate
    can beat, so that its search runs out."""
    import torch
    from trajopt_tpu_torch.ops.cost import total_cost

    X, U = st["X"], st["U"]
    dev = X.device
    quad = st["name"] == "quadrotor"
    d = st["d"].clone()
    for lane in K4_DIVERGE:
        d[lane] *= 1e6 if quad else 1e5
    J_prev = total_cost(st["obj"], X, U, st["dt_traj"]).contiguous()
    J_prev[K4_EXHAUST] = -1e30
    alpha0 = (0.5 ** (6 + torch.arange(B, device=dev) % 4)).float() if quad \
        else torch.ones(B, device=dev)
    return X[:, 0].contiguous(), d, J_prev, alpha0


def rollout_eps(model64, ins, dt, Xp, Up, calm, rollout64=None):
    """How far the float32 plain rollout (Xp, Up) sits from the float64 one
    on the same (float32) inputs ``ins`` = (x0, X, U, K, d, alpha), of
    scale, on the problems ``calm``: the floor that float32 rounding times
    the gains puts under any float32 rollout. ``rollout64``, a list, gets
    the float64 rollout (X, U, ok), for a caller that needs its cost or
    its ok mask too."""
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    X64, U64, ok64 = rollout_closed_loop(
        model64, *(t.double() for t in ins), dt)
    if rollout64 is not None:
        rollout64[:] = [X64, U64, ok64]
    calm = calm & ok64
    eX = float((Xp.double() - X64)[calm].abs().max()
               / max(1.0, float(X64[calm].abs().max())))
    eU = float((Up.double() - U64)[calm].abs().max()
               / max(1.0, float(U64[calm].abs().max())))
    return eX, eU


def phase_k7b(report, setups):
    for name in MODELS:
        k7b_case(report, setups[name], shapes=name == "quadrotor")


def k7b_case(report, st, alpha_share=None, ls_opts=LS_OPTS, j_own=False,
             shapes=False):
    """K7b on one set-up of ``k7a_case`` against its plain version, with
    lanes forced to diverge and one whose search runs out: α, ρ and dρ equal
    on every problem (with ``alpha_share``, α on at least that share and ρ,
    dρ, J and X compared where α is equal, as K4 is held), J, X and U as
    K7B_J_TOL and K7B_X_TOL say; the rounds the launch took, and with
    ``shapes`` its launch shapes."""
    import torch
    from trajopt_tpu_torch.ops.cost import total_cost
    from trajopt_tpu_torch.ops.cuda_fused import (
        fused_forward, fused_forward_cuda)
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    name = st["name"]
    model, obj, X, U, dtt = (st[k] for k in ("model", "obj", "X", "U",
                                             "dt_traj"))
    Nk, n, m = st["Nk"], model.n, model.m
    dev = X.device
    tag = f"K7b {name} (N={Nk})"
    x0, d, J_prev, alpha0 = search_inputs(st)
    one = torch.ones(B, device=dev)
    args = (model, x0, X, U, st["K"], d, st["dV1"], st["dV2"], J_prev,
            one, one, alpha0, dtt, obj, ls_opts)
    Xk, Uk, Jk, rk, drk, ak = fused_forward_cuda(*args)
    torch.cuda.synchronize()
    (Xp, Up, Jp, rp, drp, ap), plain_ms = timed(
        lambda: fused_forward(*args))
    check(Xk.shape == X.shape and Uk.shape == U.shape, "K7b shapes")
    same = ak == ap
    log(f"{tag}: alpha equal on {int(same.sum())}/{B} problems, rho "
        f"equal on {int((rk == rp).sum())}, drho on "
        f"{int((drk == drp).sum())}; steps used "
        f"{sorted(set(ak.tolist()))}")
    if alpha_share is None:
        check(bool(same.all()), f"{tag}: takes other steps than the plain "
              f"version on problems {(~same).nonzero().flatten().tolist()}")
    else:
        check(float(same.float().mean()) >= alpha_share,
              f"{tag}: takes other steps than the plain version on more "
              f"than {1 - alpha_share:.2f} of the problems")
    check(torch.equal(rk[same], rp[same])
          and torch.equal(drk[same], drp[same]),
          f"{tag}: rho or drho differ from the plain version")
    calm = same.clone()
    calm[list(K4_DIVERGE)] = False      # they follow a blown-up step
    eJ = float(((Jk - Jp).abs() / Jp.abs().clamp(min=1e-6))[calm].max())
    eX = float((Xk - Xp)[calm].abs().max()
               / max(1.0, float(Xp[calm].abs().max())))
    eU = float((Uk - Up)[calm].abs().max()
               / max(1.0, float(Up[calm].abs().max())))
    rollout64 = []
    pX, pU = rollout_eps(st["p64"].model, (x0, X, U, st["K"], d, ak),
                         st["dt"], Xp, Up, calm & (ak > 0), rollout64)
    # with ``j_own``, J too within three times the float32 plain version's
    # own distance from the float64 rollout's cost at the same steps: stiff
    # gains (|K| ~ 3e2 on the cartpole rig) amplify float32 rounding of the
    # state into the cost as into X (Q3-8/16/20)
    pJ = 0.0
    live = calm & (ak > 0)
    if j_own and bool(live.any()):
        p64 = st["p64"]
        X64, U64 = rollout64[:2]
        J64 = total_cost(p64.obj, X64, U64, p64.dt_traj())
        pJ = float(((Jp.double() - J64).abs()
                    / J64.abs().clamp(min=1e-6))[live].max())
    log(f"{tag}: J rel err {eJ:.2e} (tol {K7B_J_TOL:g}, or 3x the float32 "
        f"plain version's distance from float64: {pJ:.2e}), X {eX:.2e} and "
        f"U {eU:.2e} of scale (tol {K7B_X_TOL:g}, or 3x the float32 "
        f"plain version's distance from float64: X {pX:.2e}, U "
        f"{pU:.2e})")
    check(eJ < max(K7B_J_TOL, 3 * pJ) and eX < max(K7B_X_TOL, 3 * pX)
          and eU < max(K7B_X_TOL, 3 * pU),
          f"{tag}: disagrees with the plain version")
    ex = K4_EXHAUST
    check(float(ak[ex]) == 0.0 and torch.equal(Xk[ex], X[ex])
          and torch.equal(Uk[ex], U[ex])
          and float(Jk[ex]) == float(J_prev[ex]) and float(rk[ex]) > 10,
          f"{tag}: the exhausted search did not restore its inputs")
    for lane in K4_DIVERGE:
        check(float(ak[lane]) == float(ap[lane]),
              f"{tag} lane {lane}: step differs from the plain version")
    # did the blown-up lanes' first candidates trip the guard? (checked on
    # the quadrotor and the cart-pole, by the plain version; only logged
    # for the others, by K2, which a chain's plain rollout costs seconds)
    first = rollout_closed_loop if name in ("quadrotor", "cartpole") \
        else rollout_closed_loop_cuda
    ok0 = first(model, x0, X, U, st["K"], d, alpha0, st["dt"])[2]
    died = [lane for lane in K4_DIVERGE if not bool(ok0[lane])]
    log(f"{tag} branches: lanes {K4_DIVERGE} took alpha "
        f"{[float(ak[i]) for i in K4_DIVERGE]} (first candidate "
        f"diverged on lanes {died}); lane {ex} ran out: alpha 0, rho "
        f"{float(rk[ex]):g}, drho {float(drk[ex]):g}")
    if name in ("quadrotor", "cartpole"):
        check(len(died) == len(K4_DIVERGE) and all(
            float(ak[i]) > 0 for i in K4_DIVERGE),
            f"{tag}: the diverging lanes did not diverge and recover")
    log_rounds(tag, alpha0, ak, ls_opts[2], fused_forward_cuda)
    if shapes:
        launch_shapes(tag, fused_forward_cuda, args, range(1, 12))

    ms_k = cuda_time_ms(lambda: fused_forward_cuda(*args), reps=10)
    cands = torch.where(
        ak > 0, torch.log2(alpha0 / ak.clamp(min=1e-30)).round() + 1,
        torch.full_like(ak, ls_opts[2] + 1.0))
    per_knot = (mm(m, 1, n) + 2 * (n * n + m * m + m * n)
                + step_ops(name, n, model))
    bound_ms, bound_by = bound(
        float(cands.sum()) * (Nk - 1) * per_knot,
        nbytes(x0, X, U, st["K"], d, dtt, obj.Q, obj.R, obj.H, obj.q,
               obj.r, obj.c, Xk, Uk) + 40 * B)
    log(f"{tag} time per line search ({float(cands.mean()):.2f} "
        f"candidates a problem, {int(cands.max())} at most): kernel "
        f"{ms_k:.4f} ms, plain version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by}")
    kernel_entry(report, name=f"fused_forward_{name}",
                 source="trajopt_tpu_torch/csrc/fused_forward.cu",
                 replaces="trajopt_tpu/ops/pallas_fused.py:509",
                 max_abs_err=float((Xk - Xp)[calm].abs().max()), ms=ms_k,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_k2_full(report, setups, maze):
    """K2's full-state instantiations against ``rollout_closed_loop``: the
    five models on K7a's gains, the slack-augmented quadrotor on K3's."""
    import torch
    from trajopt_tpu_torch.ops.cuda_al_fused import fused_al_backward_cuda

    cases = []
    for name in MODELS:
        st = setups[name]
        x0, d, _, alpha0 = search_inputs(st)
        cases.append((name, st["model"], st["p64"].model,
                      [x0, st["X"], st["U"], st["K"], d,
                       alpha0.contiguous()], st["dt"]))
    prob = maze["prob"]
    K, d, _, _, fail = fused_al_backward_cuda(
        prob.model, maze["canon"], maze["X"], maze["U"], maze["lam"],
        maze["mu"], maze["dt"], prob.obj,
        torch.ones(B, device=maze["X"].device))
    check(not bool(fail.any()), "K2 slack inputs: a backward sweep failed")
    alpha0 = (0.5 ** (6 + torch.arange(B, device=K.device) % 4)).float()
    cases.append(("quadrotor_slack", prob.model, prob.model, [
        maze["X"][:, 0].contiguous(), maze["X"], maze["U"], K, d, alpha0],
        prob.dt))

    for label, model, model64, ins, dt in cases:
        k2_case(report, label, model, model64, ins, dt,
                diverged=label != "quadrotor_slack")


def warm_plain(model, ins, dt):
    """One step of the first problem of ``ins`` = (x0, X, U, K, d, alpha)
    through ``rollout_closed_loop``, before the timed run: the first plain
    call of a model or rule in a process sets ``torch.func`` and the card's
    solver libraries up (seconds), which is not the plain version's time."""
    import torch
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    x0, X, U, K, d, alpha = ins
    if torch.is_tensor(alpha) and alpha.ndim:
        alpha = alpha[:1]
    rollout_closed_loop(model, x0[:1], X[:1, :2], U[:1, :1], K[:1, :1],
                        d[:1, :1], alpha, dt)


def k2_case(report, label, model, model64, ins, dt, diverged=True):
    """K2 on the inputs ``ins`` = (x0, X, U, K, d, alpha) against
    ``rollout_closed_loop``: ok masks equal, X and U within K7B_X_TOL of
    scale or three times the float32 plain version's distance from float64
    (``diverged``: leave lanes K4_DIVERGE out, they follow a blown-up
    step)."""
    import torch
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    Nk, n, m = ins[1].shape[1], model.n, model.m
    tag = f"K2 {label} (n={n}, m={m}, N={Nk})"
    Xk, Uk, okk = rollout_closed_loop_cuda(model, *ins, dt)
    warm_plain(model, ins, dt)
    torch.cuda.synchronize()
    (Xp, Up, okp), plain_ms = timed(
        lambda: rollout_closed_loop(model, *ins, dt))
    check(Xk.shape == ins[1].shape and Uk.shape == ins[2].shape,
          f"{tag}: shapes")
    check(torch.equal(okk, okp), f"{tag}: ok masks differ from the "
          "plain version")
    calm = okk.clone()
    if diverged:
        calm[list(K4_DIVERGE)] = False
    eX = float((Xk - Xp)[calm].abs().max()
               / max(1.0, float(Xp[calm].abs().max())))
    eU = float((Uk - Up)[calm].abs().max()
               / max(1.0, float(Up[calm].abs().max())))
    pX, pU = rollout_eps(model64, ins, dt, Xp, Up, calm)
    log(f"{tag}: ok {int(okk.sum())}/{B} in both, X {eX:.2e} and U "
        f"{eU:.2e} of scale (tol {K7B_X_TOL:g}, or 3x the float32 plain "
        f"version's distance from float64: X {pX:.2e}, U {pU:.2e})")
    check(eX < max(K7B_X_TOL, 3 * pX) and eU < max(K7B_X_TOL, 3 * pU),
          f"{tag}: disagrees with the plain version")
    ms_k = cuda_time_ms(lambda: rollout_closed_loop_cuda(model, *ins, dt),
                        reps=50)
    bound_ms, bound_by = bound(
        B * (Nk - 1) * (mm(m, 1, n) + step_ops(label, n, model)),
        nbytes(*ins) + nbytes(Xk, Uk, okk))
    log(f"{tag} time per rollout: kernel {ms_k:.4f} ms, plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    kernel_entry(report, name=f"rollout_closed_loop_{label}",
                 source="trajopt_tpu_torch/csrc/rollout.cu",
                 replaces="trajopt_tpu/ops/pallas_rollout.py:260",
                 max_abs_err=float((Xk - Xp)[calm].abs().max()), ms=ms_k,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def cartpole_starts(x0, count=POOL):
    """Arm (c)'s pool: seed 0, 0.02 noise on every state entry."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    return (x0[None] + rng.normal(size=(POOL, x0.shape[0])) * 0.02)[:count]


def batched_iterations(res):
    """Inner iterations the whole batch went through: every outer iteration
    lasts as long as its slowest problem's inner solve."""
    return int(res.history["iterations_inner"].amax(0).sum())


def run_arm(report, tag, prob, opts, x0s, ran, warm_opts, U0s=None):
    """One arm of slice 3 (or 6): a warm-up call, then the timed
    ``solve_batch`` (from the control seeds ``U0s``, where given) with the
    launch counts read around it."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch
    from trajopt_tpu_torch.solvers.ilqr import HostSyncs

    solve_batch(prob, warm_opts, x0s, U0s)
    torch.cuda.synchronize()
    syncs = HostSyncs()
    reset_counts()
    t0 = time.perf_counter()
    res = solve_batch(prob, opts, x0s, U0s, syncs=syncs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    record_launches(report, launches, ran=ran)
    count = x0s.shape[0]
    check(res.X.shape == (count, prob.N, prob.n)
          and res.U.shape == (count, prob.N - 1, prob.m), f"{tag}: shapes")
    check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite states")
    its = batched_iterations(res)
    total = sum(launches.values())
    log(f"{tag}: {count} problems in one call in {wall:.3f} s = "
        f"{count / wall:.2f} solves/s | launches {launches} | batched "
        f"iterations {its}, mean iterations a problem "
        f"{res.iterations_total.float().mean().item():.2f}, most "
        f"{int(res.iterations_total.max())}, outer iterations at most "
        f"{int(res.iterations.max())} | kernel launches per iteration "
        f"{total / its:.2f}, host syncs {syncs.count} = "
        f"{syncs.count / its:.2f} per iteration")
    report[tag] = dict(solves_per_s=count / wall, wall_s=wall,
                       launches=launches, batched_iterations=its,
                       host_syncs=syncs.count)
    return res


def phase_slice3(report, refs):
    import torch
    from trajopt_tpu_torch.ops.constraints import empty_constraints
    from trajopt_tpu_torch.problems import zoo
    import trajopt_tpu_torch as tt

    dev = torch.device("cuda", 0)
    f32 = torch.float32

    def warm(**kw):
        return tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
            iterations=2, **kw))

    # --- arms (a) and (b): the unconstrained quadrotor, fused and not
    prob = zoo.quadrotor_line(N=N, dtype=f32, device=dev)
    x0s = torch.as_tensor(pool_starts(prob.x0.cpu()), dtype=f32, device=dev)
    goal = torch.tensor(GOAL, device=dev)
    ref = refs.pop("ref_quadrotor").result()
    shares = {}
    for arm, fused, ran in (
            ("slice 3 (a) quadrotor fused", True,
             ("fused_backward_quadrotor", "fused_forward_quadrotor")),
            ("slice 3 (b) quadrotor phase-split", False,
             ("riccati_sweep_13x4", "rollout_closed_loop_quadrotor"))):
        res = run_arm(report, arm, prob, tt.ALOptions(
            opts_uncon=tt.iLQROptions(fused=fused)), x0s, ran,
            warm(fused=fused))
        perr = (res.X[:, -1, :3] - goal).norm(dim=-1).cpu().numpy()
        shares[arm] = (float(np.mean(perr < 0.5)), float(np.mean(perr < 5e-3)))
        med = float(np.median(perr))
        log(f"{arm}: within 0.5 m {shares[arm][0]:.4f}, within 5 mm "
            f"{shares[arm][1]:.4f}, median final pos err {med:.3e} m (the "
            f"JAX package in float32 on the CPU, first 16: "
            f"{JAX_QUAD_SHARES}; gate: each less {GATE_MARGIN})")
        report[arm].update(share_0p5m=shares[arm][0],
                           share_5mm=shares[arm][1], median_err_m=med)
        for got, bar in zip(shares[arm], JAX_QUAD_SHARES):
            check(got >= bar - GATE_MARGIN, f"{arm}: share {got:.4f} below "
                  f"the JAX package's {bar} less {GATE_MARGIN}")
        log(f"{arm}: problems 0 and 1 in float64 on the CPU by the plain "
            f"versions ({ref['seconds']:.1f} s): final pos err "
            f"{ref['pos_err']} m (card: {perr[:2].tolist()}), iterations "
            f"{ref['iterations']} (card: "
            f"{res.iterations_total[:2].tolist()})")
        check(all(e < 0.5 for e in ref["pos_err"])
              and all(e < 0.5 for e in perr[:2]),
              f"{arm}: the card or the CPU reference misses the goal")
    # The arms must agree on the share within 0.5 m. Their 5 mm shares are
    # printed, not held to each other: in float32 this objective's cost
    # (½xᵀQx + qᵀx + c, Qf = 1000, a goal 60 m away) is known to about
    # ±0.2 only, against 0.0125 at 5 mm, so the convergence tests act on
    # rounding noise, and the two ways of summing the cost stop at different
    # points: ``total_cost`` keeps the small stage costs apart from the
    # large terminal terms and stops early on 0 < dJ < cost_tolerance; K7b,
    # like the TPU kernel, adds the terminal terms into the running sum,
    # comes out in steps of 0.125, and stops on the dJ = 0 counter
    # (tools/slice3_cost_noise.py: 5 mm shares 0.55 and 0.93, and 0.82 with
    # an exact cost).
    a, b = shares.values()
    log(f"slice 3: arms (a) and (b) differ by {abs(a[0] - b[0]):.4f} on the "
        f"share within 0.5 m (bar {GATE_MARGIN}) and by "
        f"{abs(a[1] - b[1]):.4f} on the share within 5 mm (not held: "
        "float32 cost noise, see tools/slice3_cost_noise.py)")
    check(abs(a[0] - b[0]) <= GATE_MARGIN,
          "slice 3: arms (a) and (b) disagree in outcome")

    # --- arm (c): the constrained cartpole on the default options, which
    # now run fused (K3 and K4 only), and beside it with fused_al=False (K5
    # and K2 only, the AL terms as torch ops)
    prob = zoo.cartpole(dtype=f32, device=dev)
    x0s = torch.as_tensor(cartpole_starts(prob.x0.cpu()), dtype=f32,
                          device=dev)
    split = tt.ALOptions(opts_uncon=tt.iLQROptions(fused_al=False))
    ref = refs.pop("ref_cartpole").result()
    c_shares = {}
    for arm, opts, ran, wkw in (
            ("slice 3 (c) cartpole constrained fused", tt.ALOptions(),
             al_kernels("cartpole"), {}),
            ("slice 3 (c) cartpole constrained phase-split", split,
             ("riccati_sweep_4x1", "rollout_closed_loop_cartpole"),
             dict(fused_al=False))):
        res = run_arm(report, arm, prob, opts, x0s, ran, warm(**wkw))
        share = float((res.c_max < 1e-3).float().mean())
        c_shares[arm] = share
        gerr = (res.X[:, -1] - prob.xf).norm(dim=-1).cpu().numpy()
        log(f"{arm}: P = {prob.constraints.P}, c_max < 1e-3 on {share:.4f}, "
            f"median c_max {float(res.c_max.median()):.3e}, median goal "
            f"error {float(np.median(gerr)):.3e} (the JAX package in float32 "
            f"on the CPU, first 16: {JAX_CARTPOLE_SHARE}; gate: less "
            f"{GATE_MARGIN})")
        report[arm].update(share_cmax_1e3=share,
                           median_goal_err=float(np.median(gerr)))
        check(share >= JAX_CARTPOLE_SHARE - GATE_MARGIN,
              f"{arm}: share with c_max < 1e-3 too low")
        log(f"{arm}: problems 0 and 1 in float64 on the CPU by the plain "
            f"versions ({ref['seconds']:.1f} s): c_max {ref['c_max']} (card: "
            f"{res.c_max[:2].tolist()}), goal error {ref['goal_err']} (card: "
            f"{gerr[:2].tolist()}), outer iterations {ref['outer']} (card: "
            f"{res.iterations[:2].tolist()}), inner {ref['iterations']} "
            f"(card: {res.iterations_total[:2].tolist()})")
        check([c < 1e-3 for c in ref["c_max"]]
              == (res.c_max[:2] < 1e-3).tolist(),
              f"{arm}: the card disagrees in outcome with the CPU reference")
    a, b = c_shares.values()
    fused_c, split_c = (report[k] for k in c_shares)
    log(f"slice 3 (c): fused over phase-split "
        f"{fused_c['solves_per_s'] / split_c['solves_per_s']:.2f}x in "
        f"solves/s; the shares with c_max < 1e-3 differ by {abs(a - b):.4f} "
        f"(bar {GATE_MARGIN})")
    check(abs(a - b) <= GATE_MARGIN,
          "slice 3 (c): the fused and the phase-split arm disagree")

    # --- arm (d): the other models, 128 starts each, constrained on the
    # default options (fused: K3 and K4 only) and with fused_al=False (K5
    # and K2 only), held to each other by outcome; and, without the
    # constraints, fused and phase-split
    # (0.02 noise on the starts; none on the parked car's y, whose box
    # y >= -0.001 the nominal start already touches)
    for name, label, shape, noise in (
            ("pendulum", "pendulum", "2x1", 0.02),
            ("doubleintegrator", "doubleintegrator", "2x1", 0.02),
            ("parallel_park", "car", "3x2", (0.02, 0.0, 0.02)),
            ("car_3obs", "car", "3x2", 0.02),
            ("cartpole", "cartpole", "4x1", 0.02)):
        prob = getattr(zoo, name)(dtype=f32, device=dev)
        rng = np.random.default_rng(0)
        x0s = (prob.x0[None] + torch.as_tensor(
            rng.normal(size=(B, prob.n)) * np.asarray(noise), dtype=f32,
            device=dev)).contiguous()
        if name != "cartpole":          # arm (c) drove it
            d_shares = []
            for how, opts, ran, wkw in (
                    ("fused", tt.ALOptions(), al_kernels(label), {}),
                    ("phase-split", split, (f"riccati_sweep_{shape}",
                                            f"rollout_closed_loop_{label}"),
                     dict(fused_al=False))):
                arm = f"slice 3 (d) {name} constrained {how}"
                res = run_arm(report, arm, prob, opts, x0s, ran, warm(**wkw))
                share = float((res.c_max < 1e-3).float().mean())
                d_shares.append(share)
                log(f"{arm}: P = {prob.constraints.P}, c_max < 1e-3 on "
                    f"{share:.4f} (bar {SMALL_SHARE}; the JAX package in "
                    f"float32 on the CPU, first 16: {JAX_SMALL_SHARES[name]}"
                    f"), median c_max {float(res.c_max.median()):.3e}")
                report[arm].update(share_cmax_1e3=share)
                check(share >= SMALL_SHARE,
                      f"{arm}: too few problems solved")
            log(f"slice 3 (d) {name} constrained: the arms' shares differ by "
                f"{abs(d_shares[0] - d_shares[1]):.4f} (bar {GATE_MARGIN})")
            check(abs(d_shares[0] - d_shares[1]) <= GATE_MARGIN,
                  f"slice 3 (d) {name}: the fused and the phase-split arm "
                  "disagree")
        if name == "car_3obs":          # parallel_park drove the bare car
            continue
        free = tt.update_problem(prob, constraints=empty_constraints(
            prob.N, device=dev))
        J = {}
        for fused in (True, False):
            arm = (f"slice 3 (d) {name} unconstrained "
                   + ("fused" if fused else "phase-split"))
            ran = (f"fused_backward_{label}", f"fused_forward_{label}") \
                if fused else (f"riccati_sweep_{shape}",
                               f"rollout_closed_loop_{label}")
            res = run_arm(report, arm, free, tt.ALOptions(
                opts_uncon=tt.iLQROptions(fused=fused)), x0s, ran,
                warm(fused=fused))
            J[fused] = res.J
        rel = ((J[True] - J[False]).abs() / J[False].abs().clamp(min=1e-6))
        log(f"slice 3 (d) {name} unconstrained: final J of the fused and "
            f"the phase-split solves differ by {float(rel.median()):.2e} "
            f"(median) and {float(rel.max()):.2e} (most), relative")
        check(float(rel.median()) < 0.1,
              f"slice 3 (d) {name}: fused and phase-split solves disagree")


    # --- arm (e): the maze with fused_al off, three outer iterations of
    # 128 problems: the constrained phase-split path of the slack-augmented
    # quadrotor, on K5 (13,17) and K2's slack instantiation only
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro

    prob = zoo.quadrotor_maze(dtype=f32, device=dev)
    x0s = torch.as_tensor(maze_starts(prob.x0.cpu(), B), dtype=f32,
                          device=dev)
    opts = tt.ALTROOptions(R_inf=1e-8, opts_al=tt.ALOptions(
        iterations=3, opts_uncon=tt.iLQROptions(iterations=10,
                                                fused_al=False),
        cost_tolerance_intermediate=1e-3, penalty_scaling=25.0))
    reset_counts()
    t0 = time.perf_counter()
    res = solve_batch_queued_altro(prob, opts, x0s, lanes=B, infeasible=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    record_launches(report, launches, ran=(
        "riccati_sweep_13x17", "rollout_closed_loop_quadrotor_slack"))
    check(bool(torch.isfinite(res.X).all()), "arm (e): non-finite states")
    log(f"slice 3 (e) maze phase-split: {B} problems, 3 outer iterations in "
        f"{wall:.3f} s | launches {launches} | mean inner iterations "
        f"{res.iterations_total.float().mean().item():.2f}, median c_max "
        f"{float(res.c_max.median()):.3e} after 3 of 40 outer iterations")


def phase_slice3_profile(report):
    """One round of arm (a) (10 fused iterations) and of arm (b) (6
    phase-split iterations) on the whole 1024-problem pool, from a finite
    state seed (the nominal problem's open-loop rollout), so that the round
    is iterations only: a solve from the NaN seed starts with one open-loop
    rollout in torch ops, about 15,000 small launches."""
    import types

    import torch
    from trajopt_tpu_torch.ops.rollout import rollout
    from trajopt_tpu_torch.parallel.batch import solve_batch
    from trajopt_tpu_torch.problems.zoo import quadrotor_line
    from trajopt_tpu_torch.solvers.ilqr import HostSyncs
    import trajopt_tpu_torch as tt

    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=N, dtype=torch.float32, device=dev)
    prob = tt.update_problem(prob, X=rollout(prob.model, prob.x0, prob.U,
                                             prob.dt_traj()))
    x0s = torch.as_tensor(pool_starts(prob.x0.cpu()), dtype=torch.float32,
                          device=dev)
    for tag, fused, iters, names in (
            ("slice 3 (a) profile", True, 10,
             ("fused_backward_quadrotor", "fused_forward_quadrotor")),
            ("slice 3 (b) profile", False, 6,
             ("riccati_sweep_13x4", "rollout_closed_loop_quadrotor"))):
        opts = tt.ALOptions(opts_uncon=tt.iLQROptions(
            iterations=iters, fused=fused, cost_tolerance=0.0,
            gradient_norm_tolerance=0.0))

        def one_round():
            syncs = HostSyncs()
            solve_batch(prob, opts, x0s, syncs=syncs)
            torch.cuda.synchronize()
            return types.SimpleNamespace(host_syncs=syncs.count)

        profile_round(tag, one_round, iters, names, lanes=POOL)


# ------------------------------------------------------------- slice 4

def escape_options(ctol=1e-8, fused_al=True, outer=30, **kw):
    """The options of the JAX package's flagship ALTRO test
    (tests/test_altro.py:88-94): R_inf = 1e-1, penalties 10 × 50. The pool
    runs at ``ctol`` = 1e-3."""
    import trajopt_tpu_torch as tt

    al = tt.ALOptions(cost_tolerance=1e-6, cost_tolerance_intermediate=1e-2,
                      constraint_tolerance=ctol, penalty_scaling=50.0,
                      penalty_initial=10.0, iterations=outer,
                      opts_uncon=tt.iLQROptions(fused_al=fused_al))
    return tt.ALTROOptions(opts_al=al, R_inf=1e-1, **kw)


def escape_starts(x0, count):
    """The ``car_escape`` pool: seed 0, 0.05 m normal noise on x and y of
    1024 starts; the first ``count`` of them."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    noise = np.concatenate([rng.normal(size=(ESCAPE_POOL, 2)) * 0.05,
                            np.zeros((ESCAPE_POOL, 1))], axis=1)
    return (x0[None] + noise)[:count]


def line_seeded(prob):
    """``prob`` with a straight line from its start to its goal as the
    state seed (the infeasible-start seed of tests/test_altro.py:32)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.utils.interp import interp_rows

    ends = np.stack([prob.x0.cpu().numpy(), prob.xf.cpu().numpy()], axis=1)
    return tt.initial_states(prob, interp_rows(prob.N, prob.tf, ends))


def al_problem(name, slack, dtype):
    """The constrained problem that model ``name`` meets on the main paths:
    ``car_escape``, ``cartpole``, ``pendulum``, ``doubleintegrator``,
    ``quadrotor_maze`` or a URDF rig's ``rig_problem`` with its goal; with
    ``slack`` after the infeasible-start transform
    (R_inf = 1e-1 for the car as ``car_escape`` is solved, 1 for the others,
    from a line seed where the zoo gives none)."""
    import torch
    from trajopt_tpu_torch.problems import zoo
    from trajopt_tpu_torch.solvers.altro import infeasible_problem

    factory = dict(car=zoo.car_escape, cartpole=zoo.cartpole,
                   pendulum=zoo.pendulum,
                   doubleintegrator=zoo.doubleintegrator,
                   quadrotor=zoo.quadrotor_maze).get(
        name, lambda **kw: rig_problem(name, goal=True, **kw))
    prob = factory(dtype=dtype)
    if not slack:
        return prob
    if not bool(torch.isfinite(prob.X).all()):
        prob = line_seeded(prob)
    return infeasible_problem(prob, 1e-1 if name == "car" else 1.0)


def al_setup(name, slack, seed=9, factory=None):
    """Kernel inputs of K3 and K4 for one instantiation at B = 128 and the
    problem's own N (the problem of ``al_problem``, or ``factory(dtype=)``'s
    for model ``name``), made in float64 and handed out in both types: with
    slacks the transform's seeds plus noise (0.05 on the states, 0.02 on the
    controls), without them the open-loop rollouts from starts with 0.02
    noise; duals λ in [0, 0.5] and penalties μ in [0.5, 20] on the valid
    rows."""
    import torch
    from trajopt_tpu_torch.ops.canonical import canonical_stack
    from trajopt_tpu_torch.ops.rollout import rollout

    if factory is None:
        def factory(dtype):
            return al_problem(name, slack, dtype)
    p64, p32 = factory(dtype=torch.float64), factory(dtype=torch.float32)
    dev = p64.device
    n, m, Nk, P = p64.n, p64.m, p64.N, p64.constraints.P
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    U = p64.U[None] + t(rng.normal(size=(B, Nk - 1, m)) * 0.02)
    if slack:
        X = p64.X[None] + t(rng.normal(size=(B, Nk, n)) * 0.05)
    else:
        x0s = p64.x0[None] + t(rng.normal(size=(B, n)) * 0.02)
        if name == "quadrotor":
            U = p64.U.expand(B, -1, -1)     # hover: noise would tumble it
        X = rollout(p64.model, x0s, U, p64.dt_traj())
    mask = p64.constraints.mask
    # (the plain quadrotor: a thousandth of that. A positive dual makes a
    # row active, and 44 active cylinder rows 10 to 60 m away at μ ~ 10 put
    # a stiffness of ~1e6 into lxx that nothing actuates directly without
    # the slacks: the float32 rollouts of those gains are chaotic in the
    # kernel and in the plain version alike)
    scale = 1e-3 if name == "quadrotor" and not slack else 1.0
    lam = t(rng.uniform(0.0, 0.5, size=(B, Nk, P)) * scale) * mask
    mu = t(rng.uniform(0.5, 20.0, size=(B, Nk, P)) * scale) * mask
    data64 = [a.contiguous() for a in (X, U, lam, mu)]
    label = name + ("_slack" if slack else "")
    return dict(
        label=label, name=name, slack=slack, p64=p64, p32=p32, Nk=Nk, rng=rng,
        canon64=canonical_stack(p64.constraints, n, m, dtype=torch.float64),
        canon=canonical_stack(p32.constraints, n, m, dtype=torch.float32),
        data64=data64, data=[a.float().contiguous() for a in data64])


def timed(fn):
    """``fn()`` and its time on the card in ms (one call, synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_al_models(report):
    """K3 and K4 for the instantiations beside the maze's (``AL_CASES``)
    against their plain versions on the card, and with them the slack
    instantiations of K2 and the (n, m + n) shapes of K5 that the
    phase-split path of the same problems runs."""
    for name, slack in AL_CASES:
        al_case(report, al_setup(name, slack))


def al_case(report, st):
    """K3 and K4 of one instantiation (``st`` from ``al_setup`` or
    ``kuka_setup``) against their plain versions on the card, and for the
    slack instantiations (or where ``st["phase_split"]``) K2 on K3's gains
    and K5 on the AL expansion of ``al_cost_fns``. With ``st["entry"]``
    False the checks add no entry to the ``kernels`` line (another stack of
    an instantiation that has one)."""
    import torch
    from trajopt_tpu_torch.ops.canonical import canon_al_cost, pad_terminal
    from trajopt_tpu_torch.ops.cost import Expansion, total_cost
    from trajopt_tpu_torch.ops.cuda_al_fused import (
        fused_al_backward, fused_al_backward_cuda, fused_al_forward,
        fused_al_forward_cuda)
    from trajopt_tpu_torch.ops.cuda_riccati import (
        riccati_sweep_cuda, riccati_sweep_shape)
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.riccati import scan_sweep
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop
    from trajopt_tpu_torch.solvers.al import al_cost_fns
    from trajopt_tpu_torch.solvers.ilqr import reg_noise_scale

    name, slack = st["name"], st["slack"]
    dev = st["p32"].device
    one = torch.ones(B, device=dev)
    label, p32, p64, Nk = st["label"], st["p32"], st["p64"], st["Nk"]
    model, obj, canon, dt = p32.model, p32.obj, st["canon"], p32.dt_traj()
    n, m, P = p32.n, p32.m, canon.P
    mb = m - n if slack else m
    X, U, lam, mu = st["data"]
    tag = f"K3 {label} (n={n}, m={m}, P={P}, N={Nk})"

    def three(lam_, mu_, rho, jac=False):
        """Kernel, float32 plain version (timed), float64 plain."""
        k = fused_al_backward_cuda(model, canon, X, U, lam_, mu_, dt, obj,
                                   rho, return_jacobians=jac)
        p, ms_p = timed(lambda: fused_al_backward(
            model, canon, X, U, lam_, mu_, dt, obj, rho,
            return_jacobians=jac))
        X64, U64 = st["data64"][:2]
        q = fused_al_backward(p64.model, st["canon64"], X64, U64,
                              lam_.double(), mu_.double(), p64.dt_traj(),
                              p64.obj, rho.double())
        return k, p, q, ms_p

    # benign duals, rho = 1, and the in-kernel Jacobians
    k, p, q, plain_ms = three(lam, mu, one, jac=True)
    check(k[0].shape == (B, Nk - 1, m, n) and k[1].shape == (B, Nk - 1, m),
          f"{tag}: output shapes")
    check(not bool(k[4].any()), f"{tag}: a benign problem failed")
    worst = compare_sweeps(f"{tag} rho=1", k[:5], p[:5], q,
                           kd_tol=AL_KD_TOL, dv_tol=AL_DV_TOL,
                           hold_d=st.get("hold_d", True))
    eA = float((k[5] - p[5]).abs().max())
    eB = float((k[6] - p[6]).abs().max())
    jac_tol = JAC_TOL
    if "jac_rtol" in st:
        # the chain's B reaches ~3e2: its entries are held to a share of
        # their scale, or to three times the float32 plain version's own
        # distance from float64 where that is more
        X64, U64 = st["data64"][:2]
        A64, B64 = p64.model.jacobian_traj(X64[:, :-1], U64, p64.dt_traj())
        own = max(float((p[5].double() - A64).abs().max()),
                  float((p[6].double() - B64).abs().max()))
        scale = max(1.0, float(A64.abs().max()), float(B64.abs().max()))
        jac_tol = max(st["jac_rtol"] * scale, 3 * own)
        log(f"{tag} Jacobians: scale {scale:.3e}, the float32 plain version "
            f"{own:.2e} from float64")
    log(f"{tag} Jacobians against jacobian_traj: max|dA| {eA:.2e}, "
        f"max|dB| {eB:.2e} (tol {jac_tol:.2e})")
    check(k[6].shape == (B, Nk - 1, n, m) and eA < jac_tol
          and eB < jac_tol, f"{tag}: Jacobians disagree")
    if label == "car_slack":
        # late-schedule duals (penalties 1e6..1e8, one value a row): at
        # rho = 0 and at the retry's jump; flags counted where rounding
        # may decide them
        row_mu = torch.as_tensor(
            10.0 ** st["rng"].uniform(6, 8, size=P), dtype=torch.float32,
            device=dev)
        mu_late = (row_mu * p32.constraints.mask).expand(
            B, Nk, -1).contiguous()
        jump = reg_noise_scale(mu_late, torch.float32).contiguous()
        for what, rho in (("rho = 0", torch.zeros(B, device=dev)),
                          (f"rho = {float(jump.max()):.3g}", jump)):
            k2, p2, q2, _ = three(lam, mu_late, rho)
            log(f"{tag} late duals, {what}: fail kernel "
                f"{int(k2[4].sum())}, plain f32 {int(p2[4].sum())}, plain "
                f"f64 {int(q2[4].sum())} of {B}")
            worst = max(worst, compare_sweeps(
                f"{tag} late duals, {what}", k2, p2, q2, same_flags=False,
                kd_tol=AL_KD_TOL, dv_tol=AL_DV_TOL))
        # problem 7 made indefinite at knot 40 (negative penalties on
        # its slack rows): it fails alone, gains zero at that stage
        mu_bad = mu.clone()
        r0, r1 = p32.constraints.row_slice("infeasible")
        mu_bad[7, 40, r0:r1] = -1e3
        k2, p2, q2, _ = three(lam, mu_bad, one)
        check(k2[4].nonzero().flatten().tolist() == [7]
              and torch.equal(k2[4], p2[4]), f"{tag}: fail flags of the "
              "indefinite problem")
        check(not bool(k2[0][7, 40].any())
              and not bool(k2[1][7, 40].any()),
              f"{tag}: gains left at the failed stage")
        compare_sweeps(f"{tag} problem 7 indefinite at knot 40", k2, p2,
                       q2, kd_tol=AL_KD_TOL, dv_tol=AL_DV_TOL)
        log(f"{tag}: problem 7 fails alone in kernel and plain version")

    args = (model, canon, X, U, lam, mu, dt, obj, one)
    log_k3_shape(tag)
    if st.get("shapes"):
        launch_shapes(f"K3 {label}", fused_al_backward_cuda, args,
                      (2, 3, 4, 5, 8))
    ms_k = cuda_time_ms(lambda: fused_al_backward_cuda(*args), reps=20)
    # (timed again: the first call of a plain version sets torch.func up)
    _, plain_ms = timed(lambda: fused_al_backward(*args))
    per_knot = ((n + mb) * 3 * step_ops(name, n, model)
                + 2 * (n * n + m * m + 2 * m * n) + 14 * P
                + riccati_flops(n, m))
    bound_ms, bound_by = bound(
        B * (Nk - 1) * per_knot,
        nbytes(X, U, lam, mu, dt, obj.Q, obj.R, obj.H, obj.q, obj.r, one,
               canon.row_i, canon.row_f) + nbytes(k[0], k[1]) + 9 * B)
    log(f"{tag} time per sweep: kernel {ms_k:.4f} ms, plain version "
        f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    if st.get("entry", True):
        kernel_entry(report, name=f"fused_al_backward_{label}",
                     source="trajopt_tpu_torch/csrc/fused_al_backward.cu",
                     replaces="trajopt_tpu/ops/pallas_al_fused.py:564",
                     max_abs_err=worst, ms=ms_k, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by)

    # ---- K4 on K3's gains: lanes K4_DIVERGE follow a blown-up
    # feedforward, lane K4_EXHAUST gets a cost no candidate can beat
    tag = f"K4 {label} (n={n}, m={m}, P={P}, N={Nk})"
    ls_opts = st.get("ls_opts", LS_OPTS)
    K, d, dV1, dV2 = k[0], k[1].clone(), k[2], k[3]
    quad = name == "quadrotor"
    for lane in K4_DIVERGE:
        d[lane] *= 1e6 if quad else 1e5
    x0 = X[:, 0].contiguous()
    J_prev = (total_cost(obj, X, U, dt) + canon_al_cost(
        canon, X, pad_terminal(U), lam, mu)).contiguous()
    J_prev[K4_EXHAUST] = -1e30
    alpha0 = (0.5 ** (6 + torch.arange(B, device=dev) % 4)).float() \
        if quad else one
    args = (model, canon, x0, X, U, K, d, dV1, dV2, J_prev, one, one,
            alpha0, lam, mu, dt, obj, ls_opts)
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args)
    torch.cuda.synchronize()
    (Xp, Up, Jp, rp, drp, ap), plain_ms = timed(
        lambda: fused_al_forward(*args))
    check(Xk.shape == X.shape and Uk.shape == U.shape, f"{tag}: shapes")
    same = ak == ap
    share = float(same.float().mean())
    calm = same.clone()
    calm[list(K4_DIVERGE)] = False
    eJ = float(((Jk - Jp).abs() / Jp.abs().clamp(min=1.0))[calm].max())
    eX = float((Xk - Xp)[calm].abs().max()
               / max(1.0, float(Xp[calm].abs().max())))
    eU = float((Uk - Up)[calm].abs().max()
               / max(1.0, float(Up[calm].abs().max())))
    # stiff gains (|K| ~ 1e2 on the car_escape stack) amplify float32
    # rounding of the state: the floor under any float32 rollout
    rollout64 = []
    pX, pU = rollout_eps(p64.model, (x0, X, U, K, d, ak), p32.dt, Xp, Up,
                         calm & (ak > 0), rollout64)
    # and, where ``st["j_own"]`` (the chains), into the AL cost: J is held
    # within three times the float32 plain version's distance from the
    # float64 rollout's cost at the same steps, too (K7b's rule)
    pJ = 0.0
    live = calm & (ak > 0)
    if st.get("j_own") and bool(live.any()):
        X64r, U64r = rollout64[:2]
        lam64, mu64 = st["data64"][2:]
        J64 = (total_cost(p64.obj, X64r, U64r, p64.dt_traj())
               + canon_al_cost(st["canon64"], X64r, pad_terminal(U64r),
                               lam64, mu64))
        pJ = float(((Jp.double() - J64).abs()
                    / J64.abs().clamp(min=1.0))[live].max())
    log(f"{tag}: alpha equal on {int(same.sum())}/{B} problems (bar "
        f"{K4_ALPHA_SHARE}); on those J rel err {eJ:.2e} (tol "
        f"{K4_J_TOL:g}, or 3x the float32 plain version's distance from "
        f"float64: {pJ:.2e}), X {eX:.2e} and U {eU:.2e} of scale (tol "
        f"{K4_X_TOL:g}, or 3x the float32 plain version's distance from "
        f"float64: X {pX:.2e}, U {pU:.2e}); steps used "
        f"{sorted(set(ak.tolist()))}")
    check(share >= K4_ALPHA_SHARE, f"{tag}: takes other steps than the "
          "plain version")
    check(eJ < max(K4_J_TOL, 3 * pJ) and eX < max(K4_X_TOL, 3 * pX)
          and eU < max(K4_X_TOL, 3 * pU),
          f"{tag}: disagrees with the plain version")
    ex = K4_EXHAUST
    for lane in K4_DIVERGE + (ex,):
        check(float(ak[lane]) == float(ap[lane]),
              f"{tag} lane {lane}: step differs from the plain version")
    check(float(ak[ex]) == 0.0 and torch.equal(Xk[ex], X[ex])
          and torch.equal(Uk[ex], U[ex])
          and float(Jk[ex]) == float(J_prev[ex]) and float(rk[ex]) > 10,
          f"{tag}: the exhausted search did not restore its inputs")
    check(torch.equal(rk[same], rp[same])
          and torch.equal(drk[same], drp[same]),
          f"{tag}: rho or drho differ from the plain version")
    # (the first candidates, for the log: by K2, which a chain's plain
    # rollout costs seconds)
    ok0 = rollout_closed_loop_cuda(model, x0, X, U, K, d, alpha0,
                                   p32.dt)[2]
    died = [lane for lane in K4_DIVERGE if not bool(ok0[lane])]
    log(f"{tag} branches: lanes {K4_DIVERGE} took alpha "
        f"{[float(ak[i]) for i in K4_DIVERGE]} (first candidate "
        f"diverged on lanes {died}); lane {ex} ran out: alpha 0, rho "
        f"{float(rk[ex]):g}")
    log_rounds(tag, alpha0, ak, ls_opts[2])
    if st.get("shapes"):
        launch_shapes(f"K4 {label}", fused_al_forward_cuda, args,
                      range(2, 15))
    ms_k = cuda_time_ms(lambda: fused_al_forward_cuda(*args), reps=10)
    cands = torch.where(
        ak > 0, torch.log2(alpha0 / ak.clamp(min=1e-30)).round() + 1,
        torch.full_like(ak, ls_opts[2] + 1.0))
    per_knot = (mm(m, 1, n) + 2 * (n * n + m * m + m * n) + 10 * P
                + step_ops(name + ("_slack" if slack else ""), n, model))
    bound_ms, bound_by = bound(
        float(cands.sum()) * (Nk - 1) * per_knot,
        nbytes(x0, X, U, K, d, lam, mu, dt, obj.Q, obj.R, obj.H, obj.q,
               obj.r, obj.c, canon.row_i, canon.row_f, Xk, Uk) + 40 * B)
    log(f"{tag} time per line search ({float(cands.mean()):.2f} "
        f"candidates a problem, {int(cands.max())} at most): kernel "
        f"{ms_k:.4f} ms, plain version {plain_ms:.1f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by}")
    if st.get("entry", True):
        kernel_entry(report, name=f"fused_al_forward_{label}",
                     source="trajopt_tpu_torch/csrc/fused_al_forward.cu",
                     replaces="trajopt_tpu/ops/pallas_al_fused.py:828",
                     max_abs_err=float((Xk - Xp)[calm].abs().max()),
                     ms=ms_k, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
    if not (slack or st.get("phase_split")):
        return

    # ---- the same slack problem phase-split: K2's slack instantiation
    # on K3's gains (the quadrotor's: phase 13) ...
    tag = f"K2 {label} (n={n}, m={m}, N={Nk})"
    # (kuka: at the steps K4 accepted; the full step from the held start
    # throws most arms out of bounds)
    ins = [x0, X, U, K, k[1], ak if st.get("phase_split") else one]
    Xk, Uk, okk = rollout_closed_loop_cuda(model, *ins, p32.dt)
    torch.cuda.synchronize()
    (Xp, Up, okp), plain_ms = timed(
        lambda: rollout_closed_loop(model, *ins, p32.dt))
    if st.get("j_own"):
        # the chains (the cartpole rig's stiff gains with slacks): a lane on
        # the edge of the divergence guard is decided by float32 rounding,
        # as K4's steps are; the masks are held to K4's share
        same_ok = float((okk == okp).float().mean())
        log(f"{tag}: ok masks equal on {same_ok:.4f} (bar {K4_ALPHA_SHARE})")
        check(same_ok >= K4_ALPHA_SHARE, f"{tag}: ok masks differ from the "
              "plain version")
        okk = okk & okp
    else:
        check(torch.equal(okk, okp), f"{tag}: ok masks differ from the "
              "plain version")
    check(int(okk.sum()) > B // 2, f"{tag}: too few problems stay finite")
    eX = float((Xk - Xp)[okk].abs().max()
               / max(1.0, float(Xp[okk].abs().max())))
    eU = float((Uk - Up)[okk].abs().max()
               / max(1.0, float(Up[okk].abs().max())))
    pX, pU = rollout_eps(p64.model, ins, p32.dt, Xp, Up, okk)
    log(f"{tag}: ok {int(okk.sum())}/{B} in both, X {eX:.2e} and U "
        f"{eU:.2e} of scale (tol {K7B_X_TOL:g}, or 3x the float32 plain "
        f"version's distance from float64: X {pX:.2e}, U {pU:.2e})")
    check(int(okk.sum()) > B // 2 and eX < max(K7B_X_TOL, 3 * pX)
          and eU < max(K7B_X_TOL, 3 * pU),
          f"{tag}: disagrees with the plain version")
    ms_k = cuda_time_ms(
        lambda: rollout_closed_loop_cuda(model, *ins, p32.dt), reps=50)
    bound_ms, bound_by = bound(
        B * (Nk - 1) * (mm(m, 1, n) + step_ops(label, n, model)),
        nbytes(*ins) + nbytes(Xk, Uk, okk))
    log(f"{tag} time per rollout: kernel {ms_k:.4f} ms, plain version "
        f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms by {bound_by}")
    kernel_entry(report, name=f"rollout_closed_loop_{label}",
                 source="trajopt_tpu_torch/csrc/rollout.cu",
                 replaces="trajopt_tpu/ops/pallas_rollout.py:260",
                 max_abs_err=float((Xk - Xp)[okk].abs().max()), ms=ms_k,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    if st.get("shapes"):
        launch_shapes(f"K2 {label}", rollout_closed_loop_cuda,
                      [model, *ins, p32.dt], range(1, 7))

    # ... and K5's (n, m + n) shape on the AL expansion of al_cost_fns
    if f"riccati_sweep_{n}x{m}" in [e["name"] for e in report["kernels"]] \
            + report.get("checked_elsewhere", []):
        return                   # the pendulum's shape is the same
    tag = f"K5 {label} ({n},{m}), N={Nk}"
    X64, U64, lam64, mu64 = st["data64"]
    A, Bm = p64.model.jacobian_traj(X64[:, :-1], U64, p64.dt_traj())
    e = al_cost_fns(p64.obj, p64.constraints, p64.dt_traj(), lam64,
                    mu64)[1](X64, U64)
    ins = [t.float().contiguous()
           for t in (A, Bm, e.x, e.u, e.xx, e.uu, e.ux)]
    k5 = riccati_sweep_cuda(*ins, one)
    torch.cuda.synchronize()
    exp = Expansion(*ins[2:])
    p5, plain_ms = timed(lambda: scan_sweep(ins[0], ins[1], exp, one))
    q5 = scan_sweep(A, Bm, e, one.double())
    worst = compare_sweeps(f"{tag} rho=1", k5, p5, q5)
    ms_k = cuda_time_ms(lambda: riccati_sweep_cuda(*ins, one), reps=10)
    bound_ms, bound_by = bound(
        B * (Nk - 1) * riccati_flops(n, m),
        nbytes(*ins, one) + nbytes(k5[0], k5[1]) + 9 * B)
    log(f"{tag}: kernel {ms_k:.4f} ms per sweep, plain version "
        f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms by {bound_by}; "
        + ring_shape_text(riccati_sweep_shape(n, m, B)))
    main = dict(batch=B, main_batch=B, ms_main_batch=ms_k,
                bound_ms_main_batch=bound_ms)
    if label == "kuka":
        # the kuka pool's phase-split arm sweeps KUKA_POOL_RUN problems
        few = [t[:KUKA_POOL_RUN].contiguous() for t in (*ins, one)]
        ms_few = cuda_time_ms(lambda: riccati_sweep_cuda(*few), reps=10)
        frac = KUKA_POOL_RUN / B
        log(f"{tag} at B={KUKA_POOL_RUN}: kernel {ms_few:.4f} ms per sweep, "
            f"bound {frac * bound_ms:.5f} ms; " + ring_shape_text(
                riccati_sweep_shape(n, m, KUKA_POOL_RUN)))
        main.update(main_batch=KUKA_POOL_RUN, ms_main_batch=ms_few,
                    bound_ms_main_batch=frac * bound_ms)
    if st.get("shapes"):
        launch_shapes(f"{tag} rho=1", riccati_sweep_cuda, [*ins, one],
                      range(8), shape_of=lambda c: ring_shape_text(
                          riccati_sweep_shape(n, m, c)))
    kernel_entry(report, name=f"riccati_sweep_{n}x{m}",
                 source="trajopt_tpu_torch/csrc/riccati_sweep.cu",
                 replaces="trajopt_tpu/ops/pallas_riccati.py:278",
                 max_abs_err=worst, ms=ms_k, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, **main)


def al_kernels(*labels):
    """The K3 and K4 entries of the instantiations ``labels``."""
    return tuple(f"fused_al_{w}_{label}" for label in labels
                 for w in ("backward", "forward"))


def run_counted(report, tag, fn, ran):
    """``fn()`` with the launch counts read around it, timed to the
    device's end; the counts must be those of ``ran`` and go into the
    kernels' entries."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"{tag}: {wall:.3f} s, launches {launches}")
    record_launches(report, launches, ran=ran)
    return out, wall, launches


def phase_escape(report, refs):
    """Path 1: ``altro_solve(car_escape())`` on the card in float32, with the
    projected-Newton polish, with the float64 polish of the float32 AL
    result, and with the feasible re-solve in place of the polish."""
    import torch
    from trajopt_tpu_torch.problems.zoo import car_escape
    from trajopt_tpu_torch.solvers.ilqr import HostSyncs
    from trajopt_tpu_torch.solvers.projected_newton import (
        _dynamics_defects, pn_solve_batch)
    import trajopt_tpu_torch as tt

    prob = car_escape(dtype=torch.float32)          # on the card by default
    p64 = car_escape(dtype=torch.float64)
    projection = ("riccati_sweep_3x2", "rollout_closed_loop_car")

    def outcome(p, X, U):
        cs = p.constraints
        return (float(cs.max_violation(cs.evaluate(X, U))),
                float((X[-1] - p.xf).norm()),
                float(_dynamics_defects(p, p.x0, X, U).abs().max()))

    tt.altro_solve(prob, escape_options(outer=1, resolve_feasible_problem=True))
    pn_kw = dict(resolve_feasible_problem=False, projected_newton=True,
                 projected_newton_tolerance=1e-3)
    # (i) the flagship call, everything in float32
    tag = "slice 4 altro_solve car_escape + PN, float32"
    r32, wall, _ = run_counted(
        report, tag, lambda: tt.altro_solve(prob, escape_options(**pn_kw)),
        al_kernels("car_slack") + projection)
    check(r32.X.shape == (prob.N, 3) and r32.U.shape == (prob.N - 1, 2)
          and bool(torch.isfinite(r32.X).all()), f"{tag}: output")
    c32, g32, d32 = outcome(prob, r32.X, r32.U)
    log(f"{tag}: c_max {c32:.3e}, goal error {g32:.3e}, dynamics defect "
        f"{d32:.3e}, outer {int(r32.iterations)}, inner "
        f"{int(r32.iterations_total)} (the JAX package in float32 on the "
        f"CPU: c_max {JAX_ESCAPE_F32[0]:.1e}, outer 8, inner 84; bar: the "
        f"hand-off tolerance {ESCAPE_F32_BAR:g})")
    check(c32 < ESCAPE_F32_BAR and g32 < ESCAPE_F32_BAR,
          f"{tag}: above the hand-off tolerance")
    report[tag] = dict(wall_s=wall, c_max=c32, goal_err=g32)

    # (ii) the float32 AL stage, then the polish in float64 on the card
    tag = "slice 4 altro_solve car_escape (AL, float32) + pn_solve float64"
    ral, wall_al, _ = run_counted(
        report, tag, lambda: tt.altro_solve(prob, escape_options(
            ctol=1e-3, resolve_feasible_problem=False)),
        al_kernels("car_slack") + projection)
    c_al, g_al, d_al = outcome(prob, ral.X, ral.U)
    syncs = HostSyncs()
    seed = tt.update_problem(p64, X=ral.X.double(), U=ral.U.double())
    (pol, wall_pn, _) = run_counted(
        report, tag + ": the polish",
        lambda: pn_solve_batch(seed, seed.x0[None], seed.X[None],
                               seed.U[None], tt.PNOptions(), syncs=syncs), ())
    c64, g64, d64 = outcome(p64, pol.X[0], pol.U[0])
    log(f"{tag}: AL stage {wall_al:.3f} s (c_max {c_al:.3e}, goal error "
        f"{g_al:.3e}, defect {d_al:.3e}, inner "
        f"{int(ral.iterations_total)}); polish {wall_pn:.3f} s, "
        f"{int(pol.iterations[0])} projection iterations, {syncs.count} host "
        f"syncs: c_max {c64:.3e}, goal error {g64:.3e}, defect {d64:.3e} "
        f"(bars of tests/test_altro.py: c_max < {ESCAPE_BARS[0]:g}, goal "
        f"within {ESCAPE_BARS[1]:g})")
    check(c64 < ESCAPE_BARS[0] and g64 < ESCAPE_BARS[1]
          and d64 < ESCAPE_BARS[0], f"{tag}: the float64 polish misses the "
          "JAX test's bars")
    report[tag] = dict(wall_al_s=wall_al, wall_pn_s=wall_pn, c_max=c64,
                       goal_err=g64, defect=d64)

    # (iii) the re-solve of the feasible problem in place of the polish
    tag = "slice 4 altro_solve car_escape + re-solve, float32"
    rr, wall, launches = run_counted(
        report, tag, lambda: tt.altro_solve(prob, escape_options(
            resolve_feasible_problem=True)),
        al_kernels("car_slack", "car") + projection)
    check(launches.get("riccati_sweep_3x2", 0) <= 60
          and launches.get("rollout_closed_loop_car", 0) <= 1,
          f"{tag}: K5 or K2 ran outside the projection")
    cr, gr, dr = outcome(prob, rr.X, rr.U)
    log(f"{tag}: c_max {cr:.3e}, goal error {gr:.3e}, defect {dr:.3e}, "
        f"inner {int(rr.iterations_total)} (the JAX package in float32 on "
        f"the CPU: c_max {JAX_ESCAPE_F32[1]:.1e}, inner 139; in float64 "
        f"5.8e-6, inner 225; bar {ESCAPE_F32_BAR:g})")
    check(cr < ESCAPE_F32_BAR and gr < ESCAPE_F32_BAR,
          f"{tag}: above the bar")
    report[tag] = dict(wall_s=wall, c_max=cr, goal_err=gr)

    ref = refs.pop("ref_escape").result()
    dX = float((pol.X[0].cpu() - torch.as_tensor(ref["X"])).abs().max())
    log(f"reference: altro_solve(car_escape()) with the polish in float64 on "
        f"the CPU by the plain versions ({ref['seconds']:.1f} s): c_max "
        f"{ref['c_max']:.3e}, goal error {ref['goal_err']:.3e}, outer "
        f"{ref['outer']}, inner {ref['inner']}; max|X_card - X_cpu| "
        f"{dX:.3e} (printed, both are local solutions)")
    check(ref["c_max"] < ESCAPE_BARS[0] and ref["goal_err"] < ESCAPE_BARS[1],
          "the CPU reference misses the JAX test's bars")


def escape_pool_job(report):
    """Path 2, in a worker process on the card: ``solve_batch_queued_altro_retry``
    on 512 ``car_escape`` starts over 128 lanes in float32, then
    ``pn_polish_batch`` on the result: the first ``POLISH_F64`` problems
    cast up to float64, ``POLISH_CHUNK`` at a time (the Schur blocks of one
    problem are 2 × 101 × 180² values), and the first ``POLISH_CHUNK`` in
    float32. Returns the first two problems' starts, c_max and inner
    iterations, for ``phase_escape_pool`` to hold to the CPU reference."""
    import torch
    from trajopt_tpu_torch.parallel.batch import (
        pn_polish_batch, solve_batch_queued_altro,
        solve_batch_queued_altro_retry)
    from trajopt_tpu_torch.problems.zoo import car_escape
    from trajopt_tpu_torch.solvers.ilqr import HostSyncs
    import trajopt_tpu_torch as tt

    prob = car_escape(dtype=torch.float32)
    dev = prob.device
    x0s_np = escape_starts(prob.x0.cpu(), ESCAPE_POOL_RUN)
    x0s = torch.as_tensor(x0s_np, dtype=torch.float32, device=dev)
    opts = escape_options(ctol=1e-3)
    solve_batch_queued_altro(prob, escape_options(ctol=1e-3, outer=1),
                             x0s[:B], lanes=B)
    tag = "slice 4 pool car_escape"
    (res, n_retried), wall, launches = run_counted(
        report, tag, lambda: solve_batch_queued_altro_retry(
            prob, opts, x0s, lanes=B, tol=1e-3), al_kernels("car_slack"))
    check(res.X.shape == (ESCAPE_POOL_RUN, prob.N, 3)
          and res.U.shape == (ESCAPE_POOL_RUN, prob.N - 1, 2)
          and bool(torch.isfinite(res.X).all()), f"{tag}: output")
    share = float((res.c_max < 1e-3).float().mean())
    k3, k4 = (launches[k] for k in al_kernels("car_slack"))
    log(f"{tag}: {ESCAPE_POOL_RUN} problems over {B} lanes in {wall:.3f} s "
        f"= {ESCAPE_POOL_RUN / wall:.2f} solves/s with the retry | rounds "
        f"{res.rounds}, host syncs {res.host_syncs} "
        f"({res.host_syncs / k4:.2f} per batched iteration), n_retried "
        f"{n_retried} | c_max < 1e-3 on {share:.4f}, median c_max "
        f"{float(res.c_max.median()):.3e} (the JAX package in float32 on the "
        f"CPU, first 16: {JAX_ESCAPE_POOL_SHARE}; gate: less {GATE_MARGIN}) "
        f"| mean inner iterations "
        f"{res.iterations_total.float().mean().item():.2f}, {k4} batched "
        f"iterations, K3 sweeps per K4 line search {k3 / k4:.3f}")
    report[tag] = dict(solves_per_s=ESCAPE_POOL_RUN / wall, wall_s=wall,
                       rounds=res.rounds, host_syncs=res.host_syncs,
                       n_retried=n_retried, share_cmax_1e3=share)
    check(share >= JAX_ESCAPE_POOL_SHARE - GATE_MARGIN,
          f"{tag}: share with c_max < 1e-3 too low")

    def polish(dtype, count):
        p = car_escape(dtype=dtype)
        syncs = HostSyncs()
        outs = [pn_polish_batch(p, res.X[i:min(i + POLISH_CHUNK, count)].to(
            dtype), res.U[i:min(i + POLISH_CHUNK, count)].to(dtype),
            syncs=syncs) for i in range(0, count, POLISH_CHUNK)]
        return tt.PNResult(*(torch.cat(f) for f in zip(*outs))), syncs

    for dtype, count, name in ((torch.float64, POLISH_F64, "float64"),
                               (torch.float32, POLISH_CHUNK, "float32")):
        tag = f"slice 4 pool polish {name}"
        torch.cuda.reset_peak_memory_stats()
        (pol, syncs), wall, _ = run_counted(
            report, tag, lambda: polish(dtype, count), ())
        c = pol.c_max.double()
        gerr = (pol.X[:, -1] - prob.xf.to(dtype)).norm(dim=-1)
        share6 = float((c < 1e-6).double().mean())
        moved = float((pol.X.double() - res.X[:count].double()).abs().max())
        log(f"{tag}: {count} problems, {POLISH_CHUNK} at a time, in "
            f"{wall:.3f} s = {count / wall:.2f} polishes/s, {syncs.count} host "
            f"syncs, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | c_max < "
            f"1e-6 on {share6:.4f}, viol < 1e-6 on "
            f"{float((pol.viol < 1e-6).double().mean()):.4f}, median c_max "
            f"{float(c.median()):.3e}, worst {float(c.max()):.3e}, goal "
            f"within 1e-4 on {float((gerr < 1e-4).double().mean()):.4f}, "
            f"projection iterations mean "
            f"{pol.iterations.double().mean().item():.2f}, most "
            f"{int(pol.iterations.max())}; moved X by at most {moved:.2e} "
            f"(the JAX package on the CPU, first 16: c_max < 1e-6 on "
            f"{JAX_ESCAPE_POLISH[name]})")
        report[tag] = dict(polishes_per_s=count / wall, wall_s=wall,
                           share_cmax_1e6=share6)
        check(bool(torch.isfinite(pol.X).all()), f"{tag}: non-finite states")
        check(share6 >= JAX_ESCAPE_POLISH[name] - POLISH_MARGIN,
              f"{tag}: share with c_max < 1e-6 too low")

    return dict(x0s=x0s_np[:2].tolist(), c_max=res.c_max[:2].tolist(),
                iterations=res.iterations_total[:2].tolist())


def phase_escape_pool(report, refs, job):
    """Path 2 (``escape_pool_job``), collected from its worker, its first
    two problems held to the float64 reference on the CPU."""
    card = collect_worker(report, job, "slice 4 pool")
    ref = refs.pop("ref_escape_pool").result()
    ok_ref = [c < 1e-3 for c in ref["c_max"]]
    log(f"reference: pool problems 0 and 1 in float64 on the CPU by the "
        f"plain versions ({ref['seconds']:.1f} s): c_max {ref['c_max']} "
        f"(card: {card['c_max']}), inner iterations {ref['iterations']} "
        f"(card: {card['iterations']})")
    check(ok_ref == [c < 1e-3 for c in card["c_max"]],
          "the card disagrees in outcome with the CPU plain versions")
    check(np.array_equal(np.array(card["x0s"]), escape_starts(
        np.array([2.5, 2.5, 0.0]), 2)), "the reference starts elsewhere")


def phase_escape_profile(report):
    """One ``car_escape`` AL round of 10 fused iterations on 128 lanes."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    from trajopt_tpu_torch.problems.zoo import car_escape
    import trajopt_tpu_torch as tt

    prob = car_escape(dtype=torch.float32)
    x0s = torch.as_tensor(escape_starts(prob.x0.cpu(), B),
                          dtype=torch.float32, device=prob.device)
    iters = 10
    opts = tt.ALTROOptions(R_inf=1e-1, opts_al=tt.ALOptions(
        iterations=1, opts_uncon=tt.iLQROptions(iterations=iters),
        cost_tolerance_intermediate=0.0, penalty_initial=10.0,
        penalty_scaling=50.0))

    def one_round():
        res = solve_batch_queued_altro(prob, opts, x0s, lanes=B)
        torch.cuda.synchronize()
        return res

    profile_round("slice 4 profile", one_round, iters,
                  al_kernels("car_slack"))


def phase_slice4_models(report):
    """The instantiations no other path reaches, through
    ``solve_batch_queued_altro`` on 128 starts each: the line-seeded
    cartpole, pendulum and double integrator with their slacks, fused (K3/K4
    ``*_slack``, five outer iterations: the cartpole's full solve from a
    line seed takes ~1800 inner iterations a problem) and with
    ``fused_al=False`` (K5 (n, m + n) and K2 ``*_slack``, one outer
    iteration of at most SLICE4_SPLIT_INNER inner ones, as slices 5 and 6
    drive theirs); ``car_escape`` with ``fused_al=False`` (the same depth);
    and the maze without the transform (K3/K4 of the plain quadrotor, three
    outer iterations)."""
    import dataclasses

    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    from trajopt_tpu_torch.problems import zoo
    import trajopt_tpu_torch as tt

    f32 = torch.float32
    dev = zoo.pendulum(dtype=f32).device

    def starts(prob, noise=0.02):
        rng = np.random.default_rng(0)
        return (prob.x0[None] + torch.as_tensor(
            rng.normal(size=(B, prob.n)) * noise, dtype=f32,
            device=dev)).contiguous()

    def drive(tag, prob, opts, x0s, ran, infeasible):
        res, wall, _ = run_counted(
            report, tag, lambda: solve_batch_queued_altro(
                prob, opts, x0s, lanes=B, infeasible=infeasible), ran)
        check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite states")
        log(f"{tag}: {B} problems in {wall:.3f} s | c_max < 1e-3 on "
            f"{float((res.c_max < 1e-3).float().mean()):.4f}, median c_max "
            f"{float(res.c_max.median()):.3e}, mean inner iterations "
            f"{res.iterations_total.float().mean().item():.2f} (printed, "
            "not held)")

    def altro(outer, fused_al, inner=300):
        return tt.ALTROOptions(R_inf=1.0, opts_al=tt.ALOptions(
            iterations=outer, opts_uncon=tt.iLQROptions(
                iterations=inner, fused_al=fused_al)))

    split = f"1 outer iteration of {SLICE4_SPLIT_INNER}"

    for name, shape in (("cartpole", "4x5"), ("pendulum", "2x3"),
                        ("doubleintegrator", "2x3")):
        prob = line_seeded(getattr(zoo, name)(dtype=f32, device=dev))
        x0s = starts(prob)
        drive(f"slice 4 {name} infeasible start, fused, 5 outer iterations",
              prob, altro(5, True), x0s, al_kernels(f"{name}_slack"), True)
        drive(f"slice 4 {name} infeasible start, phase-split, {split}",
              prob, altro(1, False, SLICE4_SPLIT_INNER), x0s,
              (f"riccati_sweep_{shape}", f"rollout_closed_loop_{name}_slack"),
              True)
    prob = zoo.car_escape(dtype=f32, device=dev)
    x0s = torch.as_tensor(escape_starts(prob.x0.cpu(), B), dtype=f32,
                          device=dev)
    opts = escape_options(ctol=1e-3, fused_al=False, outer=1)
    opts = dataclasses.replace(opts, opts_al=dataclasses.replace(
        opts.opts_al, opts_uncon=dataclasses.replace(
            opts.opts_al.opts_uncon, iterations=SLICE4_SPLIT_INNER)))
    drive(f"slice 4 car_escape phase-split, {split}", prob, opts, x0s,
          ("riccati_sweep_3x5", "rollout_closed_loop_car_slack"), True)
    prob = zoo.quadrotor_maze(dtype=f32, device=dev)
    x0s = torch.as_tensor(maze_starts(prob.x0.cpu(), B), dtype=f32,
                          device=dev)
    opts = tt.ALTROOptions(opts_al=tt.ALOptions(
        iterations=3, opts_uncon=tt.iLQROptions(iterations=10),
        cost_tolerance_intermediate=1e-3, penalty_scaling=25.0))
    drive("slice 4 maze without the transform, 3 outer iterations", prob,
          opts, x0s, al_kernels("quadrotor"), False)


# ------------------------------------------------------------- slice 5

def kuka_setup(slack, seed=5):
    """Kernel inputs of K3 and K4 on the kuka stack at B = 128, N = 41, made
    in float64 and handed out in both types: starts around the hold pose
    (q noise 0.05, as the pool's), each problem's own hold torques plus 0.05
    noise, λ ~ U(0, 0.5) and μ ~ U(0.5, 20) on the valid rows
    (tests/test_fused_al.py:179-207). The states hold the start on every
    knot, as a solve's first iteration sees them once the initial-rollout
    guard has held x0: an open-loop rollout of the undamped arm at
    dt = 0.125 blows up. With ``slack``, after the infeasible-start
    transform with R_inf = 1e-8: the states 0.1 off the start on every
    knot (as in that test) and the slack controls the defects that this
    leaves, plus 0.02 noise."""
    import torch
    from trajopt_tpu_torch.ops.canonical import canonical_stack
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles
    from trajopt_tpu_torch.solvers.altro import infeasible_problem

    base = kuka_obstacles(dtype=torch.float64)
    p64, p32 = base, kuka_obstacles(dtype=torch.float32)
    if slack:
        p64, p32 = (infeasible_problem(p, 1e-8) for p in (p64, p32))
    dev = p64.device
    n, m, Nk, P = p64.n, p64.m, p64.N, p64.constraints.P
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    x0s = base.x0[None] + t(np.concatenate(
        [rng.normal(size=(B, 7)) * 0.05, np.zeros((B, 7))], axis=1))
    hold = base.model.model.chain.bias_forces(x0s[:, :7],
                                              torch.zeros_like(x0s[:, :7]))
    U = hold[:, None] + t(rng.normal(size=(B, Nk - 1, 7)) * 0.05)
    X = x0s[:, None].expand(B, Nk, n)
    if slack:
        X = torch.cat([X[:, :1], X[:, 1:] + t(rng.normal(
            size=(B, Nk - 1, n)) * 0.1)], dim=1)
        defect = X[:, 1:] - base.model.step(X[:, :-1], U,
                                            base.dt_traj()[:, None])
        U = torch.cat([U, defect + t(rng.normal(size=(B, Nk - 1, n)) * 0.02)],
                      -1)
    mask = p64.constraints.mask
    lam = t(rng.uniform(0.0, 0.5, size=(B, Nk, P))) * mask
    mu = t(rng.uniform(0.5, 20.0, size=(B, Nk, P))) * mask
    data64 = [a.contiguous() for a in (X, U, lam, mu)]
    return dict(
        label="kuka" + ("_slack" if slack else ""), name="kuka", slack=slack,
        p64=p64, p32=p32, Nk=Nk, rng=rng,
        canon64=canonical_stack(p64.constraints, n, m, dtype=torch.float64),
        canon=canonical_stack(p32.constraints, n, m, dtype=torch.float32),
        data64=data64, data=[a.float().contiguous() for a in data64],
        phase_split=True, jac_rtol=KUKA_JAC_RTOL)


def phase_kuka_kernels(report):
    """Every kuka instantiation against its plain version on the card: K3,
    K4, K2 and K5 for ``kuka`` and ``kuka_slack`` through ``al_case`` (K3's
    Jacobians, K4 with diverging lanes and a search that runs out); then K3
    fed the same stack without its fk rows, K2 with two problems forced to
    diverge, and K2 on stiff gains against the float64 plain version."""
    import torch
    from trajopt_tpu_torch.ops.canonical import canonical_stack
    from trajopt_tpu_torch.ops.constraints import ConstraintSet
    from trajopt_tpu_torch.ops.cuda_al_fused import (
        fused_al_backward, fused_al_backward_cuda)
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    for slack in (False, True):
        st = kuka_setup(slack)
        # the launch shapes of K3, K4 and K2 on a chain: the arm's
        al_case(report, dict(st, shapes=not slack))
        label, p32, p64, Nk = st["label"], st["p32"], st["p64"], st["Nk"]
        n, m = p32.n, p32.m
        dev = p32.device
        one = torch.ones(B, device=dev)
        X, U, lam, mu = st["data"]
        X64, U64, lam64, mu64 = st["data64"]

        # K3 on the stack without its fk rows (bounds, goal, slack rows)
        tag = f"K3 {label} without the fk rows"
        stacks, cols = [], []
        for p in (p32, p64):
            cs = p.constraints
            mask = cs.mask.cpu().numpy()
            entries = [(c, mask[:, r0:r1].any(axis=1))
                       for c, (r0, r1) in zip(cs.cons, cs.slices)
                       if c.label != "obs"]
            stacks.append(canonical_stack(
                ConstraintSet.build(entries, Nk, device=dev), n, m,
                dtype=p.U.dtype))
        for c, (r0, r1) in zip(p32.constraints.cons, p32.constraints.slices):
            if c.label != "obs":
                cols += list(range(r0, r1))
        cols = torch.as_tensor(cols, device=dev)
        check(stacks[0].fk_joint.shape[0] == 0, f"{tag}: fk rows left")
        k = fused_al_backward_cuda(
            p32.model, stacks[0], X, U, lam[..., cols].contiguous(),
            mu[..., cols].contiguous(), p32.dt_traj(), p32.obj, one)
        pl = fused_al_backward(p32.model, stacks[0], X, U, lam[..., cols],
                               mu[..., cols], p32.dt_traj(), p32.obj, one)
        q = fused_al_backward(p64.model, stacks[1], X64, U64,
                              lam64[..., cols], mu64[..., cols],
                              p64.dt_traj(), p64.obj, one.double())
        check(not bool(k[4].any()), f"{tag}: a benign problem failed")
        compare_sweeps(tag, k, pl, q, kd_tol=AL_KD_TOL, dv_tol=AL_DV_TOL)

        # K2 with lanes 3 and 77 forced to diverge, on K3's gains
        tag = f"K2 {label}, two problems forced to diverge"
        k = fused_al_backward_cuda(p32.model, st["canon"], X, U, lam, mu,
                                   p32.dt_traj(), p32.obj, one)
        d = k[1].clone()
        d[3] *= 1e9
        d[77] *= 1e9
        # steps of 2^-6 .. 2^-8: from the held start the arm leaves its
        # bounds at 2^-4 on most problems, kernel and plain version alike
        alpha = (0.5 ** (6 + torch.arange(B, device=dev) % 3)).float()
        ins = [X[:, 0].contiguous(), X, U, k[0], d, alpha]
        Xk, Uk, okk = rollout_closed_loop_cuda(p32.model, *ins, p32.dt)
        Xp, Up, okp = rollout_closed_loop(p32.model, *ins, p32.dt)
        pX, pU = rollout_eps(p64.model, ins, p32.dt, Xp, Up, okp)
        eX = float((Xk - Xp)[okk].abs().max()
                   / max(1.0, float(Xp[okk].abs().max())))
        log(f"{tag}: ok {int(okk.sum())}/{B} (plain {int(okp.sum())}), X "
            f"{eX:.2e} of scale (tol {max(K7B_X_TOL, 3 * pX):.2e})")
        check(torch.equal(okk, okp) and not bool(okk[3])
              and not bool(okk[77]), f"{tag}: ok masks")
        check(eX < max(K7B_X_TOL, 3 * pX), f"{tag}: disagrees")

        # K2 on the stiff gains of K3 at rho = 0, against the float64 plain
        # version: the kernel within KUKA_STIFF_RATIO of the float32 plain
        # version's distance from it (or within K7B_X_TOL of scale)
        tag = f"K2 {label}, stiff gains"
        k = fused_al_backward_cuda(p32.model, st["canon"], X, U, lam, mu,
                                   p32.dt_traj(), p32.obj,
                                   torch.zeros(B, device=dev))
        ins = [X[:, 0].contiguous(), X, U, k[0], k[1], alpha]
        Xk, Uk, okk = rollout_closed_loop_cuda(p32.model, *ins, p32.dt)
        Xp, Up, okp = rollout_closed_loop(p32.model, *ins, p32.dt)
        X6, U6, ok6 = rollout_closed_loop(
            p64.model, *(a.double() for a in ins), p32.dt)
        both = okk & okp & ok6
        scale = max(1.0, float(X6[both].abs().max()))
        errs = [float((a[both].double() - X6[both]).abs().max()) / scale
                for a in (Xk, Xp)]
        log(f"{tag}: |K| up to {float(k[0].abs().max()):.3e}; ok kernel "
            f"{int(okk.sum())}, plain f32 {int(okp.sum())}, plain f64 "
            f"{int(ok6.sum())}; X from float64: kernel {errs[0]:.2e}, plain "
            f"f32 {errs[1]:.2e} of scale (bar "
            f"{max(KUKA_STIFF_RATIO * errs[1], K7B_X_TOL):.2e})")
        check(torch.equal(okk, okp), f"{tag}: ok masks differ")
        check(int(both.sum()) >= B // 2, f"{tag}: too few problems ok")
        check(errs[0] <= max(KUKA_STIFF_RATIO * errs[1], K7B_X_TOL),
              f"{tag}: further from float64 than the float32 plain version")


def kuka_options(fused_al_fk=False):
    """Path 1's options, tests/test_altro.py:101-111: 20 outer iterations,
    penalties 0.01 x 50, constraint tolerance 1e-3 (a feasible start, no
    polish)."""
    import trajopt_tpu_torch as tt

    al = tt.ALOptions(iterations=20, cost_tolerance=1e-6,
                      cost_tolerance_intermediate=1e-5,
                      constraint_tolerance=1e-3, penalty_scaling=50.0,
                      penalty_initial=0.01,
                      opts_uncon=tt.iLQROptions(fused_al_fk=fused_al_fk))
    return tt.ALTROOptions(opts_al=al)


def kuka_starts(x0, count):
    """The kuka pool: seed 0, q perturbed by N(0, 0.05²) rad, q̇ = 0; the
    first ``count`` of KUKA_POOL."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, dtype=np.float64)
    noise = np.concatenate([rng.normal(size=(KUKA_POOL, 7)) * 0.05,
                            np.zeros((KUKA_POOL, 7))], axis=1)
    return (x0[None] + noise)[:count]


def kuka_tuned(fused_al_fk=False):
    """``tuned_altro_options("kuka_obstacles")`` cut to KUKA_POOL_DEPTH,
    with ``fused_al_fk`` for the hybrid arm."""
    import dataclasses

    from trajopt_tpu_torch.problems.tuned import tuned_altro_options

    o = tuned_altro_options("kuka_obstacles")
    outer, inner = KUKA_POOL_DEPTH
    return dataclasses.replace(o, opts_al=dataclasses.replace(
        o.opts_al, iterations=outer, opts_uncon=dataclasses.replace(
            o.opts_al.opts_uncon, iterations=inner,
            fused_al_fk=fused_al_fk)))


def phase_kuka(report, refs):
    """Path 1: ``altro_solve(kuka_obstacles())`` in float32 on the card with
    path 1's options; K5 (14, 7) and K2 ``kuka`` must launch, K3 and K4 not.
    The float64 CPU reference by the plain versions ran beside."""
    import torch
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles
    import trajopt_tpu_torch as tt

    prob = kuka_obstacles(dtype=torch.float32)
    tt.altro_solve(prob, _kuka_warm())
    tag = "slice 5 altro_solve kuka_obstacles, float32"
    r, wall, launches = run_counted(
        report, tag, lambda: tt.altro_solve(prob, kuka_options()),
        ("riccati_sweep_14x7", "rollout_closed_loop_kuka"))
    check(r.X.shape == (prob.N, 14) and r.U.shape == (prob.N - 1, 7)
          and bool(torch.isfinite(r.X).all()), f"{tag}: output")
    c = float(r.c_max)
    g = float((r.X[-1] - prob.xf).norm())
    inner = int(r.iterations_total)
    k5 = launches["riccati_sweep_14x7"]
    log(f"{tag}: {wall:.3f} s, c_max {c:.3e}, goal error {g:.3e}, outer "
        f"{int(r.iterations)}, inner {inner}; per inner iteration "
        f"{wall / inner * 1e3:.2f} ms, K5 {k5 / inner:.2f} and K2 "
        f"{launches['rollout_closed_loop_kuka'] / inner:.2f} launches, "
        f"{r.host_syncs / inner:.2f} host syncs; the initial-rollout guard "
        f"held x0 for {r.seed_held} problem(s) (the JAX "
        f"package in float32 on the CPU: c_max {JAX_KUKA_F32[0]:.2e}, goal "
        f"error {JAX_KUKA_F32[1]:.1e}, outer {JAX_KUKA_F32[2]}, inner "
        f"{JAX_KUKA_F32[3]}; bars c_max < {KUKA_BARS[0]:g}, goal within "
        f"{KUKA_BARS[1]:g})")
    report[tag] = dict(wall_s=wall, c_max=c, goal_err=g, inner=inner,
                       outer=int(r.iterations), host_syncs=r.host_syncs,
                       guard=r.seed_held)
    check(c < KUKA_BARS[0] and g < KUKA_BARS[1], f"{tag}: misses the bars")

    ref = refs.pop("ref_kuka").result()
    log(f"reference: altro_solve(kuka_obstacles()) in float64 on the CPU by "
        f"the plain versions ({ref['seconds']:.1f} s): c_max "
        f"{ref['c_max']:.3e}, goal error {ref['goal_err']:.3e}, outer "
        f"{ref['outer']}, inner {ref['inner']}; max|X_card - X_cpu| "
        f"{float((r.X.cpu().double() - torch.as_tensor(ref['X'])).abs().max()):.3e}"  # noqa: E501
        " (printed, both are local solutions)")
    check(ref["c_max"] < KUKA_BARS[0] and ref["goal_err"] < KUKA_BARS[1],
          "the CPU reference misses the bars")


def _kuka_warm():
    """One outer iteration of two inner ones: sets torch and the kernels up
    before path 1 is timed."""
    import trajopt_tpu_torch as tt

    return tt.ALTROOptions(opts_al=tt.ALOptions(
        iterations=1, opts_uncon=tt.iLQROptions(iterations=2)))


def kuka_arm(report, tag, prob, opts, x0s, ran):
    """One arm of the pool: solve_batch_queued_altro over 128 lanes, with
    its shares and launches."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro

    res, wall, launches = run_counted(
        report, tag, lambda: solve_batch_queued_altro(prob, opts, x0s,
                                                      lanes=B), ran)
    count = x0s.shape[0]
    check(res.X.shape == (count, prob.N, 14)
          and bool(torch.isfinite(res.X).all()), f"{tag}: output")
    c = res.c_max.double()
    g = (res.X[:, -1] - prob.xf).norm(dim=-1).double()

    def shares(k):
        """The shares of the first ``k`` starts, as JAX_KUKA_POOL."""
        return dict(cmax_1e3=float((c[:k] < 1e-3).double().mean()),
                    goal_1e3=float((g[:k] < 1e-3).double().mean()),
                    cmax_1e1=float((c[:k] < 1e-1).double().mean()))

    every, gated = shares(count), shares(KUKA_GATE_COUNT)
    iters = max(launches[ran[0]], 1)
    log(f"{tag}: {count} problems over {B} lanes in {wall:.3f} s = "
        f"{count / wall:.2f} problems/s at the cut depth "
        f"{KUKA_POOL_DEPTH} | rounds {res.rounds}, {iters} batched "
        f"iterations (K5 sweeps), launches {launches}, host syncs "
        f"{res.host_syncs} ({res.host_syncs / iters:.2f} per batched "
        f"iteration) | shares of all {count}: {every}; of the first "
        f"{KUKA_GATE_COUNT}: {gated} (the JAX package in float32 on the "
        f"CPU, same starts and depth: {JAX_KUKA_POOL}; gate: each less "
        f"{GATE_MARGIN}) | median c_max {float(c.median()):.3e}, inner "
        f"iterations mean {res.iterations_total.double().mean().item():.2f} "
        f"and max {int(res.iterations_total.max())}")
    report[tag] = dict(problems_per_s=count / wall, wall_s=wall,
                       rounds=res.rounds, host_syncs=res.host_syncs,
                       shares=every, shares_gated=gated,
                       median_cmax=float(c.median()))
    check(all(gated[k] >= JAX_KUKA_POOL[k] - GATE_MARGIN for k in gated),
          f"{tag}: shares below the JAX package's less {GATE_MARGIN}")
    return every


def phase_kuka_pool(report):
    """Path 2: the kuka pool through ``solve_batch_queued_altro`` with the
    tuned options (cut to KUKA_POOL_DEPTH) in two arms: the default
    (phase-split: K5 (14, 7) and K2) and ``fused_al_fk=True`` (the hybrid:
    K5 and K4)."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles

    prob = kuka_obstacles(dtype=torch.float32)
    x0s = torch.as_tensor(kuka_starts(prob.x0.cpu(), KUKA_POOL_RUN),
                          dtype=torch.float32, device=prob.device)
    warm = _kuka_warm()
    shares = []
    for fk, ran in ((False, ("riccati_sweep_14x7",
                             "rollout_closed_loop_kuka")),
                    (True, ("riccati_sweep_14x7", "fused_al_forward_kuka"))):
        solve_batch_queued_altro(prob, warm, x0s[:B], lanes=B)
        arm = "hybrid (fused_al_fk=True)" if fk else "default (phase-split)"
        shares.append(kuka_arm(report, f"slice 5 pool kuka_obstacles, {arm}",
                               prob, kuka_tuned(fk), x0s, ran))
    diff = {k: abs(shares[0][k] - shares[1][k]) for k in shares[0]}
    log(f"slice 5 pool: the arms differ by {diff} on their shares (bar "
        f"{KUKA_ARM_MARGIN})")
    check(max(diff.values()) <= KUKA_ARM_MARGIN,
          "slice 5 pool: the arms disagree")


def phase_kuka_profile(report):
    """One round of 2 iterations of each arm on 128 lanes under
    torch.profiler (a profiled iteration of the phase-split arm holds
    ~20,000 device launches). The round starts from the start held on
    every knot, where the initial-rollout guard leaves a solve, so that
    the open-loop seed rollout (some 10^5 small torch ops) stays out of it."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles
    import trajopt_tpu_torch as tt

    prob = kuka_obstacles(dtype=torch.float32)
    prob = tt.update_problem(prob, X=prob.x0.expand(prob.N, 14).contiguous())
    x0s = torch.as_tensor(kuka_starts(prob.x0.cpu(), B), dtype=torch.float32,
                          device=prob.device)
    iters = 2
    for fk, names in ((False, ("riccati_sweep_14x7",
                               "rollout_closed_loop_kuka")),
                      (True, ("riccati_sweep_14x7", "fused_al_forward_kuka"))):
        opts = tt.ALTROOptions(opts_al=tt.ALOptions(
            iterations=1, cost_tolerance_intermediate=0.0,
            penalty_initial=0.01, penalty_scaling=50.0,
            opts_uncon=tt.iLQROptions(iterations=iters, fused_al_fk=fk)))

        def one_round():
            res = solve_batch_queued_altro(prob, opts, x0s, lanes=B,
                                           infeasible=False)
            torch.cuda.synchronize()
            return res

        profile_round("slice 5 profile " + ("hybrid" if fk else "default"),
                      one_round, iters, names)


def phase_kuka_slack(report):
    """Path 3, the instantiations no other path reaches: 128 line-seeded
    kuka starts through ``solve_batch_queued_altro(..., infeasible=True)``,
    one outer iteration of at most KUKA_SLACK_INNER inner ones, in both
    arms: K5 (14, 21) with K2 ``kuka_slack``, and K5 (14, 21) with K4
    ``kuka_slack``. (Three outer iterations took 86 s phase-split and 69 s
    hybrid on the H100.) Then K3, which the solver never sends a stack
    with fk rows: the same starts on ``kuka_obstacles`` without its bubble
    rows (torque bounds and the goal), which the default dispatch runs
    fused, K3 and K4 ``kuka`` (a feasible start from the hold seed), and
    from the line seed with the infeasible-start transform, K3 and K4
    ``kuka_slack``."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles
    import trajopt_tpu_torch as tt

    prob = line_seeded(kuka_obstacles(dtype=torch.float32))
    x0s = torch.as_tensor(kuka_starts(prob.x0.cpu(), B), dtype=torch.float32,
                          device=prob.device)
    for fk, ran in ((False, ("riccati_sweep_14x21",
                             "rollout_closed_loop_kuka_slack")),
                    (True, ("riccati_sweep_14x21",
                            "fused_al_forward_kuka_slack"))):
        opts = tt.ALTROOptions(R_inf=1e-8, opts_al=tt.ALOptions(
            iterations=1, penalty_initial=0.01, penalty_scaling=50.0,
            opts_uncon=tt.iLQROptions(iterations=KUKA_SLACK_INNER,
                                      fused_al_fk=fk)))
        tag = ("slice 5 kuka infeasible start, "
               + ("hybrid" if fk else "phase-split")
               + f", 1 outer iteration of {KUKA_SLACK_INNER}")
        res, wall, _ = run_counted(
            report, tag, lambda: solve_batch_queued_altro(
                prob, opts, x0s, lanes=B, infeasible=True), ran)
        check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite states")
        log(f"{tag}: {B} problems in {wall:.3f} s | c_max < 1e-3 on "
            f"{float((res.c_max < 1e-3).float().mean()):.4f}, median c_max "
            f"{float(res.c_max.median()):.3e}, mean inner iterations "
            f"{res.iterations_total.float().mean().item():.2f} (printed, "
            "not held)")

    free = kuka_without_obstacles(kuka_obstacles(dtype=torch.float32))
    for slack, start in ((False, free), (True, line_seeded(free))):
        label = "kuka_slack" if slack else "kuka"
        opts = tt.ALTROOptions(R_inf=1e-8, opts_al=tt.ALOptions(
            iterations=1, penalty_initial=0.01, penalty_scaling=50.0,
            opts_uncon=tt.iLQROptions(iterations=KUKA_SLACK_INNER)))
        tag = (f"slice 5 kuka without the bubble rows, fused, "
               f"{'infeasible' if slack else 'feasible'} start, 1 outer "
               f"iteration of {KUKA_SLACK_INNER}")
        res, wall, _ = run_counted(
            report, tag, lambda: solve_batch_queued_altro(
                start, opts, x0s, lanes=B, infeasible=slack),
            (f"fused_al_backward_{label}", f"fused_al_forward_{label}"))
        check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite states")
        log(f"{tag}: {B} problems in {wall:.3f} s | median c_max "
            f"{float(res.c_max.median()):.3e} (printed, not held)")


def kuka_without_obstacles(prob):
    """``kuka_obstacles`` without its fk rows: the torque bounds and the
    goal, a kuka stack that the default dispatch runs fused (K3, K4)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import ConstraintSet

    cs = prob.constraints
    mask = cs.mask.cpu().numpy()
    entries = [(c, mask[:, r0:r1].any(axis=1))
               for c, (r0, r1) in zip(cs.cons, cs.slices) if c.label != "obs"]
    return tt.update_problem(prob, constraints=ConstraintSet.build(
        entries, prob.N, device=prob.device))


# ------------------------------------------------------------- slice 6

def rig_problem(rig, dtype, goal=False, free=False, device=None):
    """URDF rig ``rig`` on its zoo problem (``problems.zoo.rig_problem``:
    the model replaced, as the JAX package solves it). With ``goal`` a
    problem without constraints (the double pendulum's) gets the goal
    constraint of the acrobot's, for the kernels that need a stack; with
    ``free`` the constraints are dropped."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import (
        ConstraintSetBuilder, empty_constraints, goal_constraint)
    from trajopt_tpu_torch.problems import zoo

    prob = zoo.rig_problem(rig, dtype=dtype, device=device)
    if goal and prob.constraints.P == 0:
        cons = ConstraintSetBuilder(prob.N)
        cons.add(goal_constraint(prob.xf.cpu().numpy()))
        prob = tt.update_problem(prob, constraints=cons.stack(
            device=prob.device))
    if free:
        prob = tt.update_problem(prob, constraints=empty_constraints(
            prob.N, device=prob.device))
    return prob


def kuka_free(prob):
    """``kuka_obstacles`` with an empty constraint set: path (a)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import empty_constraints

    return tt.update_problem(prob, constraints=empty_constraints(
        prob.N, device=prob.device))


def kuka_hold_seeds(prob, x0s):
    """Path (a)'s control seeds: each start's own gravity hold
    (``kuka_hold_trajectory`` of its configuration), (B, N − 1, 7). The
    problem's seed, the nominal start's hold, rolls out to non-finite
    states from every perturbed start (float64 too); the initial-rollout
    guard then holds the start, whose cost no rollout of the unconstrained
    problem beats, and every line search runs out."""
    import torch

    q = x0s[:, :7].to(prob.U.dtype)
    hold = prob.model.model.chain.bias_forces(q, torch.zeros_like(q))
    return hold[:, None].expand(-1, prob.N - 1, -1).contiguous()


def kuka_free_setup(seed=5):
    """K7a and K7b inputs on path (a)'s problem, as ``model_setup`` hands
    them out: starts with q noise 0.05 (as the pool's), each start's own
    hold torques, and the open-loop rollouts, made in float64 (the guard's
    held start where a rollout leaves the finite numbers), handed out in
    float32: the state of the first iteration of path (a)."""
    import torch
    from trajopt_tpu_torch.ops.rollout import rollout
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles

    p64 = kuka_free(kuka_obstacles(dtype=torch.float64))
    p32 = kuka_free(kuka_obstacles(dtype=torch.float32))
    rng = np.random.default_rng(seed)
    x0s = p64.x0[None] + torch.as_tensor(np.concatenate(
        [rng.normal(size=(B, 7)) * 0.05, np.zeros((B, 7))], axis=1),
        device=p64.device)
    U = kuka_hold_seeds(p64, x0s)
    X = rollout(p64.model, x0s, U, p64.dt_traj())
    blew = ~torch.isfinite(X).flatten(1).all(-1)
    X[blew] = x0s[blew][:, None]
    log(f"kuka K7a/K7b inputs: {int(blew.sum())} of {B} open-loop rollouts "
        "held at their start")
    return dict(name="kuka", p64=p64, p32=p32, model=p32.model, obj=p32.obj,
                X64=X.contiguous(), U64=U, X=X.float().contiguous(),
                U=U.float().contiguous(), dt=p32.dt, dt_traj=p32.dt_traj(),
                Nk=p32.N)


def phase_rig_fused_kernels(report):
    """Phase ``rig_kernels``, first job: every new instantiation of slice 6
    against its plain version on the card, at B = 128 and each problem's
    own N: K7a (with its Jacobians against ``jacobian_traj`` and against K5
    fed them) and K7b (diverging lanes, a search that runs out) for the
    three rigs on their zoo problems and for kuka on path (a)'s."""
    # (the feedforward d and ΔV of every chain instantiation printed, not
    # held: at the cartpole rig's stiff knots, |K| ~ 9e2, two float32
    # reductions of the same Jacobians part by 4e-3 of their scale in K3,
    # the kernel further from float64 than the plain version there and
    # nearer in K7a; CLAUDE.md)
    for rig in RIGS:
        k7b_case(report, k7a_case(report, model_setup(rig), jac_rtol=JAC_TOL,
                                  hold_d=False,
                                  shapes=rig == "cartpole_urdf"),
                 ls_opts=LS_OPTS_CHAIN, j_own=True,
                 shapes=rig == "cartpole_urdf")
    # the arm's float32 rounding is amplified as in K3/K4 (ROADMAP Q3-20):
    # the bars K3 and K4 are held to on the kuka stack
    st = k7a_case(report, kuka_free_setup(), kd_tol=AL_KD_TOL,
                  dv_tol=AL_DV_TOL, jac_rtol=KUKA_JAC_RTOL, hold_d=False)
    k7b_case(report, st, alpha_share=K4_ALPHA_SHARE, ls_opts=LS_OPTS_CHAIN,
             j_own=True)


def phase_rig_al_kernels(report):
    """Phase ``rig_kernels``, second job: K3, K4, K2 and K5 for each rig
    with and without slacks through ``al_case`` (the double pendulum with a
    goal constraint), K2 on K3's gains at the steps K4 accepted (a K5 shape
    that phase 10 or 14 checked is not checked again)."""
    for rig in RIGS:
        for slack in (False, True):
            st = al_setup(rig, slack)
            al_case(report, dict(st, phase_split=True, jac_rtol=JAC_TOL,
                                 ls_opts=LS_OPTS_CHAIN, hold_d=False,
                                 j_own=True))


def slice6_pools():
    """Path (a) and the pools of path (b): (pool, label of the model's
    instantiations, problem factory, start factory)."""
    import torch
    from trajopt_tpu_torch.problems.zoo import kuka_obstacles

    f32 = torch.float32
    pools = [("kuka", "kuka", lambda: kuka_free(kuka_obstacles(dtype=f32)),
              kuka_starts)]
    for pool, rig in SLICE6_RIG.items():
        pools.append((pool, rig, lambda r=rig, f=pool.endswith("_free"):
                      rig_problem(r, f32, free=f), cartpole_starts))
    return pools


def slice6_options(pool, fused):
    """Path (a): the AL options of ``tuned_altro_options("kuka")``; path (b)
    ``ALOptions()``, cut to SLICE6_CARTPOLE_DEPTH for the constrained
    cartpole; ``fused`` sets ``fused`` (unconstrained) and ``fused_al``
    (constrained) alike."""
    import dataclasses

    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.problems.tuned import tuned_altro_options

    o = tuned_altro_options("kuka").opts_al if pool == "kuka" \
        else tt.ALOptions()
    if pool == "cartpole":
        o = dataclasses.replace(o, iterations=SLICE6_CARTPOLE_DEPTH[0],
                                opts_uncon=dataclasses.replace(
                                    o.opts_uncon,
                                    iterations=SLICE6_CARTPOLE_DEPTH[1]))
    return dataclasses.replace(o, opts_uncon=dataclasses.replace(
        o.opts_uncon, fused=fused, fused_al=fused))


def jax_slice6():
    """The JAX package's outcomes of each pool, by (pool, type)
    (tools/slice6_gates_jax.jsonl)."""
    lines = (ROOT / "tools" / "slice6_gates_jax.jsonl").read_text()
    return {(d["pool"], d["dtype"]): d
            for d in map(json.loads, lines.splitlines())}


def slice6_outcome(c_max, err):
    """The shares ``JAX_SLICE6`` holds: c_max < 1e-3, and the terminal error
    ``err`` within each bar of SLICE6_ERR_BARS."""
    out = dict(cmax_1e3=float((c_max < 1e-3).double().mean()))
    for bar in SLICE6_ERR_BARS:
        out[f"err_{bar:g}"] = float((err < bar).double().mean())
    return out


def slice6_job(report, names):
    """Paths (a) and (b) through ``solve_batch`` in float32, one call per
    arm, in a worker process on the card, which starts with slice 7's path
    (a) (host-bound: 103 s of the main process on the H100 before slice
    8): the unconstrained kuka with ``fused=True`` (K7a and K7b only) and
    with ``fused=False`` (K5 (14, 7) and K2 only), the rigs on their zoo
    problems fused (K7a/K7b unconstrained, K3/K4 constrained) and
    phase-split (K5 and K2). Returns each arm's final J, c_max, terminal
    error (of the joints for the arm) and iterations, with the log lines
    (``run_worker``), for ``phase_slice6``."""
    import torch
    import trajopt_tpu_torch as tt

    def warm(fused):
        return tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
            iterations=2, fused=fused, fused_al=fused))

    outs = {}
    for pool, label, make, starts in slice6_pools():
        if pool not in names:
            continue
        prob = make()
        n, m = prob.n, prob.m
        x0s = torch.as_tensor(starts(prob.x0.cpu(), SLICE6_POOL),
                              dtype=torch.float32, device=prob.device)
        U0s = kuka_hold_seeds(prob, x0s) if pool == "kuka" else None
        constrained = prob.constraints.P > 0
        fused_ran = al_kernels(label) if constrained else (
            f"fused_backward_{label}", f"fused_forward_{label}")
        split_ran = (f"riccati_sweep_{n}x{m}", f"rollout_closed_loop_{label}")
        q = slice(0, 7) if pool == "kuka" else slice(None)
        for how, fused, ran in (("fused", True, fused_ran),
                                ("phase-split", False, split_ran)):
            arm = f"slice 6 {pool} {how}"
            res = run_arm(report, arm, prob, slice6_options(pool, fused),
                          x0s, ran, warm(fused), U0s)
            outs[arm] = dict(
                J=res.J.tolist(), c_max=res.c_max.tolist(),
                err=(res.X[:, -1, q] - prob.xf[q]).norm(dim=-1).tolist(),
                iterations=res.iterations_total.tolist())
    return outs


def phase_slice6(report, refs, jobs):
    """Paths (a) and (b), collected from their two workers
    (``slice6_job``: the cartpole rig's two pools in one, the others in
    the other):
    each arm's shares and final costs on the JAX package's starts are held
    to its (``SLICE6_SHARES``, SLICE6_J_RTOL), the arms to each other within
    GATE_MARGIN on their shares and SLICE6_J_RTOL in median relative J, and
    problems 0 and 1 to a float64 solve by the plain versions on the
    CPU."""
    import torch

    gates = jax_slice6()
    done = {}
    for job in jobs:
        done.update(collect_worker(report, job, "slice 6"))
    for pool, _, _, _ in slice6_pools():
        count = SLICE6_POOL
        jax = gates[pool, "float32"]
        jax64 = gates.get((pool, "float64"))
        k = min(jax["count"], count)
        for key in ("J", "c_max", "err"):
            jax[key] = jax[key][:k]
        j_bar = SLICE6_J_MEDIAN[pool]
        r = SLICE6_REFS[pool]
        ref = refs.pop(f"ref_s6_{pool}").result() if r else None
        outs = {}
        for how in ("fused", "phase-split"):
            arm = f"slice 6 {pool} {how}"
            o = done[arm]
            # the terminal error, of the joints for the arm
            err, J, c_max = (torch.as_tensor(o[key], dtype=torch.float64)
                             for key in ("err", "J", "c_max"))
            every = slice6_outcome(c_max, err)
            gated = slice6_outcome(c_max[:k], err[:k])
            theirs = slice6_outcome(torch.as_tensor(jax["c_max"]),
                                    torch.as_tensor(jax["err"]))
            if jax64:
                wide = slice6_outcome(torch.as_tensor(jax64["c_max"][:k]),
                                      torch.as_tensor(jax64["err"][:k]))
                theirs = {key: min(v, wide[key]) for key, v in theirs.items()}
            Jj = torch.as_tensor(jax["J"], dtype=torch.float64,
                                 device=J.device)
            dJ = (J[:k] - Jj).abs() / Jj.abs()
            near = float((dJ <= SLICE6_J_RTOL).double().mean())
            quart = [float(f"{v:.3g}") for v in torch.quantile(
                dJ, torch.tensor([0.25, 0.5, 0.75, 0.9], dtype=dJ.dtype,
                                 device=dJ.device)).tolist()]
            within = {f"{bar:g}": float((dJ <= bar).double().mean())
                      for bar in (1e-3, 1e-2, 4e-2, 1e-1)}
            log(f"{arm}: shares of all {count}: {every}; of the first "
                f"{k}: {gated} (the JAX package on the CPU, same starts, in "
                f"float32{' and float64, the lower' if jax64 else ''}: "
                f"{theirs}; gate: {SLICE6_SHARES[pool]}, each less "
                f"{GATE_MARGIN}) | final J against the JAX package's: median "
                f"relative difference {float(dJ.median()):.2e} (gate "
                f"{j_bar:g}), quartiles and 90th percentile {quart}, the "
                f"shares within each bar {within}"
                + (f", the share within {SLICE6_J_RTOL:g} at least "
                   f"{1 - GATE_MARGIN:g}" if pool in SLICE6_J_EACH else "")
                + f" | median J {float(J.median()):.6g} (JAX "
                f"{float(Jj.median()):.6g}), median error "
                f"{float(err.median()):.4e}, median c_max "
                f"{float(c_max.median()):.3e}")
            if pool == "acrobot":
                # the starts past the goal's 1e-3 bar, beside the JAX
                # package's errors on them in float32 and float64
                past = (err[:k] >= 1e-3).nonzero().flatten().tolist()
                log(f"{arm}: of the first {k}, at the goal within 1e-3 "
                    f"but for starts {past}: error "
                    f"{[float(f'{float(err[i]):.4g}') for i in past]}, c_max "
                    f"{[float(f'{float(c_max[i]):.4g}') for i in past]}"
                    f" (JAX float32: {[jax['err'][i] for i in past]}, float64"
                    f": {[jax64['err'][i] for i in past] if jax64 else None})"
                    f"; the JAX package's past it: float32 "
                    f"{[i for i, e in enumerate(jax['err']) if e >= 1e-3]}, "
                    "float64 "
                    + str([i for i, e in enumerate(jax64["err"][:k])
                           if e >= 1e-3] if jax64 else None))
            report[arm].update(shares=every, shares_gated=gated, J_near=near,
                               J_median_rel=float(dJ.median()),
                               J_quartiles=quart)
            for key in SLICE6_SHARES[pool]:
                check(gated[key] >= theirs[key] - GATE_MARGIN,
                      f"{arm}: share {key} {gated[key]:.4f} below the JAX "
                      f"package's {theirs[key]} less {GATE_MARGIN}")
            check(float(dJ.median()) <= j_bar,
                  f"{arm}: final costs differ from the JAX package's")
            check(pool not in SLICE6_J_EACH or near >= 1.0 - GATE_MARGIN,
                  f"{arm}: final costs differ from the JAX package's on "
                  "too many starts")
            if not r:
                outs[how] = every, J
                continue
            log(f"{arm}: problems 0 to {r - 1} in float64 on the CPU by the "
                f"plain versions ({ref['seconds']:.1f} s): J {ref['J']} "
                f"(card: {J[:r].tolist()}), c_max {ref['c_max']} (card: "
                f"{c_max[:r].tolist()}), error {ref['err']} (card: "
                f"{err[:r].tolist()}), inner iterations {ref['iterations']} "
                f"(card: {o['iterations'][:r]})")
            # (in outcome; in J too where the solves are smooth)
            check((pool not in SLICE6_J_EACH or all(
                abs(a - b) <= SLICE6_J_RTOL * abs(b)
                for a, b in zip(J[:r].tolist(), ref["J"])))
                  and [c < 1e-3 for c in ref["c_max"]]
                  == (c_max[:r] < 1e-3).tolist(),
                  f"{arm}: the card disagrees with the CPU reference")
            outs[how] = every, J
        # (on the shares the pool is held by: the unsolved cartpole pools'
        # terminal errors are where rounding leaves each start, ROADMAP Q3-25)
        (sa, Ja), (sb, Jb) = outs.values()
        diff = {key: abs(sa[key] - sb[key])
                for key in ("cmax_1e3",) + SLICE6_SHARES[pool]}
        rel = float(((Ja - Jb).abs() / Jb.abs()).median())
        log(f"slice 6 {pool}: the arms differ by {diff} on their shares (bar "
            f"{GATE_MARGIN}) and by {rel:.2e} in median relative final J "
            f"(bar {j_bar:g}); their median final J {float(Ja.median()):.6g}"
            f" and {float(Jb.median()):.6g}")
        check(max(diff.values()) <= GATE_MARGIN and rel <= j_bar,
              f"slice 6 {pool}: the fused and the phase-split arm disagree")


def phase_slice6_models(report):
    """The slice-6 instantiations no other path reaches, through
    ``solve_batch_queued_altro`` on 128 starts each, one outer iteration of
    at most SLICE6_MODELS_INNER inner ones: each rig line-seeded with its
    slacks, fused (K3/K4 ``*_slack``) and with ``fused_al=False`` (K5
    (4, m + 4) and K2 ``*_slack``), and the double pendulum with the goal
    constraint of ``rig_problem(goal=True)``, fused (K3/K4
    ``doublependulum_urdf``). Their outcomes are printed, not held."""
    import torch
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro
    import trajopt_tpu_torch as tt

    f32 = torch.float32

    def drive(tag, prob, fused_al, x0s, ran, infeasible):
        opts = tt.ALTROOptions(R_inf=1.0, opts_al=tt.ALOptions(
            iterations=1, opts_uncon=tt.iLQROptions(
                iterations=SLICE6_MODELS_INNER, fused_al=fused_al)))
        res, wall, _ = run_counted(
            report, tag, lambda: solve_batch_queued_altro(
                prob, opts, x0s, lanes=B, infeasible=infeasible), ran)
        check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite states")
        log(f"{tag}: {B} problems in {wall:.3f} s | c_max < 1e-3 on "
            f"{float((res.c_max < 1e-3).float().mean()):.4f}, median c_max "
            f"{float(res.c_max.median()):.3e}, mean inner iterations "
            f"{res.iterations_total.float().mean().item():.2f} (printed, "
            "not held)")

    for rig in RIGS:
        prob = rig_problem(rig, f32, goal=True)
        x0s = torch.as_tensor(cartpole_starts(prob.x0.cpu(), B), dtype=f32,
                              device=prob.device)
        seeded = line_seeded(prob)
        depth = f"1 outer iteration of {SLICE6_MODELS_INNER}"
        drive(f"slice 6 {rig} infeasible start, fused, {depth}", seeded,
              True, x0s, al_kernels(f"{rig}_slack"), True)
        drive(f"slice 6 {rig} infeasible start, phase-split, {depth}",
              seeded, False, x0s, (f"riccati_sweep_4x{prob.m + 4}",
                                   f"rollout_closed_loop_{rig}_slack"), True)
        if rig == "doublependulum_urdf":
            drive(f"slice 6 {rig} with a goal constraint, fused, {depth}",
                  prob, True, x0s, al_kernels(rig), False)


# ------------------------------------------------------------- slice 7

def ballonbeam_problem(dtype, device=None):
    """A ball-on-beam problem (no zoo problem of either package drives the
    model): the ball 0.25 m out on a level beam brought to rest at the
    centre, N = 51, dt = 0.05, the torque held at the level beam's 9.81 N
    (m2·g/2) as the seed and bounded to [0, 30], the goal constrained."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo

    N, n, m = 51, 4, 1
    x0 = np.array([0.25, 0.0, 0.0, 0.0])
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=0.0, u_max=30.0))
    cons.add(tt.goal_constraint(np.zeros(n)))
    return tt.problem(tt.discretize(zoo.ballonbeam, "rk3"), tt.LQRObjective(
        np.eye(n) * 1e-2, np.eye(m) * 1e-2, np.eye(n) * 100.0, np.zeros(n),
        N, dtype=dtype, device=device), constraints=cons, x0=x0,
        xf=np.zeros(n), N=N, dt=0.05, U0=np.full((N - 1, m), 9.81),
        dtype=dtype, device=device)


def quadrotor_euler_problem(dtype, device=None):
    """``quadrotor()``'s flight (60 m in 5 s, N = 101, the same weights, the
    u ≥ 0 bound and the terminal velocity box) for the Euler-angle
    quadrotor (n = 12)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo

    N, n, m = 101, 12, 4
    x0, xf = np.zeros(n), np.zeros(n)
    x0[2], xf[1:3] = 10.0, (60.0, 10.0)
    Q = np.eye(n) * 1e-3
    Q[3:6, 3:6] = np.eye(3) * 1e-2
    xf_U, xf_L = np.full(n, np.inf), np.full(n, -np.inf)
    xf_U[:3] = xf_L[:3] = xf[:3]
    xf_U[6:9] = xf_L[6:9] = 0.0
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=0.0, label="bnd_u"),
             knots=range(0, N - 1))
    cons.add(tt.bound_constraint(n, m, x_min=xf_L, x_max=xf_U,
                                 label="bnd_xf"), knots=[N - 1])
    return tt.problem(tt.discretize(zoo.quadrotor_euler, "rk3"),
                      tt.LQRObjective(Q, np.eye(m) * 1e-4, np.eye(n) * 1e3,
                                      xf, N, dtype=dtype, device=device),
                      constraints=cons, x0=x0, xf=xf, N=N, tf=5.0,
                      U0=np.full((N - 1, m), 0.5 * 9.81 / 4.0), dtype=dtype,
                      device=device)


def mintime_pendulum(dtype, line=False, device=None):
    """The minimum-time pendulum of tests/test_altro.py:64-82 (N = 31,
    dt = 0.075, |u| ≤ 5), seeded with the line to the goal if ``line``."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo

    N, n, m = 31, 2, 1
    xf = np.array([np.pi, 0.0])
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=-5.0, u_max=5.0))
    cons.add(tt.goal_constraint(xf))
    prob = tt.problem(tt.discretize(zoo.pendulum, "rk3"), tt.LQRObjective(
        np.eye(n) * 1e-3, np.eye(m) * 1e-3, np.eye(n) * 1e-3, xf, N,
        dtype=dtype, device=device), constraints=cons, x0=np.zeros(n),
        xf=xf, N=N, dt=0.075, U0=np.ones((N - 1, m)), dtype=dtype,
        device=device)
    return line_seeded(prob) if line else prob


def mintime_options():
    """tests/test_altro.py:66-68."""
    import trajopt_tpu_torch as tt

    return tt.ALTROOptions(opts_al=tt.ALOptions(iterations=50,
                                                penalty_scaling=10.0),
                           R_minimum_time=15.0, dt_max=0.15, dt_min=1e-3)


def form_base_problem(name, dtype, device=None):
    """The problem model ``name`` meets in slices 7 and 8: the minimum-time
    pendulum, ``quadrotor()``, ``cartpole()``, ``parallel_park()`` (the
    car), ``doubleintegrator()``, ``ballonbeam_problem``,
    ``quadrotor_euler_problem``, ``kuka_obstacles()``, each URDF rig on its
    zoo problem, ``doublependulum_problem()``, ``acrobot_problem()``."""
    from trajopt_tpu_torch.problems import zoo

    if name in RIGS:
        return rig_problem(name, dtype, device=device)
    return dict(
        pendulum=lambda **kw: mintime_pendulum(**kw), quadrotor=zoo.quadrotor,
        cartpole=zoo.cartpole, car=zoo.parallel_park,
        doubleintegrator=zoo.doubleintegrator, ballonbeam=ballonbeam_problem,
        quadrotor_euler=quadrotor_euler_problem, kuka=zoo.kuka_obstacles,
        doublependulum=zoo.doublependulum_problem,
        acrobot=zoo.acrobot_problem)[name](dtype=dtype, device=device)


def form_label(name, slack, mintime):
    return name + ("_slack" if slack else "") + ("_mintime" if mintime
                                                  else "")


def form_problem(name, slack, mintime, dtype, device=None, rule="rk3"):
    """``form_base_problem(name)`` with its model under the integrator
    ``rule``, line-seeded and through the infeasible-start transform if
    ``slack``, then through the minimum-time transform if ``mintime`` (the
    order of ``altro_solve``)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo

    prob = form_base_problem(name, dtype, device)
    if rule != "rk3":
        prob = tt.update_problem(prob, model=tt.discretize(zoo.MODELS[name],
                                                           rule))
    if slack:
        prob = tt.infeasible_problem(line_seeded(prob))
    if mintime:
        prob = tt.minimum_time_problem(prob)
    return prob


_FORMS = {}


def form_setup(name, slack, mintime, seed=13, device=None):
    """One K2 form at B = 128 and its problem's own N: the transformed
    problem in float64 and float32, starts with 0.02 noise on every base
    state (τ_0 = 0), its control seed with 0.02 noise (none on the
    quadrotors' hover thrust; a chain's slacks 0; kuka's: each start's own
    gravity hold and, under minimum time, steps of 0.02 s), the open-loop
    rollouts in float64, and K5's
    sweep inputs: the model's Jacobians and the AL expansion of
    ``al_cost_fns`` with λ = 0 and μ = 10 on the valid rows. Far from its
    goal a minimum-time stage cost (ℓ + R_mt)·h² is not convex (its
    Hessian's Schur complement in h is 2R_mt − 6ℓ_x for ℓ_x = ½|x − x_f|²_Q),
    and a closed loop that moves h moves every later step's dt: (``rho``,
    ``alpha``) is the first pair of 1, 10, …, 1e6 and 1, 1/4, …, 1/256 at
    which the float32 plain sweep passes on all but B/16 of the problems,
    three quarters of the float64 closed-loop rollouts on its gains stay
    inside the guard, and the float32 plain rollout stays within 1e-4 of
    scale of the float64 one on the same float32 inputs (a rollout that
    float32 rounding alone moves further is chaotic, and no kernel can be
    held to it). Made once per form (phase 10 and ``slice7_kernels`` or
    ``slice8_kernels`` share it)."""
    import torch
    from trajopt_tpu_torch.ops.cost import Expansion
    from trajopt_tpu_torch.ops.riccati import scan_sweep
    from trajopt_tpu_torch.ops.rollout import rollout, rollout_closed_loop
    from trajopt_tpu_torch.solvers.al import al_cost_fns

    key = (name, slack, mintime, seed, device)
    if key in _FORMS:
        return _FORMS[key]
    p64 = form_problem(name, slack, mintime, torch.float64, device)
    p32 = form_problem(name, slack, mintime, torch.float32, device)
    dev, n, m, Nk = p64.device, p64.n, p64.m, p64.N
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    nb = n - 1 if mintime else n
    noise = np.concatenate([rng.normal(size=(B, nb)) * 0.02,
                            np.zeros((B, n - nb))], axis=1)
    x0s = p64.x0[None] + t(noise)
    U = p64.U[None].expand(B, -1, -1)
    if not name.startswith("quadrotor"):
        U = U + t(rng.normal(size=(B, Nk - 1, m)) * 0.02)
    U = U.contiguous()
    if slack and name in SLICE8_CHAINS:
        # a chain's slacks start at 0: the line-seeded slack seed of the
        # cartpole rig rolls out to non-finite states from the perturbed
        # starts
        mb = p64.model.slack_m
        U[..., mb:m - mintime] = 0.0
    if name == "kuka":
        # each start's own gravity hold, under minimum time steps of
        # 0.02 s: from the problem's seed (the nominal start's hold,
        # dt = 0.125) every perturbed start's open-loop rollout leaves the
        # finite numbers (ROADMAP Q3-24)
        U[..., :7] = kuka_hold_seeds(p64, x0s)
        if mintime:
            U[..., -1] = 0.02 ** 0.5
    dt = p64.dt_traj()
    X = rollout(p64.model, x0s, U, dt)
    A, Bm = p64.model.jacobian_traj(X[:, :-1], U, dt)
    cs = p64.constraints
    lam = torch.zeros((B, Nk, cs.P), dtype=torch.float64, device=dev)
    e = al_cost_fns(p64.obj, cs, dt, lam, 10.0 * cs.mask.double().expand(
        B, -1, -1))[1](X, U)
    ins = [a.float().contiguous() for a in (A, Bm, e.x, e.u, e.xx, e.uu,
                                            e.ux)]
    x0, X32, U32 = (t.float().contiguous() for t in (X[:, 0], X, U))

    alphas = (1.0, 0.25, 0.0625, 0.015625, 0.00390625)

    def calm(rhos):
        """The first (rho, alpha) of ``rhos`` and ``alphas`` at which the
        rollouts are calm, with the fail flags and the float64 rollouts'
        ok flags, or None: the float32 plain sweep's gains at each rho, and
        the float32 and float64 closed-loop rollouts on them at every step
        in one batch each (a chain's plain rollout costs its launches, not
        its batch)."""
        sweeps = [scan_sweep(ins[0], ins[1], Expansion(*ins[2:]),
                             torch.full((B,), r, device=dev)) for r in rhos]
        runs = len(rhos) * len(alphas)
        args = [t.repeat((runs,) + (1,) * (t.ndim - 1))
                for t in (x0, X32, U32)]
        args += [torch.cat([sw[i].repeat((len(alphas),) + (1,) * (
            sw[i].ndim - 1)) for sw in sweeps]) for i in (0, 1)]
        args.append(torch.tensor(alphas, device=dev).repeat_interleave(
            B).repeat(len(rhos)))
        Xa, _, ok32 = rollout_closed_loop(p32.model, *args, p32.dt)
        X64, _, ok64 = rollout_closed_loop(
            p64.model, *(t.double() for t in args), p64.dt)
        for j, (rho_j, sw) in enumerate(zip(rhos, sweeps)):
            for i, alpha_i in enumerate(alphas):
                at = slice((j * len(alphas) + i) * B,
                           (j * len(alphas) + i + 1) * B)
                live = ok64[at] & ok32[at]
                gap = float((Xa[at].double() - X64[at])[live].abs().max()) \
                    / max(1.0, float(X64[at][live].abs().max())) \
                    if bool(live.any()) else float("inf")
                if int(sw[4].sum()) <= B // 16 \
                        and int(ok64[at].sum()) >= 3 * B // 4 and gap <= 1e-4:
                    return rho_j, alpha_i, sw[4], ok64[at]
        return None

    # rho = 1 first (most forms are calm there), then the others at once
    found = calm((1.0,)) or calm((10.0, 100.0, 1e3, 1e4, 1e5, 1e6))
    rho, alpha, fail, ok = found or (None, None, None, None)
    check(alpha is not None, f"K2 {form_label(name, slack, mintime)}: no "
          "calm rollout at any rho and alpha")
    _FORMS[key] = dict(
        label=form_label(name, slack, mintime), p64=p64, p32=p32, X=X32,
        U=U32, ins=ins, rho=rho, alpha=alpha, fail32=int(fail.sum()),
        alive64=int(ok.sum()))
    return _FORMS[key]


def form_k2(report, fs):
    """K2's instantiation of one form on K5's gains at the form's ``rho``
    and its steps at the form's ``alpha`` (``form_setup``), lanes
    K4_DIVERGE with the feedforward blown up (``k2_case``)."""
    import torch
    from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda

    dev = fs["X"].device
    K, d, _, _, _ = riccati_sweep_cuda(*fs["ins"], torch.full(
        (B,), fs["rho"], device=dev))
    for lane in K4_DIVERGE:
        d[lane] *= 1e5
    log(f"K2 {fs['label']}: gains of K5 at rho = {fs['rho']:g} (the float32 "
        f"plain sweep fails on {fs['fail32']} of {B}), steps at alpha = "
        f"{fs['alpha']:g} ({fs['alive64']} of {B} float64 rollouts alive)")
    p32 = fs["p32"]
    k2_case(report, fs["label"], p32.model, fs["p64"].model,
            [fs["X"][:, 0].contiguous(), fs["X"], fs["U"], K, d,
             torch.full((B,), fs["alpha"], device=dev)], p32.dt)


def phase_slice7_kernels(report):
    """Slice 7's instantiations against their plain versions: K2 for each
    form of ``SLICE7_FORMS`` (the K5 shapes they need are phase 10's), and
    K3/K4 of the quadrotor on ``quad_obs()``'s stack (P = 231: cylinder
    rows with D = 2 and sphere rows with D = 3 in one stack)."""
    from trajopt_tpu_torch.problems import zoo

    for name, slack, mintime in SLICE7_FORMS:
        form_k2(report, form_setup(name, slack, mintime))
    st = al_setup("quadrotor", False, factory=zoo.quad_obs)
    st.update(label="quadrotor on quad_obs", entry=False)
    al_case(report, st)


def mintime_job(line, starts):
    """Path (a) in a worker process on the card: ``altro_solve_batch`` of
    the minimum-time pendulum from the starts ``starts`` (a slice) of the 9
    of tools/slice7_gates_jax.py, in float32, with the launch counts read
    around it. Returns the outcome per start, the counts and the time."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.solvers.altro import altro_solve_batch
    from trajopt_tpu_torch.utils.tree import precise_context

    _build.load()
    dev = torch.device("cuda", 0)
    prob = mintime_pendulum(torch.float32, line=line, device=dev)
    x0s = torch.as_tensor(mintime_starts()[starts], dtype=torch.float32,
                          device=dev)
    with precise_context():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = altro_solve_batch(prob, mintime_options(), x0s,
                              minimum_time=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    goal = (r.X[:, -1] - prob.xf).abs().amax(-1)
    return dict(tt=r.tt.tolist(), c_max=r.c_max.tolist(),
                goal=goal.tolist(), iterations=r.iterations_total.tolist(),
                wall=wall, launches=counts, host_syncs=r.host_syncs,
                finite=bool(torch.isfinite(r.X).all()))


def mintime_starts():
    """tools/slice7_gates_jax.py's 9 starts of path (a)."""
    rng = np.random.default_rng(0)
    return np.concatenate([np.zeros((1, 2)),
                           rng.normal(size=(8, 2)) * 0.05])


def jax_slice7():
    """tools/slice7_gates_jax.jsonl by pool (the float32 lines)."""
    path = ROOT / "tools" / "slice7_gates_jax.jsonl"
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    return {d["pool"]: d for d in lines if d["dtype"] == "float32"}


def quad_starts(x0, count=SLICE7_POOL):
    """Paths (b) and (c)'s starts: the position perturbed by N(0, 0.1²)
    (seed 0)."""
    rng = np.random.default_rng(0)
    noise = np.concatenate([rng.normal(size=(count, 3)) * 0.1,
                            np.zeros((count, 10))], axis=1)
    return np.asarray(x0, np.float64)[None] + noise


def slice7_arms():
    """Paths (b) and (c): (tag, problem, fused_al, depth, kernels, the JAX
    package's pool): quad_obs fused at the full and the cut depth, and
    phase-split at the cut depth; the constrained line at the cut depth
    (phase-split: its goal row is a custom constraint)."""
    import torch
    from trajopt_tpu_torch.problems import zoo

    f32 = torch.float32
    quad = ("riccati_sweep_13x4", "rollout_closed_loop_quadrotor")
    obs, line = zoo.quad_obs(dtype=f32), zoo.quadrotor_line(
        N=N, constrained=True, dtype=f32)
    cut = f", {SLICE7_DEPTH[0]} outer x {SLICE7_DEPTH[1]} inner"
    return (("(b) quad_obs fused", obs, True, None, al_kernels("quadrotor"),
             "quad_obs"),
            ("(b) quad_obs fused" + cut, obs, True, SLICE7_DEPTH,
             al_kernels("quadrotor"), "quad_obs_cut"),
            ("(b) quad_obs phase-split" + cut, obs, False, SLICE7_DEPTH, quad,
             "quad_obs_cut"),
            ("(c) quadrotor_line constrained" + cut, line, True, SLICE7_DEPTH,
             quad, "quadrotor_line_con_cut"))


def slice7_run(report, arm):
    """One arm of ``slice7_arms`` through ``run_arm`` on 128 starts: its
    c_max and final position errors."""
    import torch
    import trajopt_tpu_torch as tt

    tag, prob, fused_al, depth, ran, pool = arm
    x0s = torch.as_tensor(quad_starts(prob.x0.cpu()), dtype=torch.float32,
                          device=prob.device)
    outer, inner = depth or (30, 300)
    opts = tt.ALOptions(iterations=outer, opts_uncon=tt.iLQROptions(
        iterations=inner, fused_al=fused_al))
    warm = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=2, fused_al=fused_al))
    res = run_arm(report, f"slice 7 {tag}", prob, opts, x0s, ran, warm)
    err = (res.X[:, -1, :3] - prob.xf[:3]).norm(dim=-1)
    return dict(c_max=res.c_max.tolist(), err=err.tolist(),
                P=prob.constraints.P)


def slice7_shares(tag, pool, out):
    """An arm's shares (``slice7_run``'s ``out``) on all 128 starts and on
    the JAX package's first ones, held to the JAX package's less
    GATE_MARGIN; returns the shares of all 128."""
    import torch

    ref = jax_slice7()[pool]
    k = ref["count"]
    c, err = (torch.as_tensor(out[key]) for key in ("c_max", "err"))
    mine = dict(share_cmax_1e3=float((c < 1e-3).float().mean()),
                share_pos_0p5=float((err < 0.5).float().mean()))
    first = dict(share_cmax_1e3=float((c[:k] < 1e-3).float().mean()),
                 share_pos_0p5=float((err[:k] < 0.5).float().mean()))
    log(f"slice 7 {tag}: P = {out['P']}, c_max < 1e-3 on "
        f"{mine['share_cmax_1e3']:.4f}, final position within 0.5 m on "
        f"{mine['share_pos_0p5']:.4f}, median c_max "
        f"{float(c.median()):.3e}, median position error "
        f"{float(err.median()):.3e} m; on the first {k}: {first} (the "
        f"JAX package in float32 on the CPU: "
        f"{ {s: ref[s] for s in SLICE7_SHARES} }; gate: each less "
        f"{GATE_MARGIN})")
    for s in SLICE7_SHARES:
        check(first[s] >= ref[s] - GATE_MARGIN,
              f"slice 7 {tag}: {s} below the JAX package's")
    return mine


def phase_slice7(report):
    """Slice 7's fused arms of path (b) and the other forms' drives on the
    card in float32 (module docstring); its phase-split arms of (b) and (c)
    run in a worker process (``slice7_split_job``)."""
    for arm in slice7_arms()[:2]:
        out = slice7_run(report, arm)
        report[f"slice 7 {arm[0]}"]["shares"] = slice7_shares(arm[0], arm[5],
                                                               out)
    slice7_models(report)


def slice7_split_job(report):
    """Slice 7's phase-split arms of paths (b) and (c), in a worker process
    on the card (``run_worker``; host-bound: about 40 s and 27 s of the
    main process before slice 8): their outcomes for
    ``phase_slice7_split``."""
    return {arm[0]: slice7_run(report, arm) for arm in slice7_arms()[2:]}


def phase_slice7_split(report, job):
    """Slice 7's phase-split arms, collected from their worker: held to the
    JAX package's shares, and quad_obs's to its fused arm's at the same
    depth within SLICE7_ARMS_MARGIN."""
    outs = collect_worker(report, job, "slice 7")
    arms = {arm[0]: arm for arm in slice7_arms()}
    got = {tag: slice7_shares(tag, arms[tag][5], o)
           for tag, o in outs.items()}
    cut = f", {SLICE7_DEPTH[0]} outer x {SLICE7_DEPTH[1]} inner"
    a = report["slice 7 (b) quad_obs fused" + cut]["shares"]
    b = got["(b) quad_obs phase-split" + cut]
    log(f"slice 7 (b){cut}: the arms' shares differ by "
        f"{ {s: abs(a[s] - b[s]) for s in SLICE7_SHARES} } (bar "
        f"{SLICE7_ARMS_MARGIN})")
    check(all(abs(a[s] - b[s]) <= SLICE7_ARMS_MARGIN for s in SLICE7_SHARES),
          "slice 7 (b): the arms disagree")


def phase_slice7_mintime(report, jobs):
    """Slice 7's path (a), collected from its workers (``mintime_job``):
    the feasible arm from one, the line-seeded arm's starts 0-4 and 5-8
    from two more."""
    jax7 = jax_slice7()
    pend = ("riccati_sweep_3x2", "rollout_closed_loop_pendulum_mintime")
    for line, tag in ((False, "feasible"), (True, "line-seeded")):
        parts = [f.result() for f in jobs[line]]
        out = {k: sum((q[k] for q in parts), []) for k in
               ("tt", "c_max", "goal", "iterations")}
        out.update(wall=max(q["wall"] for q in parts),
                   host_syncs=sum(q["host_syncs"] for q in parts),
                   finite=all(q["finite"] for q in parts),
                   launches={k: sum(q["launches"][k] for q in parts)
                             for k in parts[0]["launches"]})
        ran = pend + (("riccati_sweep_3x4",
                       "rollout_closed_loop_pendulum_slack_mintime")
                      if line else ())
        log(f"slice 7 (a) minimum-time pendulum, {tag}, 9 starts in "
            f"{len(parts)} altro_solve_batch call(s), a worker process each: "
            f"{out['wall']:.3f} s (the longest), launches {out['launches']}, "
            f"host syncs {out['host_syncs']}")
        record_launches(report, out["launches"], ran=ran)
        check(out["finite"], f"slice 7 (a) {tag}: non-finite states")
        tt_, c, g = (np.array(out[k]) for k in ("tt", "c_max", "goal"))
        bars = (tt_ < 0.5 * 0.15 * 30) & (tt_ < 1.0) & (g < 1e-3) \
            & (c < 1e-3)
        ref = jax7["mintime_line" if line else "mintime"]
        share = float(bars.mean())
        med = float(np.median(tt_))
        log(f"slice 7 (a) {tag}: tt {np.round(tt_, 4).tolist()}, c_max "
            f"{[f'{v:.2e}' for v in c]}, goal error {[f'{v:.2e}' for v in g]}"
            f", inner iterations {out['iterations']} | every bar of "
            f"tests/test_altro.py:64-82 met on {share:.4f} (the JAX package "
            f"in float32 on the same starts: {ref['share_bars']}, gate less "
            f"{MINTIME_MARGIN:.4f}; the nominal start: {bool(bars[0])}); "
            f"median tt {med:.4f} (JAX {ref['median_tt']:.4f}, within "
            f"{MINTIME_TT_RTOL})")
        check(bool(bars[0]) and share >= ref["share_bars"] - MINTIME_MARGIN,
              f"slice 7 (a) {tag}: the reference bars")
        check(abs(med - ref["median_tt"]) <= MINTIME_TT_RTOL
              * ref["median_tt"], f"slice 7 (a) {tag}: median total time")
        report[f"slice 7 (a) {tag}"] = dict(wall_s=out["wall"], share=share,
                                            median_tt=med)


def slice7_models(report):
    """The slice-7 forms no other path reaches, through the entry points a
    user calls, one outer iteration of at most SLICE7_MODELS_INNER inner
    ones a stage, the inner options ``fused=True`` (which these models and
    forms do not take: K3, K4, K7a and K7b must not launch): for each
    scalar model of ``form_base_problem`` but the pendulum (path (a)) the
    minimum-time ``altro_solve`` feasible (``MinTime<M>``) and line-seeded
    (``MinTime<WithSlack<M>>`` and, in the re-solve, ``MinTime<M>``), and
    for ballonbeam and the Euler-angle quadrotor also ``solve_batch`` on
    8 starts and the line-seeded ``altro_solve`` (their plain and slack
    forms). Outcomes are printed, not held."""
    drive_forms(report, "slice 7", [m for m in SLICE7_MODELS
                                    if m != "pendulum"],
                ("ballonbeam", "quadrotor_euler"))


def drive_forms(report, tag0, names, plain_too, batch_too=None):
    """The launch-only drives of the forms of ``names`` (slice 7's and
    slice 8's): per model the minimum-time ``altro_solve`` feasible and
    line-seeded, and for the models of ``plain_too`` the line-seeded
    ``altro_solve`` (their slack and plain forms); for those of
    ``batch_too`` (default ``plain_too``) also ``solve_batch`` on 8
    starts. One outer iteration of at most SLICE7_MODELS_INNER inner ones a
    stage, ``fused=True`` (which these forms do not take: K3, K4, K7a and
    K7b must not launch). Outcomes are printed, not held."""
    import torch
    import trajopt_tpu_torch as tt

    batch_too = plain_too if batch_too is None else batch_too
    f32 = torch.float32
    opts = tt.ALTROOptions(opts_al=tt.ALOptions(
        iterations=1, opts_uncon=tt.iLQROptions(
            iterations=SLICE7_MODELS_INNER, fused=True)))

    def kernels(name, slack, mintime, n, m):
        k5 = f"riccati_sweep_{n + mintime}x{m + mintime + n * slack}"
        return (k5, "rollout_closed_loop_" + form_label(name, slack,
                                                        mintime))

    for name in names:
        prob = form_base_problem(name, f32)
        n, m = prob.n, prob.m
        drives = [("minimum time", prob, True,
                   kernels(name, False, True, n, m))]
        drives.append(("minimum time, line-seeded", line_seeded(prob), True,
                       kernels(name, True, True, n, m)
                       + kernels(name, False, True, n, m)))
        if name in plain_too:
            drives.append(("line-seeded", line_seeded(prob), False,
                           kernels(name, True, False, n, m)
                           + kernels(name, False, False, n, m)))
        for what, p, mt, ran in drives:
            tag = f"{tag0} {name} {what}, fused=True, 1 outer iteration " \
                f"of {SLICE7_MODELS_INNER} a stage"
            res, wall, _ = run_counted(report, tag, lambda: tt.altro_solve(
                p, opts, minimum_time=mt), tuple(dict.fromkeys(ran)))
            check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite")
            log(f"{tag}: c_max {float(res.c_max):.3e}, tt "
                f"{float(res.tt):.4f} (printed, not held)")
        if name in batch_too:
            tag = f"{tag0} {name} solve_batch, 8 starts, fused=True"
            x0s = prob.x0[None].repeat(8, 1)
            res, wall, _ = run_counted(report, tag, lambda: tt.solve_batch(
                prob, opts.opts_al, x0s), kernels(name, False, False, n, m))
            check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite")


# ------------------------------------------------------------- slice 8

def phase_slice8_kernels(report):
    """Slice 8's K2 forms (``SLICE8_FORMS``: kuka and the URDF rigs under
    MinTime with and without slacks, the analytic double pendulum and
    acrobot in all four forms) against ``rollout_closed_loop`` on K5's
    gains, at B = 128 and each form's problem's own N, two lanes forced to
    diverge (``form_k2``); the K5 shapes they need are phase 10's."""
    for form in SLICE8_FORMS:
        form_k2(report, form_setup(*form))


def mintime_rig(dtype, device=None):
    """Path (b)'s problem: ``doublependulum_problem()`` with the
    ``doublependulum_urdf`` rig's model, |u| ≤ 20 and the goal constraint
    (tools/slice8_gates_jax.py)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo as mzoo
    from trajopt_tpu_torch.problems import zoo

    p = zoo.doublependulum_problem(dtype=dtype, device=device)
    n, m, Nk = 4, 2, p.N
    xf = np.array([np.pi, 0.0, 0.0, 0.0])
    cons = tt.ConstraintSetBuilder(Nk)
    cons.add(tt.bound_constraint(n, m, u_min=-20.0, u_max=20.0))
    cons.add(tt.goal_constraint(xf))
    return tt.problem(tt.discretize(mzoo.MODELS["doublependulum_urdf"],
                                    "rk3"), p.obj, constraints=cons,
                      x0=np.zeros(n), xf=xf, N=Nk, dt=0.01,
                      U0=np.ones((Nk - 1, m)), dtype=dtype, device=device)


def mintime_rig_options():
    """tools/slice8_gates_jax.py's: R_minimum_time and dt_max chosen there
    so that the JAX package's float64 solve from the nominal start meets
    path (b)'s bars."""
    import trajopt_tpu_torch as tt

    return tt.ALTROOptions(opts_al=tt.ALOptions(iterations=30,
                                                penalty_scaling=10.0),
                           R_minimum_time=10.0, dt_max=0.02, dt_min=1e-3)


def mintime_rig_starts():
    """tools/slice8_gates_jax.py's starts of path (b): the nominal one and
    7 with N(0, 0.02²) on every state entry (seed 0)."""
    rng = np.random.default_rng(0)
    return np.concatenate([np.zeros((1, 4)), rng.normal(
        size=(MINTIME_RIG_STARTS - 1, 4)) * 0.02])


def mintime_rig_job():
    """Path (b) in a worker process on the card: ``altro_solve_batch`` of
    the minimum-time double-pendulum rig from its 8 starts, in float32,
    with the launch counts read around it (as ``mintime_job``)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.solvers.altro import altro_solve_batch
    from trajopt_tpu_torch.utils.tree import precise_context

    _build.load()
    dev = torch.device("cuda", 0)
    prob = mintime_rig(torch.float32, device=dev)
    x0s = torch.as_tensor(mintime_rig_starts(), dtype=torch.float32,
                          device=dev)
    with precise_context():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = altro_solve_batch(prob, mintime_rig_options(), x0s,
                              minimum_time=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    goal = (r.X[:, -1] - prob.xf).abs().amax(-1)
    return dict(tt=r.tt.tolist(), c_max=r.c_max.tolist(),
                goal=goal.tolist(), iterations=r.iterations_total.tolist(),
                wall=wall, launches=counts, host_syncs=r.host_syncs,
                finite=bool(torch.isfinite(r.X).all()))


def jax_slice8():
    """tools/slice8_gates_jax.jsonl by (pool, type)."""
    path = ROOT / "tools" / "slice8_gates_jax.jsonl"
    return {(d["pool"], d["dtype"]): d
            for d in map(json.loads, path.read_text().splitlines())}


def slice8_job(report):
    """Slice 8's path (a) and the launch-only drives (``phase_slice8``) in a
    worker process on the card (``run_worker``), which starts with slice
    7's: each pool's outcome {name: c_max, J, terminal errors}."""
    import torch
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.problems import zoo

    pools = {}
    warm = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=2))
    for name in SLICE8_TWO_LINK:
        prob = getattr(zoo, f"{name}_problem")(dtype=torch.float32)
        n, m = prob.n, prob.m
        x0s = torch.as_tensor(cartpole_starts(prob.x0.cpu(), SLICE8_POOL),
                              dtype=torch.float32, device=prob.device)
        res = run_arm(report, f"slice 8 (a) {name}", prob, tt.ALOptions(),
                      x0s, (f"riccati_sweep_{n}x{m}",
                            f"rollout_closed_loop_{name}"), warm)
        pools[name] = dict(c_max=res.c_max.tolist(), J=res.J.tolist(),
                           err=(res.X[:, -1] - prob.xf).norm(dim=-1).tolist())
    drive_forms(report, "slice 8", SLICE8_CHAINS + SLICE8_TWO_LINK,
                SLICE8_TWO_LINK, batch_too=())
    return pools


def phase_slice8(report, job):
    """Slice 8's path (a) on the card in float32, collected from its worker
    (``slice8_job``): ``solve_batch`` on 128 starts of
    ``doublependulum_problem()`` and of ``acrobot_problem()`` with the
    analytic models, phase-split on K5 and K2, held to the JAX package's
    shares on the same starts (``SLICE8_SHARES``); and the launch-only
    drives of the slice-8 forms no path reaches (``drive_forms``: the
    minimum-time ``altro_solve`` of kuka on ``kuka_obstacles()``, of each
    URDF rig and of both two-link models, feasible and line-seeded, and the
    two-link models' line-seeded ``altro_solve``)."""
    import torch

    pools = collect_worker(report, job, "slice 8")
    gates = jax_slice8()
    for name in SLICE8_TWO_LINK:
        pool = pools[name]
        tag = f"slice 8 (a) {name}"
        c_max, err = (torch.as_tensor(pool[k], dtype=torch.float64)
                      for k in ("c_max", "err"))
        mine = slice6_outcome(c_max, err)
        jax = gates[name, "float32"]
        k = min(jax["count"], SLICE8_POOL)
        theirs = slice6_outcome(torch.as_tensor(jax["c_max"][:k]),
                                torch.as_tensor(jax["err"][:k]))
        wide = gates.get((name, "float64"))
        if wide:
            w = slice6_outcome(torch.as_tensor(wide["c_max"][:k]),
                               torch.as_tensor(wide["err"][:k]))
            theirs = {key: min(v, w[key]) for key, v in theirs.items()}
        J = torch.as_tensor(pool["J"], dtype=torch.float64)
        Jj = torch.as_tensor(jax["J"][:k], dtype=torch.float64)
        dJ = float(((J[:k] - Jj).abs() / Jj.abs()).median())
        log(f"{tag}: shares {mine} (the JAX package on the CPU, same "
            f"starts, float32{' and float64, the lower' if wide else ''}: "
            f"{theirs}; gate: {SLICE8_SHARES[name]}, each less "
            f"{GATE_MARGIN}) | median J {float(J.median()):.6g} (JAX "
            f"{float(Jj.median()):.6g}), median relative difference of "
            f"final J {dJ:.2e} (printed), median error "
            f"{float(err.median()):.4e}, median c_max "
            f"{float(c_max.median()):.3e}")
        report[tag].update(shares=mine, J_median_rel=dJ)
        for key in SLICE8_SHARES[name]:
            check(mine[key] >= theirs[key] - GATE_MARGIN,
                  f"{tag}: share {key} {mine[key]:.4f} below the JAX "
                  f"package's {theirs[key]} less {GATE_MARGIN}")


def phase_slice8_mintime(report, job):
    """Slice 8's path (b), collected from its worker (``mintime_rig_job``):
    the share of starts with c_max < 1e-3 and the goal within 1e-3 at least
    the JAX package's float32 share less one start, the nominal start among
    them, and the median total time within MINTIME_RIG_TT_RTOL of the JAX
    package's float32 median."""
    out = job.result()
    ref = jax_slice8()["dp_rig_mintime", "float32"]
    ran = ("riccati_sweep_5x3", "rollout_closed_loop_doublependulum_urdf_"
           "mintime")
    tag = "slice 8 (b) the minimum-time double-pendulum rig"
    log(f"{tag}, {MINTIME_RIG_STARTS} starts in one altro_solve_batch call "
        f"in a worker process: {out['wall']:.3f} s, launches "
        f"{out['launches']}, host syncs {out['host_syncs']}")
    record_launches(report, out["launches"], ran=ran)
    check(out["finite"], f"{tag}: non-finite states")
    tt_, c, g = (np.array(out[k]) for k in ("tt", "c_max", "goal"))
    bars = (c < 1e-3) & (g < 1e-3)
    share, med = float(bars.mean()), float(np.median(tt_))
    log(f"{tag}: tt {np.round(tt_, 4).tolist()}, c_max "
        f"{[f'{v:.2e}' for v in c]}, goal error {[f'{v:.2e}' for v in g]}, "
        f"inner iterations {out['iterations']} | c_max < 1e-3 and the goal "
        f"within 1e-3 on {share:.4f} (the JAX package in float32 on the "
        f"same starts: {ref['share_bars']}, gate less one start; the "
        f"nominal start: {bool(bars[0])}); median tt {med:.4f} (JAX "
        f"{ref['median_tt']:.4f}, within {MINTIME_RIG_TT_RTOL})")
    check(bool(bars[0]) and share >= ref["share_bars"] - 1.0
          / MINTIME_RIG_STARTS - 1e-9, f"{tag}: the bars")
    check(abs(med - ref["median_tt"]) <= MINTIME_RIG_TT_RTOL
          * ref["median_tt"], f"{tag}: median total time")
    report[tag] = dict(wall_s=out["wall"], share=share, median_tt=med)


# ------------------------------------------------------------- slice 9

def slice9_inputs(name, slack, mintime, rule, seed=17, device=None,
                  gains="all"):
    """K2's inputs for one form under ``rule`` (``SLICE9_B`` problems,
    ``SLICE9_N`` knots, SLICE9_N_IMPLICIT under an implicit rule and for
    kuka): the problem in float64 and float32, starts with 0.02 noise on
    every base state, the problem's control seed with 0.02 noise (none on
    the quadrotor's hover thrust; a chain's slacks 0; kuka each start's
    gravity hold, steps of SLICE9_DT_KUKA), X the start at every knot (the
    reference the gains act on; δx is the motion since the start), gains
    K of N(0, 0.05²) and a feedforward d of N(0, 0.02²) on the controls
    ``gains`` says (``all``: every control, the slacks and h among them;
    ``slack``: all but h; ``base``: the base model's alone, the others
    following their seed), α = 1; under an explicit rule lanes
    ``SLICE9_DIVERGE`` with the base model's controls in d blown up by 1e5
    (not the slacks' or h's). Not under an implicit rule: there a blown-up
    step is one no Newton loop meets in float32 within its 1000 trips,
    and whether the last trip's residual sits above the tolerance or just
    under it is float32 rounding; phase ``slice9_kernels`` checks the
    poisoning on a step that fails in every type."""
    import torch

    p64 = form_problem(name, slack, mintime, torch.float64, device, rule)
    p32 = form_problem(name, slack, mintime, torch.float32, device, rule)
    Bz, n, m = SLICE9_B, p64.n, p64.m
    Nk = min(p64.N, SLICE9_N_IMPLICIT if "implicit" in rule or name == "kuka"
             else SLICE9_N)
    dev = p64.device
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    nb = n - 1 if mintime else n
    x0s = p64.x0[None] + t(np.concatenate(
        [rng.normal(size=(Bz, nb)) * 0.02, np.zeros((Bz, n - nb))], axis=1))
    U = p64.U[None, :Nk - 1].expand(Bz, -1, -1)
    if not name.startswith("quadrotor"):
        U = U + t(rng.normal(size=(Bz, Nk - 1, m)) * 0.02)
    U = U.contiguous()
    if slack and name in SLICE8_CHAINS:
        U[..., p64.model.slack_m:m - mintime] = 0.0
    if name == "kuka":
        U[..., :7] = kuka_hold_seeds(p64, x0s)[:, :Nk - 1]
        if mintime:
            U[..., -1] = 0.02 ** 0.5
    dt = SLICE9_DT_KUKA if name == "kuka" else p64.dt
    X = x0s[:, None].expand(-1, Nk, -1)
    K = t(rng.normal(size=(Bz, Nk - 1, m, n)) * 0.05)
    d = t(rng.normal(size=(Bz, Nk - 1, m)) * 0.02)
    mb = p64.model.slack_m or m - mintime
    seeded = dict(all=m, slack=m - mintime, base=mb)[gains]
    K[..., seeded:, :] = 0.0
    d[..., seeded:] = 0.0
    for lane in () if "implicit" in rule else SLICE9_DIVERGE:
        d[lane, :, :mb] *= 1e5
    ins = [a.float().contiguous() for a in (
        X[:, 0], X, U, K, d, torch.ones(Bz, dtype=torch.float64,
                                         device=dev))]
    return p64, p32, ins, dt


def slice9_ops(cm, model, rule, slack, mintime, trips, steps):
    """Operations of K2's ``steps`` steps of ``model`` (entry ``cm``) under
    ``rule``: an explicit rule's stages' dynamics evaluations and
    combinations; an implicit rule's per step (f(x) for RK3, the last
    residual) and per Newton trip of this run's data (``trips``, the plain
    version's count): the residual's evaluations, the n columns of dG/dy in
    Dual (three times an evaluation each; RK3 two passes), the warp LU and
    its substitutions (2n³/3 + 2n²); the slacks' n additions, h²."""
    from trajopt_tpu_torch.ops.cuda_models import base_label

    table = getattr(model, "chain_table", None)
    dyn = DYN_OPS[base_label(cm)] if table is None else chain_dyn_ops(table)
    n = cm.n - mintime
    extra = (n if slack else 0) + mintime
    if rule in ("euler", "midpoint", "rk4"):
        stages = dict(euler=1, midpoint=2, rk4=4)[rule]
        return steps * (stages * dyn + 3 * stages * n + extra)
    evals = 1 if rule == "midpoint_implicit" else 2
    lu = 2 * n ** 3 // 3 + 2 * n * n
    per_trip = evals * dyn + evals * n * 3 * dyn + lu + 6 * n
    return steps * (evals * dyn + 8 * n + extra) + trips * per_trip


@contextlib.contextmanager
def newton_trips(counts):
    """Within the block, the plain Newton loop
    (``ops/integration.py::_newton_iterate``) appends to ``counts`` a count
    of its trips, summed over the problems, as device tensors: a problem is
    active on a trip while its residual exceeds its tolerance (a stopped
    problem's is evaluated again at the same y), so each residual the loop
    evaluates counts the problems above their tolerance, its last one
    excepted (no trip follows it)."""
    import torch
    from trajopt_tpu_torch.ops import integration

    inner = integration._newton_iterate

    def counted(x, residual_fn, newton_fn):
        tol = integration._implicit_tol(x)
        active = []

        def residual(y):
            g = residual_fn(y)
            active.append((torch.linalg.vector_norm(g, dim=-1) > tol).sum())
            return g

        out = inner(x, residual, newton_fn)
        counts.extend(active[:-1])
        return out

    integration._newton_iterate = counted
    try:
        yield
    finally:
        integration._newton_iterate = inner


def slice9_case(report, name, slack, mintime, rule):
    """K2 under ``rule`` on ``slice9_inputs`` (random gains on every
    control, h's left to its seed on the minimum-time forms of
    SLICE9_H_SEEDED) against ``rollout_closed_loop``: the ok masks equal,
    X and U within K7B_X_TOL of scale or three times the float32 plain
    version's distance from the float64 one on the same inputs, over the
    problems alive in float64 too (lanes SLICE9_DIVERGE left out)."""
    import torch
    from trajopt_tpu_torch.ops.cuda_models import cuda_model
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    p64, p32, ins, dt = slice9_inputs(
        name, slack, mintime, rule,
        gains="slack" if mintime and name in SLICE9_H_SEEDED else "all")
    model = p32.model
    cm = cuda_model(model, "chip_smoke", slack_ok=True, k2_only_ok=True)
    Bz, Nk, n = ins[1].shape
    tag = f"K2 {cm.label} (n={n}, m={cm.m}, B={Bz}, N={Nk})"
    Xk, Uk, okk = rollout_closed_loop_cuda(model, *ins, dt)
    warm_plain(model, ins, dt)
    torch.cuda.synchronize()
    counts = []
    with newton_trips(counts):
        (Xp, Up, okp), plain_ms = timed(
            lambda: rollout_closed_loop(model, *ins, dt))
    trips = int(torch.stack(counts).sum()) if counts else 0
    check(torch.equal(okk, okp), f"{tag}: ok masks differ from the plain "
          f"version ({okk.tolist()} against {okp.tolist()})")
    calm = okk.clone()
    calm[list(SLICE9_DIVERGE)] = False
    rollout64 = []
    pX, pU = rollout_eps(p64.model, ins, dt, Xp, Up, calm, rollout64)
    # the kernel is held on the problems the floor is taken over: those the
    # float64 rollout keeps alive too
    calm = calm & rollout64[2]
    check(int(calm.sum()) >= Bz // 2, f"{tag}: fewer than half the problems "
          "stay alive")
    eX = float((Xk - Xp)[calm].abs().max()
               / max(1.0, float(Xp[calm].abs().max())))
    eU = float((Uk - Up)[calm].abs().max()
               / max(1.0, float(Up[calm].abs().max())))
    log(f"{tag}: ok {int(okk.sum())}/{Bz} in both ({int(calm.sum())} held: "
        f"alive in float64 too, lanes {SLICE9_DIVERGE} out), X {eX:.2e} and U "
        f"{eU:.2e} of scale (tol {K7B_X_TOL:g}, or 3x the float32 plain "
        f"version's distance from float64: X {pX:.2e}, U {pU:.2e})")
    check(eX < max(K7B_X_TOL, 3 * pX) and eU < max(K7B_X_TOL, 3 * pU),
          f"{tag}: disagrees with the plain version")
    ms_k = cuda_time_ms(lambda: rollout_closed_loop_cuda(model, *ins, dt),
                        reps=20)
    bound_ms, bound_by = bound(
        Bz * (Nk - 1) * mm(cm.m, 1, n)
        + slice9_ops(cm, model, rule, slack, mintime, trips, Bz * (Nk - 1)),
        nbytes(*ins) + nbytes(Xk, Uk, okk))
    log(f"{tag} time per rollout: kernel {ms_k:.4f} ms, plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}"
        + (f" ({trips} Newton trips)" if "implicit" in rule else ""))
    kernel_entry(report, name=f"rollout_closed_loop_{cm.label}",
                 source=f"trajopt_tpu_torch/csrc/rollout_{rule}.cu",
                 replaces="trajopt_tpu/ops/pallas_rollout.py:260",
                 max_abs_err=float((Xk - Xp)[calm].abs().max()), ms=ms_k,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def slice9_forms():
    """(name, slack, mintime, rule) of every K2 form slice 9 checks."""
    from trajopt_tpu_torch.ops.cuda_models import CUDA_STEPS

    forms = []
    for rule in SLICE9_RULES:
        for name in CUDA_STEPS:
            forms.append((name, False, False, rule))
            if name in SLICE9_FORM_MODELS:
                forms += [(name, slack, mintime, rule)
                          for slack, mintime in ((True, False),
                                                 (False, True), (True, True))]
    return forms


def slice9_poison_inputs(rule, dtype, device):
    """The pendulum under ``rule`` and K2's inputs from SLICE9_POISON_X:
    one step of dt = 2, no gains."""
    import torch
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo

    x0 = torch.tensor(SLICE9_POISON_X, dtype=dtype, device=device)
    Bz = x0.shape[0]
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa
    return tt.discretize(zoo.pendulum, rule), [
        x0, x0[:, None].expand(-1, 2, -1).contiguous(), z(Bz, 1, 1),
        z(Bz, 1, 1, 2), z(Bz, 1, 1), torch.ones(Bz, dtype=dtype,
                                                  device=device)]


def slice9_poison_plain(rule):
    """The plain versions of the non-converging step on the CPU, in float32
    and float64 (in a worker process: 1000 Newton trips of a few tiny ops
    each): (ok float32, X float32, ok float64)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    out = []
    for dtype in (torch.float32, torch.float64):
        model, ins = slice9_poison_inputs(rule, dtype, "cpu")
        out.append(rollout_closed_loop(model, *ins, 2.0))
    return out[0][2], out[0][0], out[1][2]


def phase_slice9_kernels(report):
    """Slice 9's K2 forms against ``rollout_closed_loop``: every base model
    under every rule other than RK3, and the slack, minimum-time and
    minimum-time slack forms of SLICE9_FORM_MODELS under every rule
    (``slice9_case``); then the non-converging implicit step, which must
    come out NaN with the problem dead in K2 as in the plain version (whose
    runs go on in worker processes meanwhile)."""
    import torch
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.cuda_models import rule_label

    rules = ("midpoint_implicit", "rk3_implicit")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(rules),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        plain = [pool.submit(slice9_poison_plain, rule) for rule in rules]
        for form in slice9_forms():
            slice9_case(report, *form)
        dev = torch.device("cuda", 0)
        for rule, job in zip(rules, plain):
            model, ins = slice9_poison_inputs(rule, torch.float32, dev)
            x0, Bz = ins[0], ins[0].shape[0]
            Xk, _, okk = rollout_closed_loop_cuda(model, *ins, 2.0)
            okp, Xp, ok64 = job.result()
            tag = (f"K2 {rule_label('pendulum', rule)}: the non-converging "
                   "step at dt = 2")
            log(f"{tag}: alive {okk.tolist()} (plain version {okp.tolist()}, "
                f"float64 {ok64.tolist()}); the benign start's step "
                f"{Xk[-1, 1].tolist()} (plain {Xp[-1, 1].tolist()})")
            check(okk.tolist() == okp.tolist() == ok64.tolist()
                  == [False] * (Bz - 1) + [True], f"{tag}: not poisoned")
            check(torch.equal(Xk[:-1], x0[:-1, None].expand(-1, 2, -1)),
                  f"{tag}: a dead problem did not hold its start")
            check(float((Xk[-1].cpu() - Xp[-1]).abs().max()) < 1e-4,
                  f"{tag}: the benign step disagrees")


def slice9_pendulum(rule, dtype, device=None):
    """tests/test_ilqr.py:36-50 under ``rule``."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.models import zoo

    n, m, N = 2, 1, 31
    xf = np.array([np.pi, 0.0])
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=-3.0, u_max=3.0))
    cons.add(tt.goal_constraint(xf))
    return tt.problem(tt.discretize(zoo.pendulum, rule), tt.LQRObjective(
        np.eye(n) * 1e-3, np.eye(m) * 1e-3, np.eye(n) * 1e-3, xf, N,
        dtype=dtype, device=device), constraints=cons, x0=np.zeros(n),
        xf=xf, N=N, dt=0.15, U0=np.ones((N - 1, m)), dtype=dtype,
        device=device)


def jax_slice9():
    """tools/slice9_gates_jax.jsonl by (rule, type)."""
    path = ROOT / "tools" / "slice9_gates_jax.jsonl"
    return {(d["rule"], d["dtype"]): d
            for d in map(json.loads, path.read_text().splitlines())}


def slice9_job(report):
    """Path 9 in a worker process on the card (``run_worker``): per rule
    the pendulum swing-up pool (``solve_batch``, phase-split on K5 (2, 1)
    and K2 ``pendulum_under_<rule>``), each start's c_max and goal error;
    then the minimum-time ``altro_solve`` under rk3_implicit (K5 (3, 2), K2
    ``pendulum_mintime_under_rk3_implicit``), cut to SLICE9_MINTIME_OUTER
    outer iterations, checked for finite states."""
    import torch
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.cuda_models import rule_label

    pools = {}
    warm = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=2))
    for rule in SLICE9_RULES:
        prob = slice9_pendulum(rule, torch.float32)
        starts = np.random.default_rng(0).normal(size=(1024, 2)) * 0.02
        x0s = torch.as_tensor(starts[:SLICE9_POOL], dtype=torch.float32,
                              device=prob.device)
        res = run_arm(report, f"slice 9 pendulum {rule}", prob,
                      tt.ALOptions(), x0s,
                      ("riccati_sweep_2x1", "rollout_closed_loop_"
                       + rule_label("pendulum", rule)), warm)
        pools[rule] = dict(c_max=res.c_max.tolist(),
                           err=(res.X[:, -1] - prob.xf).norm(dim=-1).tolist())
    opts = mintime_options()
    opts = tt.ALTROOptions(
        opts_al=tt.ALOptions(iterations=SLICE9_MINTIME_OUTER,
                             penalty_scaling=10.0),
        R_minimum_time=opts.R_minimum_time, dt_max=opts.dt_max,
        dt_min=opts.dt_min)
    prob = tt.update_problem(
        mintime_pendulum(torch.float32),
        model=slice9_pendulum("rk3_implicit", torch.float32).model)
    tag = (f"slice 9 the minimum-time pendulum under rk3_implicit, "
           f"{SLICE9_MINTIME_OUTER} outer iterations")
    res, wall, _ = run_counted(report, tag, lambda: tt.altro_solve(
        prob, opts, minimum_time=True), (
            "riccati_sweep_3x2", "rollout_closed_loop_"
            + rule_label("pendulum_mintime", "rk3_implicit")))
    check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite")
    log(f"{tag}: c_max {float(res.c_max):.3e}, tt {float(res.tt):.4f} "
        "(printed, not held: a cut drive)")
    return pools


def slice9_drives_job(report, rules):
    """The launch-only drives of slice 9's other K2 forms, in a worker
    process on the card: per rule of ``rules``, ``solve_batch`` on 2 starts
    of each base
    model's problem (``form_base_problem``) for its plain form, and for
    SLICE9_FORM_MODELS also on the problem's slack (line-seeded),
    minimum-time and minimum-time slack forms (the transforms of
    ``altro_solve``, without its projection: an implicit rule's plain
    projection is a Newton loop a knot on the host); one outer iteration of
    SLICE9_DRIVE_INNER inner ones, ``fused=True`` (which no rule but RK3
    takes: K3, K4, K7a and K7b must not launch). Outcomes are printed, not
    held."""
    import torch
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.cuda_models import CUDA_STEPS, rule_label

    opts = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=SLICE9_DRIVE_INNER, fused=True))
    for rule in rules:
        for name in CUDA_STEPS:
            forms = ((False, False),) + (
                ((True, False), (False, True), (True, True))
                if name in SLICE9_FORM_MODELS else ())
            for slack, mintime in forms:
                prob = form_problem(name, slack, mintime, torch.float32,
                                    rule=rule)
                x0s = prob.x0[None].repeat(2, 1)
                U0s = kuka_hold_seeds(prob, x0s) if name == "kuka" else None
                label = rule_label(form_label(name, slack, mintime), rule)
                tag = f"slice 9 {label} solve_batch, 2 starts"
                res, wall, _ = run_counted(
                    report, tag, lambda: tt.solve_batch(prob, opts, x0s, U0s),
                    (f"riccati_sweep_{prob.n}x{prob.m}",
                     f"rollout_closed_loop_{label}"))
                check(bool(torch.isfinite(res.X).all()), f"{tag}: non-finite")


def phase_slice9(report, job, *drives):
    """Path 9, collected from its worker (``slice9_job``): each rule's
    shares of c_max < 1e-3 and of the goal within 2e-3 at least the JAX
    package's float32 shares on the same starts less GATE_MARGIN; and the
    drives of the other forms (``slice9_drives_job``, the explicit and the
    implicit rules in a worker each)."""
    pools = collect_worker(report, job, "slice 9")
    for each in drives:
        collect_worker(report, each, "slice 9 drives")
    ref = jax_slice9()
    for rule in SLICE9_RULES:
        c = np.array(pools[rule]["c_max"])
        e = np.array(pools[rule]["err"])
        r = ref[rule, "float32"]
        shares = dict(cmax_1e3=float((c < 1e-3).mean()),
                      goal_2e3=float((e < 2e-3).mean()))
        tag = f"slice 9 pendulum {rule}"
        log(f"{tag}: c_max < 1e-3 on {shares['cmax_1e3']:.4f}, the goal "
            f"within 2e-3 on {shares['goal_2e3']:.4f}; median c_max "
            f"{np.median(c):.3e}, goal error {np.median(e):.3e} (the JAX "
            f"package in float32 on the same {r['count']} starts: "
            f"{r['share_cmax_1e3']}, {r['share_goal_2e3']}; gates less "
            f"{GATE_MARGIN})")
        check(shares["cmax_1e3"] >= r["share_cmax_1e3"] - GATE_MARGIN
              and shares["goal_2e3"] >= r["share_goal_2e3"] - GATE_MARGIN,
              f"{tag}: below the JAX package's shares")
        report[tag] = shares


# ------------------------------------------ float64 references on the CPU

def cpu_reference(kind, x0s):
    """A float64 solve by the plain versions on the CPU of the starts
    ``x0s`` (a numpy array), in a worker process beside the GPU phases.
    ``kind``: "slice1" (phase 4's options), "maze" (phase 8's),
    "s6_<pool>" (slice 6's pool ``pool``: path (a) "s6_kuka", path (b)
    "s6_acrobot" and the others of SLICE6_RIG),
    "quadrotor" (slice 3 arms (a) and (b): on the CPU the fused and the
    phase-split solve are the same computation), "cartpole" (arm (c)),
    "escape" (slice 4's ``altro_solve(car_escape())`` with the polish; no
    starts), "escape_pool" (slice 4's pool) or "kuka" (slice 5's
    ``altro_solve(kuka_obstacles())``; no starts)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.parallel.batch import (
        solve_batch, solve_batch_queued, solve_batch_queued_altro_retry)
    from trajopt_tpu_torch.problems import zoo

    t0 = time.perf_counter()
    xs = None if x0s is None else torch.as_tensor(x0s)
    kw = dict(dtype=torch.float64, device="cpu")
    if kind == "slice1":
        ref = solve_batch_queued(zoo.quadrotor_line(N=N, **kw),
                                 bench_options(), xs, lanes=len(x0s))
        out = dict(pos=ref.X[:, -1, :3].numpy())
    elif kind == "maze":
        ref, _ = solve_batch_queued_altro_retry(
            zoo.quadrotor_maze(**kw), maze_options(), xs, lanes=len(x0s),
            infeasible=True, tol=1e-3)
        out = dict(c_max=ref.c_max.tolist(),
                   iterations=ref.iterations_total.tolist())
    elif kind == "quadrotor":
        prob = zoo.quadrotor_line(N=N, **kw)
        ref = solve_batch(prob, tt.ALOptions(), xs)
        out = dict(pos_err=(ref.X[:, -1, :3] - prob.xf[:3]).norm(
            dim=-1).tolist(), iterations=ref.iterations_total.tolist())
    elif kind == "cartpole":
        prob = zoo.cartpole(**kw)
        ref = solve_batch(prob, tt.ALOptions(), xs)
        out = dict(c_max=ref.c_max.tolist(),
                   goal_err=(ref.X[:, -1] - prob.xf).norm(dim=-1).tolist(),
                   outer=ref.iterations.tolist(),
                   iterations=ref.iterations_total.tolist())
    elif kind == "escape":
        prob = zoo.car_escape(**kw)
        r = tt.altro_solve(prob, escape_options(
            resolve_feasible_problem=False, projected_newton=True,
            projected_newton_tolerance=1e-3))
        out = dict(c_max=float(r.c_max), X=r.X.numpy(),
                   goal_err=float((r.X[-1] - prob.xf).norm()),
                   outer=int(r.iterations), inner=int(r.iterations_total))
    elif kind == "kuka":
        prob = zoo.kuka_obstacles(**kw)
        r = tt.altro_solve(prob, kuka_options())
        out = dict(c_max=float(r.c_max), X=r.X.numpy(),
                   goal_err=float((r.X[-1] - prob.xf).norm()),
                   outer=int(r.iterations), inner=int(r.iterations_total))
    elif kind.startswith("s6_"):
        pool = kind[3:]
        if pool == "kuka":
            prob = kuka_free(zoo.kuka_obstacles(**kw))
        else:
            prob = rig_problem(SLICE6_RIG[pool], free=pool.endswith("_free"),
                               **kw)
        ref = solve_batch(prob, slice6_options(pool, True), xs,
                          kuka_hold_seeds(prob, xs) if pool == "kuka"
                          else None)
        q = slice(0, 7) if pool == "kuka" else slice(None)
        out = dict(J=ref.J.tolist(), c_max=ref.c_max.tolist(),
                   err=(ref.X[:, -1, q] - prob.xf[q]).norm(dim=-1).tolist(),
                   iterations=ref.iterations_total.tolist())
    elif kind == "escape_pool":
        ref, _ = solve_batch_queued_altro_retry(
            zoo.car_escape(**kw), escape_options(ctol=1e-3), xs,
            lanes=len(x0s), tol=1e-3)
        out = dict(c_max=ref.c_max.tolist(),
                   iterations=ref.iterations_total.tolist())
    else:
        raise ValueError(kind)
    out["seconds"] = time.perf_counter() - t0
    return out


def start_references(pool, want):
    """Submit the reference solves of the phases in ``want``; returns
    {name: future}."""
    quad_x0 = quad_x0_np()
    jobs = {
        "ref_slice1": ("slice1", "slice1", pool_starts(quad_x0)[:N_REF]),
        "ref_maze": ("maze", "maze",
                     maze_starts(quad_x0, MAZE_POOL)[list(MAZE_REF)]),
        "ref_quadrotor": ("slice3", "quadrotor", pool_starts(quad_x0)[:2]),
        "ref_cartpole": ("slice3", "cartpole",
                         cartpole_starts(np.zeros(4), 2)),
        "ref_escape": ("escape", "escape", None),
        "ref_escape_pool": ("escape_pool", "escape_pool", escape_starts(
            np.array([2.5, 2.5, 0.0]), 2)),
        "ref_kuka": ("kuka", "kuka", None),
    }
    kuka_x0 = np.zeros(14)
    kuka_x0[1:4] = np.pi / 2
    jobs["ref_s6_kuka"] = ("slice6", "s6_kuka",
                           kuka_starts(kuka_x0, SLICE6_REFS["kuka"]))
    for rig_pool in SLICE6_RIG:
        if SLICE6_REFS[rig_pool]:
            jobs[f"ref_s6_{rig_pool}"] = ("slice6", f"s6_{rig_pool}",
                                          cartpole_starts(
                                              np.zeros(4),
                                              SLICE6_REFS[rig_pool]))
    return {name: pool.submit(cpu_reference, kind, x0s)
            for name, (phase, kind, x0s) in jobs.items() if phase in want}


def quad_x0_np():
    """The quadrotor problems' nominal start: 10 m up, level."""
    x0 = np.zeros(13)
    x0[2], x0[3] = 10.0, 1.0
    return x0


def main() -> int:
    if len(sys.argv) > 1:
        print(f"usage: python3 {Path(__file__).name}  (takes no arguments)",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "trajopt_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: trajopt_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    report = {"kernels": [], "smi": nvidia_smi_line()}
    return run_phases(report, None)


PHASES = ("build", "k1", "k2", "slice1", "profile1", "build_report", "k3",
          "k4", "maze", "k5", "k7a", "k7b", "k2full", "almodels", "slice3",
          "escape", "slice4models", "kuka_kernels", "slice7_kernels",
          "slice8_kernels", "slice9_kernels", "rig_kernels", "profile2",
          "profile3", "profile4", "kuka_profile", "kuka", "kuka_slack",
          "slice7", "slice6models", "escape_pool", "kuka_pool", "slice6",
          "slice7_mintime", "slice7_split", "slice8", "slice8_mintime",
          "slice9")


# the kernel phases that run in two worker processes on the card beside the
# main process's phases 6 to 20 (``kernel_phase_job``), started in this
# order once the build is done; ``rig_kernels`` in two jobs, its K7a/K7b
# half then, its AL half after phase 14 (``almodels``), told which K5
# shapes the main process has checked
KERNEL_WORKER_PHASES = ("kuka_kernels", "slice8_kernels", "rig_kernels",
                        "slice7_kernels", "slice9_kernels")


def run_phases(report, only):
    """Run the phases (all of them, or the names in ``only``, for a short
    first check of a new kernel) and print the result lines."""
    global TIMING_LOCK, GPU_PIDS
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.utils.tree import precise_context

    failed = []
    want = PHASES if only is None else only

    def run(name, title, fn, *a):
        if name not in want or failed or any(x is None for x in a):
            return None
        log(f"--- phase: {title}")
        t0 = time.perf_counter()
        try:
            out = fn(*a)
            log(f"--- phase {title}: {time.perf_counter() - t0:.1f} s")
            return True if out is None else out
        except Exception:
            traceback.print_exc()
            failed.append(title)
            log(f"--- phase {title}: FAILED")
            return None

    spawn = multiprocessing.get_context("spawn")
    # the float64 reference solves run on the CPU in worker processes while
    # the GPU phases go on; each phase that needs one waits for it
    workers = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=spawn)
    # the kernel phases of KERNEL_WORKER_PHASES, two at a time beside the
    # main process; a kernel is timed with the other two stopped
    # (``timing_turn``)
    TIMING_LOCK = spawn.Lock()
    GPU_PIDS = spawn.Array("i", 3, lock=False)
    GPU_PIDS[0] = os.getpid()
    kernel_workers = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=spawn, initializer=init_kernel_worker,
        initargs=(TIMING_LOCK, GPU_PIDS, T0))
    # the host-bound paths on the card, a worker process each, all started
    # at once after the kernel phases: slice 7's path (a) in three
    # (``mintime_job``), slice 8's path (b) (``mintime_rig_job``), and
    # through ``run_worker`` slice 4's pool, the kuka pool, slice 6's paths
    # (in two), slice 7's phase-split arms, slice 8's path (a), slice 9's
    # path and its drives (in two)
    gpu_workers = concurrent.futures.ProcessPoolExecutor(
        max_workers=14, mp_context=spawn)
    jobs7 = job8 = None
    jobs, kjobs = {}, {}

    def kernel_job(name, phase, *a):
        kjobs.setdefault(name, []).append(kernel_workers.submit(
            run_worker, "kernel_phase_job", phase, *a))

    try:
        # (slice 3's start once the host-bound slice 1 has been timed)
        early = [p for p in ("slice1", "maze", "kuka") if p in want]
        refs = start_references(workers, early)
        with precise_context():
            run("build", "device and build", phase_build, report)
            lin = run("k1", "K1 vs twin", phase_k1, report)
            run("k2", "K2 vs twin", phase_k2, report, lin)
            run("slice1", "slice 1", phase_slice, report, refs)
            run("profile1", "profile of slice 1", phase_profile, report)
            run("build_report", "the build's report", phase_build_report,
                report)
            if not failed:
                refs.update(start_references(
                    workers, [p for p in ("slice3", "escape", "escape_pool",
                                          "slice6") if p in want]))
                if any(p in want for p in KERNEL_WORKER_PHASES):
                    _build.build()      # every library in place first
                for name in KERNEL_WORKER_PHASES:
                    if name in want:
                        kernel_job(name, "rig_fused_kernels"
                                   if name == "rig_kernels" else name)
            maze = run("k3", "K3 vs plain version", phase_k3, report)
            run("k4", "K4 vs plain version", phase_k4, report, maze)
            run("maze", "slice 2 (maze)", phase_maze, report, refs)
            run("k5", "K5 vs plain version", phase_k5, report, lin)
            setups = run("k7a", "K7a vs plain version and K5", phase_k7a,
                         report)
            run("k7b", "K7b vs plain version", phase_k7b, report, setups)
            run("k2full", "K2 full-state instantiations", phase_k2_full,
                report, setups, maze)
            run("almodels", "K3, K4 (and K2, K5 with slacks) for every "
                "model vs plain versions", phase_al_models, report)
            if "rig_kernels" in kjobs and not failed:
                kernel_job("rig_kernels", "rig_al_kernels",
                           [k["name"] for k in report["kernels"]])
            run("slice3", "slice 3", phase_slice3, report, refs)
            run("escape", "slice 4: altro_solve(car_escape)", phase_escape,
                report, refs)
            run("slice4models", "slice 4: the other instantiations",
                phase_slice4_models, report)
            for name, title in (
                    ("kuka_kernels", "slice 5: every kuka instantiation "
                     "against its plain version"),
                    ("slice7_kernels", "slice 7: K2's new forms and K3/K4 on "
                     "quad_obs's stack against their plain versions"),
                    ("slice8_kernels", "slice 8: K2's new forms against "
                     "their plain versions"),
                    ("slice9_kernels", "slice 9: K2 under every other "
                     "integrator against its plain versions"),
                    ("rig_kernels", "slice 6: K7a/K7b for kuka and the "
                     "rigs, K2-K5 for the rigs, against their plain "
                     "versions")):
                run(name, title + " (collected from a kernel worker)",
                    collect_kernel_worker, report, kjobs.get(name), name)
            TIMING_LOCK = GPU_PIDS = None   # the kernel workers are done
            # the profiles once no kernel worker runs beside them
            run("profile2", "profile of slice 2", phase_maze_profile, report)
            run("profile3", "profile of slice 3", phase_slice3_profile,
                report)
            run("profile4", "profile of slice 4", phase_escape_profile,
                report)
            run("kuka_profile", "profile of slice 5", phase_kuka_profile,
                report)
            # the host-bound paths in worker processes from here on, side
            # by side: after every phase that times a kernel or profiles a
            # round
            if not failed:
                submit = gpu_workers.submit
                if "slice7_mintime" in want:
                    jobs7 = {False: [submit(mintime_job, False,
                                            slice(0, 9))],
                             True: [submit(mintime_job, True, part)
                                    for part in (slice(0, 5), slice(5, 9))]}
                if "slice8_mintime" in want:
                    job8 = submit(mintime_rig_job)
                for name, fn, *args in (
                        ("escape_pool", "escape_pool_job"),
                        ("kuka_pool", "phase_kuka_pool"),
                        ("slice6", "slice6_job", SLICE6_SPLIT[0]),
                        ("slice6", "slice6_job", SLICE6_SPLIT[1]),
                        ("slice7_split", "slice7_split_job"),
                        ("slice8", "slice8_job"),
                        ("slice9", "slice9_job"),
                        ("slice9", "slice9_drives_job", SLICE9_RULES[:3]),
                        ("slice9", "slice9_drives_job", SLICE9_RULES[3:])):
                    if name in want:
                        jobs.setdefault(name, []).append(
                            submit(run_worker, fn, *args))
            run("kuka", "slice 5: altro_solve(kuka_obstacles)", phase_kuka,
                report, refs)
            run("kuka_slack", "slice 5: the kuka slack instantiations",
                phase_kuka_slack, report)
            run("slice7", "slice 7: quad_obs fused and the other forms",
                phase_slice7, report)
            run("slice6models", "slice 6: the rigs' other instantiations",
                phase_slice6_models, report)
            run("escape_pool", "slice 4: the car_escape pool and its polish",
                phase_escape_pool, report, refs,
                jobs.get("escape_pool", [None])[0])
            run("kuka_pool", "slice 5: the kuka pool, both arms",
                collect_worker, report, jobs.get("kuka_pool", [None])[0],
                "kuka pool")
            run("slice6", "slice 6: the unconstrained kuka and the rigs, "
                "fused and phase-split", phase_slice6, report, refs,
                jobs.get("slice6"))
            run("slice7_mintime", "slice 7: the minimum-time pendulum",
                phase_slice7_mintime, report, jobs7)
            run("slice7_split", "slice 7: the phase-split arms",
                phase_slice7_split, report,
                jobs.get("slice7_split", [None])[0])
            run("slice8", "slice 8: the two-link pools and the other "
                "forms", phase_slice8, report, jobs.get("slice8", [None])[0])
            run("slice8_mintime", "slice 8: the minimum-time double-pendulum "
                "rig", phase_slice8_mintime, report, job8)
            run("slice9", "slice 9: the pendulum under every integrator and "
                "the other forms' drives", phase_slice9, report,
                *(jobs.get("slice9") or [None]))
    finally:
        workers.shutdown(wait=True, cancel_futures=True)
        kernel_workers.shutdown(wait=True, cancel_futures=True)
        gpu_workers.shutdown(wait=True, cancel_futures=True)
        TIMING_LOCK = GPU_PIDS = None
    idle = [k["name"] for k in report["kernels"] if not k.get("launches")]
    if only is None and not failed and idle:
        log(f"chip_smoke: no main path launched {idle}")
        failed.append("launch counts")
    if failed:
        log(json.dumps({k: v for k, v in report.items() if k != "smi"}))
        log("chip_smoke: failed phases", failed)
        return 1
    # the result lines, unstamped: the kernels, the card, and the last line
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(report["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
