#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``trajopt_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # about two minutes on one H100

Phases, each of which must pass:

1. device and build: the card's name and power limit from ``nvidia-smi``,
   TF32 off (``precise``), the CUDA kernels built from ``csrc/`` by nvcc
   (ptxas's register and spill report printed), and each wrapper refusing
   a float64 CUDA input;
2. kernel K1 (``csrc/sqrt_sweep.cu``) against its plain twin on the card,
   float32, at the main path's shapes (B=128, N=101, error state n=12,
   m=4), on error-state linearizations of ``quadrotor_line`` around 128
   perturbed starts, for rho in {0, 1e-2}; at rho = 0 one problem needs
   the equilibrated Cholesky fallback and one fails outright;
3. kernel K2 (``csrc/rollout_quadrotor.cu``) against its plain twin on the
   card, float32, B=128, N=101, with two lanes forced to diverge, and on
   stiff gains against the twin in float64;
4. the slice: ``solve_batch_queued`` on ``quadrotor_line(N=101)`` in float32
   with the quadrotor benchmark's options, a pool of 1024 perturbed starts
   over 128 lanes. Both kernels' launch counters must move, the outcome
   bars must hold, and the first problems of the pool must agree with a
   float64 solve of the same problems by the plain twins on the CPU;
5. profile: one round of 6 iLQR iterations on 128 lanes, timed plainly and
   then under ``torch.profiler``: device busy share, launches and host
   syncs per iteration, and the kernels that take the device time.

The last two lines of standard output are the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``; the line before them is a JSON summary of
the kernels. Without a CUDA device, or without the package beside this
script, it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
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
B, N, POOL = 128, 101, 1024
GOAL = (0.0, 60.0, 10.0)
# small-input agreement with the CPU float64 twins: problems and the bar on
# their final positions
N_REF, REF_TOL = 8, 1e-2
# K1's branch problems (phase 2, rho = 0): (lane, knot) of a stage whose
# control Hessian is made mildly indefinite, so the plain float32 factor
# breaks down and the equilibrated one succeeds on its pivot floor, and of
# one made strongly indefinite, so both break down and the problem fails
EQ_AT, FAIL_AT = (5, 7), (9, 12)
# the kernel's rollout error against the twin in float64 on stiff gains,
# at most this multiple of the float32 twin's (phase 3)
STIFF_RATIO = 1.5


def log(*a):
    print(*a, flush=True)


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


def cuda_time_ms(fn, reps, warmup=2):
    """Mean device time of one call: CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def linearization(x0s):
    """Error-state linearizations of quadrotor_line (N=101) around the
    open-loop rollouts from the starts ``x0s`` (B, 13) under the hover
    seed, computed in float64 on the card. Returns the float32 sweep
    inputs (A, B, lx, lu, lxx, luu, lux), the rollouts X, the controls U
    and dt."""
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
    A, Bm, exp = project_error_state(X, A, Bm, exp, (3, 7))
    f32 = [t.float().contiguous() for t in
           (A, Bm, exp.x, exp.u, exp.xx, exp.uu, exp.ux)]
    return f32, X.float().contiguous(), U.float().contiguous(), prob.dt


def quad_x0():
    from trajopt_tpu_torch.problems.zoo import quadrotor_line

    return quadrotor_line(N=N).x0.numpy()


def indefinite(luu, at, off):
    """Replace the control Hessian of stage ``at`` = (lane, knot) by
    c·[[1, off], [off, 1]] ⊕ c·I (tests/test_torch_sqrt.py): indefinite for
    off > 1, with eigenvalue c·(1 − off)."""
    import torch

    c = luu[at][0, 0]
    M = c * torch.eye(4, dtype=luu.dtype, device=luu.device)
    M[0, 1] = M[1, 0] = c * off
    luu[at] = M


def phase_build(report):
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.models import zoo
    from trajopt_tpu_torch.models.base import Model, discretize
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
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if line.strip():
            log("nvcc:", line.strip())

    dev = torch.device("cuda", 0)
    z = lambda *s: torch.zeros(s, dtype=torch.float64, device=dev)  # noqa
    for name, call in (
            ("sqrt_sweep_cuda", lambda: sqrt_sweep_cuda(
                z(2, 3, 12, 12), z(2, 3, 12, 4), z(2, 4, 12), z(2, 3, 4),
                z(2, 4, 12, 12), z(2, 3, 4, 4), z(2, 3, 4, 12), z(2))),
            ("rollout_closed_loop_cuda", lambda: rollout_closed_loop_cuda(
                discretize(zoo.quadrotor, "rk3"), z(2, 13), z(2, 4, 13),
                z(2, 3, 4), z(2, 3, 4, 12), z(2, 3, 4), z(2), 0.05,
                quat_slice=(3, 7)))):
        try:
            call()
        except ValueError as e:
            log(f"{name}: float64 CUDA input refused ({e})")
        else:
            raise AssertionError(f"{name} accepted a float64 CUDA input")
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa
    other = discretize(Model(zoo.quadrotor_dynamics, 13, 4, name="custom"),
                       "rk3")
    try:
        rollout_closed_loop_cuda(other, f(2, 13), f(2, 4, 13), f(2, 3, 4),
                                 f(2, 3, 4, 12), f(2, 3, 4), f(2), 0.05,
                                 quat_slice=(3, 7))
    except NotImplementedError as e:
        log(f"rollout_closed_loop_cuda: model without a CUDA step refused "
            f"({e})")
    else:
        raise AssertionError("a model without a CUDA step was accepted")


def phase_k1(report):
    """K1 on the recipe of tests/test_pallas.py: open-loop rollouts from
    starts with 0.02 noise on every state entry, with two stages made
    indefinite (``EQ_AT``, ``FAIL_AT``) so that the kernel's equilibrated
    fallback and its fail branch run."""
    import torch
    from trajopt_tpu_torch.ops.cost import Expansion
    from trajopt_tpu_torch.ops.cuda_sqrt import (
        equilibrated_chol_upper, plain_chol_upper, sqrt_sweep,
        sqrt_sweep_cuda)

    rng = np.random.default_rng(3)
    lin = linearization(quad_x0()[None] + rng.normal(size=(B, 13)) * 0.02)
    (A, Bm, lx, lu, lxx, luu, lux), _, _, _ = lin
    check(A.shape == (B, N - 1, 12, 12) and Bm.shape == (B, N - 1, 12, 4),
          "K1 input shapes")
    luu = luu.clone()
    indefinite(luu, EQ_AT, 1.0 + 2e-4)
    indefinite(luu, FAIL_AT, 1.5)
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
        K1, d1, v11, v21, f1 = sqrt_sweep_cuda(A, Bm, lx, lu, lxx, luu, lux,
                                               rho)
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
    rho = torch.zeros(B, device=A.device)
    ms = cuda_time_ms(lambda: sqrt_sweep_cuda(A, Bm, lx, lu, lxx, luu, lux,
                                              rho), reps=20)
    plain_ms = cuda_time_ms(lambda: sqrt_sweep(A, Bm, exp, rho), reps=3,
                            warmup=1)
    log(f"K1 time per sweep: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    report["kernels"].append(dict(
        name="sqrt_sweep", route="cuda",
        source="trajopt_tpu_torch/csrc/sqrt_sweep.cu",
        replaces="trajopt_tpu/ops/pallas_sqrt.py:321", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms))
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
        pool_starts(quad_x0())[:B])
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
    report["kernels"].append(dict(
        name="rollout_closed_loop_quadrotor", route="cuda",
        source="trajopt_tpu_torch/csrc/rollout_quadrotor.cu",
        replaces="trajopt_tpu/ops/pallas_rollout.py:260",
        max_abs_err=max(eX, eU), ms=ms, plain_ms=plain_ms))

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


def phase_slice(report):
    import torch
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued
    from trajopt_tpu_torch.problems.zoo import quadrotor_line
    import trajopt_tpu_torch as tt

    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=N, dtype=torch.float32, device=dev)
    x0s_np = pool_starts(prob.x0.cpu())
    x0s = torch.as_tensor(x0s_np, dtype=torch.float32, device=dev)
    opts = bench_options()
    goal = torch.tensor(GOAL, device=dev)

    # warm-up: one short round (library handles, allocator), not timed
    warm = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=2, error_state=True, bp_type="sqrt"))
    solve_batch_queued(prob, warm, x0s[:B], lanes=B)
    torch.cuda.synchronize()

    sqrt_sweep_cuda.launches = 0
    rollout_closed_loop_cuda.launches = 0
    t0 = time.perf_counter()
    res = solve_batch_queued(prob, opts, x0s, lanes=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sqrt_sweep": sqrt_sweep_cuda.launches,
                "rollout_closed_loop_quadrotor":
                    rollout_closed_loop_cuda.launches}
    log(f"slice: launches {launches}")
    for k in report["kernels"]:
        k["launches"] = launches[k["name"]]
    check(all(v > 0 for v in launches.values()), "a kernel never launched")

    check(res.X.shape == (POOL, N, 13) and res.U.shape == (POOL, N - 1, 4),
          "slice output shapes")
    check(bool(torch.isfinite(res.X).all()), "non-finite final states")
    perr = (res.X[:, -1, :3] - goal).norm(dim=-1).cpu().numpy()
    conv = float(np.mean(perr < 0.5))
    conv_ref = float(np.mean(perr < 5e-3))
    med = float(np.median(perr))
    its = res.iterations_total.float().mean().item()
    log(f"slice: {POOL} problems over {B} lanes in {wall:.3f} s = "
        f"{POOL / wall:.2f} solves/s | rounds {res.rounds}, host syncs "
        f"{res.host_syncs} ({res.host_syncs / res.rounds:.2f} per round)")
    log(f"slice: converged_frac(<0.5 m) {conv:.4f}, "
        f"converged_frac_ref_tol(<5e-3 m) {conv_ref:.4f}, "
        f"median final pos err {med:.3e} m, mean iterations_total {its:.2f}")
    report["slice"] = dict(
        solves_per_s=POOL / wall, wall_s=wall, rounds=res.rounds,
        host_syncs=res.host_syncs, converged_frac=conv,
        converged_frac_ref_tol=conv_ref, median_final_pos_err_m=med,
        mean_iterations_total=its)
    check(conv >= 0.98, "fewer than 98% of the pool within 0.5 m")
    check(med < 5e-3, "median final position error above 5e-3 m")

    # the same first problems, solved in float64 by the plain twins on the
    # CPU (the path the CPU tests hold to the JAX package)
    t0 = time.perf_counter()
    prob64 = quadrotor_line(N=N, dtype=torch.float64)
    ref = solve_batch_queued(prob64, opts, torch.as_tensor(x0s_np[:N_REF]),
                             lanes=N_REF)
    p_ref = ref.X[:, -1, :3].numpy()
    p_gpu = res.X[:N_REF, -1, :3].double().cpu().numpy()
    dp = np.linalg.norm(p_gpu - p_ref, axis=-1)
    log(f"reference: first {N_REF} problems in float64 on the CPU "
        f"({time.perf_counter() - t0:.1f} s): |p_gpu - p_cpu| max "
        f"{dp.max():.3e} m, median {np.median(dp):.3e} m (bar {REF_TOL:g})")
    check(np.median(dp) < REF_TOL, "the card disagrees with the CPU twins")


def phase_profile(report):
    """Where one round's time goes: one AL round of 6 iLQR iterations on the
    first 128 pool problems (warmed up), timed plainly, then again under
    torch.profiler. The busy share is the union of the device's kernel and
    copy intervals in the profiled run over the plain run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda
    from trajopt_tpu_torch.parallel.batch import solve_batch_queued
    from trajopt_tpu_torch.problems.zoo import quadrotor_line
    import trajopt_tpu_torch as tt

    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=N, dtype=torch.float32, device=dev)
    x0s = torch.as_tensor(pool_starts(prob.x0.cpu())[:B],
                          dtype=torch.float32, device=dev)
    iters = 6
    opts = tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
        iterations=iters, error_state=True, bp_type="sqrt"))

    def one_round():
        res = solve_batch_queued(prob, opts, x0s, lanes=B)
        torch.cuda.synchronize()
        return res

    one_round()
    k1, k2 = sqrt_sweep_cuda.launches, rollout_closed_loop_cuda.launches
    t0 = time.perf_counter()
    res = one_round()
    wall = time.perf_counter() - t0
    k1 = sqrt_sweep_cuda.launches - k1
    k2 = rollout_closed_loop_cuda.launches - k2
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()
    wall_prof = time.perf_counter() - t0
    log(f"profile: one round of {iters} iterations on {B} lanes: "
        f"{wall * 1e3:.1f} ms plain ({wall_prof * 1e3:.1f} ms profiled), "
        f"K1 {k1} and K2 {k2} launches, {res.host_syncs} host syncs")
    dev_evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_evts:
        log("profile: device time not measured (no device events traced)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_evts)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy = (busy + hi - lo) / 1e3  # ms
    by_name = {}
    for e in dev_evts:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    total = sum(t for t, _ in by_name.values())
    log(f"profile: device busy {busy:.1f} ms of {wall * 1e3:.1f} ms plain "
        f"wall = busy share {busy / (wall * 1e3):.3f}, idle share "
        f"{1 - busy / (wall * 1e3):.3f}; {len(dev_evts)} device launches "
        f"= {len(dev_evts) / iters:.0f} per iteration, "
        f"{res.host_syncs / iters:.1f} host syncs per iteration")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"profile:   {100 * t / total:5.1f}% of device time, {c:5d} x "
            f"{1e3 * t / c:8.1f} us  {name[:90]}")


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
    from trajopt_tpu_torch.utils.tree import precise_context

    report = {"kernels": [], "smi": nvidia_smi_line()}
    failed = []

    def run(name, fn, *a):
        log(f"--- phase: {name}")
        try:
            return fn(*a)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"--- phase {name}: FAILED")
            return None

    with precise_context():
        run("device and build", phase_build, report)
        if not failed:
            lin = run("K1 vs twin", phase_k1, report)
            if lin is not None:
                run("K2 vs twin", phase_k2, report, lin)
        if not failed:
            run("slice", phase_slice, report)
        if not failed:
            run("profile", phase_profile, report)
    if failed:
        log(json.dumps({k: v for k, v in report.items() if k != "smi"}))
        log("chip_smoke: failed phases", failed)
        return 1
    log(json.dumps({"kernels": report["kernels"]}))
    log(report["smi"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
