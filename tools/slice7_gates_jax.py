#!/usr/bin/env python3
"""Outcome bars for slice 7 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice7_gates_jax.py [--write]
        [--dtype=float64] [count [pool...]]
    JAX_PLATFORMS=cpu python tools/slice7_gates_jax.py --spread

Solves the starts that ``chip_smoke.py`` drives in its slice-7 phase with
the JAX package ``trajopt_tpu`` in float32 (or, with ``--dtype=float64``,
in float64) on the CPU and prints one JSON line per pool with the shares the
port's GPU run is held to (less a margin, see ``chip_smoke.py``). Pools
(all by default):

- ``mintime``, ``mintime_line``: ``altro_solve(minimum_time=True)`` on the
  minimum-time pendulum of tests/test_altro.py:64-82 (N = 31, dt = 0.075,
  |u| ≤ 5, the reference test's options) from its own start and 8 starts
  perturbed by N(0, 0.05²) on both states (seed 0), one solve per start;
  ``mintime_line`` seeds every start with the straight line to the goal
  (the infeasible arm). Each start's total time tt, c_max, goal error in
  the ∞-norm, and the share that meets every bar of the reference test
  (tt < 0.5·4.5, tt < 1, goal within 1e-3, c_max < 1e-3). ``count`` does
  not apply: always the 9 starts.
- ``quad_obs``: ``solve_batch`` on the first ``count`` (default 16) of 128
  starts of ``quad_obs()`` with the position perturbed by N(0, 0.1²)
  (seed 0), ``ALOptions()``; ``quad_obs_cut`` the same at the cut depth
  ``CUT_DEPTH`` (outer iterations, inner cap) at which ``chip_smoke.py``
  drives the phase-split arm; ``quadrotor_line_con_cut``: the same on
  ``quadrotor_line(N=101, constrained=True)`` at the cut depth. The shares
  with c_max < 1e-3 and < 1e-2, and of final positions within 0.5 m and
  5 cm of the goal.

With ``--write`` each pool's line replaces that pool's line of the same
type in ``tools/slice7_gates_jax.jsonl``, which ``chip_smoke.py`` reads.
``--spread`` solves the float64 minimum-time pendulum (both arms) from x0
moved by k·(1e-13, −1e-13), k = 0..7, and prints each total time: how far
rounding alone moves the reference's result (the tolerance of
tests/test_torch_altro.py and tests/test_torch_mintime.py).
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import trajopt_tpu as tt  # noqa: E402
from trajopt_tpu.models import zoo as mzoo  # noqa: E402
from trajopt_tpu.parallel.batch import solve_batch  # noqa: E402
from trajopt_tpu.problems import zoo  # noqa: E402
from trajopt_tpu.solvers import altro as alt  # noqa: E402
from trajopt_tpu.utils.interp import line_trajectory  # noqa: E402

GATES = Path(__file__).resolve().parent / "slice7_gates_jax.jsonl"
QUAD_POOL = 128
MINTIME_STARTS = 9
# the cut depth of the phase-split arms: (outer iterations, inner cap) of
# ALOptions()'s (30, 300)
CUT_DEPTH = (10, 30)


def mintime_problem(dtype, line):
    """tests/test_altro.py:15-26 with dt = 0.075, |u| ≤ 5."""
    N, n, m = 31, 2, 1
    xf = np.array([np.pi, 0.0])
    obj = tt.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                          np.eye(n) * 1e-3, xf, N)
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=-5.0, u_max=5.0))
    cons.add(tt.goal_constraint(xf))
    p = tt.problem(tt.discretize(mzoo.pendulum, "rk3"), obj,
                   constraints=cons, x0=np.zeros(n), xf=xf, N=N, dt=0.075,
                   U0=np.ones((N - 1, m)), dtype=dtype)
    if line:
        p = tt.initial_states(p, line_trajectory(np.zeros(n), xf, N))
    return p


def mintime_options():
    """tests/test_altro.py:66-68."""
    return alt.ALTROOptions(opts_al=tt.ALOptions(iterations=50,
                                                 penalty_scaling=10.0),
                            R_minimum_time=15.0, dt_max=0.15, dt_min=1e-3)


def mintime_starts():
    """The nominal start and 8 perturbed by N(0, 0.05²) (seed 0)."""
    rng = np.random.default_rng(0)
    return np.concatenate([np.zeros((1, 2)),
                           rng.normal(size=(MINTIME_STARTS - 1, 2)) * 0.05])


def quad_starts(x0, count):
    """128 starts with the position perturbed by N(0, 0.1²) (seed 0)."""
    rng = np.random.default_rng(0)
    noise = np.concatenate([rng.normal(size=(QUAD_POOL, 3)) * 0.1,
                            np.zeros((QUAD_POOL, 10))], axis=1)
    return (np.asarray(x0, np.float64)[None] + noise)[:count]


def mintime_bars(tt_mt, goal, c_max):
    """Every bar of tests/test_altro.py:64-82, per start."""
    return (tt_mt < 0.5 * 0.15 * 30) & (tt_mt < 1.0) & (goal < 1e-3) \
        & (c_max < 1e-3)


def run_mintime(name, dtype):
    prob = mintime_problem(dtype, name == "mintime_line")
    opts = mintime_options()
    rows = []
    t0 = time.perf_counter()
    for x0 in mintime_starts():
        p = tt.update_problem(prob, x0=jnp.asarray(x0, dtype),
                              X=prob.X.at[0].set(jnp.asarray(x0, dtype)))
        r = alt.altro_solve(p, opts, minimum_time=True)
        X = np.asarray(r.X, np.float64)
        rows.append((float(r.tt), float(r.c_max),
                     float(np.abs(X[-1] - [np.pi, 0.0]).max()),
                     int(r.iterations_total)))
    tt_mt, c, goal, its = (np.array(v) for v in zip(*rows))
    return dict(share_bars=float(np.mean(mintime_bars(tt_mt, goal, c))),
                tt=tt_mt.tolist(), c_max=c.tolist(), goal_err=goal.tolist(),
                iterations=its.tolist(), median_tt=float(np.median(tt_mt)),
                seconds=time.perf_counter() - t0)


def run_quad(name, dtype, count):
    prob = zoo.quad_obs(dtype=dtype) if name.startswith("quad_obs") else \
        zoo.quadrotor_line(N=101, constrained=True, dtype=dtype)
    opts = tt.ALOptions()
    if name.endswith("_cut"):
        opts = tt.ALOptions(iterations=CUT_DEPTH[0], opts_uncon=(
            tt.iLQROptions(iterations=CUT_DEPTH[1])))
    t0 = time.perf_counter()
    res = solve_batch(prob, opts,
                      jnp.asarray(quad_starts(prob.x0, count), dtype))
    X = np.asarray(res.X, np.float64)
    err = np.linalg.norm(X[:, -1, :3] - np.asarray(prob.xf[:3]), axis=-1)
    c = np.asarray(res.c_max, np.float64)
    return dict(share_cmax_1e3=float(np.mean(c < 1e-3)),
                share_cmax_1e2=float(np.mean(c < 1e-2)),
                share_pos_0p5=float(np.mean(err < 0.5)),
                share_pos_5cm=float(np.mean(err < 5e-2)),
                median_cmax=float(np.median(c)),
                median_pos_err=float(np.median(err)),
                c_max=[float(f"{v:.4g}") for v in c],
                pos_err=[float(f"{e:.4g}") for e in err],
                iterations=np.asarray(res.iterations_total).tolist(),
                seconds=time.perf_counter() - t0)


def write(line):
    """Replace the pool's line of the same type in GATES (keeping the
    others)."""
    def key(x):
        d = json.loads(x)
        return d["pool"], d["dtype"]

    lines = GATES.read_text().splitlines() if GATES.exists() else []
    lines = [x for x in lines if key(x) != key(line)] + [line]
    GATES.write_text("\n".join(lines) + "\n")


def spread():
    jax.config.update("jax_enable_x64", True)
    for name in ("mintime", "mintime_line"):
        prob = mintime_problem(jnp.float64, name == "mintime_line")
        out = []
        for k in range(8):
            x0 = np.array([1e-13 * k, -1e-13 * k])
            p = tt.update_problem(prob, x0=jnp.asarray(x0),
                                  X=prob.X.at[0].set(jnp.asarray(x0)))
            out.append(float(alt.altro_solve(p, mintime_options(),
                                             minimum_time=True).tt))
        print(json.dumps(dict(pool=name, spread_tt=out, low=min(out),
                              high=max(out))), flush=True)


def main():
    args = sys.argv[1:]
    jax.config.update("jax_platforms", "cpu")
    if "--spread" in args:
        return spread()
    save = "--write" in args
    wide = "--dtype=float64" in args
    args = [a for a in args if a != "--write" and not a.startswith("--dtype")]
    count = int(args[0]) if args else 16
    pools = args[1:] or ["mintime", "mintime_line", "quad_obs",
                         "quad_obs_cut", "quadrotor_line_con_cut"]
    if wide:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if wide else jnp.float32
    for name in pools:
        out = dict(pool=name, dtype=jnp.dtype(dtype).name)
        if name.startswith("mintime"):
            out.update(count=MINTIME_STARTS, **run_mintime(name, dtype))
        else:
            out.update(count=count, **run_quad(name, dtype, count))
        print(json.dumps(out), flush=True)
        if save:
            write(json.dumps(out))


if __name__ == "__main__":
    main()
