#!/usr/bin/env python3
"""Outcome bars for slice 8 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice8_gates_jax.py [--write]
        [--dtype=float64] [count [pool...]]

Solves the starts that ``chip_smoke.py`` drives in its slice-8 phase with
the JAX package ``trajopt_tpu`` in float32 (or, with ``--dtype=float64``,
in float64) on the CPU and prints one JSON line per pool with the shares
the port's GPU run is held to (less a margin, see ``chip_smoke.py``).
Pools (all by default):

- ``doublependulum``: the analytic double pendulum on
  ``doublependulum_problem()`` (N = 101, dt = 0.01, unconstrained),
  ``ALOptions()``, ``solve_batch`` on the first ``count`` (default 16) of
  the starts with 0.02 noise on every state entry (seed 0, the first of
  1024, slice 3's cartpole pool and slice 6's rig pools); the shares of
  terminal errors ‖x_N − x_f‖ within 1e-1, 3e-2, 1e-2 and 1e-3;
- ``acrobot``: the analytic acrobot on ``acrobot_problem()`` (N = 151,
  dt = 0.01, the goal constraint), the same options and starts; also the
  share with c_max < 1e-3;
- ``dp_rig_mintime``: ``altro_solve(minimum_time=True)`` on
  ``doublependulum_problem()`` with the ``doublependulum_urdf`` rig's model,
  the control box |u| ≤ U_MAX and the goal constraint added (as
  tests/test_altro.py:64-82 adds them to the pendulum), the options of
  ``mintime_options`` (R_minimum_time and dt_max chosen so that the
  float64 solve from the nominal start meets the bars below: U_MAX = 20,
  dt_max = 0.02, R_minimum_time = 10 took tt 0.969 s, c_max 9.7e-6, 140
  inner iterations; R_minimum_time = 1 took 1.31 s, 386), from the
  nominal start and 7 starts with N(0, 0.02²) on every state entry (seed
  0), one solve per start; ``count`` does not apply. Each start's total
  time, c_max and goal error in the ∞-norm, and the share that meets
  c_max < 1e-3 and the goal within 1e-3.

With ``--write`` each pool's line replaces that pool's line of the same
type in ``tools/slice8_gates_jax.jsonl``, which ``chip_smoke.py`` reads
(there: 128 starts of each two-link pool in float32, and of the acrobot in
float64 too; the minimum-time rig in both types).
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
from trajopt_tpu.models import robots  # noqa: E402
from trajopt_tpu.parallel.batch import solve_batch  # noqa: E402
from trajopt_tpu.problems import zoo  # noqa: E402
from trajopt_tpu.solvers import altro as alt  # noqa: E402

POOL = 1024
GATES = Path(__file__).resolve().parent / "slice8_gates_jax.jsonl"
# the minimum-time rig: its control box, its starts
U_MAX = 20.0
MINTIME_STARTS = 8


def two_link_pool(x0, count):
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    return (x0[None] + rng.normal(size=(POOL, x0.shape[0])) * 0.02)[:count]


def mintime_starts():
    """The nominal start (at rest, hanging down) and 7 with N(0, 0.02²) on
    every state entry (seed 0)."""
    rng = np.random.default_rng(0)
    return np.concatenate([np.zeros((1, 4)),
                           rng.normal(size=(MINTIME_STARTS - 1, 4)) * 0.02])


def mintime_problem(dtype):
    """``doublependulum_problem()`` with the rig's model, |u| ≤ U_MAX and
    the goal constraint."""
    p = zoo.doublependulum_problem(dtype=dtype)
    model = tt.discretize(robots.doublependulum_urdf_model(), "rk3")
    n, m, N = 4, 2, p.N
    xf = np.array([np.pi, 0.0, 0.0, 0.0])
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=-U_MAX, u_max=U_MAX))
    cons.add(tt.goal_constraint(xf))
    return tt.problem(model, p.obj, constraints=cons, x0=np.zeros(n), xf=xf,
                      N=N, dt=0.01, U0=np.ones((N - 1, m)), dtype=dtype)


def mintime_options():
    return alt.ALTROOptions(opts_al=tt.ALOptions(iterations=30,
                                                 penalty_scaling=10.0),
                            R_minimum_time=10.0, dt_max=0.02, dt_min=1e-3)


def shares(err, bars=(1e-1, 3e-2, 1e-2, 1e-3)):
    return {f"within_{b:g}": float(np.mean(err < b)) for b in bars}


def run_two_link(name, dtype, count):
    prob = getattr(zoo, f"{name}_problem")(dtype=dtype)
    x0s = two_link_pool(prob.x0, count)
    t0 = time.perf_counter()
    res = solve_batch(prob, tt.ALOptions(), jnp.asarray(x0s, dtype))
    X = np.asarray(res.X, np.float64)
    err = np.linalg.norm(X[:, -1] - np.asarray(prob.xf, np.float64), axis=-1)
    c = np.asarray(res.c_max, np.float64)
    J = np.asarray(res.J, np.float64)
    return dict(share_cmax_1e3=float(np.mean(c < 1e-3)),
                goal_err=shares(err), median_err=float(np.median(err)),
                median_cmax=float(np.median(c)),
                median_J=float(np.median(J)),
                J=[float(f"{j:.6g}") for j in J],
                err=[float(f"{e:.4g}") for e in err],
                c_max=[float(f"{v:.4g}") for v in c],
                iterations=np.asarray(res.iterations_total).tolist(),
                seconds=time.perf_counter() - t0)


def run_mintime(dtype):
    prob = mintime_problem(dtype)
    opts = mintime_options()
    xf = np.array([np.pi, 0.0, 0.0, 0.0])
    rows = []
    t0 = time.perf_counter()
    for x0 in mintime_starts():
        p = tt.update_problem(prob, x0=jnp.asarray(x0, dtype),
                              X=prob.X.at[0].set(jnp.asarray(x0, dtype)))
        r = alt.altro_solve(p, opts, minimum_time=True)
        X = np.asarray(r.X, np.float64)
        rows.append((float(r.tt), float(r.c_max),
                     float(np.abs(X[-1] - xf).max()),
                     int(r.iterations_total)))
    tt_mt, c, goal, its = (np.array(v) for v in zip(*rows))
    bars = (c < 1e-3) & (goal < 1e-3)
    return dict(share_bars=float(np.mean(bars)), tt=tt_mt.tolist(),
                c_max=c.tolist(), goal_err=goal.tolist(),
                iterations=its.tolist(), median_tt=float(np.median(tt_mt)),
                u_max=U_MAX, seconds=time.perf_counter() - t0)


def write(line):
    """Replace the pool's line of the same type in GATES (keeping the
    others)."""
    def key(x):
        d = json.loads(x)
        return d["pool"], d["dtype"]

    lines = GATES.read_text().splitlines() if GATES.exists() else []
    lines = [x for x in lines if key(x) != key(line)] + [line]
    GATES.write_text("\n".join(lines) + "\n")


def main():
    args = sys.argv[1:]
    save = "--write" in args
    wide = "--dtype=float64" in args
    args = [a for a in args if a != "--write" and not a.startswith("--dtype")]
    count = int(args[0]) if args else 16
    pools = args[1:] or ["doublependulum", "acrobot", "dp_rig_mintime"]
    jax.config.update("jax_platforms", "cpu")
    if wide:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if wide else jnp.float32
    for name in pools:
        out = run_mintime(dtype) if name == "dp_rig_mintime" \
            else run_two_link(name, dtype, count)
        line = json.dumps(dict(pool=name, dtype=jnp.dtype(dtype).name,
                               count=MINTIME_STARTS
                               if name == "dp_rig_mintime" else count,
                               **out))
        print(line, flush=True)
        if save:
            write(line)


if __name__ == "__main__":
    main()
