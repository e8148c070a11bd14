#!/usr/bin/env python3
"""Outcome bars for slice 5 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice5_gates_jax.py [count] [--full]
        [--dtype=float32 | --dtype=float64]

Runs, with the JAX package ``trajopt_tpu`` on the CPU (its XLA path), what
``chip_smoke.py`` drives on the GPU in slice 5, in float32 and in float64,
and prints the outcomes that the port's GPU run is held to (see
``chip_smoke.py``). One JSON line each:

- path 1: ``altro_solve(kuka_obstacles())`` with the options of
  tests/test_altro.py:101-111 (a feasible start, no polish): c_max, the
  distance to the goal, outer and inner iterations;
- path 2: ``solve_batch_queued_altro(kuka_obstacles(),
  tuned_altro_options("kuka_obstacles"), x0s)`` on the first ``count``
  (default 16) of 1024 starts (seed 0, q perturbed by N(0, 0.05²) rad,
  q̇ = 0), at the depth ``chip_smoke.py`` drives it (DEPTH: the tuned
  options cut to 5 outer iterations of at most 300 inner ones, the first
  depth at which some of the first 16 starts reach the goal within 1e-3),
  and with ``--full`` also at the tuned options' own depth (20 outer, 300
  inner; 27 minutes per dtype for 16 starts): the shares with c_max < 1e-3,
  with c_max < 1e-1 and with the goal within 1e-3, the median c_max and
  the inner iterations.

``--dtype`` runs one of the two types (two processes side by side take
half the time of one that runs both).
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import trajopt_tpu as tt  # noqa: E402
from trajopt_tpu.parallel.batch import solve_batch_queued_altro  # noqa: E402
from trajopt_tpu.problems import zoo  # noqa: E402
from trajopt_tpu.problems.tuned import tuned_altro_options  # noqa: E402
from trajopt_tpu.solvers.altro import ALTROOptions, altro_solve  # noqa: E402

POOL = 1024
# path 2's depth on the GPU: (outer iterations, inner cap)
DEPTH = (5, 300)


def path1_options():
    """tests/test_altro.py:101-111."""
    al = tt.ALOptions(iterations=20, cost_tolerance=1e-6,
                      cost_tolerance_intermediate=1e-5,
                      constraint_tolerance=1e-3, penalty_scaling=50.0,
                      penalty_initial=0.01)
    return ALTROOptions(opts_al=al)


def pool_options(depth=None):
    """The tuned options, cut to ``depth`` = (outer, inner cap) if given."""
    o = tuned_altro_options("kuka_obstacles")
    if depth is None:
        return o
    al = dataclasses.replace(
        o.opts_al, iterations=depth[0], opts_uncon=dataclasses.replace(
            o.opts_al.opts_uncon, iterations=depth[1]))
    return dataclasses.replace(o, opts_al=al)


def kuka_pool(x0, count):
    """Seed 0, q perturbed by N(0, 0.05²) rad, q̇ = 0: the first ``count``
    of 1024 starts."""
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    noise = np.concatenate([rng.normal(size=(POOL, 7)) * 0.05,
                            np.zeros((POOL, 7))], axis=1)
    return (x0[None] + noise)[:count]


def say(**kw):
    print(json.dumps(kw), flush=True)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    count = int(args[0]) if args else 16
    depths = [DEPTH] + ([None] if "--full" in sys.argv else [])
    dtypes = [(t, n) for t, n in ((jnp.float32, "float32"),
                                  (jnp.float64, "float64"))
              if f"--dtype={n}" in sys.argv
              or not any(a.startswith("--dtype") for a in sys.argv)]
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    for dtype, name in dtypes:
        prob = zoo.kuka_obstacles(dtype=dtype)
        t0 = time.perf_counter()
        r = altro_solve(prob, path1_options())
        assert r.X.dtype == dtype, r.X.dtype
        say(run="altro_solve kuka_obstacles", dtype=name,
            c_max=float(r.c_max),
            goal_err=float(np.linalg.norm(np.asarray(r.X[-1], np.float64)
                                          - np.asarray(prob.xf))),
            outer=int(r.iterations), inner=int(r.iterations_total),
            seconds=time.perf_counter() - t0)

    for depth, (dtype, name) in ((d, t) for d in depths for t in dtypes):
        prob = zoo.kuka_obstacles(dtype=dtype)
        x0s = jnp.asarray(kuka_pool(prob.x0, count), dtype)
        t0 = time.perf_counter()
        res = solve_batch_queued_altro(prob, pool_options(depth), x0s,
                                       lanes=count)
        assert res.X.dtype == dtype, res.X.dtype
        c = np.asarray(res.c_max, np.float64)
        g = np.linalg.norm(np.asarray(res.X[:, -1], np.float64)
                           - np.asarray(prob.xf, np.float64)[None], axis=-1)
        say(run="kuka_obstacles pool", count=count, dtype=name,
            depth="tuned" if depth is None else list(depth),
            share_cmax_1e3=float(np.mean(c < 1e-3)),
            share_cmax_1e1=float(np.mean(c < 1e-1)),
            share_goal_1e3=float(np.mean(g < 1e-3)),
            median_cmax=float(np.median(c)), c_max=c.tolist(),
            goal_err=g.tolist(),
            iterations=np.asarray(res.iterations_total).tolist(),
            seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
