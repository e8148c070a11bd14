#!/usr/bin/env python3
"""Outcome bars for slice 4 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice4_gates_jax.py [count]

Runs, with the JAX package ``trajopt_tpu`` in float32 on the CPU (where it
takes its XLA path), what ``chip_smoke.py`` drives on the GPU in slice 4, and
prints the outcomes that the port's GPU run is held to, less a margin (see
``chip_smoke.py``). One JSON line each:

- ``altro_solve(car_escape())`` with the options of tests/test_altro.py:88-94
  (R_inf = 1e-1, penalty 10 × 50, projected Newton at a hand-off tolerance
  of 1e-3), in float32 and, for the float64 bars of that test, in float64:
  c_max and the distance to the goal; and with ``resolve_feasible_problem``
  instead of the polish;
- the pool form: ``solve_batch_queued_altro_retry`` on the first ``count``
  (default 16) of 1024 ``car_escape`` starts (seed 0, 0.05 m normal noise on
  x and y), ``tol = 1e-3``: the share with c_max < 1e-3; then
  ``pn_polish_batch`` on the result in float32 and, cast up, in float64: the
  shares with c_max < 1e-6;
- the default constrained ``solve_batch`` of ``pendulum``,
  ``doubleintegrator``, ``parallel_park`` and ``car_3obs`` on ``count``
  starts (seed 0, 0.02 noise; none on the parked car's y): the share with
  c_max < 1e-3.
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
from trajopt_tpu.parallel.batch import (  # noqa: E402
    pn_polish_batch, solve_batch, solve_batch_queued_altro_retry,
)
from trajopt_tpu.problems import zoo  # noqa: E402
from trajopt_tpu.solvers.altro import ALTROOptions, altro_solve  # noqa: E402


def escape_options(ctol=1e-8, **kw):
    """tests/test_altro.py:88-94; the pool runs at ``ctol`` = 1e-3."""
    al = tt.ALOptions(cost_tolerance=1e-6, cost_tolerance_intermediate=1e-2,
                      constraint_tolerance=ctol, penalty_scaling=50.0,
                      penalty_initial=10.0)
    return ALTROOptions(opts_al=al, R_inf=1e-1, **kw)


def escape_pool(x0, count, pool=1024):
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    noise = np.concatenate([rng.normal(size=(pool, 2)) * 0.05,
                            np.zeros((pool, 1))], axis=1)
    return (x0[None] + noise)[:count]


def small_pool(prob, name, count):
    rng = np.random.default_rng(0)
    noise = (0.02, 0.0, 0.02) if name == "parallel_park" else 0.02
    return (np.asarray(prob.x0, np.float64)[None]
            + rng.normal(size=(count, prob.n)) * np.asarray(noise))


def say(**kw):
    print(json.dumps(kw), flush=True)


def main():
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    for dtype, name in ((jnp.float32, "float32"), (jnp.float64, "float64")):
        prob = zoo.car_escape(dtype=dtype)
        for tag, kw in (
                ("pn", dict(resolve_feasible_problem=False,
                            projected_newton=True,
                            projected_newton_tolerance=1e-3)),
                ("resolve", dict(resolve_feasible_problem=True))):
            t0 = time.perf_counter()
            r = altro_solve(prob, escape_options(**kw))
            assert r.X.dtype == dtype, r.X.dtype
            say(run=f"altro_solve car_escape {tag}", dtype=name,
                c_max=float(r.c_max),
                goal_err=float(np.linalg.norm(np.asarray(r.X[-1], np.float64)
                                              - np.asarray(prob.xf))),
                outer=int(r.iterations), inner=int(r.iterations_total),
                seconds=time.perf_counter() - t0)

    f32 = jnp.float32
    prob = zoo.car_escape(dtype=f32)
    x0s = jnp.asarray(escape_pool(prob.x0, count), f32)
    t0 = time.perf_counter()
    res, n_retried = solve_batch_queued_altro_retry(
        prob, escape_options(ctol=1e-3), x0s, lanes=count, tol=1e-3)
    assert res.X.dtype == f32, res.X.dtype
    c = np.asarray(res.c_max)
    say(run="car_escape pool", count=count, dtype="float32",
        share_cmax_1e3=float(np.mean(c < 1e-3)), median_cmax=float(np.median(c)),
        n_retried=int(n_retried),
        iterations=np.asarray(res.iterations_total).tolist(),
        seconds=time.perf_counter() - t0)
    for dtype, name in ((jnp.float32, "float32"), (jnp.float64, "float64")):
        t0 = time.perf_counter()
        p = zoo.car_escape(dtype=dtype)
        pol = pn_polish_batch(p, jnp.asarray(res.X, dtype),
                              jnp.asarray(res.U, dtype))
        assert pol.X.dtype == dtype, pol.X.dtype
        c = np.asarray(pol.c_max)
        v = np.asarray(pol.viol)
        say(run="car_escape pool polish", count=count, dtype=name,
            share_cmax_1e6=float(np.mean(c < 1e-6)),
            share_viol_1e6=float(np.mean(v < 1e-6)),
            median_cmax=float(np.median(c)), median_viol=float(np.median(v)),
            worst_viol=float(np.max(v)),
            iterations=np.asarray(pol.iterations).tolist(),
            seconds=time.perf_counter() - t0)

    for name in ("pendulum", "doubleintegrator", "parallel_park", "car_3obs"):
        prob = zoo.PROBLEMS[name](dtype=f32)
        x0s = jnp.asarray(small_pool(prob, name, count), f32)
        t0 = time.perf_counter()
        res = solve_batch(prob, tt.ALOptions(), x0s)
        assert res.X.dtype == f32, res.X.dtype
        c = np.asarray(res.c_max)
        say(run=f"{name} default", count=count, dtype="float32",
            share_cmax_1e3=float(np.mean(c < 1e-3)),
            median_cmax=float(np.median(c)),
            iterations=np.asarray(res.iterations_total).tolist(),
            seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
