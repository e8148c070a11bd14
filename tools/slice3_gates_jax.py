#!/usr/bin/env python3
"""Outcome bars for slice 3 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice3_gates_jax.py [count]

Solves the first ``count`` (default 16) problems of the pools that
``chip_smoke.py`` drives on the GPU, with the JAX package ``trajopt_tpu`` in
float32 on the CPU (where it takes its XLA path, so ``fused=True`` and
``fused=False`` are the same program), and prints the shares that the
port's GPU run is held to, less a margin (see ``chip_smoke.py``):

- ``quadrotor_line(N=101)`` without constraints, ``solve_batch`` with
  ``ALOptions()``, starts with 0.1 m position noise (seed 0): the share of
  problems within 0.5 m and within 5 mm of the goal, the median error;
- ``cartpole()`` (N=101, control box and goal constraint), ``solve_batch``
  with ``ALOptions()``, starts with 0.02 noise on the state (seed 0): the
  share with c_max < 1e-3, the median goal error.

One JSON line per pool.
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
from trajopt_tpu.parallel.batch import solve_batch  # noqa: E402
from trajopt_tpu.problems import zoo  # noqa: E402


def quadrotor_pool(x0, count, pool=1024):
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    return (np.tile(x0[None], (pool, 1)) + np.concatenate(
        [rng.normal(size=(pool, 3)) * 0.1, np.zeros((pool, 10))],
        axis=1))[:count]


def cartpole_pool(x0, count, pool=1024):
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    return (x0[None] + rng.normal(size=(pool, x0.shape[0])) * 0.02)[:count]


def main():
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    jax.config.update("jax_platforms", "cpu")
    f32 = jnp.float32

    prob = zoo.quadrotor_line(N=101, dtype=f32)
    x0s = jnp.asarray(quadrotor_pool(prob.x0, count), f32)
    t0 = time.perf_counter()
    res = solve_batch(prob, tt.ALOptions(), x0s)
    err = np.linalg.norm(np.asarray(res.X)[:, -1, :3]
                         - np.asarray(prob.xf)[:3], axis=-1)
    print(json.dumps(dict(
        pool="quadrotor_line", count=count, dtype="float32",
        share_0p5m=float(np.mean(err < 0.5)),
        share_5mm=float(np.mean(err < 5e-3)), median_err_m=float(np.median(err)),
        iterations=np.asarray(res.iterations_total).tolist(),
        seconds=time.perf_counter() - t0)), flush=True)

    prob = zoo.cartpole(dtype=f32)
    x0s = jnp.asarray(cartpole_pool(prob.x0, count), f32)
    t0 = time.perf_counter()
    res = solve_batch(prob, tt.ALOptions(), x0s)
    c = np.asarray(res.c_max)
    err = np.linalg.norm(np.asarray(res.X)[:, -1] - np.asarray(prob.xf),
                         axis=-1)
    print(json.dumps(dict(
        pool="cartpole", count=count, dtype="float32",
        share_cmax_1e3=float(np.mean(c < 1e-3)),
        median_goal_err=float(np.median(err)), median_cmax=float(np.median(c)),
        outer=np.asarray(res.iterations).tolist(),
        iterations=np.asarray(res.iterations_total).tolist(),
        seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
