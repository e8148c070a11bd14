#!/usr/bin/env python3
"""Outcome bars for slice 1 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice1_gates_jax.py [count]

Solves the first ``count`` (default 512, the number ``chip_smoke.py``
phase 4 drives) starts of the quadrotor benchmark's pool with the JAX
package ``trajopt_tpu`` in float32 on the CPU: ``quadrotor_line(N=101)``,
the options of ``bench.py:47-54`` (16 outer iterations, 25 inner, the
quaternion error state, the square-root backward pass), starts with 0.1 m
position noise (seed 0, the first of 1024), ``solve_batch_queued`` over 128
lanes, 128 starts a call. After each call it prints one JSON line with the
shares of the starts so far within 0.5 m and within 5 mm of the goal and
the median error; ``chip_smoke.py`` holds the card's 5 mm share to the last
line's less 0.03. The bar in ``chip_smoke.py`` comes from all 512 starts
(513 s on eight CPU cores): within 5 mm 0.88671875, within 0.5 m
0.986328125, median error 2.93e-4 m.
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
from trajopt_tpu.parallel.batch import solve_batch_queued  # noqa: E402
from trajopt_tpu.problems import zoo  # noqa: E402
from trajopt_tpu.solvers.ilqr import iLQROptions  # noqa: E402

LANES = 128


def quadrotor_pool(x0, count, pool=1024):
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    return (np.tile(x0[None], (pool, 1)) + np.concatenate(
        [rng.normal(size=(pool, 3)) * 0.1, np.zeros((pool, 10))],
        axis=1))[:count]


def main():
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    jax.config.update("jax_platforms", "cpu")
    f32 = jnp.float32
    prob = zoo.quadrotor_line(N=101, dtype=f32)
    opts = tt.ALOptions(iterations=16, opts_uncon=iLQROptions(
        iterations=25, error_state=True, bp_type="sqrt"))
    solve = jax.jit(lambda xs: solve_batch_queued(prob, opts, xs,
                                                  lanes=LANES))
    x0s = quadrotor_pool(prob.x0, count)
    goal = np.asarray(prob.xf)[:3]
    errs, iters = [], []
    t0 = time.perf_counter()
    for s in range(0, count, LANES):
        res = solve(jnp.asarray(x0s[s:s + LANES], f32))
        errs += np.linalg.norm(np.asarray(res.X)[:, -1, :3] - goal,
                               axis=-1).tolist()
        iters += np.asarray(res.iterations_total).tolist()
        e = np.asarray(errs)
        print(json.dumps(dict(
            pool="quadrotor_line slice 1", count=len(errs), dtype="float32",
            share_0p5m=float(np.mean(e < 0.5)),
            share_5mm=float(np.mean(e < 5e-3)),
            median_err_m=float(np.median(e)),
            mean_iterations=float(np.mean(iters)),
            seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
