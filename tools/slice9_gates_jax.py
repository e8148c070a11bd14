#!/usr/bin/env python3
"""Outcome bars for slice 9 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice9_gates_jax.py [--write]
        [--dtype=float64] [count [rule...]]

Solves the starts that ``chip_smoke.py`` drives in its slice-9 path with
the JAX package ``trajopt_tpu`` in float32 (or, with ``--dtype=float64``,
in float64) on the CPU and prints one JSON line per integrator with the
shares the port's GPU run is held to (less a margin, see
``chip_smoke.py``). The problem is the reference pendulum swing-up of
tests/test_ilqr.py:36-50 (N = 31, dt = 0.15, |u| ≤ 3, the goal
constraint, ``U0`` all ones) under the integrator ``rule`` (``euler``,
``midpoint``, ``rk4``, ``midpoint_implicit``, ``rk3_implicit``; all by
default), solved by ``solve_batch`` with ``ALOptions()`` on the first
``count`` (default 16) of 1024 starts with N(0, 0.02²) on both state
entries (seed 0). Per start the final c_max, the goal error
‖x_N − x_f‖ and J; the shares with c_max < 1e-3 and with the goal within
2e-3 (the bars of the canonical drive), the medians.

With ``--write`` each rule's line replaces that rule's line of the same
type in ``tools/slice9_gates_jax.jsonl``, which ``chip_smoke.py`` reads
(there: 128 starts in float32).
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
from trajopt_tpu.models import zoo  # noqa: E402
from trajopt_tpu.parallel.batch import solve_batch  # noqa: E402

POOL = 1024
GATES = Path(__file__).resolve().parent / "slice9_gates_jax.jsonl"
RULES = ("euler", "midpoint", "rk4", "midpoint_implicit", "rk3_implicit")


def pendulum_problem(rule, dtype):
    """tests/test_ilqr.py:36-50 under ``rule``."""
    n, m, N = 2, 1, 31
    xf = np.array([np.pi, 0.0])
    obj = tt.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                          np.eye(n) * 1e-3, xf, N)
    cons = tt.ConstraintSetBuilder(N)
    cons.add(tt.bound_constraint(n, m, u_min=-3.0, u_max=3.0))
    cons.add(tt.goal_constraint(xf))
    return tt.problem(tt.discretize(zoo.pendulum, rule), obj,
                      constraints=cons, x0=np.zeros(n), xf=xf, N=N, dt=0.15,
                      U0=np.ones((N - 1, m)), dtype=dtype)


def starts(count):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(POOL, 2)) * 0.02)[:count]


def run(rule, dtype, count):
    prob = pendulum_problem(rule, dtype)
    t0 = time.perf_counter()
    res = solve_batch(prob, tt.ALOptions(), jnp.asarray(starts(count), dtype))
    X = np.asarray(res.X, np.float64)
    err = np.linalg.norm(X[:, -1] - np.array([np.pi, 0.0]), axis=-1)
    c = np.asarray(res.c_max, np.float64)
    J = np.asarray(res.J, np.float64)
    return dict(share_cmax_1e3=float(np.mean(c < 1e-3)),
                share_goal_2e3=float(np.mean(err < 2e-3)),
                median_err=float(np.median(err)),
                median_cmax=float(np.median(c)),
                median_J=float(np.median(J)),
                J=[float(f"{j:.6g}") for j in J],
                err=[float(f"{e:.4g}") for e in err],
                c_max=[float(f"{v:.4g}") for v in c],
                iterations=np.asarray(res.iterations_total).tolist(),
                seconds=time.perf_counter() - t0)


def write(line):
    """Replace the rule's line of the same type in GATES (keeping the
    others)."""
    def key(x):
        d = json.loads(x)
        return d["rule"], d["dtype"]

    lines = GATES.read_text().splitlines() if GATES.exists() else []
    lines = [x for x in lines if key(x) != key(line)] + [line]
    GATES.write_text("\n".join(lines) + "\n")


def main():
    args = sys.argv[1:]
    save = "--write" in args
    wide = "--dtype=float64" in args
    args = [a for a in args if a != "--write" and not a.startswith("--dtype")]
    count = int(args[0]) if args else 16
    rules = args[1:] or list(RULES)
    jax.config.update("jax_platforms", "cpu")
    if wide:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if wide else jnp.float32
    for rule in rules:
        line = json.dumps(dict(rule=rule, dtype=jnp.dtype(dtype).name,
                               count=count, **run(rule, dtype, count)))
        print(line, flush=True)
        if save:
            write(line)


if __name__ == "__main__":
    main()
