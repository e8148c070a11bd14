#!/usr/bin/env python3
"""Outcome bars for slice 6 of the PyTorch/CUDA port, from the JAX package.

    JAX_PLATFORMS=cpu python tools/slice6_gates_jax.py [--write]
        [--dtype=float64] [count [pool...]]

Solves the first ``count`` (default 16) starts of the pools that
``chip_smoke.py`` drives in its slice-6 phase with the JAX package
``trajopt_tpu`` in float32 (or, with ``--dtype=float64``, in float64) on
the CPU (where it takes its XLA path, so the fused and the phase-split arm
are one program), ``solve_batch`` in one call per pool, and prints one JSON line per pool with the shares that the
port's GPU run is held to, less a margin (see ``chip_smoke.py``). Pools
(all by default):

- ``kuka``: ``kuka_obstacles()`` with an empty constraint set, starts with
  q perturbed by N(0, 0.05²) rad (seed 0, the first of 1024, the slice-5
  pool), each seeded with its own gravity hold (``kuka_hold_trajectory`` of
  its start), the AL options of ``tuned_altro_options("kuka")`` (inner cap
  300, cost tolerance 1e-6): the shares of terminal joint errors
  ‖q_N − q_f‖ within 1e-1, 3e-2, 1e-2 and 1e-3 rad. (The problem's own
  seed, the hold of the nominal start, rolls out to non-finite states from
  every perturbed start; the initial-rollout guard then holds the start on
  every knot, whose cost no rollout can beat, and every line search of the
  unconstrained solve runs out: 11 iterations, X never moves.)
- ``doublependulum``: the ``doublependulum_urdf`` rig on
  ``doublependulum_problem()`` (unconstrained), ``ALOptions()``;
- ``acrobot``, ``cartpole``: the ``acrobot_urdf`` rig on
  ``acrobot_problem()`` (goal constraint) and the ``cartpole_urdf`` rig on
  ``cartpole()`` (control box and goal), ``ALOptions()``: the share with
  c_max < 1e-3; the constrained cartpole at the cut depth CARTPOLE_DEPTH
  (outer iterations, inner cap), as ``chip_smoke.py`` drives it;
- ``acrobot_free``, ``cartpole_free``: the same two without their
  constraints.

The rigs' starts have 0.02 noise on every state entry (seed 0, the first of
1024, slice 3's cartpole pool); every rig pool also reports the shares of
terminal state errors ‖x_N − x_f‖ within 1e-1, 3e-2, 1e-2 and 1e-3. Every
pool reports each start's final cost J, c_max and error, and their medians.
With ``--write`` each pool's line also replaces that pool's line of the
same type in ``tools/slice6_gates_jax.jsonl``, which ``chip_smoke.py``
reads (there: 64 starts of every pool in float32, and of the acrobot in
float64 too; the constrained cartpole at its full depth, 30 outer
iterations of up to 300 inner ones, took about 25 minutes for 16 starts
on eight CPU cores).
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
from trajopt_tpu.ops.constraints import empty_constraints  # noqa: E402
from trajopt_tpu.parallel.batch import solve_batch  # noqa: E402
from trajopt_tpu.problems import zoo  # noqa: E402
from trajopt_tpu.problems.tuned import tuned_altro_options  # noqa: E402

POOL = 1024
# the constrained cartpole rig's depth: (outer iterations, inner cap)
CARTPOLE_DEPTH = (10, 30)
GATES = Path(__file__).resolve().parent / "slice6_gates_jax.jsonl"
RIGS = dict(doublependulum=("doublependulum_urdf", zoo.doublependulum_problem),
            acrobot=("acrobot_urdf", zoo.acrobot_problem),
            cartpole=("cartpole_urdf", zoo.cartpole))


def kuka_pool(x0, count):
    rng = np.random.default_rng(0)
    noise = np.concatenate([rng.normal(size=(POOL, 7)) * 0.05,
                            np.zeros((POOL, 7))], axis=1)
    return (np.asarray(x0, np.float64)[None] + noise)[:count]


def rig_pool(x0, count):
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float64)
    return (x0[None] + rng.normal(size=(POOL, x0.shape[0])) * 0.02)[:count]


def shares(err, bars=(1e-1, 3e-2, 1e-2, 1e-3)):
    return {f"within_{b:g}": float(np.mean(err < b)) for b in bars}


def problem(name, f32):
    """The pool's problem: the rig's zoo problem with its model (kuka:
    ``kuka_obstacles``), without constraints for ``kuka`` and ``*_free``."""
    if name == "kuka":
        p = zoo.kuka_obstacles(dtype=f32)
        return tt.update_problem(p, constraints=empty_constraints(p.N))
    rig, factory = RIGS[name.removesuffix("_free")]
    p = tt.update_problem(factory(dtype=f32), model=tt.discretize(
        getattr(robots, f"{rig}_model")(), "rk3"))
    if name.endswith("_free"):
        p = tt.update_problem(p, constraints=empty_constraints(p.N))
    return p


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
    pools = args[1:] or ["kuka", "doublependulum", "acrobot", "cartpole",
                         "acrobot_free", "cartpole_free"]
    jax.config.update("jax_platforms", "cpu")
    if wide:
        jax.config.update("jax_enable_x64", True)
    f32 = jnp.float64 if wide else jnp.float32
    for name in pools:
        prob = problem(name, f32)
        U0s = None
        if name == "kuka":
            opts = tuned_altro_options("kuka").opts_al
            x0s = kuka_pool(prob.x0, count)
            U0s = jnp.stack([robots.kuka_hold_trajectory(
                prob.model.model.chain, jnp.asarray(x[:7], f32), prob.N)
                for x in x0s]).astype(f32)
        else:
            opts = tt.ALOptions()
            if name == "cartpole":
                opts = tt.ALOptions(iterations=CARTPOLE_DEPTH[0],
                                    opts_uncon=tt.iLQROptions(
                                        iterations=CARTPOLE_DEPTH[1]))
            x0s = rig_pool(prob.x0, count)
        t0 = time.perf_counter()
        res = solve_batch(prob, opts, jnp.asarray(x0s, f32), U0s)
        X = np.asarray(res.X, np.float64)
        xf = np.asarray(prob.xf, np.float64)
        c = np.asarray(res.c_max, np.float64)
        out = dict(pool=name, count=count, dtype=jnp.dtype(f32).name,
                   share_cmax_1e3=float(np.mean(c < 1e-3)),
                   median_cmax=float(np.median(c)))
        if name == "kuka":
            err = np.linalg.norm(X[:, -1, :7] - xf[:7], axis=-1)
            out.update(joint_err=shares(err))
        else:
            err = np.linalg.norm(X[:, -1] - xf, axis=-1)
            out.update(goal_err=shares(err))
        J = np.asarray(res.J, np.float64)
        out.update(median_err=float(np.median(err)),
                   median_J=float(np.median(J)),
                   J=[float(f"{j:.6g}") for j in J],
                   err=[float(f"{e:.4g}") for e in err],
                   c_max=[float(f"{v:.4g}") for v in c],
                   iterations=np.asarray(res.iterations_total).tolist(),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        if save:
            write(json.dumps(out))


if __name__ == "__main__":
    main()
