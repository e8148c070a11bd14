#!/usr/bin/env python3
"""Time the main paths that run K1, K5 and K7a in this tree and in another,
in turns, on one GPU.

    python3 tools/paths_against_parent.py PARENT

PARENT is the root of another checkout of this repository (for example the
parent commit, unpacked by ``git archive`` into a directory that
``.gitignore`` lists). Each tree runs in a process of its own, in the order
other, this, this, other, with its own package, kernels (built under its
own ``build/``) and ``chip_smoke.py`` set-ups, the arms of
``chip_smoke.py`` as its slices 1, 3 and 6 drive them, each a warm-up call
and then one timed ``solve_batch_queued`` or ``solve_batch`` (wall clock to
``synchronize``):

- slice 1, the quadrotor queued pool with the sqrt backward pass (K1, K2),
  512 starts over 128 lanes;
- slice 3 (a), the unconstrained quadrotor, 1024 starts, ``fused=True``
  (K7a and K7b at B = 1024), and (b) the same phase-split (K5 (13,4), K2);
- slice 3 (c) phase-split, the constrained cartpole, 1024 starts,
  ``fused_al=False`` (K5 (4,1), K2);
- slice 6, every pool (the unconstrained kuka from its gravity holds, the
  URDF rigs on their zoo problems) fused and phase-split, 128 starts.

Prints the card's ``nvidia-smi`` line, one line per arm with each run's
solves/s, and the change over the other tree (the mean of this tree's two
runs over the mean of the other's).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: str):
    """In this process: every arm on the tree at ``tree``; one JSON line."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.parallel.batch import (
        solve_batch, solve_batch_queued)
    from trajopt_tpu_torch.problems import zoo

    assert Path(cs.__file__).resolve().parent == Path(tree).resolve()
    _build.load()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    out = {}

    def arm(name, prob, opts, x0s, warm, U0s=None):
        solve_batch(prob, warm, x0s, U0s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batch(prob, opts, x0s, U0s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert bool(torch.isfinite(res.X).all()), name
        out[name] = x0s.shape[0] / wall

    def warm(**kw):
        return tt.ALOptions(iterations=1, opts_uncon=tt.iLQROptions(
            iterations=2, **kw))

    prob = zoo.quadrotor_line(N=cs.N, dtype=f32, device=dev)
    x0s = torch.as_tensor(cs.pool_starts(prob.x0.cpu()), dtype=f32,
                          device=dev)
    pool = x0s[:cs.SLICE1_POOL]
    solve_batch_queued(prob, tt.ALOptions(iterations=1, opts_uncon=(
        tt.iLQROptions(iterations=2, error_state=True, bp_type="sqrt"))),
        pool[:cs.B], lanes=cs.B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_batch_queued(prob, cs.bench_options(), pool, lanes=cs.B)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(res.X).all()), "slice 1"
    out["slice 1 quadrotor queued pool, sqrt"] = pool.shape[0] / (
        time.perf_counter() - t0)
    for name, fused in (("slice 3 (a) quadrotor fused", True),
                        ("slice 3 (b) quadrotor phase-split", False)):
        arm(name, prob, tt.ALOptions(opts_uncon=tt.iLQROptions(fused=fused)),
            x0s, warm(fused=fused))
    prob = zoo.cartpole(dtype=f32, device=dev)
    x0s = torch.as_tensor(cs.cartpole_starts(prob.x0.cpu()), dtype=f32,
                          device=dev)
    arm("slice 3 (c) cartpole phase-split", prob, tt.ALOptions(
        opts_uncon=tt.iLQROptions(fused_al=False)), x0s,
        warm(fused_al=False))
    for pool, label, make, starts in cs.slice6_pools():
        prob = make()
        x0s = torch.as_tensor(starts(prob.x0.cpu(), cs.SLICE6_POOL),
                              dtype=f32, device=prob.device)
        U0s = cs.kuka_hold_seeds(prob, x0s) if pool == "kuka" else None
        for how, fused in (("fused", True), ("phase-split", False)):
            arm(f"slice 6 {pool} {how}", prob, cs.slice6_options(pool, fused),
                x0s, warm(fused=fused, fused_al=fused), U0s)
    print("RESULT " + json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_tree(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = str(Path(sys.argv[1]).resolve())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    for tree in (parent, str(ROOT), str(ROOT), parent):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--run", tree],
                              capture_output=True, text=True, cwd=tree)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(line[0][7:]))
        print(f"{'this' if tree == str(ROOT) else 'other'} tree: "
              f"{runs[-1]}", flush=True)
    for name in runs[0]:
        o0, t0, t1, o1 = (r[name] for r in runs)
        print(f"{name}: solves/s other {o0:.2f}, this {t0:.2f}, this "
              f"{t1:.2f}, other {o1:.2f}: this over the other "
              f"{(t0 + t1) / (o0 + o1):.3f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
