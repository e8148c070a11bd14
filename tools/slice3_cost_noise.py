#!/usr/bin/env python3
"""Why the fused and the phase-split solve of the unconstrained quadrotor end
at different distances from the goal in float32: an experiment on one GPU.

    python3 tools/slice3_cost_noise.py [count]

``quadrotor_line(N=101)`` writes its cost as ½xᵀQx + qᵀx + c with Qf = 1000
and a goal 60 m away, so the terminal cost of a state near the goal is the
difference of terms of size 1.8e6: in float32 it comes out in steps of about
0.125, against a true value of 0.0125 at 5 mm. The line search and the
convergence test read that number. The script solves the first ``count``
(default 1024) problems of chip_smoke.py's quadrotor pool through
``ilqr_solve`` with the default options, float32, four ways:

  fused        kernels K7a and K7b (the cost summed inside K7b)
  split        K5 and K2, the cost by ``total_cost`` in float32
  split_f64    K5 and K2, the cost evaluated in float64 on the card
  split_shift  K5 and K2, the cost in float32 as ½(x−xf)ᵀQ(x−xf) + ½uᵀRu,
               which has no cancellation

and prints for each the share of problems within 0.5 m and 5 mm of the goal,
the median error, the mean iteration count and the share of problems whose
last cost change was exactly zero. One JSON line per way.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from trajopt_tpu_torch.problems.zoo import quadrotor_line  # noqa: E402
from trajopt_tpu_torch.solvers.ilqr import iLQROptions, ilqr_solve  # noqa: E402
from trajopt_tpu_torch.utils.tree import precise_context  # noqa: E402


def main():
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    dev = torch.device("cuda", 0)
    prob = quadrotor_line(N=101, dtype=torch.float32, device=dev)
    obj64 = prob.obj.to(dtype=torch.float64)
    rng = np.random.default_rng(0)
    x0s = prob.x0.cpu().numpy()[None] + np.concatenate(
        [rng.normal(size=(1024, 3)) * 0.1, np.zeros((1024, 10))], axis=1)
    x0s = torch.as_tensor(x0s[:count], dtype=torch.float32, device=dev)
    dt_traj = prob.dt_traj()
    X0 = prob.X.expand(count, -1, -1).clone()
    X0[:, 0] = x0s
    U0 = prob.U.expand(count, -1, -1).contiguous()
    Q, R, Qf = prob.obj.Q[0], prob.obj.R[0], prob.obj.Q[-1]

    def cost_f32(X, U):
        return prob.obj.total(X, U, dt_traj)

    def cost_f64(X, U):
        return obj64.total(X.double(), U.double(), dt_traj.double()).float()

    def cost_shift(X, U):
        e = X - prob.xf
        stage = 0.5 * torch.einsum("bki,ij,bkj->bk", e[:, :-1], Q, e[:, :-1]) \
            + 0.5 * torch.einsum("bki,ij,bkj->bk", U, R, U)
        term = 0.5 * torch.einsum("bi,ij,bj->b", e[:, -1], Qf, e[:, -1])
        return (stage * dt_traj).sum(-1) + term

    def expansion(X, U):
        return prob.obj.expansion(X, U, dt_traj)

    ways = (("fused", cost_f32, True), ("split", cost_f32, False),
            ("split_f64", cost_f64, False), ("split_shift", cost_shift, False))
    with precise_context():
        for name, cost_fn, fused in ways:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ilqr_solve(prob.model, cost_fn, expansion, x0s, X0, U0,
                             prob.dt, iLQROptions(fused=fused),
                             objective=prob.obj if fused else None)
            torch.cuda.synchronize()
            err = (res.X[:, -1, :3] - prob.xf[:3]).norm(dim=-1).cpu().numpy()
            print(json.dumps(dict(
                way=name, count=count, seconds=time.perf_counter() - t0,
                share_0p5m=float(np.mean(err < 0.5)),
                share_5mm=float(np.mean(err < 5e-3)),
                median_err_m=float(np.median(err)),
                mean_iterations=float(res.iterations.float().mean()),
                most_iterations=int(res.iterations.max()),
                share_last_dJ_zero=float((res.dJ == 0).float().mean()),
                median_J=float(res.J.median()))), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("slice3_cost_noise: no CUDA device")
    main()
