"""Problem zoo.

Counterpart of ``trajopt_tpu/problems/zoo.py``. Only the unconstrained
``quadrotor_line`` is ported (ROADMAP Queue 1: the constrained variant and
the maze are slice 2, the rest of the zoo comes after).
"""
from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.models import zoo as dynamics
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.cost import LQRObjective
from trajopt_tpu_torch.problem import problem


def quadrotor_line(N=101, dtype=torch.float64, device="cpu",
                   constrained=False, distance=60.0):
    """Flagship benchmark problem: quadrotor ``distance``-meter translation
    (reference problems/quadrotor.jl spec, tf=5, minus bounds)."""
    if constrained:
        raise NotImplementedError(
            "quadrotor_line(constrained=True) needs the constraint layer "
            "(ROADMAP Queue 1, slice 2)")
    model_d = discretize(dynamics.quadrotor, "rk3")
    n, m = 13, 4
    x0 = np.zeros(n)
    x0[0:3] = [0.0, 0.0, 10.0]
    x0[3] = 1.0
    xf = np.zeros(n)
    xf[0:3] = [0.0, distance, 10.0]
    xf[3] = 1.0
    Q = np.eye(n) * 1e-3
    Q[3:7, 3:7] = np.eye(4) * 1e-2
    obj = LQRObjective(Q, np.eye(m) * 1e-4, np.eye(n) * 1000.0, xf, N)
    return problem(model_d, obj, x0=x0, xf=xf, N=N, dt=5.0 / (N - 1),
                   U0=np.full((N - 1, m), 0.5 * 9.81 / 4.0), dtype=dtype,
                   device=device)
