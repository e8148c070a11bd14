"""Trajectory seeding utilities.

Own copy of ``trajopt_tpu/utils/interp.py``: ``interp_rows`` (reference
src/utils.jl:5-15) interpolates a coarse waypoint guess onto N knot points
for infeasible-start seeding, ``line_trajectory`` (reference
src/solvers/altro/infeasible.jl:82-99) draws the straight line. Plain
numpy.
"""
from __future__ import annotations

import numpy as np


def interp_rows(N: int, tf: float, X: np.ndarray) -> np.ndarray:
    """Interpolate the waypoint matrix ``X`` (n, M) linearly onto N knots.
    Returns (N, n), time-major."""
    X = np.asarray(X, dtype=np.float64)
    n, M = X.shape
    t_way = np.linspace(0.0, tf, M)
    t_knot = np.linspace(0.0, tf, N)
    return np.stack([np.interp(t_knot, t_way, X[i]) for i in range(n)],
                    axis=-1)



def line_trajectory(x0, xf, N: int) -> np.ndarray:
    """Straight-line state trajectory from x0 to xf, (N, n)."""
    x0 = np.asarray(x0, dtype=np.float64)
    xf = np.asarray(xf, dtype=np.float64)
    alphas = np.linspace(0.0, 1.0, N)[:, None]
    return (1 - alphas) * x0[None, :] + alphas * xf[None, :]
