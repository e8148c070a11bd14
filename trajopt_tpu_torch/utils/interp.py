"""Trajectory seeding utilities.

Own copy of ``trajopt_tpu/utils/interp.py::interp_rows`` (reference
src/utils.jl:5-15): interpolate a coarse waypoint guess onto N knot points
for infeasible-start seeding. Plain numpy.
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

