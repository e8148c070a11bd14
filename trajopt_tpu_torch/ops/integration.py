"""Explicit integrators.

Counterparts of ``trajopt_tpu/ops/integration.py`` (reference
src/integration.jl). Each takes a continuous dynamics function
``f(x, u) -> xdot`` and returns a discrete step ``step(x, u, dt)``. They are
plain tensor arithmetic, so they broadcast over any leading batch dimensions
and work under ``torch.func`` transforms. The implicit integrators are not
ported yet (ROADMAP Queue 1, "the rest of the zoo").
"""
from __future__ import annotations


def euler(f):
    def step(x, u, dt):
        return x + dt * f(x, u)

    return step


def midpoint(f):
    """Explicit midpoint (reference src/integration.jl:26-33)."""

    def step(x, u, dt):
        xm = x + 0.5 * dt * f(x, u)
        return x + dt * f(xm, u)

    return step


def rk3(f):
    """Runge-Kutta 3 with zero-order hold (reference src/integration.jl:149-158).

    k1 = dt f(x), k2 = dt f(x + k1/2), k3 = dt f(x - k1 + 2 k2);
    x+ = x + (k1 + 4 k2 + k3)/6.
    """

    def step(x, u, dt):
        k1 = dt * f(x, u)
        k2 = dt * f(x + 0.5 * k1, u)
        k3 = dt * f(x - k1 + 2.0 * k2, u)
        return x + (k1 + 4.0 * k2 + k3) / 6.0

    return step


def rk4(f):
    """Classic Runge-Kutta 4 (reference src/integration.jl:115-124)."""

    def step(x, u, dt):
        k1 = dt * f(x, u)
        k2 = dt * f(x + 0.5 * k1, u)
        k3 = dt * f(x + 0.5 * k2, u)
        k4 = dt * f(x + k3, u)
        return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

    return step


INTEGRATORS = {"euler": euler, "midpoint": midpoint, "rk3": rk3, "rk4": rk4}
