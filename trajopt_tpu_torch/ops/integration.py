"""Explicit integrators.

Counterparts of ``trajopt_tpu/ops/integration.py`` (reference
src/integration.jl). Each takes a continuous dynamics function
``f(x, u) -> xdot`` and returns a discrete step ``step(x, u, dt)``; the
uncertain variants take ``f(x, u, w)`` and return ``step(x, u, w, dt)``, the
disturbance w held over the step. They are plain tensor arithmetic, so they
broadcast over any leading batch dimensions and work under ``torch.func``
transforms. Only ``rk3`` has CUDA steps (``ops/cuda_models.py``): on a CUDA
tensor a solve under any other integrator raises. The other integrators'
CUDA steps and the implicit integrators everywhere (``midpoint_implicit``,
``rk3_implicit`` with their Newton step) are not ported yet (ROADMAP
Queue 1 #4).
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


# ------------------------------------------------------ uncertain variants
# (reference midpoint_uncertain / rk3_uncertain / rk4_uncertain,
# integration.jl:35-42, 126-135, 160-168)


def midpoint_uncertain(f):
    def step(x, u, w, dt):
        xm = x + 0.5 * dt * f(x, u, w)
        return x + dt * f(xm, u, w)

    return step


def rk3_uncertain(f):
    def step(x, u, w, dt):
        k1 = dt * f(x, u, w)
        k2 = dt * f(x + 0.5 * k1, u, w)
        k3 = dt * f(x - k1 + 2.0 * k2, u, w)
        return x + (k1 + 4.0 * k2 + k3) / 6.0

    return step


def rk4_uncertain(f):
    def step(x, u, w, dt):
        k1 = dt * f(x, u, w)
        k2 = dt * f(x + 0.5 * k1, u, w)
        k3 = dt * f(x + 0.5 * k2, u, w)
        k4 = dt * f(x + k3, u, w)
        return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

    return step


UNCERTAIN_INTEGRATORS = {"midpoint": midpoint_uncertain, "rk3": rk3_uncertain,
                         "rk4": rk4_uncertain}
