"""Explicit and implicit integrators.

Counterparts of ``trajopt_tpu/ops/integration.py`` (reference
src/integration.jl). Each takes a continuous dynamics function
``f(x, u) -> xdot`` and returns a discrete step ``step(x, u, dt)``; the
uncertain variants take ``f(x, u, w)`` and return ``step(x, u, w, dt)``, the
disturbance w held over the step. The explicit steps are plain tensor
arithmetic, so they broadcast over any leading batch dimensions and work
under ``torch.func`` transforms. The implicit steps (``midpoint_implicit``,
``rk3_implicit``) run a Newton loop batched over the leading dimensions with
the semantics of the JAX package's ``vmap`` of its ``lax.while_loop``: each
problem stops updating once its own residual meets its own tolerance, none
runs more than ``_IMPLICIT_MAX_ITERS`` trips, and a problem whose final
residual misses the tolerance comes out NaN. Their loop has a data-dependent
length, so ``torch.func`` cannot differentiate or vmap them: their
Jacobians come from the implicit-function theorem at the converged step
(``models/base.py::implicit_jacobian``). Every integrator has CUDA steps in
the rollout kernel K2 (``csrc/models.cuh``); the fused kernels carry RK3
alone, as the JAX package's lane steps do.
"""
from __future__ import annotations

import torch


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


_IMPLICIT_MAX_ITERS = 1000  # the abort bound (reference
#                             src/integration.jl:55-59 errors after 1000)
IMPLICIT = ("midpoint_implicit", "rk3_implicit")


def _implicit_tol(x):
    """The Newton tolerance of each problem, eps^0.75 · (1 + |x|) over the
    last dimension: ≈ 1e-12 in float64 (the reference's fixed 1e-12,
    integration.jl:52), ≈ 6e-6 in float32."""
    eps = torch.finfo(x.dtype).eps
    return eps ** 0.75 * (1.0 + torch.linalg.vector_norm(x, dim=-1))


def _newton_iterate(x, residual_fn, newton_fn):
    """Newton iteration from y = x, batched over the leading dimensions of
    x (…, n), to each problem's tolerance (reference integration.jl:44-104:
    iterate to 1e-12, abort at 1000). A problem is updated only while its
    residual exceeds its tolerance, as in the JAX package's ``vmap`` of
    its ``lax.while_loop`` (a NaN residual stops it too), and no problem
    takes more than ``_IMPLICIT_MAX_ITERS`` trips. ``newton_fn`` is
    evaluated for the whole batch and kept where a problem is still
    active. Returns y and the residual at y."""
    tol = _implicit_tol(x)
    y = x
    g = residual_fn(y)
    active = torch.linalg.vector_norm(g, dim=-1) > tol
    trips = 0
    while trips < _IMPLICIT_MAX_ITERS and bool(active.any()):
        y = torch.where(active[..., None], newton_fn(y), y)
        g = residual_fn(y)
        active = active & (torch.linalg.vector_norm(g, dim=-1) > tol)
        trips += 1
    return y, g


def _poison_unconverged(y, g, x):
    """NaN where a problem's residual ``g`` at its step ``y`` misses its
    tolerance (reference src/integration.jl:55-59 errors there; the
    rollouts' divergence guard and the line search's restore take NaN as
    a failed step, as in the JAX package)."""
    ok = torch.linalg.vector_norm(g, dim=-1) <= _implicit_tol(x)
    return torch.where(ok[..., None], y, torch.full_like(y, float("nan")))


def _solve(A, b):
    """A⁻¹ b by LU with partial pivoting, batched (``jnp.linalg.solve``'s
    rule); a singular A gives inf or NaN instead of raising."""
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]


def _mat_scale(dt):
    """dt as a factor of (…, n, n) matrices: dt is a float, a 0-d tensor or
    (…, 1) beside states (…, n)."""
    return dt[..., None] if torch.is_tensor(dt) and dt.ndim > 0 else dt


def batched_jacfwd(f, argnums):
    """``torch.func.jacfwd`` of ``f(x, u)`` in ``argnums`` mapped over the
    leading dimensions of x (…, n) and u (…, m): (…, n, ·) each."""
    jac = torch.func.vmap(torch.func.jacfwd(f, argnums=argnums))

    def batched(x, u):
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        n, m = x.shape[-1], u.shape[-1]
        out = jac(x.expand(lead + (n,)).reshape(-1, n),
                  u.expand(lead + (m,)).reshape(-1, m))
        return torch.utils._pytree.tree_map(
            lambda J: J.reshape(lead + J.shape[1:]), out)

    return batched


# the widest state whose Newton Jacobian is taken by reverse-mode autograd:
# n backward passes beat jacfwd's mapped forward pass for the zoo's narrow
# models (n <= 4); for the quadrotors (n = 12, 13) one mapped forward pass
# is as fast
_REVERSE_MAX_N = 8


def newton_jac_x(f):
    """``jac(x, u) -> ∂f/∂x`` (…, n, n) for the Newton loop, batched over
    the leading dimensions of x (…, n) and u (…, m). Up to
    ``_REVERSE_MAX_N`` states by reverse-mode autograd: each problem's
    outputs depend on its own inputs only, so the gradient of a state's
    derivative summed over the problems is that state's row of every
    problem's Jacobian, one backward pass a row; wider states by
    :func:`batched_jacfwd`."""
    fwd = batched_jacfwd(f, 0)

    def jac(x, u):
        n = x.shape[-1]
        if n > _REVERSE_MAX_N:
            return fwd(x, u)
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        with torch.enable_grad():
            xg = x.detach().expand(lead + (n,)).contiguous().requires_grad_()
            y = f(xg, u.expand(lead + u.shape[-1:]))
            rows = []
            for i in range(y.shape[-1]):
                g = torch.autograd.grad(
                    y[..., i].sum(), xg, retain_graph=i + 1 < y.shape[-1],
                    allow_unused=True)[0] if y.requires_grad else None
                rows.append(torch.zeros_like(xg) if g is None else g)
        return torch.stack(rows, dim=-2).detach()

    return jac


def midpoint_implicit(f, jac_x=None):
    """Implicit midpoint rule (reference src/integration.jl:44-68): solves
    y = x + dt·f((x + y)/2, u) by Newton iteration with the exact state
    Jacobian of f (``jac_x(x, u)``, batched; by default ``torch.func``'s
    :func:`newton_jac_x` of f), to each problem's tolerance
    (:func:`_newton_iterate`); a step that misses it is NaN
    (:func:`_poison_unconverged`)."""
    jac_x = jac_x or newton_jac_x(f)

    def step(x, u, dt):
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        dtm = _mat_scale(dt)

        def residual(y):
            return y - x - dt * f(0.5 * (x + y), u)

        def newton(y):
            xm = 0.5 * (x + y)
            g = y - x - dt * f(xm, u)
            dg = eye - 0.5 * dtm * jac_x(xm, u)
            return y - _solve(dg, g)

        y, g = _newton_iterate(x, residual, newton)
        return _poison_unconverged(y, g, x)

    return step


def rk3_implicit(f, jac_x=None):
    """Implicit RK3 / Hermite-Simpson style step (reference
    src/integration.jl:171-210), Newton as :func:`midpoint_implicit`; a
    step that misses the tolerance is NaN."""
    jac_x = jac_x or newton_jac_x(f)

    def step(x, u, dt):
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        dtm = _mat_scale(dt)
        fc1 = f(x, u)

        def residual(y):
            fc3 = f(y, u)
            xm = 0.5 * (x + y) + dt / 8.0 * (fc1 - fc3)
            fc2 = f(xm, u)
            return (y - x - dt / 6.0 * fc1 - 4.0 / 6.0 * dt * fc2
                    - dt / 6.0 * fc3)

        def newton(y):
            fc3 = f(y, u)
            xm = 0.5 * (x + y) + dt / 8.0 * (fc1 - fc3)
            g = (y - x - dt / 6.0 * fc1 - 4.0 / 6.0 * dt * f(xm, u)
                 - dt / 6.0 * fc3)
            # ∂f at xm and at y in one mapped jacfwd
            a1, a2 = jac_x(torch.stack([xm, y]), u)
            dg = (eye - 4.0 / 6.0 * dtm * a1 @ (0.5 * eye - dtm / 8.0 * a2)
                  - dtm / 6.0 * a2)
            return y - _solve(dg, g)

        y, g = _newton_iterate(x, residual, newton)
        return _poison_unconverged(y, g, x)

    return step


INTEGRATORS = {
    "euler": euler,
    "midpoint": midpoint,
    "rk3": rk3,
    "rk4": rk4,
    "midpoint_implicit": midpoint_implicit,
    "rk3_implicit": rk3_implicit,
}


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
