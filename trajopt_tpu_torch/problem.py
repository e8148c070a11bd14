"""Problem container.

Counterpart of ``trajopt_tpu/problem.py`` (reference src/problem.jl). A
``Problem`` bundles the discrete model, the stacked objective, the
constraint set, the initial state and the seeds, all on one device and in
one dtype. ``dt`` is kept as a Python float: the kernels take one uniform
step size as an argument. A per-interval ``dt`` (N-1,) carried over from
the JAX package (``convert.py``: the steps a minimum-time solve found) is a
tensor, which the CPU solves and the fused paths take.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trajopt_tpu_torch.models.base import DiscreteModel
from trajopt_tpu_torch.ops.constraints import (
    ConstraintSet, ConstraintSetBuilder, empty_constraints,
)
from trajopt_tpu_torch.ops.cost import Objective
from trajopt_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Problem:
    """(reference src/problem.jl:37-72)."""

    x0: torch.Tensor          # (n,)
    xf: torch.Tensor          # (n,)
    X: torch.Tensor           # (N, n) state seed/solution
    U: torch.Tensor           # (N-1, m) control seed/solution
    obj: Objective
    constraints: ConstraintSet
    dt: float                 # or a (N-1,) tensor (module docstring)
    tf: float
    model: DiscreteModel
    N: int

    @property
    def n(self):
        return self.model.n

    @property
    def m(self):
        return self.model.m

    @property
    def device(self):
        return self.U.device

    def dt_traj(self):
        """(N-1,) per-interval step sizes (reference get_dt_traj,
        problem.jl:292-314)."""
        if torch.is_tensor(self.dt):
            return self.dt
        return torch.full((self.N - 1,), self.dt, dtype=self.U.dtype,
                          device=self.U.device)


def problem(model: DiscreteModel, obj: Objective, constraints=None, x0=None,
            xf=None, N=None, dt=None, tf=None, U0=None, X0=None,
            dtype=torch.float64, device=None) -> Problem:
    """Build a Problem with reference time validation semantics
    (reference _validate_time, problem.jl:169-220): give two of (N, tf, dt).
    ``constraints`` is a ConstraintSetBuilder or a compiled ConstraintSet;
    everything lands on ``device`` (None: the current CUDA device).
    """
    device = resolve_device(device)
    N, dt, tf = _validate_time(N, tf, dt, obj)
    n, m = model.n, model.m

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    obj = obj.to(dtype=dtype, device=device)
    x0 = torch.zeros(n, dtype=dtype, device=device) if x0 is None \
        else tensor(x0)
    xf = torch.zeros(n, dtype=dtype, device=device) if xf is None \
        else tensor(xf)
    if U0 is None:
        U = torch.zeros((N - 1, m), dtype=dtype, device=device)
    else:
        U = tensor(U0)
        if U.ndim == 1:
            U = U.expand(N - 1, m).clone()
    if X0 is None:
        # NaN ⇒ "no state seed" (reference problem.jl:84)
        X = torch.full((N, n), float("nan"), dtype=dtype, device=device)
        X[0] = x0
    else:
        X = tensor(X0)
    if constraints is None:
        cs = empty_constraints(N, device=device)
    elif isinstance(constraints, ConstraintSetBuilder):
        cs = constraints.stack(device=device)
    else:
        cs = constraints.to(device)
    return Problem(x0=x0, xf=xf, X=X, U=U, obj=obj, constraints=cs, dt=dt,
                   tf=tf, model=model, N=N)


def _validate_time(N, tf, dt, obj):
    if N is None:
        N = obj.N if hasattr(obj, "N") else None
    if tf is not None and tf > 0:
        if N is not None and dt is None:
            dt = tf / (N - 1)
        elif dt is not None and N is None:
            N = int(round(tf / dt)) + 1
    elif dt is not None and N is not None:
        tf = dt * (N - 1)
    elif tf == 0:
        # minimum-time problem (reference problem.jl:177): seed dt required
        if dt is None:
            raise ValueError("minimum-time problems need a seed dt")
        tf = dt * (N - 1)
    if N is None or dt is None or tf is None:
        raise ValueError("must specify two of (N, tf, dt)")
    return N, float(dt), float(tf)


def initial_controls(prob: Problem, U0) -> Problem:
    """(reference initial_controls!, problem.jl:148-150): a (N-1, m) seed,
    or one (m,) control held at every knot."""
    U = torch.as_tensor(np.asarray(U0), dtype=prob.U.dtype,
                        device=prob.device)
    if U.ndim == 1:
        U = U.expand(prob.U.shape).clone()
    return dataclasses.replace(prob, U=U)


def initial_states(prob: Problem, X0) -> Problem:
    """(reference initial_states!, problem.jl:152-154). A finite state seed
    asks ALTRO for the infeasible-start transform (reference
    altro_methods.jl:100)."""
    X = torch.as_tensor(np.asarray(X0), dtype=prob.X.dtype,
                        device=prob.device)
    return dataclasses.replace(prob, X=X)


def update_problem(prob: Problem, **kwargs) -> Problem:
    """(reference update_problem, problem.jl:137-146)."""
    return dataclasses.replace(prob, **kwargs)



def cost(prob: Problem) -> torch.Tensor:
    """(reference cost(prob), problem.jl:240): the objective at the
    problem's own X and U."""
    return prob.obj.total(prob.X, prob.U, prob.dt_traj())


def max_violation(prob: Problem) -> torch.Tensor:
    """(reference max_violation(prob), problem.jl:242-267)."""
    C = prob.constraints.evaluate(prob.X, prob.U)
    return prob.constraints.max_violation(C)
