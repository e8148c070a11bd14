"""Problem carry-over from the JAX package.

The port never imports JAX. A problem built by ``trajopt_tpu`` is handed
over as plain numpy arrays: ``problem_arrays`` reads them off any object
with the JAX ``Problem``'s attributes (through ``np.asarray``), and
``problem_from_arrays`` builds the port's ``Problem`` from them, on the
device and in the dtype asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.constraints import empty_constraints
from trajopt_tpu_torch.ops.cost import Objective
from trajopt_tpu_torch.problem import Problem

MODELS = {"quadrotor": zoo.quadrotor}
OBJECTIVE_FIELDS = ("Q", "R", "H", "q", "r", "c")


def problem_arrays(prob) -> dict:
    """The data of a JAX ``Problem`` as numpy arrays: x0, xf, X, U, dt, tf,
    N, the objective's Q, R, H, q, r, c, and the model and integrator
    names. Only unconstrained problems carry over so far."""
    if getattr(prob.constraints, "P", 0) > 0:
        raise NotImplementedError("constraints do not carry over yet "
                                  "(ROADMAP Queue 1, slice 2)")
    out = {k: np.asarray(getattr(prob, k)) for k in ("x0", "xf", "X", "U")}
    out.update({k: np.asarray(getattr(prob.obj, k))
                for k in OBJECTIVE_FIELDS})
    out.update(dt=float(np.asarray(prob.dt)), tf=float(np.asarray(prob.tf)),
               N=int(prob.N), model=prob.model.name,
               integrator=prob.model.integrator)
    return out


def problem_from_arrays(*, model, integrator, x0, xf, X, U, dt, tf, N, Q, R,
                        H, q, r, c, dtype=torch.float64,
                        device="cpu") -> Problem:
    """The port's ``Problem`` from the arrays of :func:`problem_arrays`.
    ``dt`` must be uniform (a scalar)."""
    if model not in MODELS:
        raise NotImplementedError(f"model {model!r} is not ported yet "
                                  "(ROADMAP Queue 1, the rest of the zoo)")
    if np.ndim(dt) != 0:
        raise NotImplementedError("per-interval dt does not carry over yet")

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    obj = Objective(Q=tensor(Q), R=tensor(R), H=tensor(H), q=tensor(q),
                    r=tensor(r), c=tensor(c))
    return Problem(x0=tensor(x0), xf=tensor(xf), X=tensor(X), U=tensor(U),
                   obj=obj, constraints=empty_constraints(N, device=device),
                   dt=float(dt), tf=float(tf),
                   model=discretize(MODELS[model], integrator), N=int(N))
