"""Problem and solver state carried over from the JAX package.

The port never imports JAX. A problem built by ``trajopt_tpu`` is handed
over as plain numpy arrays: ``problem_arrays`` reads them off any object
with the JAX ``Problem``'s attributes (through ``np.asarray``), and
``problem_from_arrays`` builds the port's ``Problem`` from them, on the
device and in the dtype asked for. The constraint set travels as data too:
per constraint its label, its canonical row kind with the parameters, the
equality flags and the knots it applies at. The forward-kinematics rows of
a chain (kuka's collision bubbles) are a function of the arm in the JAX
package; they travel as their ``fk_sphere`` descriptor, which holds the
chain's rotation coefficients, and are rebuilt from it here
(``ops/constraints.py::fk_sphere_constraint``), so a problem that has them
is the same problem on each side whether it is carried over or built by
name (``PROBLEMS["kuka_obstacles"]``). ``state_arrays`` and
``state_from_arrays`` do the same for a solver state (X, U, λ, μ), and
``result_arrays`` hands an ``ALResult`` back as numpy arrays. Options travel
as nested dicts of plain values: ``options_dict`` reads them off the JAX
package's option dataclasses (``ALTROOptions`` with its ``ALOptions``,
``iLQROptions`` and ``PNOptions``), ``altro_options_from_dict`` builds the
port's. ``MODELS`` and ``PROBLEMS`` name the ported models (``kuka`` among
them) and zoo problems (``car_escape``, ``kuka_obstacles`` among them) as
the JAX package's ``models.zoo`` and ``problems.zoo.PROBLEMS`` do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.constraints import (
    ConstraintSet, fk_sphere_constraint, linear_rows_constraint,
    sphere_rows_constraint,
)
from trajopt_tpu_torch.ops.cost import Objective
from trajopt_tpu_torch.problem import Problem
from trajopt_tpu_torch.problems import zoo as problems_zoo
from trajopt_tpu_torch.solvers.al import ALOptions
from trajopt_tpu_torch.solvers.altro import ALTROOptions
from trajopt_tpu_torch.solvers.ilqr import iLQROptions
from trajopt_tpu_torch.solvers.projected_newton import PNOptions
from trajopt_tpu_torch.utils.device import resolve_device

MODELS = zoo.MODELS
# the ported zoo problems under the JAX package's names
PROBLEMS = {name: getattr(problems_zoo, name) for name in (
    "doubleintegrator", "pendulum", "cartpole", "parallel_park", "car_3obs",
    "car_escape", "quadrotor_maze", "kuka_obstacles")}
OBJECTIVE_FIELDS = ("Q", "R", "H", "q", "r", "c")
STATE_FIELDS = ("X", "U", "lam", "mu")


def constraint_arrays(cs) -> list:
    """The constraints of a JAX ``ConstraintSet`` as data, one dict per
    constraint: label, applies, equality (p,), knots (N,) bool, term_rows
    or None, and the canonical descriptor (kind 'sphere': coords, ctr, b;
    kind 'linear': rows of (is_u, idx, sign), off; kind 'fk_sphere': meta,
    the chain's coefficients, points and rows as nested tuples). A
    constraint without a descriptor (a custom function) does not carry
    over."""
    mask = np.asarray(cs.mask)
    out = []
    for con, (r0, r1) in zip(cs.cons, cs.slices):
        canon = getattr(con, "canon", None)
        if canon is None or canon[0] not in ("sphere", "linear",
                                             "fk_sphere"):
            raise NotImplementedError(
                f"constraint {con.label!r} has no canonical descriptor and "
                "does not carry over (ROADMAP Queue 1)")
        d = dict(label=con.label, applies=con.applies,
                 equality=np.asarray(con.equality, bool),
                 knots=mask[:, r0:r1].any(axis=1), kind=canon[0],
                 term_rows=getattr(con, "term_rows", None))
        if canon[0] == "sphere":
            d.update(coords=tuple(canon[1]), ctr=np.asarray(canon[2]),
                     b=np.asarray(canon[3]))
        elif canon[0] == "fk_sphere":
            d.update(meta=canon[1])
        else:
            d.update(rows=tuple(canon[1]), off=np.asarray(canon[2]))
        out.append(d)
    return out


def constraints_from_arrays(constraints, N: int, device=None) -> ConstraintSet:
    """The port's ``ConstraintSet`` from :func:`constraint_arrays` data."""
    entries = []
    for d in constraints:
        if d["kind"] == "sphere":
            con = sphere_rows_constraint(d["coords"], d["ctr"], d["b"],
                                         d["label"], applies=d["applies"])
        elif d["kind"] == "fk_sphere":
            con = fk_sphere_constraint(("fk_sphere", d["meta"]), d["label"],
                                       applies=d["applies"])
        else:
            con = linear_rows_constraint(
                d["rows"], d["off"], d["label"], equality=d["equality"],
                applies=d["applies"], term_rows=d["term_rows"])
        entries.append((con, d["knots"]))
    return ConstraintSet.build(entries, N, device=device)


def problem_arrays(prob) -> dict:
    """The data of a JAX ``Problem`` as numpy arrays: x0, xf, X, U, dt, tf,
    N, the objective's Q, R, H, q, r, c, the model and integrator names,
    and the constraint set (:func:`constraint_arrays`)."""
    out = {k: np.asarray(getattr(prob, k)) for k in ("x0", "xf", "X", "U")}
    out.update({k: np.asarray(getattr(prob.obj, k))
                for k in OBJECTIVE_FIELDS})
    out.update(dt=float(np.asarray(prob.dt)), tf=float(np.asarray(prob.tf)),
               N=int(prob.N), model=prob.model.name,
               integrator=prob.model.integrator,
               constraints=constraint_arrays(prob.constraints))
    return out


def problem_from_arrays(*, model, integrator, x0, xf, X, U, dt, tf, N, Q, R,
                        H, q, r, c, constraints=(), dtype=torch.float64,
                        device=None) -> Problem:
    """The port's ``Problem`` from the arrays of :func:`problem_arrays`, on
    ``device`` (None: the current CUDA device). ``dt`` must be uniform (a
    scalar)."""
    if model not in MODELS:
        raise NotImplementedError(f"model {model!r} is not ported yet "
                                  "(ROADMAP Queue 1, the rest of the zoo)")
    if np.ndim(dt) != 0:
        raise NotImplementedError("per-interval dt does not carry over yet")
    device = resolve_device(device)

    def tensor(a):
        # a copy: arrays read off JAX are read-only views
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    obj = Objective(Q=tensor(Q), R=tensor(R), H=tensor(H), q=tensor(q),
                    r=tensor(r), c=tensor(c))
    return Problem(x0=tensor(x0), xf=tensor(xf), X=tensor(X), U=tensor(U),
                   obj=obj,
                   constraints=constraints_from_arrays(constraints, int(N),
                                                       device=device),
                   dt=float(dt), tf=float(tf),
                   model=discretize(MODELS[model], integrator), N=int(N))


def state_arrays(**state) -> dict:
    """A solver state (any of X, U, lam, mu) as numpy arrays."""
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in state.items() if k in STATE_FIELDS}


def state_from_arrays(dtype=torch.float64, device=None, **state) -> dict:
    """Tensors on ``device`` from the numpy arrays of a solver state."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in state.items() if k in STATE_FIELDS}


def result_arrays(res) -> dict:
    """An ``ALResult`` (of either package) as numpy arrays, the history's
    entries under ``history_<name>``."""
    out = {k: v for k, v in res._asdict().items() if k != "history"}
    out.update({f"history_{k}": v for k, v in res.history.items()})
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def options_dict(opts) -> dict:
    """An options dataclass (of either package) as a dict of plain values,
    nested options as nested dicts, None kept."""
    out = {}
    for f in dataclasses.fields(opts):
        v = getattr(opts, f.name)
        out[f.name] = options_dict(v) if dataclasses.is_dataclass(v) else v
    return out


def altro_options_from_dict(d: dict) -> ALTROOptions:
    """The port's ``ALTROOptions`` from :func:`options_dict` data: nested
    ``opts_al`` (with its ``opts_uncon``) and ``opts_pn`` rebuilt as the
    port's dataclasses. An option the port does not have raises
    ``TypeError``."""
    d = dict(d)
    al = dict(d.pop("opts_al", None) or {})
    uncon = iLQROptions(**(al.pop("opts_uncon", None) or {}))
    pn = d.pop("opts_pn", None)
    return ALTROOptions(opts_al=ALOptions(opts_uncon=uncon, **al),
                        opts_pn=None if pn is None else PNOptions(**pn), **d)
