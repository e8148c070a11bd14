"""Per-problem tuned solver options from the reference IROS-2019 scripts.

Counterpart of ``trajopt_tpu/problems/tuned.py``, the same table.

The ALTRO paper's benchmark problems each ship with hand-tuned solver
options (reference examples/IROS_2019/<name>.jl, the ``opts_ilqr`` /
``opts_al`` / ``opts_altro`` blocks); with the library defaults some of
them (car_escape most visibly) do not converge at all. This table
reproduces those options 1:1 so benchmarks and examples solve the
problems the way the paper did.

Every script sets max_con_viol = 1e-8 and polishes with projected Newton
unless noted.
"""
from __future__ import annotations

from trajopt_tpu_torch.solvers.al import ALOptions
from trajopt_tpu_torch.solvers.altro import ALTROOptions
from trajopt_tpu_torch.solvers.ilqr import iLQROptions

_TOL = 1e-8


def _altro(ilqr_iters=None, al_iters=None, cost_tol=1e-4,
           cost_tol_int=1e-2, penalty_scaling=10.0, penalty_initial=1.0,
           R_inf=None, resolve=True, pn=True, pn_tol=1e-3):
    kw_ilqr = {} if ilqr_iters is None else {"iterations": ilqr_iters}
    kw_al = {} if al_iters is None else {"iterations": al_iters}
    al = ALOptions(opts_uncon=iLQROptions(**kw_ilqr),
                   cost_tolerance=cost_tol,
                   cost_tolerance_intermediate=cost_tol_int,
                   constraint_tolerance=_TOL,
                   penalty_scaling=penalty_scaling,
                   penalty_initial=penalty_initial, **kw_al)
    kw = {}
    if R_inf is not None:
        kw["R_inf"] = R_inf
    return ALTROOptions(opts_al=al, resolve_feasible_problem=resolve,
                        projected_newton=pn,
                        projected_newton_tolerance=pn_tol, **kw)


# (reference examples/IROS_2019/<key>.jl options blocks)
TUNED_ALTRO = {
    "pendulum": _altro(cost_tol=1e-4, cost_tol_int=1e-3,
                       penalty_scaling=10.0, pn_tol=1e-3),
    "doubleintegrator": _altro(cost_tol=1e-4, cost_tol_int=1e-2,
                               penalty_scaling=1000.0, pn=False),
    "cartpole": _altro(cost_tol=1e-4, cost_tol_int=1e-3,
                       penalty_scaling=50.0, pn_tol=1e-3),
    "acrobot": _altro(cost_tol=1e-5, cost_tol_int=1e-2,
                      penalty_scaling=100.0, pn_tol=1e-4),
    "parallel_park": _altro(al_iters=30, penalty_scaling=10.0, pn_tol=1e-4),
    "car_3obs": _altro(cost_tol=1e-4, cost_tol_int=1e-2,
                       penalty_scaling=50.0, penalty_initial=10.0,
                       pn_tol=1e-3),
    "car_escape": _altro(cost_tol=1e-6, cost_tol_int=1e-2,
                         penalty_scaling=50.0, penalty_initial=10.0,
                         R_inf=1e-1, resolve=False, pn_tol=1e-3),
    "quadrotor": _altro(ilqr_iters=300, al_iters=40, cost_tol=1e-5,
                        cost_tol_int=1e-4, penalty_scaling=10.0,
                        R_inf=1e-8, resolve=False, pn_tol=1e-3),
    "quadrotor_maze": _altro(ilqr_iters=300, al_iters=40, cost_tol=1e-5,
                             cost_tol_int=1e-4, penalty_scaling=10.0,
                             R_inf=1e-8, resolve=False, pn_tol=1e-4),
    "kuka": _altro(ilqr_iters=300, al_iters=20, cost_tol=1e-6,
                   cost_tol_int=1e-5, penalty_scaling=50.0,
                   penalty_initial=0.01, pn=False),
    "kuka_obstacles": _altro(ilqr_iters=300, al_iters=20, cost_tol=1e-6,
                             cost_tol_int=1e-5, penalty_scaling=50.0,
                             penalty_initial=0.01, pn=False),
}


def tuned_altro_options(name: str) -> ALTROOptions:
    """ALTRO options for a zoo problem — the IROS-2019 tuned block if the
    paper shipped one, library defaults otherwise."""
    return TUNED_ALTRO.get(name, ALTROOptions())
