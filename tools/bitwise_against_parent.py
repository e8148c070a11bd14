#!/usr/bin/env python3
"""Hold kernels K1, K2, K3, K4, K5, K7a and K7b bitwise against another
tree's, on one GPU.

    python3 tools/bitwise_against_parent.py PARENT [sqrt_sweep]

PARENT is the root of another checkout of this repository (for example the
parent commit, unpacked by ``git archive`` into a directory that
``.gitignore`` lists) whose kernels have this tree's C interfaces
(``kernels/_build.py`` SIGNATURES); a model's id is translated to the other
tree's numbering (its ``kModelSlack`` and ``kModelMinTime`` in
``csrc/models.cuh``). Its ``sqrt_sweep.cu`` (K1), ``rollout.cu`` (K2),
``fused_al_backward.cu`` (K3), ``fused_al_forward.cu`` (K4),
``riccati_sweep.cu`` (K5), ``fused_backward.cu`` (K7a) and
``fused_forward.cu`` (K7b), or with ``sqrt_sweep`` K1's alone, are
built by nvcc with the flags of ``kernels/_build.py`` under
``build/parent_kernels/``, side by side. On the inputs of
``chip_smoke.py``'s checks at B = 128, each output of this tree's kernel
is compared with the other's bit for bit: K1 on ``chip_smoke.k1_inputs``
at ρ = 0 (the equilibrated-fallback and failing problems among them) and
1e-2, at B = 128 and 1024 (slice 1's batch, and the 128 problems tiled),
and on the cartpole's (4,1), the car's (3,2) and ``k1_any_shape_inputs``'
(5,3) and (13,17) sweeps at both ρ; K3 for
every (model, slack) instantiation at ρ = 1 and 0 (the maze's and kuka's
stacks among them), the in-kernel Jacobians too; K4 on the maze's search
with its branch lanes; K5 at ρ = 1 and 0, control and state
regularization, and K7a at ρ = 1 and 0 with its Jacobians, on the five
scalar models, the three rigs and kuka (path (a)'s inputs), and K5 at ρ =
1 at every slack-augmented shape on the AL expansion (the maze's (13,17)
among them); K7b on their searches; K2 for every form the other tree's
K2 carries: the quadrotor's error state on slice 1's candidates
(``chip_smoke.rollout_inputs``), each model of K3 with and without slacks
(kuka and the rigs among them) on K3's gains at ρ = 1 on its set-up,
ballonbeam, the Euler-angle quadrotor and every scalar model's minimum-time
forms on ``chip_smoke.form_setup``'s inputs (K5's gains at the form's ρ,
its steps at the form's α), lanes K4_DIVERGE blown up; and K5 on those
forms' linearizations. Each case is also timed, both trees
in turns (other, this, this, other; CUDA events over 10 launches each),
and the ones of ``chip_smoke.py``'s main paths at their batch too: B =
1024 for K3's cartpole (slice 3 arm (c)), K5 (13,4) (arm (b)) and (4,1)
(arm (c) phase-split), K7a's and K7b's quadrotor (arm (a)); B = 64 for K5
(14,7) (the kuka pool). The times are of the two trees' C entry points on
the same arguments. Prints one line per case and the card's
``nvidia-smi`` line; exits non-zero if any output differs.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the kernels compared, by source: the C entry point called in both trees
PARENT = {
    "sqrt_sweep": "trajopt_sqrt_sweep_f32",
    "rollout": "trajopt_rollout_f32",
    "fused_al_backward": "trajopt_fused_al_backward_f32",
    "fused_al_forward": "trajopt_fused_al_forward_f32",
    "fused_forward": "trajopt_fused_forward_f32",
    "riccati_sweep": "trajopt_riccati_sweep_f32",
    "fused_backward": "trajopt_fused_backward_f32",
}


def build(parent: Path, stems):
    from trajopt_tpu_torch.kernels import _build

    csrc = parent / "trajopt_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in stems:
        lib = out / f"lib{stem}.so"
        jobs[stem] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib),
             str(csrc / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for stem, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
        name = PARENT[stem]
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.argtypes = list(_build.SIGNATURES[stem][name])
        fn.restype = ctypes.c_int
        fns[stem] = fn
    return fns


# the other tree's kModelSlack and kModelMinTime (set by main)
THEIR_IDS = {}


def their_id(cm) -> int:
    """The other tree's id of this tree's entry ``cm``: its base model's id
    (the same in both trees) plus the other tree's offsets."""
    from trajopt_tpu_torch.ops.cuda_models import MINTIME_ID, SLACK_ID

    mintime, rest = divmod(cm.id, MINTIME_ID)
    slack, base = divmod(rest, SLACK_ID)
    return (base + slack * THEIR_IDS["Slack"]
            + mintime * THEIR_IDS["MinTime"])


def model_id(cm, f, stem) -> int:
    """``cm``'s id for the entry point ``f`` of kernel ``stem``: this
    tree's, or the other tree's numbering."""
    from trajopt_tpu_torch.kernels import _build

    this = getattr(_build.load(), PARENT[stem])
    return cm.id if f is this else their_id(cm)


def read_their_ids(parent: Path):
    import re

    src = (parent / "trajopt_tpu_torch" / "csrc" / "models.cuh").read_text()
    for key in ("Slack", "MinTime"):
        THEIR_IDS[key] = int(re.search(rf"kModel{key} = (\d+)",
                                       src).group(1))


def ms_per_launch(fn, reps=10):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(label, run_mine, call, stem, fn, theirs):
    """Run both trees' kernels once (``call(fn)`` launches the other tree's
    entry point ``fn``, fills ``theirs`` and returns the CUDA error;
    ``run_mine`` this tree's wrapper), count the entries of each output
    that differ bitwise, time both trees' C entry points on the same
    arguments in turns (the wrapper's checks and allocations left out, as
    the other tree's call has none), print, and return whether none
    differs."""
    import torch
    from trajopt_tpu_torch.kernels import _build

    if call(fn):
        raise RuntimeError(f"{label}: the other tree's launch failed")
    mine = run_mine()
    torch.cuda.synchronize()
    diffs = []
    for a, b in zip(mine, theirs):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        diffs.append(int((a != b).sum()))
    this = getattr(_build.load(), PARENT[stem])
    t0, m0, m1, t1 = (ms_per_launch(lambda f=f: call(f))
                      for f in (fn, this, this, fn))
    print(f"{label}: entries that differ, by output: {diffs}; ms a launch: "
          f"this tree {(m0 + m1) / 2:.4f}, the other {(t0 + t1) / 2:.4f}",
          flush=True)
    return not any(diffs)


def k1_case(fn, label, ins, rho_val):
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_sqrt import (
        sqrt_sweep_cuda, sqrt_sweep_shape)

    A, Bm = ins[0], ins[1]
    Bz, N1, n, m = Bm.shape
    dev = A.device
    rho = torch.full((Bz,), rho_val, device=dev)
    K, d = torch.empty(Bz, N1, m, n, device=dev), torch.empty(Bz, N1, m,
                                                             device=dev)
    dV = torch.empty(Bz, 2, device=dev)
    fail = torch.empty(Bz, dtype=torch.bool, device=dev)
    def call(f):
        return f(*(t.data_ptr() for t in (*ins, rho, K, d, dV, fail)), Bz,
                  N1 + 1, n, m, _build.stream(dev))

    sh = sqrt_sweep_shape(n, m, Bz)
    return same(f"K1 {label} ({n},{m}) B={Bz} rho={rho_val:g} (Wc, Wp, G) "
                f"= ({sh['consumers']}, {sh['producers']}, "
                f"{sh['knots_a_step']})",
                lambda: sqrt_sweep_cuda(*ins, rho), call, "sqrt_sweep", fn,
                (K, d, dV[:, 0], dV[:, 1], fail))


def k2_case(fn, label, model, ins, dt, error_state=False):
    """K2 on ``ins`` = (x0, X, U, K, d, alpha): X̄, Ū and ok."""
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda

    cm = cuda_model(model, "bitwise_against_parent", slack_ok=True,
                    k2_only_ok=True)
    X, U = ins[1], ins[2]
    Bz, N, _ = X.shape
    dev = X.device
    Xo, Uo = torch.empty_like(X), torch.empty_like(U)
    ok = torch.empty(Bz, dtype=torch.bool, device=dev)
    def call(f):
        return f(*(t.data_ptr() for t in ins), Xo.data_ptr(), Uo.data_ptr(),
                  ok.data_ptr(), chain_table_ptr(model, cm, dev), Bz, N,
                  model_id(cm, f, "rollout"), int(error_state), float(dt),
                  1e8, 1e8, _build.stream(dev))

    kw = dict(quat_slice=(3, 7)) if error_state else {}
    return same(f"K2 {label} B={Bz} N={N}",
                lambda: rollout_closed_loop_cuda(model, *ins, dt, **kw),
                call, "rollout", fn, (Xo, Uo, ok))


def k3_case(fn, label, model, canon, X, U, lam, mu, dt, obj, rho):
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_al_fused import fused_al_backward_cuda
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    cm = cuda_model(model, "bitwise_against_parent", slack_ok=True)
    Bz, N, n = X.shape
    dev = X.device
    new = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    K, d, dV = new(Bz, N - 1, cm.m, n), new(Bz, N - 1, cm.m), new(2, Bz)
    fail = torch.empty(Bz, dtype=torch.bool, device=dev)
    A, Bo = new(Bz, N - 1, n, n), new(Bz, N - 1, n, cm.m_base)
    def call(f):
        return f(X.data_ptr(), U.data_ptr(), lam.data_ptr(), mu.data_ptr(),
                  dt.data_ptr(), obj.Q.data_ptr(), obj.R.data_ptr(),
                  obj.H.data_ptr(), obj.q.data_ptr(), obj.r.data_ptr(),
                  rho.data_ptr(), canon.row_i.data_ptr(),
                  canon.row_f.data_ptr(), canon.groups.data_ptr(),
                  canon.col_ptr.data_ptr(), canon.col_rows.data_ptr(),
                  canon.fk_joint.data_ptr(), canon.fk_point.data_ptr(),
                  chain_table_ptr(model, cm, dev), K.data_ptr(), d.data_ptr(),
                  dV.data_ptr(), fail.data_ptr(), A.data_ptr(),
                  Bo.data_ptr(), Bz, N, canon.P, canon.groups.shape[0],
                  canon.fk_joint.shape[0], canon.fk_point.shape[0],
                  model_id(cm, f, "fused_al_backward"), 0, 0.0, None,
                  _build.stream(dev))

    def mine():
        out = fused_al_backward_cuda(model, canon, X, U, lam, mu, dt, obj,
                                     rho, return_jacobians=True)
        return out[:6] + (out[6][..., :cm.m_base],)

    mine()          # (its block, for the label)
    return same(f"K3 {label} B={Bz} rho={float(rho[0]):g} "
                f"(Wc, Wp) = {fused_al_backward_cuda.warps}", mine, call,
                "fused_al_backward", fn,
                (K, d, dV[0], dV[1], fail, A, Bo))


def k4_case(fn, args):
    """K4 on chip_smoke's maze search (``args`` as phase_k4 builds them)."""
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_al_fused import fused_al_forward_cuda
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    (model, canon, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho, alpha0, lam,
     mu, dt, obj, opts) = args
    cm = cuda_model(model, "bitwise_against_parent", slack_ok=True)
    Bz, N, _ = X.shape
    dev = X.device
    W = _build.load().trajopt_fused_al_forward_warps(cm.id, Bz)
    ws = torch.empty(Bz * W * (N * cm.n + (N - 1) * cm.m), device=dev)
    Xo, Uo = torch.empty_like(X), torch.empty_like(U)
    scal = torch.empty(4, Bz, device=dev)
    lb, ub, iters, reg_min, reg_factor, reg_fp = opts
    def call(f):
        return f(x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
                  d.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
                  J_prev.data_ptr(), rho.data_ptr(), drho.data_ptr(),
                  alpha0.data_ptr(), lam.data_ptr(), mu.data_ptr(),
                  dt.data_ptr(), obj.Q.data_ptr(), obj.R.data_ptr(),
                  obj.H.data_ptr(), obj.q.data_ptr(), obj.r.data_ptr(),
                  obj.c.data_ptr(), canon.row_i.data_ptr(),
                  canon.row_f.data_ptr(), canon.fk_joint.data_ptr(),
                  canon.fk_point.data_ptr(), None,
                  chain_table_ptr(model, cm, dev), ws.data_ptr(), ws.numel(),
                  Xo.data_ptr(), Uo.data_ptr(), scal.data_ptr(), Bz, N,
                  canon.P, canon.fk_joint.shape[0], canon.fk_point.shape[0],
                  model_id(cm, f, "fused_al_forward"), int(iters), lb, ub,
                  reg_min, reg_factor, reg_fp, 0.0, _build.stream(dev))

    return same(f"K4 {cm.label} B={Bz} W={W}",
                lambda: fused_al_forward_cuda(*args), call,
                "fused_al_forward", fn,
                (Xo, Uo, *scal))


def k5_case(fn, label, ins, reg_state, rho_val=1.0):
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_riccati import (
        riccati_sweep_cuda, riccati_sweep_shape)

    A, Bm = ins[0], ins[1]
    Bz, N1, n, m = Bm.shape
    dev = A.device
    rho = torch.full((Bz,), rho_val, device=dev)
    K, d = torch.empty(Bz, N1, m, n, device=dev), torch.empty(Bz, N1, m,
                                                             device=dev)
    dV = torch.empty(2, Bz, device=dev)
    fail = torch.empty(Bz, dtype=torch.bool, device=dev)
    def call(f):
        return f(*(t.data_ptr() for t in (*ins, rho, K, d, dV, fail)), Bz,
                  N1 + 1, n, m, int(reg_state), _build.stream(dev))

    sh = riccati_sweep_shape(n, m, Bz)
    return same(f"K5 {label} ({n},{m}) B={Bz} rho={rho_val:g} "
                f"reg_state={reg_state} (Wc, Wp) = "
                f"({sh['consumers']}, {sh['producers']})",
                lambda: riccati_sweep_cuda(*ins, rho, reg_state=reg_state),
                call, "riccati_sweep", fn, (K, d, dV[0], dV[1], fail))


def k7a_case(fn, label, st, rho_val=1.0, X=None, U=None):
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_fused import (
        fused_backward_cuda, fused_backward_shape)
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    model, dt, obj = st["model"], st["dt_traj"], st["obj"]
    X = st["X"] if X is None else X
    U = st["U"] if U is None else U
    cm = cuda_model(model, "bitwise_against_parent")
    Bz, N, n = X.shape
    dev = X.device
    rho = torch.full((Bz,), rho_val, device=dev)
    new = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    K, d, dV = new(Bz, N - 1, cm.m, n), new(Bz, N - 1, cm.m), new(2, Bz)
    fail = torch.empty(Bz, dtype=torch.bool, device=dev)
    A, Bo = new(Bz, N - 1, n, n), new(Bz, N - 1, n, cm.m)
    def call(f):
        return f(X.data_ptr(), U.data_ptr(), dt.data_ptr(),
                  obj.Q.data_ptr(), obj.R.data_ptr(), obj.H.data_ptr(),
                  obj.q.data_ptr(), obj.r.data_ptr(), rho.data_ptr(),
                  chain_table_ptr(model, cm, dev), K.data_ptr(), d.data_ptr(),
                  dV.data_ptr(), fail.data_ptr(), A.data_ptr(),
                  Bo.data_ptr(), Bz, N, model_id(cm, f, "fused_backward"), 0,
                  _build.stream(dev))

    sh = fused_backward_shape(model, Bz)
    return same(f"K7a {label} B={Bz} rho={rho_val:g} (Wc, Wp, G) = "
                f"({sh['consumers']}, {sh['producers']}, "
                f"{sh['knots_a_step']})", lambda: fused_backward_cuda(
        model, X, U, dt, obj, rho, return_jacobians=True), call,
        "fused_backward", fn, (K, d, dV[0], dV[1], fail, A, Bo))


def k7b_case(fn, label, args):
    import torch
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_fused import fused_forward_cuda
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    (model, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho, alpha0, dt, obj,
     opts) = args
    cm = cuda_model(model, "bitwise_against_parent")
    Bz, N, _ = X.shape
    dev = X.device
    W = _build.load().trajopt_fused_forward_warps(cm.id, Bz)
    ws = torch.empty(Bz * W * (N * cm.n + (N - 1) * cm.m) if W > 1 else 1,
                     device=dev)
    Xo, Uo = torch.empty_like(X), torch.empty_like(U)
    scal = torch.empty(4, Bz, device=dev)
    lb, ub, iters, reg_min, reg_factor, reg_fp = opts
    def call(f):
        return f(x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
                  d.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
                  J_prev.data_ptr(), rho.data_ptr(), drho.data_ptr(),
                  alpha0.data_ptr(), dt.data_ptr(), obj.Q.data_ptr(),
                  obj.R.data_ptr(), obj.H.data_ptr(), obj.q.data_ptr(),
                  obj.r.data_ptr(), obj.c.data_ptr(), None,
                  chain_table_ptr(model, cm, dev),
                  ws.data_ptr() if W > 1 else None,
                  ws.numel() if W > 1 else 0, Xo.data_ptr(), Uo.data_ptr(),
                  scal.data_ptr(), Bz, N, model_id(cm, f, "fused_forward"),
                  int(iters), lb, ub, reg_min,
                  reg_factor, reg_fp, _build.stream(dev))

    fused_forward_cuda(*args)
    return same(f"K7b {label} B={Bz} W={fused_forward_cuda.warps}",
                lambda: fused_forward_cuda(*args), call, "fused_forward", fn,
                (Xo, Uo, *scal))


def main():
    import torch
    import chip_smoke as cs
    from trajopt_tpu_torch.ops.canonical import canon_al_cost, pad_terminal
    from trajopt_tpu_torch.ops.cost import total_cost
    from trajopt_tpu_torch.ops.cuda_al_fused import fused_al_backward_cuda
    from trajopt_tpu_torch.ops.cuda_fused import fused_backward_cuda

    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([],
                                                           ["sqrt_sweep"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bitwise_against_parent: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    read_their_ids(Path(sys.argv[1]))
    fns = build(Path(sys.argv[1]), sys.argv[2:] or list(PARENT))
    dev = torch.device("cuda", 0)
    B = cs.B
    one, zero = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    tile = torch.arange(B, device=dev).repeat(8)
    ok = True

    # K1: slice 1's inputs with the branch problems, at B = 128 and 1024,
    # and two small shapes
    if "sqrt_sweep" in fns:
        ins, _ = cs.k1_inputs()
        big = [t[tile].contiguous() for t in ins]
        for rho_val in (0.0, 1e-2):
            ok &= k1_case(fns["sqrt_sweep"], "quadrotor error state", ins,
                          rho_val)
            ok &= k1_case(fns["sqrt_sweep"], "quadrotor error state", big,
                          rho_val)
        smalls = [(name, cs.sweep_inputs(cs.model_setup(name),
                                         torch.float32))
                  for name in ("cartpole", "car")]
        smalls += [("any shape", [t.float().contiguous()
                                  for t in cs.k1_any_shape_inputs(*nm)])
                   for nm in ((5, 3), (13, 17))]
        for name, small in smalls:
            for rho_val in (0.0, 1e-2):
                ok &= k1_case(fns["sqrt_sweep"], name, small, rho_val)
    if set(fns) == {"sqrt_sweep"}:
        print("every output bitwise equal" if ok else "outputs differ",
              flush=True)
        return 0 if ok else 1

    # K3: the maze, every other (model, slack) pair, kuka with the fk rows
    ms = cs.maze_setup(torch.float32, B)
    maze = (ms["prob"].model, ms["canon"], ms["X"], ms["U"], ms["lam"],
            ms["mu"], ms["dt"], ms["prob"].obj)
    for rho in (one, zero):
        ok &= k3_case(fns["fused_al_backward"], "quadrotor_slack", *maze,
                      rho)
    setups = [cs.al_setup(name, slack) for name in (
        "car", "cartpole", "pendulum", "doubleintegrator", "quadrotor",
        *cs.RIGS) for slack in (False, True) if (name, slack) != (
        "quadrotor", True)]
    setups += [cs.kuka_setup(slack) for slack in (False, True)]
    for st in setups:
        p = st["p32"]
        for rho in (one, zero):
            ok &= k3_case(fns["fused_al_backward"], st["label"], p.model,
                          st["canon"], *st["data"], p.dt_traj(), p.obj, rho)

    # K5 at the slack-augmented shapes (n, m + n), on the AL expansion, as
    # chip_smoke.py's phase_k5 (the maze) and al_case (the rest) build them
    from trajopt_tpu_torch.solvers.al import al_cost_fns

    mz = cs.maze_setup(torch.float64, B)
    al_inputs = [("quadrotor_slack", mz["prob"], mz["X"], mz["U"], mz["lam"],
                  mz["mu"])]
    al_inputs += [(st["label"], st["p64"], *st["data64"]) for st in setups
                  if st["label"].endswith("_slack")]
    for label, p64, X64, U64, lam64, mu64 in al_inputs:
        dt64 = p64.dt_traj()
        A, Bm = p64.model.jacobian_traj(X64[:, :-1], U64, dt64)
        e = al_cost_fns(p64.obj, p64.constraints, dt64, lam64, mu64)[1](
            X64, U64)
        ins = [t.float().contiguous()
               for t in (A, Bm, e.x, e.u, e.xx, e.uu, e.ux)]
        ok &= k5_case(fns["riccati_sweep"], label, ins, False)

    # K4: the maze's search as phase_k4 builds it
    prob = ms["prob"]
    canon, X, U, lam, mu, dt = maze[1:7]
    K, d, dV1, dV2, _ = fused_al_backward_cuda(prob.model, canon, X, U, lam,
                                               mu, dt, prob.obj, one)
    J_prev = (total_cost(prob.obj, X, U, dt) + canon_al_cost(
        canon, X, pad_terminal(U), lam, mu)).contiguous()
    d = d.clone()
    for lane in cs.K4_DIVERGE:
        d[lane] *= 1e6
    J_prev[cs.K4_EXHAUST] = -1e30
    alpha0 = (0.5 ** (6 + torch.arange(B, device=dev) % 4)).float()
    ok &= k4_case(fns["fused_al_forward"], (
        prob.model, canon, X[:, 0].contiguous(), X, U, K, d, dV1, dV2,
        J_prev, one, one.clone(), alpha0, lam, mu, dt, prob.obj,
        cs.LS_OPTS))

    # K5 and K7a on chip_smoke's K7a set-ups, K7b on their searches
    for name in (*cs.MODELS, *cs.RIGS):
        st = cs.model_setup(name)
        ins = cs.sweep_inputs(st, torch.float32)
        for rho_val in (1.0, 0.0):
            for reg_state in (False, True):
                ok &= k5_case(fns["riccati_sweep"], name, ins, reg_state,
                              rho_val)
            ok &= k7a_case(fns["fused_backward"], name, st, rho_val)
        if name in ("quadrotor", "cartpole"):
            # slice 3 arms (b) and (a), and (c) phase-split: B = 1024
            big = [t[tile].contiguous() for t in ins]
            for rho_val in (1.0, 0.0):
                ok &= k5_case(fns["riccati_sweep"], name, big, False,
                              rho_val)
                if name == "quadrotor":
                    ok &= k7a_case(fns["fused_backward"], name, st, rho_val,
                                   X=st["X"][tile].contiguous(),
                                   U=st["U"][tile].contiguous())
        K, d, dV1, dV2, _ = fused_backward_cuda(
            st["model"], st["X"], st["U"], st["dt_traj"], st["obj"], one)
        st.update(K=K, d=d, dV1=dV1, dV2=dV2)
        x0, d, J_prev, alpha0 = cs.search_inputs(st)
        opts = cs.LS_OPTS_CHAIN if name in cs.RIGS else cs.LS_OPTS
        ok &= k7b_case(fns["fused_forward"], name, (
            st["model"], x0, st["X"], st["U"], K, d, dV1, dV2, J_prev, one,
            one.clone(), alpha0, st["dt_traj"], st["obj"], opts))
        if name == "quadrotor":      # slice 3 arm (a): B = 1024
            big = [t[tile].contiguous() for t in (
                x0, st["X"], st["U"], K, d, dV1, dV2, J_prev, one, one,
                alpha0)]
            ok &= k7b_case(fns["fused_forward"], name, (
                st["model"], *big, st["dt_traj"], st["obj"], opts))
    # kuka on path (a)'s inputs: K7a, and K5 (14,7) at B = 128 and at the
    # pool's 64
    st = cs.kuka_free_setup()
    ins = cs.sweep_inputs(st, torch.float32)
    for rho_val in (1.0, 0.0):
        ok &= k7a_case(fns["fused_backward"], "kuka", st, rho_val)
        for reg_state in (False, True):
            ok &= k5_case(fns["riccati_sweep"], "kuka", ins, reg_state,
                          rho_val)
    ok &= k5_case(fns["riccati_sweep"], "kuka",
                  [t[:64].contiguous() for t in ins], False)
    # K2: slice 1's error-state candidates; K3's gains at rho = 1 on its
    # set-ups (the maze's slack quadrotor, every other model of K3 with and
    # without slacks, kuka's), lanes K4_DIVERGE blown up; and the other
    # tree's other forms (ballonbeam and the Euler-angle quadrotor plain
    # and with slacks, every scalar model's minimum-time forms) on
    # form_setup's inputs, K5's gains at the form's rho, with K5 on those
    # linearizations
    from trajopt_tpu_torch.models import zoo
    from trajopt_tpu_torch.models.base import discretize
    from trajopt_tpu_torch.ops.cuda_models import CHAIN_LABELS, CUDA_STEPS
    from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda

    ins, dt = cs.rollout_inputs()
    ok &= k2_case(fns["rollout"], "quadrotor error state",
                  discretize(zoo.quadrotor, "rk3"), ins, dt,
                  error_state=True)
    steps = (0.5 ** (torch.arange(B, device=dev) % 4)).float()
    for label, p, canon, (X, U, lam, mu) in [
            ("quadrotor_slack", ms["prob"], ms["canon"],
             (ms["X"], ms["U"], ms["lam"], ms["mu"]))] + [
            (st["label"], st["p32"], st["canon"], st["data"])
            for st in setups]:
        K, d, _, _, _ = fused_al_backward_cuda(p.model, canon, X, U, lam, mu,
                                               p.dt_traj(), p.obj, one)
        for lane in cs.K4_DIVERGE:
            d[lane] *= 1e5
        ok &= k2_case(fns["rollout"], label, p.model,
                      [X[:, 0].contiguous(), X, U, K, d, steps], p.dt)
    for base in CUDA_STEPS.values():
        if base.id >= THEIR_IDS["Slack"] or base.label in CHAIN_LABELS:
            continue            # a model the other tree does not carry
        for slack in (False, True):
            for mintime in (False, True):
                if not mintime and base.label not in ("ballonbeam",
                                                      "quadrotor_euler"):
                    continue    # on K3's gains above
                fs = cs.form_setup(base.label, slack, mintime)
                rho = torch.full((B,), fs["rho"], device=dev)
                ok &= k5_case(fns["riccati_sweep"], fs["label"], fs["ins"],
                              False, fs["rho"])
                K, d, _, _, _ = riccati_sweep_cuda(*fs["ins"], rho)
                for lane in cs.K4_DIVERGE:
                    d[lane] *= 1e5
                p32 = fs["p32"]
                ok &= k2_case(fns["rollout"], fs["label"], p32.model, [
                    fs["X"][:, 0].contiguous(), fs["X"], fs["U"], K, d,
                    torch.full((B,), fs["alpha"], device=dev)], p32.dt)
    # K3's cartpole at B = 1024 (slice 3 arm (c))
    st = next(st for st in setups if st["label"] == "cartpole")
    p = st["p32"]
    X, U, lam, mu = (t[tile].contiguous() for t in st["data"])
    ok &= k3_case(fns["fused_al_backward"], "cartpole", p.model, st["canon"],
                  X, U, lam, mu, p.dt_traj(), p.obj,
                  torch.ones(8 * B, device=dev))
    print("every output bitwise equal" if ok else "outputs differ",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
