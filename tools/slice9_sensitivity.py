#!/usr/bin/env python3
"""How far float32 rounding alone moves slice 9's K2 checks on the forms
with slacks or minimum time, on one GPU.

    python3 tools/slice9_sensitivity.py [name ...]

For each slack, minimum-time and minimum-time slack form of the models
``name`` (default: ``chip_smoke.SLICE9_FORM_MODELS``) under each rule of
``chip_smoke.SLICE9_RULES``, on ``chip_smoke.slice9_inputs`` with random
gains on every control (``all``), on all but h (``slack``) and on the base
model's controls alone (``base``), one line each: the kernel's distance
from the float32 plain version (X, of scale), the float32 plain version's
distance from the float64 one (the floor ``chip_smoke.py`` holds the
kernel to three times of), and how far the float32 plain rollout moves
when each start moves by one ulp (``torch.nextafter``): a form whose
rollout moves further than the bar under a 1-ulp move is chaotic in
float32, and no float32 kernel can be held to its plain version there.
The problems held are those alive in every run, lanes
``chip_smoke.SLICE9_DIVERGE`` left out. Prints the card's name and power
limit first.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def of_scale(a, b, mask):
    """max |a − b| over the problems ``mask``, of max(1, max |b|)."""
    return float((a.double() - b.double())[mask].abs().max()) / max(
        1.0, float(b[mask].abs().max()))


def main(names):
    from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
    from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    for name in names:
        for slack, mintime in ((True, False), (False, True), (True, True)):
            for rule in cs.SLICE9_RULES:
                for gains in ("all", "slack", "base"):
                    if gains == "slack" and not mintime:
                        continue        # the same as "all"
                    p64, p32, ins, dt = cs.slice9_inputs(
                        name, slack, mintime, rule, device=dev, gains=gains)
                    model = p32.model
                    Xk, _, okk = rollout_closed_loop_cuda(model, *ins, dt)
                    Xp, _, okp = rollout_closed_loop(model, *ins, dt)
                    X64, _, ok64 = rollout_closed_loop(
                        p64.model, *(t.double() for t in ins), dt)
                    nudged = [torch.nextafter(ins[0], torch.full_like(
                        ins[0], float("inf")))] + ins[1:]
                    Xn, _, okn = rollout_closed_loop(model, *nudged, dt)
                    held = okk & okp & ok64 & okn
                    held[list(cs.SLICE9_DIVERGE)] = False
                    e_k = of_scale(Xk, Xp, held)
                    e_64 = of_scale(Xp, X64, held)
                    e_ulp = of_scale(Xn, Xp, held)
                    bar = max(cs.K7B_X_TOL, 3 * e_64)
                    print(f"{model.name if hasattr(model, 'name') else name}"
                          f" slack={slack} mintime={mintime} {rule} gains="
                          f"{gains}: held {int(held.sum())}/{held.numel()}, "
                          f"ok masks equal {bool(torch.equal(okk, okp))}; X "
                          f"kernel-plain {e_k:.2e}, plain f32-f64 {e_64:.2e} "
                          f"(bar {bar:.2e}), a 1-ulp move of the starts "
                          f"{e_ulp:.2e}" + ("  OVER" if e_k >= bar else ""),
                          flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("slice9_sensitivity: no CUDA device")
    main(sys.argv[1:] or cs.SLICE9_FORM_MODELS)
