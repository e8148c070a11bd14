#!/usr/bin/env python3
"""Σ launches × (ms − bound) by kernel, from the output of a whole
``chip_smoke.py`` run, and for K5 and K7a from
``tools/bitwise_against_parent.py``'s output at each main path's batch.

    python3 tools/above_bound.py SMOKE_LOG [BITWISE_LOG]

SMOKE_LOG holds the ``{"kernels": [...]}`` line of a ``chip_smoke.py`` run
that reached its end (its launches are those of the main paths). Prints,
per kernel (K1 … K7b), the time above the bound at the checks' batch (ms
and bound_ms of each entry) and, where an entry has them, at its main
path's batch (ms_main_batch, bound_ms_main_batch). With BITWISE_LOG, also
K5's and K7a's with the ms both trees' C entry points took there at the
entry's main batch (ρ = 1, control regularization), on the same launches
and bounds: this tree's against the other's.
"""
from __future__ import annotations

import json
import re
import sys

KERNELS = (("sqrt_sweep", "K1"), ("rollout_closed_loop", "K2"),
           ("fused_al_backward", "K3"), ("fused_al_forward", "K4"),
           ("riccati_sweep", "K5"), ("fused_backward", "K7a"),
           ("fused_forward", "K7b"))


def kernel_of(name):
    for prefix, k in KERNELS:
        if name == prefix or name.startswith(prefix + "_"):
            return k, name[len(prefix) + 1:]
    raise ValueError(name)


def bitwise_ms(lines, kernel, inst, batch):
    """(this tree's, the other's) ms of the first bitwise line for K5's
    (n, m) or K7a's model at ``batch``, ρ = 1, control regularization."""
    if kernel == "K5":
        n, m = inst.split("x")
        pat = rf"^K5 \S+ \({n},{m}\) B={batch} rho=1 reg_state=False "
    else:
        pat = rf"^K7a {re.escape(inst)} B={batch} rho=1 "
    for line in lines:
        if re.search(pat, line):
            got = re.search(r"this tree ([\d.]+), the other ([\d.]+)", line)
            return float(got.group(1)), float(got.group(2))
    return None


def main():
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    text = open(sys.argv[1]).read().splitlines()
    line = next(x for x in text if x.startswith('{"kernels"'))
    entries = json.loads(line)["kernels"]
    sums = {}
    for e in entries:
        k, _ = kernel_of(e["name"])
        at = sums.setdefault(k, [0.0, 0.0])
        launches = e.get("launches", 0)
        at[0] += launches * (e["ms"] - e["bound_ms"]) / 1e3
        at[1] += launches * (e.get("ms_main_batch", e["ms"])
                             - e.get("bound_ms_main_batch",
                                     e["bound_ms"])) / 1e3
    for k, (checks, main_b) in sums.items():
        print(f"{k}: s above bound {checks:.3f} at the checks' batch, "
              f"{main_b:.3f} at the main paths' batch")
    if len(sys.argv) == 3:
        lines = open(sys.argv[2]).read().splitlines()
        for want in ("K5", "K7a"):
            mine = theirs = 0.0
            for e in entries:
                k, inst = kernel_of(e["name"])
                if k != want or not e.get("launches"):
                    continue
                batch = e.get("main_batch", 128)
                got = bitwise_ms(lines, k, inst, batch)
                if got is None:
                    print(f"  {e['name']}: {e['launches']} launches, no "
                          f"line at B={batch} in the bitwise log: left out")
                    continue
                bnd = e.get("bound_ms_main_batch", e["bound_ms"])
                mine += e["launches"] * (got[0] - bnd) / 1e3
                theirs += e["launches"] * (got[1] - bnd) / 1e3
                print(f"  {e['name']}: {e['launches']} launches at B={batch}"
                      f": this tree {got[0]:.4f} ms, the other {got[1]:.4f}"
                      f" ms, bound {bnd:.5f} ms")
            print(f"{want} at the main paths' batch, C entry points: this "
                  f"tree {mine:.3f} s above bound, the other {theirs:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
