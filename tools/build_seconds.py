#!/usr/bin/env python3
"""nvcc's seconds for each kernel source of one or more trees.

    python3 tools/build_seconds.py [--only=riccati_sweep,rollout] [TREE ...]

Compiles ``TREE/trajopt_tpu_torch/csrc/<source>.cu`` of each tree (default:
this one) with the flags of ``kernels/_build.py``, one compile at a time
(``chip_smoke.py`` runs them side by side, where they share the cores), into
a temporary directory, in turns over the trees (this, other, ..., then
again), and prints one JSON line per tree with the seconds of each source,
both rounds. Needs nvcc (the GPU machine), not a card.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from trajopt_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402


def compile_seconds(src: Path, out_dir: Path) -> float:
    t0 = time.perf_counter()
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / "lib.so"),
                    str(src)], check=True, capture_output=True)
    return time.perf_counter() - t0


def main():
    args = sys.argv[1:]
    only = None
    for a in args:
        if a.startswith("--only="):
            only = set(a.split("=", 1)[1].split(","))
    trees = [Path(a) for a in args if not a.startswith("--")] or [ROOT]
    seconds = {str(t): {} for t in trees}
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            for tree in trees:
                for src in sorted((tree / "trajopt_tpu_torch" / "csrc")
                                  .glob("*.cu")):
                    if only is None or src.stem in only:
                        seconds[str(tree)].setdefault(src.stem, []).append(
                            round(compile_seconds(src, Path(tmp)), 2))
    for tree, by in seconds.items():
        print(json.dumps(dict(tree=tree, seconds=by)), flush=True)


if __name__ == "__main__":
    main()
