"""The composed route's kernels in one tree of this repository, on one GPU.

    python scripts/torch_composed_probe.py TREE [TREE ...]

For each TREE (this checkout, ``.``, or an unpacked copy of another tree
or variant, for example under ``build/``), one worker process imports
``mcmcglm_tpu_torch`` and ``chip_smoke`` from that tree, builds its
kernels there, and prints one line ``EXP {json}`` with:

* the build's seconds and its per-instantiation ptxas table (registers,
  spill store and load bytes; ``chip_smoke.ptxas_table``);
* what ``chip_smoke.composed_kernels`` (the smoke's phase 3c) returns
  after its checks against the plain versions pass: for binomial/logit and
  each pair of ``chip_smoke.TIMED_COMPOSED`` at C=256, n=10,000, the
  device ms of ``battery_gather_commit`` (K=4, an X^T of d=1,000 rows),
  ``fused_coord_update`` and ``fused_sweep`` (d=16) by replays of a
  captured CUDA graph, with the fused launches' evaluations per chain
  (block maxima).

Trees run in the order given; repeat a tree to see the spread.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def worker(root):
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import mcmcglm_tpu_torch as mt
    from mcmcglm_tpu_torch.ops import _build

    if not os.path.abspath(mt.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {mt.__file__}, not the tree {root}")
    t0 = time.perf_counter()
    _build.load_library()
    out = dict(tree=root, build_s=time.perf_counter() - t0,
               nvcc_s=_build.BUILD_INFO["seconds"],
               ptxas=cs.ptxas_table(_build.BUILD_INFO["log"]))
    # chip_smoke's phase 3c: the checks, then the times at the main shape
    out["times"] = {label: dict(ms=rec, evaluations_per_chain=evals)
                    for label, (rec, evals) in cs.composed_kernels().items()}
    print("EXP " + json.dumps(out), flush=True)


def main(trees):
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(tree)], capture_output=True, text=True,
            timeout=1800)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise RuntimeError(f"the worker for {tree} failed")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
