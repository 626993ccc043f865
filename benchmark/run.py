"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Standard error carries the set-up steps, the launch-latency canary
and nvidia-smi's clocks around the window, and, as its last lines, each
number compared beside its limit; the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.  Exits
non-zero, printing no result, without CUDA, with fewer cards than the cell
asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    work, _ = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("run.py: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(work["chips"]):
        print(f"run.py: the cell asks for {work['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line, rows, _ = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        t_start=T_START)
    return emit(line, rows)


def emit(line, rows) -> int:
    """Print each number compared beside its limit on standard error and
    the result line last on standard output; 3, and no result line, when a
    forbidden module was loaded at any point of the run, the reference and
    the metric readers included."""
    harness.report_checks(rows)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
