"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Standard error carries the set-up steps, the launch-latency canary
and nvidia-smi's clocks around the window, and, as its last lines, each
number compared beside its limit; the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.  A cell
on N > 1 cards runs as N processes, one per card (``ranks.py``), and this
process prints what rank 0 returned.  Exits non-zero, printing no result,
without CUDA or with fewer cards than the cell asks for (2), when JAX or
the JAX package was loaded in any process of the run (3), or when a rank
raised, died or outlived its time limit, or the ranks used fewer cards
than the cell asks for (4).
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

from benchmark import harness, ranks, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    work, _ = spec.cell(args.workload)
    chips = int(work["chips"])
    if not torch.cuda.is_available():
        print("run.py: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"run.py: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if chips == 1:
        line, rows, _ = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
            t_start=T_START)
        return emit(line, rows)
    return run_ranks(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", chips, t_start=T_START)


def run_ranks(name, seed, seconds, trace_on, device_type, chips, *,
              t_start, limit_s=None) -> int:
    """A cell on ``chips`` > 1 ranks (``ranks.run_cell``), ended as
    :func:`emit` ends a run; 4, and no result line, when a rank failed."""
    try:
        line, rows, _, bad = ranks.run_cell(
            name, seed, seconds, trace_on, device_type, chips,
            t_start=t_start, limit_s=limit_s)
    except ranks.RankFailure as exc:
        print(f"run.py: {exc}", file=sys.stderr, flush=True)
        return 4
    return emit(line, rows, bad)


def emit(line, rows, ranks_loaded=()) -> int:
    """Print each number compared beside its limit on standard error and
    the result line last on standard output; 3, and no result line, when a
    forbidden module was loaded at any point of the run, the reference and
    the metric readers included, here or in a rank (``ranks_loaded``)."""
    harness.report_checks(rows)
    bad = sorted(set(harness.forbidden_modules()) | set(ranks_loaded))
    if bad:
        print(f"run.py: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
