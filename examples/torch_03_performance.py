"""CGGibbs update-against-naive runtime on the GPU port: the ``performance``
vignette.

The claim (reference README.md:11-16): the total runtime of CGGibbs is
linear in the parameter count d with the incremental linear-predictor
update (O(n) per coordinate), and quadratic with the naive recompute (a
full product per slice evaluation, O(nd)).  This example runs the
reference's methodology (``R/measure_performance.R:113-151``) on the
lockstep engine (``CGGibbs``) through the pandas-free timing core
``perf.eta_comptime_rows_across_nvars``: simulated gaussian data for each
width, one untimed sweep (``compile_time``), then ``n_samples`` timed
sweeps, with ``linear_predictor_calc="update"`` and ``"naive"``.

The lockstep engine runs in plain PyTorch and is host-bound on the card:
each iteration of its slice loops costs a fixed slice of host time
whatever the width, so at these small widths (n=100) the timings measure
the host's launches more than the O(n) against O(nd) arithmetic.  Read
the table as "how to produce the curve".  To keep the example short on the
card, it times ``SWEEPS`` = 2 sweeps per width (the reference times 100).
The table's ``flag reads`` column counts the slice loops' host reads per
sweep.  On a host with pandas and matplotlib,
``mcmcglm_tpu_torch.compare_eta_comptime_across_nvars`` returns the same
rows as a DataFrame and ``plot_eta_comptime`` draws time against width.

Run from the repository root:

  PYTHONPATH=. python examples/torch_03_performance.py
  PYTHONPATH=. python examples/torch_03_performance.py --device cpu --small
"""

import argparse

import numpy as np
import torch

from mcmcglm_tpu_torch.perf import eta_comptime_rows_across_nvars

# timed sweeps per width and calculation, cut from the reference's 100
SWEEPS = 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a CPU-sized run (widths 2, 10 and 20)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    n_vars = [2, 10, 20] if args.small else [2, 50, 100, 200, 400]
    rows = eta_comptime_rows_across_nvars(
        n_vars=n_vars, n=100, n_samples=SWEEPS, burnin=0,
        device=args.device,
    )
    print(f"device {rows[0]['device']}, n={rows[0]['n_obs']}, "
          f"{SWEEPS} timed sweeps of {rows[0]['n_chains']} chain after "
          "one untimed sweep")
    print(f"{'n_vars':>6} {'calc':>7} {'time (s)':>9} {'first (s)':>9} "
          f"{'s/sweep':>8} {'evals':>7} {'flag reads':>10}")
    for r in rows:
        print(f"{r['n_vars']:>6} {r['linear_predictor_calc']:>7} "
              f"{r['time']:9.3f} {r['compile_time']:9.3f} "
              f"{r['time'] / r['n_samples']:8.3f} "
              f"{r['evals_per_sweep']:7.1f} {r['flag_reads_per_sweep']:10.1f}")
    by = {}
    for r in rows:
        by.setdefault(r["linear_predictor_calc"], {})[r["n_vars"]] = r["time"]
    for calc in ("update", "naive"):
        ds = np.array(sorted(by[calc]), float)
        ts = np.array([by[calc][d] for d in sorted(by[calc])])
        slope = np.polyfit(np.log(ds), np.log(ts), 1)[0]
        print(f"log-log slope of time against width, {calc}: {slope:.2f}")
    ratio = by["naive"][max(n_vars)] / by["update"][max(n_vars)]
    print(f"naive / update at d={max(n_vars)}: {ratio:.2f}")


if __name__ == "__main__":
    main()
