"""Speculative proposal batteries on the GPU port (``mcmcglm_tpu_torch``).

The free-running CGGibbs automaton advances every chain by one slice-kernel
target evaluation per device pass.  In Neal's shrinkage procedure the
all-rejections proposal path is deterministic given the uniforms, so K
proposals can be generated up front, evaluated in one battery, and the
first acceptor selected: the same kernel in law as one proposal at a time,
with fewer passes per coordinate.

On a CUDA device ``spec_k`` defaults to 4, so this example asks for both
settings explicitly and compares them on one problem.  With K > 1 the
battery runs in a hand-written CUDA kernel of
``mcmcglm_tpu_torch/csrc/freerun_battery.cu``; ``battery_impl`` picks it:

  "cuda"   ``battery_sums``: the K sums over the observations, from one
           read of eta and the gathered X^T row per chain;
  "cuda2"  ``battery_commit``: the sums, the first-acceptor decision
           replayed in the kernel and the committed eta written back;
  "cuda3"  ``battery_gather_commit``: as "cuda2", with the X^T row gathered
           inside the kernel by each chain's coordinate index.  "auto"
           resolves to it on the card for every built-in family/link pair.

With K = 1 (and on the CPU) the pass evaluates its one proposal in plain
PyTorch.  Each fit prints its wall time, the battery it ran, the largest
error of its posterior mean against the true coefficients, the
evaluations per sweep (summed over coordinates, per chain) and the device
passes per sweep (burn-in included).

Run from the repository root:

  PYTHONPATH=. python examples/torch_05_speculative_batteries.py
  PYTHONPATH=. python examples/torch_05_speculative_batteries.py --device cpu --small
"""

import argparse
import time

import numpy as np
import torch

import mcmcglm_tpu_torch as mt

# the largest |posterior mean - truth| of any coefficient, in posterior sd
Z_TOL = 4.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a CPU-sized problem (n=300, d=5, 60 sweeps)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    n, d, n_samples, burnin = ((300, 5, 60, 20) if args.small
                               else (2_000, 50, 500, 100))

    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)) / np.sqrt(d)
    beta_true = rng.normal(size=d)
    y = rng.binomial(1, 1.0 / (1.0 + np.exp(-X @ beta_true))).astype(float)

    for engine_opts in ({"spec_k": 1}, {"spec_k": 4}):
        t0 = time.perf_counter()
        fit = mt.mcmcglm(
            family="binomial", X=X, y=y, beta_prior=mt.Normal(0.0, 1.0),
            n_samples=n_samples, burnin=burnin, n_chains=8, seed=1, w=0.5,
            engine_opts=engine_opts, device=args.device,
        )
        dt = time.perf_counter() - t0
        post = fit.post_burnin().reshape(-1, d)
        err = np.abs(post.mean(0) - beta_true)
        z = float(np.max(err / post.std(0)))
        passes = int(fit.state.ctr) - 1  # device passes after the init
        print(f"engine_opts={engine_opts!r}: {dt:6.2f} s, battery "
              f"{fit.sampler.battery_impl!r}, max |mean - truth| = "
              f"{err.max():.3f}, mean evals/sweep = "
              f"{float(fit.n_evals.mean()):.1f}, passes/sweep = "
              f"{passes / n_samples:.1f}")
        print(f"  largest |mean - truth| in posterior sd = {z:.2f} "
              f"(the example's tolerance: {Z_TOL})")

    # Both fits target the same posterior with the same kernel in law; the
    # speculative one tests K proposals per pass, so it needs fewer passes
    # for the same evaluations per sweep.


if __name__ == "__main__":
    main()
