"""Tall data, on-device diagnostics and alternative slice kernels on the
GPU port (``mcmcglm_tpu_torch``).

1. The obs-sharded free-running engine (``ObsShardedFreeRunCGGibbs``): the
   fast automaton over a (chain x obs) mesh, for data whose design matrix
   or linear predictor exceeds one card's memory.  Each rank holds a slab
   of the observations; every pass runs the ``battery_sums`` CUDA kernel
   on the slab and one all-reduce of the partial sums over the obs axis.
   One process per card over NCCL (``torch.cuda.device_count()`` ranks, all
   on the obs axis), or ``--procs`` CPU processes over gloo with ``--device
   cpu``, spawned by ``parallel.launch.run_local``.
2. Streaming min-ESS on the device: ``run_thinned(..., ess=True)`` keeps
   the split-chain autocovariance accumulator, so only a (d,) vector
   leaves the device (``pooled.ess_from_state``); the example prints it
   beside the host ESS of the same kept draws.
3. The latent (Li & Walker 2020) and doubling (Neal 2003) slice kernels,
   and the quantile kernel with pseudo-targets adapted in warmup (Heiner
   et al. 2024), on the free-running engine through ``mcmcglm``, on the
   first 2,000 rows.

Each part prints its recovery against the true coefficients, in posterior
sd.

Run from the repository root:

  PYTHONPATH=. python examples/torch_06_tall_data_and_recovery.py
  PYTHONPATH=. python examples/torch_06_tall_data_and_recovery.py --device cpu --procs 2 --small
"""

import argparse

import numpy as np
import torch

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.parallel.launch import run_local
from mcmcglm_tpu_torch.parallel.pooled import ess_from_state, pooled_summary

# the largest |posterior mean - truth| of any coefficient, in posterior sd
Z_TOL = 4.0
CHAINS_PER_SHARD = 8


def problem(small):
    rng = np.random.default_rng(0)
    n, d = (2_000, 5) if small else (20_000, 12)  # tall: many rows, few columns
    X = np.column_stack([np.ones(n),
                         rng.normal(size=(n, d - 1)) / np.sqrt(d - 1)])
    beta_true = rng.normal(size=d)
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta_true))).astype(float)
    return X, y, beta_true


def rank_fn(rank, small, device_type):
    """One rank of the obs mesh: its slab of the observations, all chains;
    the pooled moments, the streamed ESS and the kept draws, the same on
    every rank."""
    world = torch.distributed.get_world_size()
    mesh = mt.make_mesh(1, world, device_type=device_type)
    X, y, _ = problem(small)
    d = X.shape[1]
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else "cpu")
    eng = mt.ObsShardedFreeRunCGGibbs(
        X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), d),
        tuning={"w": 0.5}, mesh=mesh, device=device)
    warm, n_outer = (10, 20) if small else (60, 150)
    state = eng.init(0, CHAINS_PER_SHARD)
    state, _, _ = eng.warmup(state, warm)
    state, mom, kept, _, es = eng.run_thinned(state, n_outer=n_outer, thin=2,
                                              ess=True)
    summary = pooled_summary(mom, group=eng.chain_group)
    return {
        "mesh": (eng.n_chain_shards, eng.n_obs_shards),
        "battery": eng.inner.battery_impl,
        "loop": eng.loop_reason,
        "mean": summary["mean"].cpu().numpy(),
        "var": summary["var"].cpu().numpy(),
        "rhat": summary["rhat"].cpu().numpy(),
        "dev_ess": ess_from_state(es, group=eng.chain_group).cpu().numpy(),
        "kept": eng.gather(kept).cpu().numpy(),
    }


def recovery(label, post, beta_true):
    mean, sd = post.mean(0), post.std(0)
    z = float(np.max(np.abs(mean - beta_true) / sd))
    head = " ".join(f"{v:7.3f}" for v in mean[:4])
    print(f"{label} coef head: {head}; largest |mean - "
          f"truth| in posterior sd = {z:.2f} (the example's tolerance: "
          f"{Z_TOL})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=2,
                    help="CPU processes with --device cpu")
    ap.add_argument("--small", action="store_true",
                    help="a CPU-sized problem (n=2,000, d=5, fewer sweeps)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; pass "
                               "--device cpu to run on the CPU")
        device_type, nprocs = "cuda", torch.cuda.device_count()
    else:
        device_type, nprocs = "cpu", args.procs
    X, y, beta_true = problem(args.small)

    # -- 1. obs-sharded free-running engine; 2. streaming ESS ---------------
    out = run_local(rank_fn, nprocs, args=(args.small, device_type),
                    device_type=device_type, timeout=1200.0)[0]
    kept = out["kept"]
    err = np.abs(out["mean"] - beta_true)
    z = float(np.max(err / np.sqrt(out["var"])))
    print(f"world: {nprocs} {device_type} process(es), mesh (chain, obs) = "
          f"{out['mesh']}, battery {out['battery']!r}, loop: {out['loop']}")
    print(f"chains: {kept.shape[0]}, kept draws/chain: {kept.shape[1]}")
    print(f"max |posterior mean - truth|: {float(err.max()):.3f}; largest "
          f"|mean - truth| in posterior sd = {z:.2f} (the example's "
          f"tolerance: {Z_TOL})")
    print(f"max pooled rhat: {float(out['rhat'].max()):.4f}")
    print(f"min ESS (on-device streaming): {float(out['dev_ess'].min()):.1f}")
    print(f"min ESS (host, same draws):    {float(np.min(mt.ess(kept))):.1f}")

    # -- 3. alternative slice kernels on the free-running engine ------------
    rows = 500 if args.small else 2000
    common = dict(X=X[:rows], y=y[:rows], family="binomial",
                  beta_prior=mt.IIDPrior(mt.Normal(0, 1), X.shape[1]),
                  engine="freerun", n_samples=50 if args.small else 300,
                  burnin=20 if args.small else 80, n_chains=8, seed=0,
                  device=args.device)
    # the truth of the first rows' posterior is the same beta_true
    fit = mt.mcmcglm(slice_fn="latent", rate=0.5, **common)
    recovery("latent-kernel   ", fit.post_burnin().reshape(-1, fit.d),
             beta_true)
    # doubling expands the interval geometrically (robust to a badly sized
    # w) and replays Neal's Fig. 6 back-test as extra automaton phases
    fit = mt.mcmcglm(slice_fn="doubling", w=0.1, **common)
    recovery("doubling-kernel ", fit.post_burnin().reshape(-1, fit.d),
             beta_true)
    # quantile with pseudo-targets adapted per (chain, coordinate) in
    # warmup, frozen for sampling
    fit = mt.mcmcglm(slice_fn="quantile", pseudo_adapt=True, pseudo_c=5.0,
                     **common)
    recovery("adapted-quantile", fit.post_burnin().reshape(-1, fit.d),
             beta_true)
    head = " ".join(f"{v:7.3f}" for v in beta_true[:4])
    print(f"truth head:                  {head}")


if __name__ == "__main__":
    main()
