"""Multi-card sharded sampling with pooled diagnostics on the GPU port.

Runs the sharded lockstep engine (``ShardedCGGibbs``) on a logistic GLM
(n=4,000, d=20) over a (chain x obs) device mesh, 8 chains per chain
shard: one process per card over NCCL (``torch.cuda.device_count()``
ranks), or ``--procs`` CPU processes over gloo with ``--device cpu``.  The
processes come from ``parallel.launch.run_local``, which spawns them, so
the function each rank runs lives at module level.  A world of an even
size above 1 splits the observations in two (obs = 2), as the JAX example
does; otherwise every rank is a chain shard.

After 100 burn-in sweeps each rank keeps every 2nd of 200 sweeps and
streams per-chain Welford moments on its device; the moments are merged
over the chain axis (``pooled.pooled_summary``) into the pooled posterior
mean and R-hat.  The example prints the largest error of the pooled mean
against the true coefficients, the largest pooled R-hat, and the split
R-hat and the smallest ESS of the thinned draws (gathered to the host).

Run from the repository root:

  PYTHONPATH=. python examples/torch_04_multichip.py
  PYTHONPATH=. python examples/torch_04_multichip.py --device cpu --procs 2 --small
"""

import argparse

import numpy as np
import torch

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.parallel.launch import run_local
from mcmcglm_tpu_torch.parallel.pooled import pooled_summary

# the largest |pooled mean - truth| of any coefficient, in pooled posterior sd
Z_TOL = 4.0
CHAINS_PER_SHARD = 8


def problem(small):
    rng = np.random.default_rng(0)
    n, d = (500, 5) if small else (4000, 20)
    X = np.column_stack([np.ones(n),
                         rng.normal(size=(n, d - 1)) / np.sqrt(d - 1)])
    beta_true = rng.normal(size=d)
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta_true))).astype(float)
    return X, y, beta_true


def rank_fn(rank, small, device_type):
    """One rank of the world: its shard of the chains (and of the
    observations when obs = 2); the pooled summaries and every chain's
    thinned draws, the same on every rank."""
    world = torch.distributed.get_world_size()
    n_obs = 2 if world > 1 and world % 2 == 0 else 1
    mesh = mt.make_mesh(world // n_obs, n_obs, device_type=device_type)
    X, y, _ = problem(small)
    d = X.shape[1]
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else "cpu")
    eng = mt.ShardedCGGibbs(X, y, "binomial",
                            mt.IIDPrior(mt.Normal(0, 1), d),
                            tuning={"w": 0.5}, mesh=mesh, device=device)
    n_chains = CHAINS_PER_SHARD * eng.n_chain_shards
    burnin, n_outer = (30, 20) if small else (100, 100)
    state = eng.init(0, n_chains)
    state, _, _ = eng.run(state, burnin)
    state, mom, draws, _ = eng.run_thinned(state, n_outer=n_outer, thin=2)
    summary = pooled_summary(mom, group=eng.chain_group)
    return {
        "mesh": (eng.n_chain_shards, eng.n_obs_shards),
        "n_chains": n_chains,
        "draws_per_chain": float(summary["draws_per_chain"]),
        "mean": summary["mean"].cpu().numpy(),
        "var": summary["var"].cpu().numpy(),
        "rhat": summary["rhat"].cpu().numpy(),
        "draws": eng.gather(draws).cpu().numpy(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--procs", type=int, default=2,
                    help="CPU processes with --device cpu")
    ap.add_argument("--small", action="store_true",
                    help="a CPU-sized problem (n=500, d=5, 30 + 40 sweeps)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; pass "
                               "--device cpu to run on the CPU")
        device_type, nprocs = "cuda", torch.cuda.device_count()
    else:
        device_type, nprocs = "cpu", args.procs
    out = run_local(rank_fn, nprocs, args=(args.small, device_type),
                    device_type=device_type, timeout=1200.0)[0]
    _, _, beta_true = problem(args.small)
    err = np.abs(out["mean"] - beta_true)
    z = float(np.max(err / np.sqrt(out["var"])))
    print(f"world: {nprocs} {device_type} process(es), mesh (chain, obs) = "
          f"{out['mesh']}")
    print(f"chains: {out['n_chains']}, draws/chain: "
          f"{out['draws_per_chain']:.0f}, thinned draws/chain: "
          f"{out['draws'].shape[1]}")
    print(f"max |posterior mean - truth|: {float(err.max()):.4f}")
    print(f"largest |mean - truth| in posterior sd = {z:.2f} "
          f"(the example's tolerance: {Z_TOL})")
    print(f"max pooled rhat: {float(out['rhat'].max()):.4f}")
    print(f"split-rhat from thinned draws: "
          f"{float(mt.split_rhat(out['draws']).max()):.4f}")
    print(f"min ESS (thinned draws): {float(np.min(mt.ess(out['draws']))):.1f}")


if __name__ == "__main__":
    main()
