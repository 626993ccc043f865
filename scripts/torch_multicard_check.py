"""The port's sharded free-running engines across the cards of one host.

    python scripts/torch_multicard_check.py            # every card, NCCL
    python scripts/torch_multicard_check.py --cpu 4    # 4 CPU ranks, gloo

Spawns one process per card (``parallel.launch.run_local``; NCCL on
CUDA) and runs the bench configuration (binomial/logit, n=10,000,
d=1,000, ``generate_glm_data(seed=0)``, IID Normal(0, 1), C=256,
quantile with adapted pseudo-targets, spec_k=4) through:

  * the chain mesh (W, 1): each shard against a standalone
    ``FreeRunCGGibbs`` under its shard seed (bitwise), ms per pass;
  * the obs mesh (W / 2, 2): ``ObsShardedFreeRunCGGibbs`` on the graph
    loop (the all-reduce captured) against the same engine on the eager
    loop (bitwise), ms per pass of each, the obs ranks' beta and counters
    bitwise equal, eta equal to X beta;
  * the pooled monitor at BASELINE config 5's size (C=4,096, the
    benchmark's cell ``logistic_p1000.chainmesh.c4096x4``): the chain mesh
    (W, 1), 30 burn-in sweeps, two steps of
    ``run_thinned(32, thin=1, moments=<carried>, ess=True)``, then
    ``pooled_summary`` and ``ess_from_state`` merged over the chain group;
    rank 0 holds the merged pooled mean, variance and R-hat (of all 64
    draws a chain) and ESS (of the last step's 32) against the float64
    reference (``benchmark/reference/pooled_monitor.py``) on the gathered
    draws, within ``POOLED_TOL``, and the same summaries with the moments
    folded in bfloat16 must fall outside it.

Prints one line per mesh with the card's name and power limit and exits
nonzero when a check fails.  ``--cpu W`` rehearses it on W CPU
processes at n=600, d=8, C=16.
"""

import argparse
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

WARMUP, SWEEPS = 2, 3
POOLED_C, POOLED_BURNIN, POOLED_STEPS, POOLED_SWEEPS, POOLED_LAG = (
    4096, 30, 2, 32, 64)
# merged summaries against the float64 reference: the mean's largest gap
# in posterior sds, the variance's and the ESS's largest relative gaps,
# R-hat's largest gap.  Float32 reads about 1e-7 on each (the ESS's
# streamed raw sums lose a further factor of (|mean| / sd)^2 in the
# centring, some 1e2 at most here); folded in bfloat16 the moments read
# 1e-3 and more, on four CPU ranks and on four cards (PERF.md)
POOLED_TOL = {"mean": 1e-4, "var": 1e-4, "rhat": 1e-4, "ess": 1e-3}


def _timed(eng, st, n_sweeps, sync):
    inner = getattr(eng, "inner", eng)
    cap0, ctr0 = inner.loop_stats["capture_seconds"], int(st.ctr)
    sync()
    t0 = time.perf_counter()
    out = eng.run(st, n_sweeps)
    sync()
    t = (time.perf_counter() - t0
         - (inner.loop_stats["capture_seconds"] - cap0))
    return out, 1e3 * t / max(int(out[0].ctr) - ctr0, 1)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and all(
        torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


def pooled_phase(W, dev, X, y, prior, kw, C):
    """The pooled monitor over the chain mesh (module docstring); on rank
    0 (gaps, bfloat16 gaps, ms of the last step's spans), else None."""
    import torch.distributed as dist

    import mcmcglm_tpu_torch as mt
    from mcmcglm_tpu_torch.parallel import make_mesh, pooled
    from mcmcglm_tpu_torch.utils import profiling

    from benchmark.reference import pooled_monitor

    eng = mt.ShardedFreeRunCGGibbs(X, y, "binomial", prior,
                                   mesh=make_mesh(W, 1, dev.type), **kw)
    st, _, _ = eng.warmup(eng.init(7, C), POOLED_BURNIN)
    mom, kept = None, []
    for _ in range(POOLED_STEPS):
        profiling.reset_spans()
        st, mom, draws, _, es, _ = eng.run_thinned(
            st, POOLED_SWEEPS, 1, moments=mom, ess=True,
            ess_max_lag=POOLED_LAG, nev_at_draws=True)
        kept.append(draws)
        summ = pooled.pooled_summary(mom, group=eng.chain_group)
        ess = pooled.ess_from_state(es, group=eng.chain_group)
    ms = {}
    for s in profiling.spans():
        if s["name"].startswith("pooled."):
            ms[s["name"]] = ms.get(s["name"], 0.0) + 1e-6 * (s["t1"]
                                                             - s["t0"])
    kept = torch.cat(kept, 1)
    bf = torch.bfloat16
    mom_bf = pooled.fold_moments(pooled.ChainMoments(
        torch.zeros(kept.shape[0], dtype=bf, device=dev),
        torch.zeros(kept.shape[0], kept.shape[2], dtype=bf, device=dev),
        torch.zeros(kept.shape[0], kept.shape[2], dtype=bf, device=dev)),
        kept.to(bf))
    summ_bf = pooled.pooled_summary(mom_bf, group=eng.chain_group)
    every = eng.gather(kept)
    if dist.get_rank():
        return None
    ref = dict(pooled_monitor.summary(every), ess=pooled_monitor.ess(
        every[:, -POOLED_SWEEPS:], POOLED_LAG))
    return (pooled_monitor.gaps(dict(summ, ess=ess), ref),
            pooled_monitor.gaps(summ_bf, ref), ms, float(ref["rhat"].max()),
            float(ref["ess"].min()))


def worker(rank, device_type, n, d, C, pooled_c):
    import torch.distributed as dist

    import mcmcglm_tpu_torch as mt
    from mcmcglm_tpu_torch.parallel import make_mesh

    W = dist.get_world_size()
    dev = torch.device(device_type)
    sync = (torch.cuda.synchronize if device_type == "cuda"
            else (lambda: None))
    X, y, _ = mt.generate_glm_data("binomial", n=n, d=d, seed=0)
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), d)
    kw = dict(tuning={"pseudo_scale": 2.0, "pseudo_adapt": True,
                      "pseudo_c": 3.0},
              slice_kernel="quantile", spec_k=4, device=dev)
    out = {"pooled": pooled_phase(W, dev, X, y, prior, kw, pooled_c)}
    chain = mt.ShardedFreeRunCGGibbs(X, y, "binomial", prior,
                                     mesh=make_mesh(W, 1, dev.type), **kw)
    alone = mt.FreeRunCGGibbs(X, y, "binomial", prior, **kw)
    runs = []
    for eng, st in ((chain, chain.init(0, C)),
                    (alone, alone.init(chain.shard_seed(0), C // W))):
        st, _, _ = eng.warmup(st, WARMUP)
        runs.append(_timed(eng, st, SWEEPS, sync))
    out["chain"] = (_same(runs[0][0], runs[1][0]), runs[0][1], runs[1][1],
                    chain.inner.battery_impl)

    mesh = make_mesh(W // 2, 2, dev.type)
    runs = []
    for graph in (None, False):
        eng = mt.ObsShardedFreeRunCGGibbs(X, y, "binomial", prior, mesh=mesh,
                                          graph=graph, **kw)
        st, _, _ = eng.warmup(eng.init(0, C), WARMUP)
        runs.append(_timed(eng, st, SWEEPS, sync))
        if graph is None:
            reason, impl = eng.loop_reason, eng.inner.battery_impl
            st_g = runs[-1][0][0]
            ref = st_g.beta.double() @ eng.inner.Xt.double()
            drift = float((st_g.eta.double() - ref).abs().max())
            mine = torch.cat([st_g.beta.flatten(), st_g.nev.double(),
                              st_g.ctr.double().reshape(1)])
            parts = [torch.empty_like(mine) for _ in range(2)]
            dist.all_gather(parts, mine, group=eng.obs_group)
            agree = torch.equal(parts[0], parts[1])
    out["obs"] = (_same(runs[0][0], runs[1][0]), runs[0][1], runs[1][1],
                  reason, impl, agree, drift)
    return out


def _pooled_ok(got, card) -> bool:
    """Prints the pooled phase's line; whether it passed."""
    gaps, ctl, ms, rhat, least = got
    ok = all(gaps[k] <= POOLED_TOL[k] for k in POOLED_TOL)
    ctl_out = [k for k in ctl if ctl[k] > POOLED_TOL[k]]
    print(f"rank 0 pooled monitor ({POOLED_STEPS} steps of {POOLED_SWEEPS}"
          f" draws, lag window {POOLED_LAG}): gaps to the float64 "
          f"reference {gaps} (tolerances {POOLED_TOL}): "
          f"{'within' if ok else 'OUTSIDE'}; bfloat16 moments {ctl}: "
          f"outside on {ctl_out}; last step ms {ms}; reference max R-hat "
          f"{rhat:.6f}, min ESS {least:.1f}; {card}")
    return ok and bool(ctl_out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on this many CPU processes")
    args = ap.parse_args()
    from mcmcglm_tpu_torch.parallel.launch import run_local

    if args.cpu:
        W, device_type, size, card = args.cpu, "cpu", (600, 8, 16), "CPU"
        pooled_c = 16
    else:
        from mcmcglm_tpu_torch.ops import _build

        W, device_type, size = torch.cuda.device_count(), "cuda", (
            10_000, 1_000, 256)
        pooled_c = POOLED_C
        card = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines())
        _build.load_library()  # once, before the ranks load it
    if W < 2 or W % 2:
        print(f"needs an even number of ranks, have {W}", file=sys.stderr)
        return 1
    n, d, C = size
    t0 = time.perf_counter()
    res = run_local(worker, W, (device_type, n, d, C, pooled_c),
                    device_type=device_type, timeout=900.0)
    ok = _pooled_ok(res[0]["pooled"], card)
    for r, x in enumerate(res):
        same, ms_s, ms_a, impl = x["chain"]
        print(f"rank {r} chain mesh ({W}, 1), {C // W} chains on {impl}: "
              f"bitwise standalone {same}; ms/pass {ms_s:.4f} (standalone "
              f"{ms_a:.4f}); {card}")
        same, ms_g, ms_e, reason, impl, agree, drift = x["obs"]
        print(f"rank {r} obs mesh ({W // 2}, 2), {n // 2} observations on "
              f"{impl} ({reason}): graph loop bitwise eager {same}; ms/pass "
              f"graph {ms_g:.4f}, eager {ms_e:.4f}; obs ranks agree "
              f"{agree}; max|eta - X beta| {drift:.3g}; {card}")
        ok &= x["chain"][0] and same and agree and drift < 1e-3
    print(f"{'MULTICARD_OK' if ok else 'MULTICARD_FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
