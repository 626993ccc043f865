"""Chain scaling on one card: warm throughput and min-ESS/s against the
chain count C, for the free-running, fused and lockstep engines.

The port's counterpart of ``scripts/chain_scaling.py`` (its ``--engine
xla|fused``) and ``scripts/c_scaling_probe.py`` (the free-running arm).
min-ESS/s scales with C x sweeps/s (the mixing per draw does not depend on
C), so the best C for a card maximises C x sweeps/s.

Protocol, per C: build the engine, init from seed 0, burn in (the
free-running engine's adaptive warmup; the others' plain sweeps), run one
untimed sweep (the free-running engine captures its sampling graphs
there), then time the plan's timed sweeps in ``REPEATS`` (3) equal windows
(host clock, synchronised).  Each row reports the median window's ms per
sweep and C x sweeps/s, the efficiency (sweeps/s per chain against the
smallest C's), evaluations per coordinate, and the min-ESS of all timed draws
(``diagnostics.ess``, on the host, outside the timed windows) over the
timed seconds.

  freerun  FreeRunCGGibbs, battery "auto" ("cuda3" on the card), spec_k
           default (4 on the card), w=0.5; C = 128 ... 2048; 15 warmup and
           30 timed sweeps (c_scaling_probe.py's protocol); then C=256 once
           more after 60 warmup sweeps, the fused arm's burn-in, so that the
           two engines' min-ESS/s also compare at equal burn-in
  fused    FusedCGGibbs (block_chains=8, w=0.5); C = 64, 256, 1024; 60
           burn-in and 30 timed sweeps (chain_scaling.py's)
  xla      the lockstep CGGibbs (w=0.5); host-bound on the card, so it is
           meant for --small there

The data are the bench's: binomial/logit, n=10,000, d=1,000 from
``generate_glm_data(seed=0)``, IID Normal(0, 1) prior; ``--small`` takes
n=2,000, d=100 and short runs.

    python scripts/torch_chain_scaling.py --engine freerun
    python scripts/torch_chain_scaling.py --engine fused
    python scripts/torch_chain_scaling.py --engine xla --small
    python scripts/torch_chain_scaling.py --engine freerun --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402

import numpy as np  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402
from torch_study import (  # noqa: E402
    REPEATS,
    Records,
    resolve_device,
    timed_windows,
)

# engine -> ((chain count, burn-in sweeps) per row, timed sweeps), full and
# --small
PLANS = {
    "freerun": (([(128, 15), (256, 15), (512, 15), (1024, 15), (2048, 15),
                  (256, 60)], 30), ([(8, 4), (32, 4), (8, 8)], 6)),
    "fused": (([(64, 60), (256, 60), (1024, 60)], 30), ([(8, 2), (16, 2)], 3)),
    "xla": (([(8, 30), (32, 30), (128, 30)], 30), ([(8, 2), (32, 2)], 3)),
}


def make_engine(kind, X, y, d, device):
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), d)
    if kind == "freerun":
        return mt.FreeRunCGGibbs(X, y, "binomial", prior, tuning={"w": 0.5},
                                 device=device)
    if kind == "fused":
        return mt.FusedCGGibbs(X, y, "binomial", prior, tuning={"w": 0.5},
                               device=device)
    return mt.CGGibbs(X, y, "binomial", prior, tuning={"w": 0.5},
                      device=device)


def draws_of(kind, out):
    """(C, K, d) draws and the summed evaluations of one ``run`` call."""
    state, draws, nev = out
    if kind == "fused":  # (K, C, d) draws; nev summed over chains per sweep
        return state, draws.transpose(0, 1), nev.sum().item() / draws.shape[1]
    if kind == "freerun":  # nev: cumulative count at each sweep's end
        return state, draws, None
    return state, draws, nev.double().sum(1).mean().item()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="freerun",
                    choices=["freerun", "fused", "xla"])
    ap.add_argument("--chains", default="",
                    help="comma list of chain counts at the plan's first "
                    "burn-in (default: the plan's rows)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    plan, timed = PLANS[args.engine][1 if args.small else 0]
    if args.chains:
        plan = [(int(c), plan[0][1]) for c in args.chains.split(",")]
    n, d = (2_000, 100) if args.small else (10_000, 1_000)
    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    rec = Records(f"chain_scaling_{args.engine}", device, args.out)
    per_window = max(1, timed // REPEATS)
    base = None
    for C, burnin in plan:
        eng = make_engine(args.engine, X, y, d, device)
        state = eng.init(0, C)
        if args.engine == "freerun":
            state, _, _ = eng.warmup(state, burnin)
        else:
            state, _, _ = eng.run(state, burnin)
        state, _, _ = eng.run(state, 1)  # untimed: graph captures
        nev0 = getattr(state, "nev", None)
        nev0 = None if nev0 is None else nev0.double().clone()
        ctr0 = int(state.ctr) if args.engine == "freerun" else None
        parts, evals = [], 0.0

        def window():
            nonlocal state, evals
            state, draws, ev = draws_of(args.engine, eng.run(state,
                                                             per_window))
            parts.append(draws)
            evals += 0.0 if ev is None else ev

        secs = timed_windows(window, REPEATS, device)
        draws = np.concatenate([p.cpu().numpy() for p in parts], axis=1)
        n_timed = draws.shape[1]
        if nev0 is not None:
            evals = float((state.nev.double() - nev0).mean())
        min_ess = float(np.min(mt.ess(draws)))
        med = float(np.median(secs))
        rate = C * per_window / med  # chain-sweeps per second
        if base is None:
            base = rate / C
        row = {
            "engine": args.engine, "chains": C, "n": n, "d": d,
            "burnin": burnin, "timed_sweeps": n_timed,
            "window_seconds": secs,
            "ms_per_sweep": 1e3 * med / per_window,
            "chain_sweeps_per_s": rate,
            "scaling_efficiency": rate / (base * C),
            "evals_per_coord": evals / n_timed / d,
            "min_ess": min_ess,
            "min_ess_per_s": min_ess / float(np.sum(secs)),
        }
        if args.engine == "freerun":
            passes = int(state.ctr) - ctr0
            row.update(battery=eng.battery_impl, spec_k=eng.spec_k,
                       passes_per_sweep=passes / n_timed,
                       ms_per_pass=1e3 * float(np.sum(secs)) / passes)
        rec.write(row)


if __name__ == "__main__":
    main()
