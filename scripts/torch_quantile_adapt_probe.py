"""Same-process A/B of the quantile slice kernel's pseudo-targets on the
free-running engine: adapted per (chain, coordinate) in warmup
(``pseudo_adapt=True``, Heiner et al. 2024, frozen for sampling) over a
ladder of ``pseudo_c``, against two anchors, the fixed global Cauchy(0, 2)
pseudo-target (``quantile_s2``) and warmup-adapted stepping-out.

The port's counterpart of ``scripts/quantile_adapt_probe.py``, with its
three problems and two anchors.  The default ladder is "2,3,4,5,10,20":
it includes c=3, the bench's own value (``bench.py``), which the JAX
script's "2,5,10,20" missed.  One process runs every problem and variant
in a fixed interleaved order (problem by problem, anchors then the
ladder), each on a fresh engine with the same battery ("auto": "cuda3" on
the card) and spec_k (the engine's default: 4 on the card) and the same
chain count, under ``torch_study.measure_freerun``'s protocol: the burn-in
as adaptive warmup, one untimed sweep, then the timed sweeps in
three windows (rates are the median window's).

  logistic_p1000        binomial/logit, n=10,000, d=1,000, C=256, IID
                        Normal(0, 1), 30 warmup + 120 timed sweeps
  logistic_p100         binomial/logit, n=10,000, d=100, C=64, 30 + 99
  poisson_laplace_p100  poisson/log, n=10,000, d=100, C=64, IID
                        Laplace(0, 1), 30 + 99

Data from ``generate_glm_data(seed=0)``.  ``--small`` cuts every problem to
n=1,000, d=10, C=8, 3 + 3 sweeps.

    python scripts/torch_quantile_adapt_probe.py
    python scripts/torch_quantile_adapt_probe.py --problems logistic_p1000 --ladder 3
    python scripts/torch_quantile_adapt_probe.py --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402
from torch_study import Records, measure_freerun, resolve_device  # noqa: E402

# problem -> (family, n, d, C, prior distribution, warmup, timed sweeps)
PROBLEMS = {
    "logistic_p1000": ("binomial", 10_000, 1_000, 256, mt.Normal(0.0, 1.0),
                       30, 120),
    "logistic_p100": ("binomial", 10_000, 100, 64, mt.Normal(0.0, 1.0),
                      30, 99),
    "poisson_laplace_p100": ("poisson", 10_000, 100, 64,
                             mt.Laplace(0.0, 1.0), 30, 99),
}
ANCHORS = {
    "quantile_s2": {"slice_kernel": "quantile",
                    "tuning": {"pseudo_loc": 0.0, "pseudo_scale": 2.0}},
    "stepping_out": {"slice_kernel": "stepping_out", "tuning": {"w": 0.5}},
}


def variants(anchors, ladder):
    out = [(a, ANCHORS[a]) for a in anchors]
    for c in ladder:
        out.append((f"quantile_adapt_c{c}", {
            "slice_kernel": "quantile",
            "tuning": {"pseudo_scale": 2.0, "pseudo_adapt": True,
                       "pseudo_c": float(c)}}))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", default=",".join(PROBLEMS))
    ap.add_argument("--ladder", default="2,3,4,5,10,20",
                    help="comma list of pseudo_c values")
    ap.add_argument("--anchors", default="quantile_s2,stepping_out",
                    help='comma list of anchors ("" for none)')
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    rec = Records("quantile_adapt", device, args.out)
    plan = variants([a for a in args.anchors.split(",") if a],
                    [c for c in args.ladder.split(",") if c])
    for problem in args.problems.split(","):
        fam, n, d, C, dist, warm, timed = PROBLEMS[problem]
        if args.small:
            n, d, C, warm, timed = 1_000, 10, 8, 3, 3
        X, y, _ = generate_glm_data(fam, n=n, d=d, seed=0)
        prior = mt.IIDPrior(dist, d)
        for name, kw in plan:
            eng = mt.FreeRunCGGibbs(X, y, fam, prior, device=device, **kw)
            rec.write({"problem": problem, "kernel": name,
                       "battery": eng.battery_impl, "spec_k": eng.spec_k,
                       "n": n, "d": d,
                       **measure_freerun(eng, C, warm, timed)})


if __name__ == "__main__":
    main()
