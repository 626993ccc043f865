"""Families and priors tour on the GPU port (``mcmcglm_tpu_torch``).

The scenarios of the reference's main vignette (``pospkg.Rmd``):
gaussian/identity, binomial/logit, binomial/probit, poisson/log and
negative binomial, with an IID prior, a strongly misspecified prior, a
per-coordinate list of priors and a multivariate-normal prior, then the
normal-normal conjugate oracle as a cross-check.

The data are a dict of 1-D arrays, which the port's formula parser takes
in place of a DataFrame.  Each fit prints, per coefficient, the posterior
mean and its 2.5/50/97.5% quantiles (numpy, over the post-burn-in draws
pooled across chains), the bulk ESS and the split R-hat, and the largest
distance of a posterior mean from the true coefficients in posterior sd.
The slice-sampling fits run the free-running engine, whose speculative
battery is the ``battery_gather_commit`` CUDA kernel on the card; the
normal-normal oracle runs the lockstep engine.

Run from the repository root:

  PYTHONPATH=. python examples/torch_01_families_and_priors.py
  PYTHONPATH=. python examples/torch_01_families_and_priors.py --device cpu --small
"""

import argparse

import numpy as np
import torch
from scipy.stats import norm

import mcmcglm_tpu_torch as mt

TRUTH = np.array([1.0, 1.5, 2.0])  # (Intercept), X1, X2
# the largest |posterior mean - truth| of any coefficient, in posterior sd,
# for every fit whose prior does not pull it away from the truth
Z_TOL = 4.0


def show(title, fit, check=True):
    post = fit.post_burnin().reshape(-1, fit.d)
    mean, sd = post.mean(0), post.std(0)
    q = np.quantile(post, [0.025, 0.5, 0.975], axis=0)
    ess, rhat = fit.ess(), fit.rhat()
    print(f"\n== {title}")
    print(f"{'var':>12} {'mean':>8} {'q2.5':>8} {'q50':>8} {'q97.5':>8} "
          f"{'ess':>7} {'rhat':>6}")
    for i, name in enumerate(fit.columns):
        print(f"{name:>12} {mean[i]:8.3f} {q[0, i]:8.3f} {q[1, i]:8.3f} "
              f"{q[2, i]:8.3f} {ess[i]:7.0f} {rhat[i]:6.3f}")
    z = float(np.max(np.abs(mean - TRUTH) / sd))
    if check:
        print(f"largest |mean - truth| in posterior sd = {z:.2f} "
              f"(the example's tolerance: {Z_TOL})")
    else:
        print(f"largest |mean - truth| in posterior sd = {z:.2f} "
              "(no tolerance: the prior pulls the fit away)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a CPU-sized run (60 sweeps of 2 chains)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    n = 1000
    common = dict(n_samples=60 if args.small else 500,
                  burnin=20 if args.small else 100,
                  n_chains=2 if args.small else 4, seed=0,
                  device=args.device)

    rng = np.random.default_rng(42)
    x1 = rng.normal(size=n)
    x2 = rng.binomial(1, 0.5, n).astype(float)
    lin_pred = TRUTH[0] + TRUTH[1] * x1 + TRUTH[2] * x2

    # gaussian / identity (pospkg.Rmd:39-77)
    dat = {"Y": rng.normal(lin_pred, 1.0), "X1": x1, "X2": x2}
    show("gaussian/identity",
         mt.mcmcglm("Y ~ .", "gaussian", dat, mt.Normal(0, 1), w=0.5,
                    **common))

    # binomial / logit (pospkg.Rmd:79-86)
    dat["Y"] = rng.binomial(1, 1 / (1 + np.exp(-lin_pred))).astype(float)
    show("binomial/logit",
         mt.mcmcglm("Y ~ .", "binomial", dat, mt.Normal(0, 1), w=0.8,
                    **common))

    # binomial / probit (pospkg.Rmd:101-108)
    dat["Y"] = rng.binomial(1, norm.cdf(lin_pred)).astype(float)
    show("binomial/probit",
         mt.mcmcglm("Y ~ .", mt.binomial(link="probit"), dat,
                    mt.Normal(0, 1), w=0.8, **common))

    # poisson / log (pospkg.Rmd:123-130)
    dat["Y"] = rng.poisson(np.exp(np.clip(lin_pred, -10, 10))).astype(float)
    show("poisson/log",
         mt.mcmcglm("Y ~ .", "poisson", dat, mt.Normal(0, 1), w=0.3,
                    **common))

    # negative binomial (pospkg.Rmd:149-156; size=1 like the reference)
    mu = np.exp(np.clip(lin_pred, -10, 10))
    dat["Y"] = rng.negative_binomial(1, 1 / (1 + mu)).astype(float)
    show("negative.binomial/log",
         mt.mcmcglm("Y ~ .", "negative.binomial", dat, mt.Normal(0, 2),
                    w=0.5, **common))

    # prior pull: strongly misspecified N(1000, 1) prior (pospkg.Rmd:183)
    dat["Y"] = rng.normal(lin_pred, 1.0)
    show("misspecified prior N(1000,1): expect pull away from truth",
         mt.mcmcglm("Y ~ .", "gaussian", dat, mt.Normal(1000.0, 1.0), w=0.5,
                    **common), check=False)

    # per-coordinate list of priors (pospkg.Rmd:194-204)
    show("list of marginal priors",
         mt.mcmcglm("Y ~ .", "gaussian", dat,
                    beta_prior=[mt.Normal(0, 1), mt.Gamma(1, 1),
                                mt.Exponential(2.0)], w=0.5, **common))

    # correlated MVN prior (pospkg.Rmd:224-236)
    cov = np.array([[1.0, 0.5, 0.0], [0.5, 1.0, 0.0], [0.0, 0.0, 1.0]])
    show("multivariate normal prior",
         mt.mcmcglm("Y ~ .", "gaussian", dat,
                    beta_prior=mt.MultivariateNormal(np.zeros(3), cov),
                    w=0.5, **common))

    # conjugate cross-check (pospkg.Rmd:339-348)
    show("normal-normal conjugate oracle",
         mt.mcmcglm("Y ~ .", "gaussian", dat, mt.Normal(0, 1),
                    sample_method="normal-normal", **common))


if __name__ == "__main__":
    main()
