"""Adding a new family on the GPU port (``mcmcglm_tpu_torch``).

The reference's extension recipe is "define a log_density method"
(``customising.Rmd``); here it is one ``register_family`` call with a
per-observation log density written in torch.  The example registers the
vignette's inverse-gaussian model (which ships built in) under a new name
from scratch and fits it.

No hand-written kernel can compile a Python density, so on the card this
family runs the plain PyTorch battery, and the engine says so once with a
``RuntimeWarning`` that names the pair ("my.inverse.gaussian/log is not in
KERNEL_FAMILIES ...").  That is deliberate: the built-in
``"inverse.gaussian"`` family runs the CUDA kernels.  The example prints the
posterior summary (numpy, over the post-burn-in draws pooled across
chains) beside the true coefficients, and each chain's mean and mean log
likelihood.

This density tends to a finite limit as mu grows, so the posterior has a
flat tail far from its mode, along a ridge where the intercept and the X2
coefficient trade off.  A chain drawn from the N(0, 2) prior far out can
stay on that tail for the whole run: coordinate-wise slice updates along
the ridge barely move it (the JAX package's engines do the same on this
problem for some seeds, and so does the port's lockstep engine).  Such a
chain shows as a split R-hat far above 1 and a mean log likelihood far
below the other chains'; the example names it, and its recovery line
reads the other chains.

Run from the repository root:

  PYTHONPATH=. python examples/torch_02_customising.py
  PYTHONPATH=. python examples/torch_02_customising.py --device cpu --small
"""

import argparse
import math

import numpy as np
import torch

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.models.families import Family, register_family
from mcmcglm_tpu_torch.models.links import get_link

TRUTH = np.array([0.2, 0.5, 0.3])  # (Intercept), X1, X2
# the largest |posterior mean - truth| of any coefficient, in posterior sd,
# over the chains not held on the flat tail
Z_TOL = 4.0
# a chain whose mean log likelihood is this far below the best chain's is
# on the flat tail (a mixing chain's varies by a few nats)
TAIL_NATS = 50.0


# --- the single definition a user writes (customising.Rmd:53-56) ----------
# The engine calls it inside the CUDA graph of its pass loop, so it makes
# no tensor from a host number (a copy to the card cannot be captured):
# the engine hands ``extra`` over as 0-d tensors on mu's device, and the
# constants stay Python floats.
def my_invgauss_logpdf(mu, y, extra):
    """statmod::dinvgauss parametrisation: mean mu, shape lam."""
    lam = extra.get("shape", 1.0)
    log_lam = torch.log(lam) if torch.is_tensor(lam) else math.log(lam)
    return (
        0.5 * (log_lam - math.log(2.0 * math.pi) - 3.0 * torch.log(y))
        - lam * (y - mu) ** 2 / (2.0 * mu * mu * y)
    )


def my_inverse_gaussian(link="log"):
    return Family(name="my.inverse.gaussian", link=get_link(link),
                  log_density=my_invgauss_logpdf)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="a CPU-sized run (60 sampling sweeps)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass "
                           "--device cpu to run on the CPU")
    register_family("my.inverse.gaussian", my_inverse_gaussian)

    # --- data as in customising.Rmd:36-47 (log link for positivity) -------
    rng = np.random.default_rng(42)
    n = 1000
    x1 = rng.exponential(0.5, n)
    x2 = rng.binomial(1, 0.5, n).astype(float)
    mu = np.exp(TRUTH[0] + TRUTH[1] * x1 + TRUTH[2] * x2)
    # inverse-gaussian draws via the reciprocal-normal transform
    lam = 1.0
    nu = rng.normal(size=n) ** 2
    xq = mu + mu**2 * nu / (2 * lam) - mu / (2 * lam) * np.sqrt(
        4 * mu * lam * nu + mu**2 * nu**2
    )
    z = rng.uniform(size=n)
    y = np.where(z <= mu / (mu + xq), xq, mu**2 / xq)
    dat = {"Y": y, "X1": x1, "X2": x2}

    fit = mt.mcmcglm(
        "Y ~ .",
        family="my.inverse.gaussian",
        data=dat,
        beta_prior=mt.Normal(0, 2),
        log_likelihood_extra_args={"shape": 1.0},
        w=0.3,
        n_samples=160 if args.small else 500,
        burnin=100,
        n_chains=4,
        device=args.device,
    )
    print(fit)
    print(f"battery: {fit.sampler.battery_impl!r} ({fit.sampler.battery_reason})")
    post = fit.post_burnin().reshape(-1, fit.d)
    mean = post.mean(0)
    q = np.quantile(post, [0.025, 0.5, 0.975], axis=0)
    ess, rhat = fit.ess(), fit.rhat()
    print(f"{'var':>12} {'mean':>8} {'q2.5':>8} {'q50':>8} {'q97.5':>8} "
          f"{'ess':>7} {'rhat':>6} {'truth':>6}")
    for i, name in enumerate(fit.columns):
        print(f"{name:>12} {mean[i]:8.3f} {q[0, i]:8.3f} {q[1, i]:8.3f} "
              f"{q[2, i]:8.3f} {ess[i]:7.0f} {rhat[i]:6.3f} {TRUTH[i]:6.2f}")
    # each chain's mean log likelihood over its draws: a chain held on the
    # density's flat tail sits far below the others
    draws = fit.post_burnin()  # (C, K, d)
    mu_draws = torch.from_numpy(np.exp(draws @ fit.model_matrix.T))
    loglik = my_invgauss_logpdf(mu_draws, torch.from_numpy(y),
                                {"shape": 1.0}).sum(-1).mean(-1).numpy()
    on_tail = loglik < loglik.max() - TAIL_NATS
    for c in range(fit.n_chains):
        print(f"chain {c}: mean {np.round(draws[c].mean(0), 3)}, mean log "
              f"likelihood {loglik[c]:.1f}"
              + ("  <- on the flat tail" if on_tail[c] else ""))
    kept = draws[~on_tail].reshape(-1, fit.d)
    zmax = float(np.max(np.abs(kept.mean(0) - TRUTH) / kept.std(0)))
    print(f"{int(on_tail.sum())} of {fit.n_chains} chains on the flat tail; "
          f"over the others, largest |mean - truth| in posterior sd = "
          f"{zmax:.2f} (the example's tolerance: {Z_TOL})")

if __name__ == "__main__":
    main()
