"""Synthetic data generators for benchmarks and examples.

A numpy-only copy of ``mcmcglm_tpu/datagen.py`` (same seeds, same arrays).

Analogue of the reference's ``generate_normal_data``
(R/measure_performance.R:46-63): a gaussian design of a given width with an
intercept, unit true coefficients and gaussian response.
"""

from __future__ import annotations

import numpy as np

__all__ = ["domain_data", "eta_sign", "example_extra", "family_response",
           "generate_normal_data", "generate_glm_data", "normal_arrays"]


def normal_arrays(n_vars: int, n: int = 100, beta=None, sd: float = 1.0,
                  seed=0):
    """(model matrix (n, n_vars) with an intercept column, response (n,)):
    the arrays of :func:`generate_normal_data`'s "Y ~ ." fit, without
    pandas."""
    rng = np.random.default_rng(seed)
    if beta is None:
        beta = np.ones(n_vars)
    beta = np.asarray(beta, dtype=np.float64)
    Xcov = rng.normal(size=(n, n_vars - 1))
    model_matrix = np.column_stack([np.ones(n), Xcov])
    y = rng.normal(model_matrix @ beta, sd)
    return model_matrix, y


def generate_normal_data(n_vars: int, n: int = 100, beta=None, sd: float = 1.0, seed=0):
    """DataFrame with response Y and n_vars-1 standard-normal covariates
    (the model matrix then includes an intercept, so the fitted parameter
    count is n_vars — matching R/measure_performance.R:46-56)."""
    import pandas as pd

    model_matrix, y = normal_arrays(n_vars, n, beta, sd, seed)
    data = {"Y": y}
    for i in range(n_vars - 1):
        data[f"X{i + 1}"] = model_matrix[:, i + 1]
    return pd.DataFrame(data)


def generate_glm_data(
    family: str, n: int, d: int, beta=None, seed=0, link=None, sd: float = 1.0
):
    """Array-first generator for the BASELINE config matrix (BASELINE.md):
    returns (X, y, beta_true) with X ~ N(0, 1/sqrt(d)) columns + intercept."""
    rng = np.random.default_rng(seed)
    if beta is None:
        beta = rng.normal(size=d) / np.sqrt(max(d, 1))
    beta = np.asarray(beta, dtype=np.float64)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1)) / np.sqrt(max(d - 1, 1))])
    eta = X @ beta
    if family == "gaussian":
        y = rng.normal(eta, sd)
    elif family == "binomial":
        y = rng.binomial(1, 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)
    elif family == "poisson":
        y = rng.poisson(np.exp(np.clip(eta, -20, 20))).astype(np.float64)
    else:
        raise ValueError(f"unsupported family for generation: {family}")
    return X, y, beta


# the extra arguments the port's examples and checks give each built-in
# family
EXAMPLE_EXTRA = {"gaussian": {"sd": 1.3}, "binomial": {}, "poisson": {},
                 "negative.binomial": {"size": 2.5}, "Gamma": {"shape": 2.0},
                 "inverse.gaussian": {"dispersion": 0.5}}


def example_extra(pair) -> dict:
    """The extra arguments of a built-in (family, link) pair's examples:
    its family's :data:`EXAMPLE_EXTRA`, but inverse-gaussian/inverse takes
    ``shape`` (so that phi = 1 / shape is exercised)."""
    if tuple(pair) == ("inverse.gaussian", "inverse"):
        return {"shape": 2.0}
    return dict(EXAMPLE_EXTRA[pair[0]])


def eta_sign(family) -> int:
    """The sign the linear predictor must keep for the mean to lie in the
    family's ``mean_domain``: 0 where eta = -1, 0 and 1 all give finite
    means and those of -1 and 1 lie inside (any eta of moderate size
    will do), else the side of 0 whose mean lies inside (+1 for the
    inverse and 1/mu^2 links and a positive mean's identity link, -1 for
    binomial/log)."""
    import torch

    lo, hi = family.mean_domain
    mu = family.link.linkinv(
        torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64)).tolist()
    inside = [lo < m < hi for m in mu]
    if inside[0] and inside[2] and np.isfinite(mu[1]):
        return 0
    return 1 if inside[2] else -1


def family_response(name: str, n: int, rng) -> np.ndarray:
    """n float64 responses in a built-in family's support, drawn from the
    numpy Generator ``rng``: Bernoulli(0.4), N(1, 1), Gamma(2, 1) + 0.05,
    Wald(1, 2), and Poisson(2) for the count families."""
    y = {"binomial": lambda: rng.binomial(1, 0.4, size=n),
         "gaussian": lambda: rng.normal(1.0, 1.0, size=n),
         "Gamma": lambda: rng.gamma(2.0, 1.0, size=n) + 0.05,
         "inverse.gaussian": lambda: rng.wald(1.0, 2.0, size=n)}.get(
        name, lambda: rng.poisson(2.0, size=n))()
    return y.astype(np.float64)


def domain_data(pair, n: int, d: int, seed=0):
    """(X, y) for a built-in (family, link) pair on which every predictor
    eta = X beta with beta > 0 (a prior on the positive axis) keeps the
    mean in the family's domain: X of the pair's :func:`eta_sign` (>= 0
    where any eta will do), entries in [0.2, 1] / d, and y from
    :func:`family_response`."""
    from .models.families import check_family

    sign = eta_sign(check_family(pair[0]).with_link(pair[1])) or 1
    rng = np.random.default_rng(seed)
    X = sign * rng.uniform(0.2, 1.0, size=(n, d)) / d
    return X, family_response(pair[0], n, rng)
