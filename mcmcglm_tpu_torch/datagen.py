"""Synthetic data generators for benchmarks and examples.

A numpy-only copy of ``mcmcglm_tpu/datagen.py`` (same seeds, same arrays).

Analogue of the reference's ``generate_normal_data``
(R/measure_performance.R:46-63): a gaussian design of a given width with an
intercept, unit true coefficients and gaussian response.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_normal_data", "generate_glm_data", "normal_arrays"]


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
