"""The benchmark's own GLM data, frozen: the semantics of the port's
``datagen.generate_glm_data`` (an intercept and d - 1 columns of
N(0, 1/sqrt(d - 1)), beta_true ~ N(0, 1/d), then y), written again in
NumPy so that a change to the program cannot change the inputs.  The
response law is the configuration's own: ``sample`` of its
``reference/<family>_<link>.py``, through :meth:`spec.Model.sample`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["glm_data"]


def glm_data(sample, n: int, d: int, seed: int):
    """(X (n, d), y (n,), beta_true (d,)), float64, from ``seed``;
    ``sample(rng, eta)`` draws y with the same generator."""
    rng = np.random.default_rng(int(seed))
    beta = rng.normal(size=d) / np.sqrt(max(d, 1))
    X = np.empty((n, d))
    X[:, 0] = 1.0
    X[:, 1:] = rng.normal(size=(n, d - 1)) / np.sqrt(max(d - 1, 1))
    y = np.asarray(sample(rng, X @ beta), dtype=np.float64)
    return X, y, beta
