"""The port's elliptical and generalized-elliptical slice kernels in law:
the mirror of tests/test_freerun_elliptical.py (the gaussian conjugate
oracle for both kernels, the K-proposal battery, binomial/logit), plus
the posterior and evaluation rate against the JAX engine on the same
problem.  The generators differ, so these compare distributions, never
draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402

ELL_TUNING = {"mu": 0.0, "sigma": 2.0}
GEN_TUNING = {"mu": 0.0, "sigma": 2.0, "df": 5.0}
KERNELS = [("elliptical", ELL_TUNING), ("genelliptical", GEN_TUNING)]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    cov = np.linalg.inv(X.T @ X + np.eye(d))
    return X, y, cov @ (X.T @ y), cov


def _fit(X, y, kernel, tuning, seed=0, warm=50, sweeps=300, **kw):
    d = X.shape[1]
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                            extra={"sd": 1.0}, slice_kernel=kernel,
                            tuning=tuning, device="cpu", **kw)
    st = eng.init(seed, 8)
    st, _, _ = eng.warmup(st, warm)
    nev0 = st.nev.numpy().copy()
    st, draws, _ = eng.run(st, sweeps)
    nev = (st.nev.numpy() - nev0).mean() / sweeps
    return draws.numpy(), nev


@pytest.mark.parametrize("kernel,tuning", KERNELS)
def test_matches_conjugate_oracle(problem, kernel, tuning):
    X, y, mean, cov = problem
    draws, _ = _fit(X, y, kernel, tuning)
    post = draws[:, 100:, :].reshape(-1, X.shape[1])
    np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(post.std(0), np.sqrt(np.diag(cov)), rtol=0.15)


@pytest.mark.parametrize("kernel,tuning", KERNELS)
def test_matches_jax_engine_in_law(problem, kernel, tuning):
    """The K=4 battery: the conjugate oracle's mean, and the posterior and
    evaluations per sweep against the JAX engine's kernel."""
    X, y, mean, _ = problem
    d = X.shape[1]
    draws_t, nev_t = _fit(X, y, kernel, tuning, seed=1, spec_k=4)
    ej = JaxFreeRun(X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                    extra={"sd": 1.0}, slice_kernel=kernel, tuning=tuning,
                    spec_k=4)
    s = ej.init(jax.random.key(1), 8)
    s, _, _ = ej.warmup(s, 50)
    nev0 = np.asarray(s.nev).copy()
    s, draws_j, _ = ej.run(s, 300)
    nev_j = (np.asarray(s.nev) - nev0).mean() / 300
    pt = draws_t[:, 100:, :].reshape(-1, d)
    pj = np.asarray(draws_j)[:, 100:, :].reshape(-1, d)
    np.testing.assert_allclose(pt.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(pt.mean(0), pj.mean(0), atol=0.06)
    np.testing.assert_allclose(pt.std(0), pj.std(0), rtol=0.2)
    assert abs(nev_t / nev_j - 1.0) < 0.15, (nev_t, nev_j)


def test_binomial_logit():
    rng = np.random.default_rng(5)
    n, d = 400, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([0.5, 1.0, -1.0])
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta)))
    eng = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 2), d),
                            slice_kernel="elliptical", tuning=ELL_TUNING,
                            spec_k=4, device="cpu")
    st = eng.init(6, 8)
    st, _, _ = eng.warmup(st, 60)
    st, draws, _ = eng.run(st, 400)
    post = draws.numpy()[:, 100:, :].reshape(-1, d)
    np.testing.assert_allclose(post.mean(0), beta, atol=0.4)
