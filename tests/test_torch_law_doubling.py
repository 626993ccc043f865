"""The port's doubling slice kernel in law: the mirror of
tests/test_freerun_doubling.py:54 (the gaussian conjugate oracle), the
heavy-doubling case beside it, plus the posterior against the JAX engine
on the same problem (:97, the bimodal back-test mode masses, is
tests/test_torch_law_bimodal.py).
The generators differ, so these compare distributions, never draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    cov = np.linalg.inv(X.T @ X + np.eye(d))
    return X, y, cov @ (X.T @ y), cov


def _fit(X, y, seed=0, warm=30, sweeps=300, w=0.5):
    d = X.shape[1]
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                            extra={"sd": 1.0}, slice_kernel="doubling",
                            tuning={"w": w}, device="cpu")
    st = eng.init(seed, 8)
    st, _, _ = eng.warmup(st, warm)
    nev0 = st.nev.numpy().copy()
    st, draws, _ = eng.run(st, sweeps)
    return draws.numpy(), (st.nev.numpy() - nev0).mean() / sweeps


def test_matches_conjugate_oracle(problem):
    X, y, mean, cov = problem
    draws, _ = _fit(X, y)
    post = draws[:, 100:, :].reshape(-1, X.shape[1])
    np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(post.std(0), np.sqrt(np.diag(cov)), rtol=0.15)


def test_small_w_heavy_doubling(problem):
    """w far below the conditional scale: the expansion and the back-test
    halvings both run, and the posterior is unchanged."""
    X, y, mean, cov = problem
    draws, nev = _fit(X, y, seed=1, w=0.02, sweeps=250)
    post = draws[:, 80:, :].reshape(-1, X.shape[1])
    np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(post.std(0), np.sqrt(np.diag(cov)), rtol=0.15)
    assert nev / X.shape[1] > 6.0  # the schedule really ran


def test_matches_jax_engine_in_law(problem):
    X, y, _, _ = problem
    d = X.shape[1]
    draws_t, nev_t = _fit(X, y, seed=2)
    ej = JaxFreeRun(X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                    extra={"sd": 1.0}, slice_kernel="doubling",
                    tuning={"w": 0.5}, spec_k=1)
    s = ej.init(jax.random.key(2), 8)
    s, _, _ = ej.warmup(s, 30)
    nev0 = np.asarray(s.nev).copy()
    s, draws_j, _ = ej.run(s, 300)
    nev_j = (np.asarray(s.nev) - nev0).mean() / 300
    pt = draws_t[:, 100:, :].reshape(-1, d)
    pj = np.asarray(draws_j)[:, 100:, :].reshape(-1, d)
    np.testing.assert_allclose(pt.mean(0), pj.mean(0), atol=0.06)
    np.testing.assert_allclose(pt.std(0), pj.std(0), rtol=0.2)
    assert abs(nev_t / nev_j - 1.0) < 0.1, (nev_t, nev_j)
