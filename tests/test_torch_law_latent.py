"""The port's latent slice kernel in law: the mirror of
tests/test_freerun_latent.py:49 (the gaussian conjugate oracle) and :145
(the carried width register is refreshed), plus its posterior and
evaluation rate against the JAX engine on the same problem.  The
generators differ, so these compare distributions, never draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402

TUNING = {"rate": 0.5}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    cov = np.linalg.inv(X.T @ X + np.eye(d))
    return X, y, cov @ (X.T @ y), cov


def _fit(X, y, seed=0, warm=50, sweeps=300, **kw):
    d = X.shape[1]
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                            extra={"sd": 1.0}, slice_kernel="latent",
                            tuning=TUNING, device="cpu", **kw)
    st = eng.init(seed, 8)
    st, _, _ = eng.warmup(st, warm)
    nev0 = st.nev.numpy().copy()
    st, draws, _ = eng.run(st, sweeps)
    nev = (st.nev.numpy() - nev0).mean() / sweeps
    return draws.numpy(), nev, eng, st


@pytest.mark.parametrize("spec_k", [1, 4])
def test_matches_conjugate_oracle(problem, spec_k):
    X, y, mean, cov = problem
    draws, _, _, _ = _fit(X, y, spec_k=spec_k)
    post = draws[:, 100:, :].reshape(-1, X.shape[1])
    np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(post.std(0), np.sqrt(np.diag(cov)), rtol=0.15)


def test_matches_jax_engine_in_law(problem):
    """Posterior and evaluations per sweep against the JAX engine's latent
    kernel on the same problem."""
    X, y, _, _ = problem
    d = X.shape[1]
    draws_t, nev_t, _, _ = _fit(X, y, seed=1, spec_k=4)
    ej = JaxFreeRun(X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                    extra={"sd": 1.0}, slice_kernel="latent", tuning=TUNING,
                    spec_k=4)
    s = ej.init(jax.random.key(1), 8)
    s, _, _ = ej.warmup(s, 50)
    nev0 = np.asarray(s.nev).copy()
    s, draws_j, _ = ej.run(s, 300)
    nev_j = (np.asarray(s.nev) - nev0).mean() / 300
    pt = draws_t[:, 100:, :].reshape(-1, d)
    pj = np.asarray(draws_j)[:, 100:, :].reshape(-1, d)
    np.testing.assert_allclose(pt.mean(0), pj.mean(0), atol=0.06)
    np.testing.assert_allclose(pt.std(0), pj.std(0), rtol=0.2)
    assert abs(nev_t / nev_j - 1.0) < 0.15, (nev_t, nev_j)


def test_width_register_is_refreshed(problem):
    """logw carries log s' per (chain, coordinate): it changes at every
    coordinate visit (unlike frozen stepping-out widths)."""
    X, y, _, _ = problem
    _, _, eng, st = _fit(X, y, seed=8, warm=5, sweeps=5)
    init = np.log(np.float32(1.0 / eng.rate))
    assert (np.abs(st.logw.numpy() - init) > 1e-6).mean() > 0.95


def test_binomial_logit():
    rng = np.random.default_rng(5)
    n, d = 400, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([0.5, 1.0, -1.0])
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta)))
    eng = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 2), d),
                            slice_kernel="latent", tuning=TUNING, spec_k=4,
                            device="cpu")
    st = eng.init(6, 8)
    st, _, _ = eng.warmup(st, 60)
    st, draws, _ = eng.run(st, 400)
    post = draws.numpy()[:, 100:, :].reshape(-1, d)
    np.testing.assert_allclose(post.mean(0), beta, atol=0.4)
