"""The port's multivariate-normal prior (``MultivariateNormal``,
``MVNPrior``) against the JAX package's: log densities, the O(d)
coordinate form and the moments at float32 (rtol 1e-5, atol 1e-5), the
draws in law, and the prior through the lockstep and free-running engines
(``mcmcglm(beta_prior=MultivariateNormal(...))``) against the closed-form
gaussian posterior and the JAX engines (tests/test_priors.py:67-140,
tests/test_engine.py:173-190, tests/test_freerun.py:83-95)."""

import numpy as np
import pytest
import scipy.stats as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOC = np.array([0.0, 1.0, -1.0, 0.5])
COV = np.array([[2.0, 0.5, 0.2, 0.0],
                [0.5, 1.0, 0.1, 0.0],
                [0.2, 0.1, 1.5, 0.3],
                [0.0, 0.0, 0.3, 1.0]])


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_log_prob_matches_scipy_and_jax():
    pts = np.array([[0.0, 0.0, 0.0, 0.0], [1.0, -1.0, 2.0, 0.3],
                    [2.0, 1.0, -0.5, 0.1]])
    mvn = mt.MultivariateNormal(LOC, COV)
    np.testing.assert_allclose(mvn.log_prob(_t(pts, torch.float64)).numpy(),
                               st.multivariate_normal(LOC, COV).logpdf(pts),
                               rtol=1e-10)
    want = jax.vmap(mg.MultivariateNormal(LOC.astype(np.float32),
                                          COV.astype(np.float32)).log_prob)(
        jnp.asarray(pts, jnp.float32))
    got = mvn.log_prob(_t(pts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(mvn.mean().numpy(), LOC)
    np.testing.assert_allclose(mvn.covariance().numpy(), COV)


def test_prior_matches_jax():
    """coord_log_prob for (C,) and (C, K) proposals (each chain's own
    coordinate), log_prob_beta and the moments, against the JAX MVNPrior
    vmapped over chains."""
    rng = np.random.default_rng(0)
    C, d, K = 7, 4, 3
    pt = mt.MVNPrior(LOC, COV)
    pj = mg.MVNPrior(LOC.astype(np.float32), COV.astype(np.float32))
    beta = rng.normal(size=(C, d)).astype(np.float32)
    j = rng.integers(0, d, C)
    b = rng.normal(size=(C, K)).astype(np.float32)
    want = np.stack([np.asarray(jax.vmap(pj.coord_log_prob)(
        jnp.asarray(beta), jnp.asarray(j), jnp.asarray(b[:, k])))
        for k in range(K)], 1)
    got = pt.coord_log_prob(_t(beta), torch.tensor(j, dtype=torch.int32),
                            _t(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got1 = pt.coord_log_prob(_t(beta), torch.tensor(j), _t(b[:, 0]))
    np.testing.assert_allclose(got1.numpy(), want[:, 0], **TOL)
    np.testing.assert_allclose(
        pt.log_prob_beta(_t(beta)).numpy(),
        np.asarray(jax.vmap(pj.log_prob_beta)(jnp.asarray(beta))), **TOL)
    np.testing.assert_allclose(pt.mean_beta().numpy(), LOC)
    np.testing.assert_allclose(pt.cov_beta().numpy(), COV)
    np.testing.assert_allclose(pt.precision.numpy(), np.linalg.inv(COV),
                               rtol=1e-10)


def test_delta_consistency():
    """coord_log_prob(beta, j, b) equals log_prob_beta(beta with b at j) up
    to a b-independent constant."""
    prior = mt.MVNPrior(LOC, COV)
    beta = _t([[0.3, 0.8, 0.5, 0.1]] * 4, torch.float64)
    j = torch.arange(4)
    for b1, b2 in [(0.7, 0.2), (1.5, 0.9)]:
        full = []
        for bb in (b1, b2):
            nb = beta.clone()
            nb[j, j] = bb
            full.append(prior.log_prob_beta(nb))
        d1 = prior.coord_log_prob(beta, j, torch.full((4,), b1,
                                                      dtype=torch.float64))
        d2 = prior.coord_log_prob(beta, j, torch.full((4,), b2,
                                                      dtype=torch.float64))
        np.testing.assert_allclose((d1 - d2).numpy(),
                                   (full[0] - full[1]).numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_make_beta_prior_and_draws():
    p = mt.make_beta_prior(mt.MultivariateNormal(np.zeros(3), np.eye(3)), 3)
    assert isinstance(p, mt.MVNPrior) and p.d == 3
    with pytest.raises(ValueError, match="multivariate normal `beta_prior` "
                       "dimension"):
        mt.make_beta_prior(mt.MultivariateNormal(np.zeros(3), np.eye(3)), 4)
    draws = mt.MVNPrior(LOC, COV).sample_beta(
        torch.Generator().manual_seed(0), 20000, dtype=torch.float32,
        device="cpu").numpy()
    assert draws.shape == (20000, 4) and draws.dtype == np.float32
    se = np.sqrt(np.diag(COV) / 20000)
    assert (np.abs(draws.mean(0) - LOC) < 4 * se).all()
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.06)


def _problem():
    rng = np.random.default_rng(2)
    n, d = 300, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, -0.5, 0.7]), 1.0)
    return X, y


def _posterior(X, y, loc, cov):
    P = np.linalg.inv(cov)
    prec = X.T @ X + P
    return np.linalg.solve(prec, X.T @ y + P @ loc)


def _mcse(draws):
    """(d,) Monte Carlo standard errors of the mean of (C, S, d) draws."""
    return draws.reshape(-1, draws.shape[-1]).std(0) / np.sqrt(mt.ess(draws))


MVN_LOC = np.array([0.5, 0.0, -0.5])
MVN_COV = np.array([[1.0, 0.3, 0.0], [0.3, 1.0, 0.0], [0.0, 0.0, 2.0]])


@pytest.fixture(scope="module")
def jax_draws():
    """The JAX engines with the MVN prior on the same problem: lockstep
    and free-running."""
    X, y = _problem()
    prior = mg.MVNPrior(MVN_LOC, MVN_COV)
    out = {}
    b, _, _ = mg.CGGibbs(X, y, "gaussian", prior, extra={"sd": 1.0},
                         tuning={"w": 0.7}).sample(jax.random.key(3), 200,
                                                   n_chains=8)
    out["lockstep"] = b[:, 51:]
    fr = JaxFreeRun(X, y, "gaussian", prior, extra={"sd": 1.0},
                    tuning={"w": 0.7})
    st_ = fr.init(jax.random.key(3), 8)
    st_, _, _ = fr.warmup(st_, 50)
    st_, draws, _ = fr.run(st_, 150)
    out["freerun"] = np.asarray(draws)
    return out


@pytest.mark.parametrize("engine,opts", [("xla", None), ("auto", None),
                                         ("auto", {"spec_k": 4})])
def test_mvn_prior_through_the_engines(jax_draws, engine, opts):
    """mcmcglm(beta_prior=MultivariateNormal(...)) on the lockstep engine
    and on the free-running one (its plain battery at spec_k=4): the
    posterior mean within 4 MCSE of the closed form and of the JAX
    engine."""
    X, y = _problem()
    fit = mt.mcmcglm(X=X, y=y, family="gaussian",
                     beta_prior=mt.MultivariateNormal(MVN_LOC, MVN_COV),
                     w=0.7, n_samples=200, burnin=50, n_chains=8, seed=1,
                     engine=engine, engine_opts=opts, device="cpu")
    assert isinstance(fit.sampler.prior, mt.MVNPrior)
    lockstep = engine == "xla"
    assert isinstance(fit.sampler, mt.CGGibbs) == lockstep
    draws = fit.post_burnin()
    mu = _posterior(X, y, MVN_LOC, MVN_COV)
    m_t, se_t = draws.reshape(-1, 3).mean(0), _mcse(draws)
    assert (np.abs(m_t - mu) < 4 * se_t).all(), (m_t, mu, se_t)
    jd = jax_draws["lockstep" if lockstep else "freerun"]
    m_j, se_j = jd.reshape(-1, 3).mean(0), _mcse(jd)
    assert (np.abs(m_t - m_j) < 4 * np.sqrt(se_t ** 2 + se_j ** 2)).all()


def test_mvn_prior_pull():
    """An informative MVN prior away from the data pulls the lockstep
    posterior to the closed form (tests/test_engine.py:173-190)."""
    X, y = _problem()
    loc, cov = np.array([5.0, 5.0, 5.0]), 1e-4 * np.eye(3)
    eng = mt.CGGibbs(X, y, "gaussian", mt.MVNPrior(loc, cov),
                     extra={"sd": 1.0}, tuning={"w": 0.5}, device="cpu")
    betas, _, _ = eng.sample(0, 100, n_chains=4)
    post = betas[:, 31:, :].reshape(-1, 3)
    np.testing.assert_allclose(post.mean(0), _posterior(X, y, loc, cov),
                               atol=0.05)
