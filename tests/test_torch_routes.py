"""The routes this slice of the port opened: ``mcmcglm`` with the latent,
elliptical, genelliptical and doubling kernels, ``thin > 1`` and
``sample_method="normal-normal"`` on the free-running engine, and the
list form of ``beta_prior`` (``StackedPrior``, held against the JAX
package's)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    n = 300
    X = np.column_stack([np.ones(n), rng.normal(size=n),
                         rng.binomial(1, 0.5, size=n)])
    y = rng.normal(X @ np.array([1.0, 1.5, 2.0]), 1.0)
    return X, y, np.linalg.solve(X.T @ X + np.eye(3), X.T @ y)


TUNING = {"latent": {}, "elliptical": {"sigma": 2.0},
          "genelliptical": {"sigma": 2.0, "df": 5.0}, "doubling": {"w": 0.5}}


@pytest.mark.parametrize("kernel", list(TUNING))
def test_mcmcglm_runs_each_kernel(data, kernel):
    X, y, post_mean = data
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", slice_fn=kernel,
                     n_samples=250, burnin=50, n_chains=4, device="cpu",
                     engine_opts={"spec_k": 4}, **TUNING[kernel])
    assert fit.slice_kernel == kernel == fit.sampler.slice_kernel
    # doubling runs the one-evaluation pass: the route drops spec_k
    assert fit.sampler.spec_k == (1 if kernel == "doubling" else 4)
    assert fit.beta.shape == (4, 251, 3) and fit.n_evals.shape == (4, 200)
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0),
                               post_mean, atol=0.1)


def test_mcmcglm_thin(data):
    X, y, post_mean = data
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, thin=3,
                     n_samples=350, burnin=50, n_chains=4, device="cpu")
    # the init row, then every 3rd of the 300 sampling sweeps
    assert fit.beta.shape == (4, 101, 3) and fit.burnin == 0
    assert fit.n_evals.shape == (4, 300)
    np.testing.assert_allclose(fit.beta[:, 1:].reshape(-1, 3).mean(0),
                               post_mean, atol=0.1)


def test_mcmcglm_normal_normal_on_the_freerun_engine(data):
    X, y, post_mean = data
    fit = mt.mcmcglm(X=X, y=y, family="gaussian",
                     sample_method="normal-normal", engine="freerun",
                     n_samples=300, burnin=50, n_chains=4, device="cpu")
    assert fit.sampler.coord_sampler == "conjugate"
    assert fit.slice_kernel is None
    assert (fit.n_evals == 3).all()  # one pass per coordinate
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0),
                               post_mean, atol=0.05)
    # under engine="auto" the normal-normal oracle is the lockstep engine's
    # factored conjugate sampler, as in the JAX package
    fit = mt.mcmcglm(X=X, y=y, family="gaussian",
                     sample_method="normal-normal", n_samples=300, burnin=50,
                     n_chains=4, device="cpu")
    assert isinstance(fit.sampler, mt.CGGibbs) and fit.sampler.kernel is None
    assert fit.slice_kernel is None and (fit.n_evals == 0).all()
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0),
                               post_mean, atol=0.05)


def test_mcmcglm_list_prior(data):
    X, y, _ = data
    prior = [mt.Normal(1.0, 0.5), mt.Normal(0.0, 2.0), mt.Normal(0.5, 1.0)]
    fit = mt.mcmcglm(X=X, y=y, family="gaussian",
                     sample_method="normal-normal", engine="freerun",
                     beta_prior=prior, n_samples=300, burnin=50, n_chains=4,
                     device="cpu")
    assert isinstance(fit.sampler.prior, mt.StackedPrior)
    m, s = np.array([1.0, 0.0, 0.5]), np.array([0.5, 2.0, 1.0])
    P = X.T @ X + np.diag(1 / s ** 2)
    mu = np.linalg.solve(P, X.T @ y + m / s ** 2)
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0), mu,
                               atol=0.05)


def test_stacked_prior_matches_jax():
    dists_t = [mt.Normal(0.5, 2.0), mt.Laplace(0.0, 0.7),
               mt.StudentT(3.0, 0.0, 1.0), mt.Gamma(2.0, 1.0)]
    dists_j = [mg.Normal(0.5, 2.0), mg.Laplace(0.0, 0.7),
               mg.StudentT(3.0, 0.0, 1.0), mg.Gamma(2.0, 1.0)]
    pt, pj = mt.StackedPrior(dists_t), mg.StackedPrior(dists_j)
    rng = np.random.default_rng(0)
    C, d, K = 9, 4, 3
    beta = np.abs(rng.normal(size=(C, d))) + 0.1
    j = rng.integers(0, d, C)
    b = np.abs(rng.normal(size=(C, K))) + 0.05
    want_k = np.stack([
        np.asarray(jax.vmap(pj.coord_log_prob, in_axes=(0, 0, 0))(
            jnp.asarray(beta), jnp.asarray(j), jnp.asarray(b[:, k])))
        for k in range(K)], 1)
    bt = torch.tensor(beta, dtype=torch.float64)
    jt = torch.tensor(j, dtype=torch.int32)
    got_k = pt.coord_log_prob(bt, jt, torch.tensor(b)).numpy()
    np.testing.assert_allclose(got_k, want_k, rtol=1e-6, atol=1e-8)
    got_1 = pt.coord_log_prob(bt, jt, torch.tensor(b[:, 0])).numpy()
    np.testing.assert_allclose(got_1, want_k[:, 0], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(
        pt.log_prob_beta(bt).numpy(),
        np.asarray(jax.vmap(pj.log_prob_beta)(jnp.asarray(beta))),
        rtol=1e-6)
    np.testing.assert_allclose(pt.mean_beta().numpy(),
                               np.asarray(pj.mean_beta()), rtol=1e-6)
    np.testing.assert_allclose(pt.cov_beta().numpy(),
                               np.asarray(pj.cov_beta()), rtol=1e-6)
    draws = pt.sample_beta(torch.Generator().manual_seed(0), 20000,
                           dtype=torch.float64, device="cpu")
    assert draws.shape == (20000, 4)
    np.testing.assert_allclose(draws[:, [0, 1, 3]].mean(0).numpy(),
                               np.asarray(pj.mean_beta())[[0, 1, 3]],
                               atol=0.06)
