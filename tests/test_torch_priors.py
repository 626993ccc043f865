"""The port's six univariate prior distributions against the JAX package:
log densities elementwise on the same numpy inputs, the support edges
included (Gamma is -inf at x <= 0, Exponential at x < 0, Uniform outside
[low, high]), and sample moments against mean() / variance()."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402

RTOL, ATOL = 1e-6, 1e-6  # float32 on both sides; libm implementations differ

# (class name, parameters, points to evaluate besides the random ones)
CASES = [
    ("Normal", dict(loc=0.3, scale=1.7), [0.0]),
    ("Gamma", dict(concentration=2.5, rate=1.5), [-1.0, 0.0, 1e-30, 1.0]),
    ("Exponential", dict(rate=2.0), [-1e-7, 0.0, 3.0]),
    ("StudentT", dict(df=3.0, loc=-0.5, scale=2.0), [0.0, 1e4]),
    ("Laplace", dict(loc=0.25, scale=0.7), [0.25]),
    ("Uniform", dict(low=-1.0, high=2.0), [-1.0, 2.0, -1.0000001, 2.0000002]),
]


def _points(extra, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(scale=2.0, size=200), extra])
    return x.astype(np.float32)


@pytest.mark.parametrize("name,params,extra", CASES)
def test_log_prob_matches_jax(name, params, extra):
    dj, dt = getattr(mg, name)(**params), getattr(mt, name)(**params)
    x = _points(extra)
    lj = np.asarray(dj.log_prob(jnp.asarray(x)))
    lt = dt.log_prob(torch.from_numpy(x)).numpy()
    assert lt.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(lt), np.isneginf(lj))
    np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
    assert (dt.mean(), dt.variance()) == (dj.mean(), dj.variance())


@pytest.mark.parametrize("name,params,extra", CASES)
def test_samples_match_moments_and_support(name, params, extra):
    if name == "StudentT":
        params = dict(params, df=6.0)  # a finite fourth moment
    dist = getattr(mt, name)(**params)
    g = torch.Generator().manual_seed(1)
    s = dist.sample(g, (200_000,), dtype=torch.float64, device="cpu").numpy()
    assert s.shape == (200_000,) and np.isfinite(dist.log_prob(
        torch.from_numpy(s)).numpy()).all()
    sd = np.sqrt(dist.variance())
    assert abs(s.mean() - dist.mean()) < 5 * sd / np.sqrt(s.size)
    assert abs(s.var() / dist.variance() - 1.0) < 0.03


def test_iid_prior_over_each_distribution():
    x = torch.from_numpy(_points([]).reshape(50, 4))
    for name, params, _ in CASES:
        dist = getattr(mt, name)(**params)
        prior = mt.make_beta_prior(dist, 4)
        assert isinstance(prior, mt.IIDPrior)
        assert torch.equal(prior.coord_log_prob(x, None, x[:, 0]),
                           dist.log_prob(x[:, 0]))
        np.testing.assert_allclose(prior.mean_beta().numpy(),
                                   np.full(4, dist.mean()))
        np.testing.assert_allclose(prior.cov_beta().numpy(),
                                   np.eye(4) * dist.variance())
