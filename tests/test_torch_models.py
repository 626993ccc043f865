"""Model math of the port against the JAX package, elementwise on the same
numpy inputs: every family/link's log densities, every link, the Normal /
IID prior, and the init product eta0 = X beta0 against float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402

RTOL, ATOL = 1e-6, 1e-6  # float32 on both sides; libm implementations differ

# (family, link, extra, eta sampler, y sampler)
CASES = [
    ("gaussian", "identity", {"sd": 1.7}, "normal", "normal"),
    ("binomial", "logit", {}, "normal", "bernoulli"),
    ("binomial", "probit", {}, "normal", "bernoulli"),
    ("binomial", "cloglog", {}, "normal", "bernoulli"),
    ("poisson", "log", {}, "normal", "counts"),
    ("negative_binomial", "log", {"size": 2.5}, "normal", "counts"),
    ("gamma", "log", {"shape": 2.0}, "normal", "positive"),
    ("gamma", "inverse", {"shape": 2.0}, "positive", "positive"),
    ("inverse_gaussian", "1/mu^2", {"dispersion": 0.5}, "positive",
     "positive"),
    ("inverse_gaussian", "log", {"shape": 3.0}, "normal", "positive"),
]


def _inputs(eta_kind, y_kind, n=257, seed=0):
    rng = np.random.default_rng(seed)
    eta = (rng.normal(scale=1.5, size=n) if eta_kind == "normal"
           else rng.uniform(0.2, 2.0, size=n))
    y = {
        "normal": lambda: rng.normal(size=n),
        "bernoulli": lambda: rng.binomial(1, 0.4, size=n),
        "counts": lambda: rng.poisson(2.0, size=n),
        "positive": lambda: rng.gamma(2.0, 1.0, size=n) + 0.05,
    }[y_kind]()
    return eta.astype(np.float32), y.astype(np.float32)


def _families(name, link):
    return (getattr(mg, name)(link), getattr(mt, name)(link))


@pytest.mark.parametrize("name,link,extra,eta_kind,y_kind", CASES)
def test_family_log_densities_match_jax(name, link, extra, eta_kind, y_kind):
    fj, ft = _families(name, link)
    assert (fj.name, fj.link.name) == (ft.name, ft.link.name)
    eta, y = _inputs(eta_kind, y_kind)
    mu = np.array(fj.linkinv(jnp.asarray(eta)), np.float32)
    for method, arg in (("log_density_eta_rel", eta),
                        ("log_density_eta", eta),
                        ("log_density_mu", mu)):
        want = np.asarray(getattr(fj, method)(jnp.asarray(arg),
                                              jnp.asarray(y), extra))
        got = getattr(ft, method)(torch.from_numpy(arg),
                                  torch.from_numpy(y), extra).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}/{link} {method}")


@pytest.mark.parametrize("link", ["identity", "log", "logit", "probit",
                                  "cloglog", "inverse", "1/mu^2", "sqrt",
                                  "cauchit"])
def test_links_match_jax(link):
    lj, lt = mg.get_link(link), mt.get_link(link)
    rng = np.random.default_rng(1)
    pos = link in ("inverse", "1/mu^2", "sqrt")
    eta = (rng.uniform(0.2, 2.0, 101) if pos
           else rng.normal(size=101)).astype(np.float32)
    mu = np.array(lj.linkinv(jnp.asarray(eta)), np.float32)
    if link in ("logit", "probit", "cloglog", "cauchit"):
        mu = np.clip(mu, 1e-3, 1 - 1e-3)
    for fn, arg in (("linkinv", eta), ("mu_eta", eta), ("link", mu)):
        want = np.asarray(getattr(lj, fn)(jnp.asarray(arg)))
        got = getattr(lt, fn)(torch.from_numpy(arg)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6,
                                   err_msg=f"{link}.{fn}")


def test_check_family_errors_match():
    with pytest.raises(ValueError, match="not recognized"):
        mt.check_family("nope")
    with pytest.raises(ValueError, match="unknown link"):
        mt.get_link("nope")


@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (0.7, 2.5)])
def test_normal_iid_prior_matches_jax(loc, scale):
    rng = np.random.default_rng(2)
    C, K, d = 6, 4, 5
    beta = rng.normal(size=(C, d)).astype(np.float32)
    b = (3.0 * rng.normal(size=(C, K))).astype(np.float32)
    j = rng.integers(0, d, C).astype(np.int32)
    pj = mg.IIDPrior(mg.Normal(loc, scale), d)
    pt = mt.IIDPrior(mt.Normal(loc, scale), d)
    want = np.stack([
        np.asarray([pj.coord_log_prob(jnp.asarray(beta[c]), int(j[c]),
                                      jnp.asarray(b[c, k]))
                    for k in range(K)])
        for c in range(C)
    ])
    got = pt.coord_log_prob(torch.from_numpy(beta), torch.from_numpy(j),
                            torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_full = np.asarray([pj.log_prob_beta(jnp.asarray(r)) for r in beta])
    got_full = pt.log_prob_beta(torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(got_full, want_full, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(pt.mean_beta().numpy(),
                               np.asarray(pj.mean_beta()), rtol=0)
    np.testing.assert_allclose(pt.cov_beta().numpy(),
                               np.asarray(pj.cov_beta()), rtol=1e-7)


def test_prior_draws_have_the_prior_law():
    pt = mt.IIDPrior(mt.Normal(0.5, 2.0), 4)
    g = torch.Generator().manual_seed(0)
    draws = pt.sample_beta(g, 20_000, dtype=torch.float32,
                           device=torch.device("cpu")).numpy()
    assert draws.shape == (20_000, 4)
    assert np.abs(draws.mean(0) - 0.5).max() < 0.06
    assert np.abs(draws.std(0) / 2.0 - 1.0).max() < 0.03


def test_make_beta_prior_forms():
    assert isinstance(mt.make_beta_prior(mt.Normal(), 3), mt.IIDPrior)
    with pytest.raises(ValueError, match="dimension"):
        mt.make_beta_prior(mt.IIDPrior(mt.Normal(), 2), 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.make_beta_prior([mt.Normal()] * 3, 3)


def test_init_eta_matches_float64_product():
    """eta0 = X beta0 is the only full product and its error would stay
    with each chain for life: every chain's mean offset against a float64
    X beta0 must be below 1e-6, whatever the matmul precision setting."""
    rng = np.random.default_rng(3)
    n, d, C = 3000, 120, 16
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.binomial(1, 0.5, n).astype(float)
    eng = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 3), d),
                            tuning={"w": 0.5}, device="cpu")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        st = eng.init(0, C)
    finally:
        torch.set_float32_matmul_precision(prev)
    Xf = X.astype(np.float32).astype(np.float64)  # the engine's f32 design
    ref = st.beta.numpy().astype(np.float64) @ Xf.T
    offset = (st.eta.numpy().astype(np.float64) - ref).mean(axis=1)
    assert np.abs(offset).max() < 1e-6
    assert np.abs(st.eta.numpy() - ref).max() < 1e-4


@pytest.mark.parametrize("kernel,tuning", [
    ("stepping_out", {"w": 0.5}),
    ("quantile", {"pseudo_scale": 2.0, "pseudo_adapt": True}),
])
def test_init_matches_jax_from_the_same_beta0(kernel, tuning):
    """From the same beta0 (and a formula-style offset) the two engines
    build the same eta, cache and deterministic registers."""
    rng = np.random.default_rng(4)
    n, d, C = 200, 4, 6
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.poisson(2.0, n).astype(float)
    offset = rng.normal(scale=0.3, size=n)
    beta0 = (0.3 * rng.normal(size=(C, d))).astype(np.float32)
    kw = dict(tuning=tuning, slice_kernel=kernel, offset=offset)
    ej = JaxFreeRun(X, y, "poisson", mg.IIDPrior(mg.Normal(0, 1), d), **kw)
    et = mt.FreeRunCGGibbs(X, y, "poisson", mt.IIDPrior(mt.Normal(0, 1), d),
                           device="cpu", **kw)
    sj = ej.init(jax.random.key(0), C, beta0=beta0)
    st = et.init(0, C, beta0=beta0)
    assert ej.eval_cache == et.eval_cache
    ref = beta0.astype(np.float64) @ X.astype(np.float32).T + \
        offset.astype(np.float32)
    assert np.abs(st.eta.numpy() - ref).max() < 1e-5
    np.testing.assert_allclose(st.eta.numpy(), np.asarray(sj.eta),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(st.ld0.numpy(), np.asarray(sj.ld0),
                               rtol=2e-5, atol=2e-3)
    for name in ("beta", "logw", "b0", "lp0"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("j", "phase", "stepdir", "n_shrink", "nev"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
