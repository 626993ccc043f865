"""The port's model-math functions (``mcmcglm_tpu_torch/models/
potential.py``) against the JAX package's on the same inputs: the four
exported functions and the lockstep engine's relative coordinate target,
at float32 with rtol 1e-5 and atol 1e-5 (the JAX functions run one chain
each, vmapped; the port's are batched over chains)."""

import numpy as np
import pytest
import scipy.stats as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.models import make_coord_target as jax_target  # noqa: E402
from mcmcglm_tpu_torch.models import make_coord_target  # noqa: E402
from mcmcglm_tpu_torch.ops.freerun_batteries import masked_sum  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
f32 = np.float32


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_log_density_generic():
    mu = np.array([0.5, 0.9])
    y = np.array([1.0, 0.0])
    got = mt.log_density("binomial", _t(mu, torch.float64),
                         _t(y, torch.float64))
    np.testing.assert_allclose(got.numpy(),
                               st.bernoulli.logpmf(y.astype(int), mu),
                               rtol=1e-6)
    mu = np.array([0.5, 2.0, 3.5], f32)
    y = np.array([1.0, 2.0, 0.0], f32)
    want = mg.log_density("poisson", jnp.asarray(mu), jnp.asarray(y))
    np.testing.assert_allclose(mt.log_density("poisson", _t(mu), _t(y)),
                               np.asarray(want), **TOL)
    want = mg.log_density("gaussian", jnp.asarray(mu), jnp.asarray(y), sd=1.3)
    np.testing.assert_allclose(
        mt.log_density("gaussian", _t(mu), _t(y), sd=1.3), np.asarray(want),
        **TOL)
    np.testing.assert_allclose(
        mt.log_likelihood("poisson", _t(mu), _t(y)).numpy(),
        float(mg.log_likelihood("poisson", jnp.asarray(mu), jnp.asarray(y))),
        **TOL)


def test_update_linear_predictor():
    out = mt.update_linear_predictor(2.0, 0.5, _t([1.0, 2.0, 3.0]),
                                     _t([0.5, -1.0, 2.0]))
    np.testing.assert_allclose(out, np.array([1.0, 2.0, 3.0])
                               + 1.5 * np.array([0.5, -1.0, 2.0]))
    rng = np.random.default_rng(0)
    C, n = 5, 40
    eta, xj = rng.normal(size=(C, n)).astype(f32), rng.normal(size=n).astype(f32)
    new, cur = rng.normal(size=C).astype(f32), rng.normal(size=C).astype(f32)
    want = jax.vmap(mg.update_linear_predictor, in_axes=(0, 0, 0, None))(
        jnp.asarray(new), jnp.asarray(cur), jnp.asarray(eta), jnp.asarray(xj))
    got = mt.update_linear_predictor(_t(new), _t(cur), _t(eta), _t(xj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_log_potential_update_equals_naive_and_jax():
    """Both linear-predictor calculations give the same potential, and the
    JAX package's, for every chain and coordinate."""
    rng = np.random.default_rng(0)
    n, d, C = 50, 4, 6
    X = rng.normal(size=(n, d)).astype(f32)
    y = rng.normal(size=n).astype(f32)
    beta = rng.normal(size=(C, d)).astype(f32)
    eta = (beta.astype(np.float64) @ X.T.astype(np.float64)).astype(f32)
    new = rng.normal(size=C).astype(f32)
    pt = mt.IIDPrior(mt.Normal(0.0, 1.0), d)
    pj = mg.IIDPrior(mg.Normal(0.0, 1.0), d)
    for j in range(d):
        got = {calc: mt.log_potential_from_betaj(
            _t(new), j, _t(beta), _t(eta), _t(y), _t(X), "gaussian", pt,
            linear_predictor_calc=calc, extra={"sd": 1.0})
            for calc in ("update", "naive")}
        want = jax.vmap(lambda nb, b, e: mg.log_potential_from_betaj(
            nb, j, b, e, jnp.asarray(y), jnp.asarray(X), "gaussian", pj,
            extra={"sd": 1.0}))(jnp.asarray(new), jnp.asarray(beta),
                                jnp.asarray(eta))
        np.testing.assert_allclose(got["update"].numpy(),
                                   got["naive"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["update"].numpy(), np.asarray(want),
                                   **TOL)
    # one (d,) chain, a per-chain coordinate index
    one = mt.log_potential_from_betaj(
        float(new[0]), 2, _t(beta[0]), _t(eta[0]), _t(y), _t(X), "gaussian",
        pt, extra={"sd": 1.0})
    per = mt.log_potential_from_betaj(
        _t(new), torch.full((C,), 2), _t(beta), _t(eta), _t(y), _t(X),
        "gaussian", pt, extra={"sd": 1.0})
    assert one.dim() == 0 and float(one) == pytest.approx(float(per[0]),
                                                          rel=1e-6)


def test_log_potential_matches_direct():
    rng = np.random.default_rng(1)
    n, d = 30, 3
    X, y, beta = rng.normal(size=(n, d)), rng.normal(size=n), rng.normal(size=d)
    j, b_new = 1, 0.3
    beta2 = beta.copy()
    beta2[j] = b_new
    expected = (st.norm.logpdf(y, X @ beta2, 1.0).sum()
                + st.norm.logpdf(beta2).sum())
    f64 = torch.float64
    got = mt.log_potential_from_betaj(
        b_new, j, _t(beta, f64), _t(X @ beta, f64), _t(y, f64), _t(X, f64),
        "gaussian", mt.IIDPrior(mt.Normal(0.0, 1.0), d), extra={"sd": 1.0})
    np.testing.assert_allclose(float(got), expected, rtol=1e-6)


FAMILIES = [("gaussian", {"sd": 1.3}), ("binomial", {}), ("poisson", {})]


def _priors(d):
    return [
        (mt.IIDPrior(mt.Normal(0.5, 2.0), d), mg.IIDPrior(mg.Normal(0.5, 2.0), d)),
        (mt.StackedPrior([mt.Normal(0, 1), mt.Laplace(0, 0.7),
                          mt.StudentT(3.0, 0.0, 1.0)]),
         mg.StackedPrior([mg.Normal(0, 1), mg.Laplace(0, 0.7),
                          mg.StudentT(3.0, 0.0, 1.0)])),
    ]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("family,extra", FAMILIES)
def test_coord_target_matches_jax(family, extra, weighted):
    """g(b) of make_coord_target for (C,) and (C, K) proposals against the
    JAX package's target (vmapped over chains and proposals); g(beta_j) is
    0 exactly."""
    rng = np.random.default_rng(3)
    C, n, d, K = 6, 120, 3, 4
    Xt = (rng.normal(size=(d, n)) / np.sqrt(d)).astype(f32)
    if family == "binomial":
        y = rng.binomial(1, 0.4, n).astype(f32)
    elif family == "poisson":
        y = rng.poisson(1.5, n).astype(f32)
    else:
        y = rng.normal(size=n).astype(f32)
    w = rng.uniform(0.5, 2.0, n).astype(f32)
    beta = (0.5 * rng.normal(size=(C, d))).astype(f32)
    eta = (0.5 * rng.normal(size=(C, n))).astype(f32)
    j = rng.integers(0, d, C)
    b = (beta[np.arange(C), j][:, None]
         + 0.3 * rng.normal(size=(C, K))).astype(f32)
    fam_t, fam_j = mt.check_family(family), mg.check_family(family)
    ld = fam_t.log_density_eta(_t(eta), _t(y), extra)
    reduce_t = (lambda t: masked_sum(t, _t(w))) if weighted else \
        (lambda t: torch.sum(t, -1))
    reduce_j = (lambda t: jnp.sum(t * jnp.asarray(w), -1)) if weighted else \
        (lambda t: jnp.sum(t, -1))
    for pt, pj in _priors(d):
        ft = make_coord_target(fam_t, pt, _t(y), extra, reduce_fn=reduce_t)
        fj = jax_target(fam_j, pj, jnp.asarray(y), extra, reduce_fn=reduce_j)
        g = ft(_t(beta), _t(eta), ld, _t(Xt)[torch.tensor(j)],
               torch.tensor(j))
        assert g.batched
        got_k = g(_t(b)).numpy()
        ldj = np.asarray(jax.vmap(lambda e: fam_j.log_density_eta(
            e, jnp.asarray(y), extra))(jnp.asarray(eta)))

        def one(be, et, l, xj, jj, bb):
            return fj(be, et, l, xj, jj)(bb)

        want_k = np.stack([np.asarray(jax.vmap(one)(
            jnp.asarray(beta), jnp.asarray(eta), jnp.asarray(ldj),
            jnp.asarray(Xt[j]), jnp.asarray(j), jnp.asarray(b[:, k])))
            for k in range(K)], 1)
        np.testing.assert_allclose(got_k, want_k, **TOL)
        np.testing.assert_allclose(g(_t(b[:, 1])).numpy(), want_k[:, 1],
                                   **TOL)
        # one (n,) design row shared by all chains, as the engine passes it
        jc = torch.full((C,), 1)
        g1 = ft(_t(beta), _t(eta), ld, _t(Xt[1]), jc)
        np.testing.assert_array_equal(g1(_t(beta[:, 1])).numpy(), 0.0)
