"""The port's whole-vector slice samplers (``mcmcglm_tpu_torch/baselines/
mv_slice.py``: hyperrect, latent-mv, quantile-mv) against the JAX
package's (tests/test_mv_slice.py): the closed-form gaussian posterior
(mean and sd) and the logistic recovery at the JAX tests' problems and
tolerances, the latent widths' law, the quantile pseudo-targets' cdf,
ppf and log density against the JAX methods (float64, rtol 1e-12), chain
c bitwise the same at C=3 and C=5 and at loop block lengths 1 and 4, the
state converter, and the errors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.baselines import mv_slice as jax_mv  # noqa: E402
from mcmcglm_tpu_torch.baselines import (  # noqa: E402
    HyperrectSliceGLM,
    LatentSliceGLM,
    QuantileSliceGLM,
)
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402


def _gaussian_problem(n=300, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta_true = np.linspace(1.0, -0.5, d)
    y = X @ beta_true + rng.normal(size=n)
    P = X.T @ X + np.eye(d)
    mu = np.linalg.solve(P, X.T @ y)
    sd = np.sqrt(np.diag(np.linalg.inv(P)))
    return X, y, mu, sd


def _make(cls, X, y, d, **kw):
    return cls(X, y, "gaussian", mt.IIDPrior(mt.Normal(0.0, 1.0), d),
               extra={"sd": 1.0}, device="cpu", **kw)


SAMPLERS = [
    (HyperrectSliceGLM, {"w": 0.5}),
    (LatentSliceGLM, {"rate": 3.0}),
    (QuantileSliceGLM, {"pseudo_scale": 1.0}),
]


@pytest.mark.parametrize("cls,kw", SAMPLERS)
def test_gaussian_conjugate_recovery(cls, kw):
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    eng = _make(cls, X, y, d, **kw)
    betas, nev, _ = eng.sample(1, 3000, n_chains=16)
    post = betas[:, 500:, :].reshape(-1, d)
    assert np.abs(post.mean(0) - mu).max() < 0.03
    assert np.abs(post.std(0) / sd - 1.0).max() < 0.12
    assert (nev >= 1).all() and (nev <= eng.max_shrink).all()


@pytest.mark.parametrize("cls,kw", [
    (HyperrectSliceGLM, {"w": 0.4}),
    (LatentSliceGLM, {"rate": 4.0}),
    (QuantileSliceGLM, {"pseudo_scale": 0.8, "pseudo_family": "normal"}),
])
def test_logistic_recovery(cls, kw):
    """Non-gaussian likelihood: posterior mean should sit near the truth
    (z-score < 3 against the posterior sd)."""
    X, y, beta_true = generate_glm_data("binomial", n=800, d=4, seed=3)
    eng = cls(X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), 4),
              device="cpu", **kw)
    betas, _, _ = eng.sample(2, 2500, n_chains=8)
    post = betas[:, 500:, :].reshape(-1, 4)
    z = np.abs(post.mean(0) - beta_true) / np.maximum(post.std(0), 1e-9)
    assert z.max() < 3.0


def test_latent_widths_follow_rate():
    """The latent sampler's carried widths obey s = 2|l - x| + Exp(rate):
    in a concentrated posterior (|l - x| small) the Exp(rate) term with
    mean 1/rate dominates, so a larger rate yields smaller brackets."""
    X, y, mu, sd = _gaussian_problem()
    d = X.shape[1]
    means = {}
    for rate in (0.5, 20.0):
        eng = _make(LatentSliceGLM, X, y, d, rate=rate)
        st = eng.init(0, 8)
        st, _, _ = eng.run(st, 300)
        s = st.aux.numpy()
        assert s.shape == (8, d) and np.isfinite(s).all() and (s > 0).all()
        means[rate] = float(s.mean())
    assert means[20.0] < means[0.5] / 5.0


@pytest.mark.parametrize("family", ["normal", "cauchy"])
def test_pseudo_target_functions_match_jax(family):
    X, y, _, _ = _gaussian_problem()
    loc, scale = np.array([0.1, -0.3, 0.5]), np.array([0.8, 1.5, 0.6])
    kw = dict(pseudo_loc=loc, pseudo_scale=scale, pseudo_family=family)
    jeng = jax_mv.QuantileSliceGLM(X, y, "gaussian",
                                   mg.IIDPrior(mg.Normal(0.0, 1.0), 3),
                                   extra={"sd": 1.0}, dtype=jnp.float64, **kw)
    eng = QuantileSliceGLM(X, y, "gaussian", mt.IIDPrior(mt.Normal(0.0, 1.0), 3),
                           extra={"sd": 1.0}, dtype=torch.float64,
                           device="cpu", **kw)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 3)) * 2.0
    u = rng.uniform(1e-6, 1 - 1e-6, size=(6, 3))
    np.testing.assert_allclose(eng._cdf(torch.tensor(x)).numpy(),
                               np.asarray(jeng._cdf(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(eng._ppf(torch.tensor(u)).numpy(),
                               np.asarray(jeng._ppf(jnp.asarray(u))),
                               rtol=1e-12)
    np.testing.assert_allclose(
        eng._logpdf_sum(torch.tensor(x)).numpy(),
        np.asarray(jax.vmap(jeng._logpdf_sum)(jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("cls,kw", SAMPLERS)
def test_chains_independent_of_batch_and_block(cls, kw):
    X, y, _, _ = _gaussian_problem(n=120)
    out = []
    for C, B in ((3, 1), (5, 1), (3, 4), (5, 4)):
        eng = _make(cls, X, y, 3, **kw)
        eng._block_iters = B
        st, betas, nev = eng.run(eng.init(4, C), 25)
        out.append((st.beta[:3], st.lp[:3], st.aux[:3], betas[:3], nev[:3]))
        assert eng.loop_stats["flag_reads"] > 0
    for o in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], o))


def test_convert_mv_slice_state():
    X, y, _, _ = _gaussian_problem()
    jeng = jax_mv.LatentSliceGLM(X, y, "gaussian",
                                 mg.IIDPrior(mg.Normal(0.0, 1.0), 3),
                                 extra={"sd": 1.0}, rate=3.0)
    jst, _, _ = jeng.run(jeng.init(jax.random.key(0), 4), 5)
    eng = _make(LatentSliceGLM, X, y, 3, rate=3.0)
    st = mt.convert_mv_slice_state(jst, eng, seed=5)
    for name in ("beta", "lp", "aux"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    assert st.step == 0 and st.key.tolist() == [5, 0]
    # the carried log posterior is the port's own at the carried beta
    np.testing.assert_allclose(eng._logpost(st.beta).numpy(), st.lp.numpy(),
                               rtol=1e-5)
    st2, betas, _ = eng.run(st, 5)
    assert torch.isfinite(betas).all() and st2.step == 5


def test_prior_dim_mismatch_raises():
    X, y, _, _ = _gaussian_problem()
    with pytest.raises(ValueError, match="prior dimension"):
        HyperrectSliceGLM(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), 7),
                          w=0.5, device="cpu")


def test_quantile_bad_pseudo_family_raises():
    X, y, _, _ = _gaussian_problem()
    with pytest.raises(ValueError, match="pseudo_family"):
        QuantileSliceGLM(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), 3),
                         pseudo_family="laplace", device="cpu")
