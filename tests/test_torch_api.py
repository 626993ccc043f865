"""The port's user path: ``mcmcglm(device="cpu")`` against the JAX
package's ``mcmcglm`` on the README example, and the numpy-only copies
(datagen, diagnostics, formula) against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402


def test_mcmcglm_cpu_recovers_readme_example(readme_gaussian_data):
    X, y, beta_true = readme_gaussian_data
    kw = dict(X=X, y=y, family="gaussian", w=0.5, n_samples=300, burnin=60,
              n_chains=4, seed=1)
    fit_t = mt.mcmcglm(device="cpu", **kw)
    fit_j = mg.mcmcglm(**kw)
    coef_t, coef_j = fit_t.coef().to_numpy(), fit_j.coef().to_numpy()
    assert fit_t.beta.shape == fit_j.beta.shape == (4, 301, 3)
    assert fit_t.n_evals.shape == fit_j.n_evals.shape == (4, 240)
    np.testing.assert_allclose(coef_t, beta_true, atol=0.15)
    # the closed-form posterior mean (prior N(0, 1), sd 1) and the JAX fit,
    # within Monte Carlo error
    post_mean = np.linalg.solve(X.T @ X + np.eye(3), X.T @ y)
    np.testing.assert_allclose(coef_t, post_mean, atol=0.03)
    np.testing.assert_allclose(coef_t, coef_j, atol=0.04)
    assert np.all(fit_t.rhat() < 1.1)
    q = fit_t.quantile()
    assert list(q.columns) == list(fit_j.quantile().columns)
    assert fit_t.samples().shape == fit_j.samples().shape
    assert abs(fit_t.n_evals.mean() / fit_j.n_evals.mean() - 1.0) < 0.1


def test_mcmcglm_formula_quantile_path():
    rng = np.random.default_rng(3)
    import pandas as pd

    n = 300
    df = pd.DataFrame({"x": rng.normal(size=n),
                       "g": pd.Categorical(rng.choice(["a", "b"], n))})
    df["Y"] = rng.binomial(1, 1 / (1 + np.exp(-(0.3 + df["x"])))).astype(float)
    fit = mt.mcmcglm("Y ~ x + g", family="binomial", data=df,
                     slice_fn="quantile", pseudo_scale=2.0, pseudo_adapt=True,
                     pseudo_c=3.0, n_samples=120, burnin=40, n_chains=4,
                     device="cpu", engine_opts={"spec_k": 4})
    assert fit.columns == ["(Intercept)", "x", "gb"]
    assert fit.slice_kernel == "quantile"
    assert np.isfinite(fit.beta).all()
    assert 0.4 < float(fit.coef()["x"]) < 1.8


def test_datagen_copies_match():
    for fam in ("gaussian", "binomial", "poisson"):
        a = mg.generate_glm_data(fam, n=50, d=4, seed=3)
        b = mt.generate_glm_data(fam, n=50, d=4, seed=3)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert mg.generate_normal_data(3, n=20, seed=1).equals(
        mt.generate_normal_data(3, n=20, seed=1))


def test_diagnostics_copies_match():
    rng = np.random.default_rng(0)
    draws = np.cumsum(rng.normal(size=(4, 200, 3)), axis=1) * 0.1 + \
        rng.normal(size=(4, 200, 3))
    np.testing.assert_array_equal(mt.ess(draws),
                                  mg.ess(draws, use_native=False))
    np.testing.assert_array_equal(mt.ess(draws[:, :, 0]),
                                  mg.ess(draws[:, :, 0], use_native=False))
    np.testing.assert_array_equal(
        mt.ess(draws, rank_normalized=True),
        mg.ess(draws, use_native=False, rank_normalized=True))
    np.testing.assert_array_equal(mt.split_rhat(draws), mg.split_rhat(draws))
    assert mt.summarize(draws).equals(mg.summarize(draws))


@pytest.mark.parametrize("formula,factor", [
    ("Y ~ .", True), ("Y ~ x1 + g", True), ("Y ~ x1 * g - 1", True),
    ("Y ~ log(x2) + I(x1^2)", False), ("Y ~ x1 + offset(x2)", False),
])
def test_formula_copies_match(formula, factor):
    import pandas as pd

    rng = np.random.default_rng(1)
    n = 40
    df = pd.DataFrame({"Y": rng.normal(size=n), "x1": rng.normal(size=n),
                       "x2": rng.uniform(0.5, 2.0, n)})
    if factor:  # function terms evaluate every column as numbers
        df["g"] = pd.Categorical(rng.choice(["u", "v", "w"], n))
    a, b = mg.build_design(formula, df), mt.build_design(formula, df)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.columns == b.columns
    if a.offset is None:
        assert b.offset is None
    else:
        np.testing.assert_array_equal(a.offset, b.offset)
