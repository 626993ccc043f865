"""The port's model-criticism tools (WAIC, LOO), ``predict`` and
``trace_plot``, mirroring tests/test_criticism.py, and held against the
JAX package on the same draws.

The JAX package evaluates the log densities in float32 when x64 is off
(its library setting; the test suite turns x64 on), so the comparisons
run it under ``jax.enable_x64(False)``; the port evaluates them in float32
on the fit's device (the CPU here).  Tolerances: the WAIC and LOO sums
rtol 1e-5 (float32 densities from two libraries' log and exp, summed in
float64), the linear predictor rtol 1e-12 (float64 products in another
order), the mean rtol 2e-6 (a float32 inverse link).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import (  # noqa: E402
    eta_sign,
    example_extra,
    family_response,
)
from mcmcglm_tpu.results import MCMCGLM as JaxResult  # noqa: E402
from mcmcglm_tpu_torch.diagnostics import (  # noqa: E402
    ess,
    rank_normalize,
    split_rhat,
)


@pytest.fixture(scope="module")
def fit():
    X, y, _ = mt.generate_glm_data("binomial", n=600, d=4, seed=0)
    return mt.mcmcglm(family="binomial", X=X, y=y, n_samples=300, burnin=100,
                      n_chains=4, w=0.8, device="cpu")


class TestWAIC:
    def test_p_waic_near_param_count(self, fit):
        w = fit.waic()
        # effective parameter count ~ d for a well-identified model
        assert 1.5 < w["p_waic"] < 8.0
        assert w["waic"] == pytest.approx(-2 * w["elpd_waic"])

    def test_loo_agrees_with_waic(self, fit):
        w, l = fit.waic(), fit.loo()
        assert abs(w["elpd_waic"] - l["elpd_loo"]) < 5.0
        assert l["p_loo"] > 0

    def test_model_comparison_orders_correctly(self):
        """WAIC must prefer the true model over one missing a covariate."""
        rng = np.random.default_rng(1)
        n = 800
        X = np.column_stack([np.ones(n), rng.normal(size=n),
                             rng.normal(size=n)])
        y = rng.binomial(1, 1 / (1 + np.exp(-X @ [0.3, 1.2, 0.0]))).astype(
            float)
        common = dict(n_samples=250, burnin=80, n_chains=4, w=0.8,
                      device="cpu")
        full = mt.mcmcglm(family="binomial", X=X[:, :2], y=y, **common)
        null = mt.mcmcglm(family="binomial", X=X[:, :1], y=y, **common)
        assert full.waic()["elpd_waic"] > null.waic()["elpd_waic"]


class TestRankNormalized:
    def test_heavy_tail_robustness(self):
        rng = np.random.default_rng(2)
        x = rng.standard_cauchy(size=(4, 2000))
        e = ess(x, rank_normalized=True)
        assert 0.5 * 8000 < e < 2 * 8000
        assert abs(split_rhat(x, rank_normalized=True) - 1.0) < 0.02

    def test_rank_normalize_shape_and_monotone(self):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 50, 3))
        z = rank_normalize(x)
        assert z.shape == x.shape
        flat_x = x[:, :, 0].ravel()
        flat_z = z[:, :, 0].ravel()
        order = np.argsort(flat_x)
        assert (np.diff(flat_z[order]) > 0).all()


class TestThin:
    def test_thin_through_api(self):
        X, y, _ = mt.generate_glm_data("binomial", n=400, d=5, seed=4)
        fit = mt.mcmcglm(family="binomial", X=X, y=y, n_samples=400,
                         burnin=100, n_chains=4, w=0.8, thin=4, device="cpu")
        assert fit.beta.shape == (4, 76, 5)  # init + 300/4 draws
        assert fit.burnin == 0  # thinned draws are post-burn-in
        assert np.isfinite(fit.post_burnin()).all()


# -- against the JAX package on the same draws ---------------------------------

def _jax_twin(res, jax_family):
    """The JAX package's result object over the port result's draws."""
    return JaxResult(
        beta=res.beta, columns=res.columns, family_name=res.family_name,
        burnin=res.burnin, sample_method=res.sample_method,
        slice_kernel=res.slice_kernel, tuning=res.tuning,
        model_matrix=res.model_matrix, response=res.response,
        family=jax_family, extra=res.extra, offset=res.offset)


def _synthetic(pair, extra, seed=0, n=150, d=3, C=3, K=60, burnin=10,
               offset=False):
    """A port result over random draws of a pair, with every eta in the
    pair's domain: X >= 0 and beta > 0 (X <= 0 for binomial/log)."""
    rng = np.random.default_rng(seed)
    sign = eta_sign(mt.check_family(pair[0]).with_link(pair[1])) or 1
    X = sign * rng.uniform(0.1, 1.0, size=(n, d))
    beta = rng.gamma(4.0, 0.1, size=(C, K + 1, d))
    name = pair[0]
    y = family_response(name, n, rng)
    return mt.MCMCGLM(
        beta=beta, columns=[f"X{i}" for i in range(d)], family_name=name,
        burnin=burnin, sample_method="slice_sampling",
        slice_kernel="stepping_out", tuning={"w": 0.5}, model_matrix=X,
        response=y, family=mt.check_family(name).with_link(pair[1]),
        extra=extra, offset=(0.05 * rng.uniform(size=n) if offset else None),
        device="cpu")


PAIRS = {p: example_extra(p) for p in (
    ("binomial", "logit"), ("binomial", "probit"), ("binomial", "log"),
    ("gaussian", "identity"), ("gaussian", "inverse"), ("poisson", "sqrt"),
    ("negative.binomial", "log"), ("Gamma", "inverse"),
    ("inverse.gaussian", "1/mu^2"))}


@pytest.mark.parametrize("pair", list(PAIRS), ids="/".join)
def test_criticism_matches_jax_on_the_same_draws(pair):
    res = _synthetic(pair, PAIRS[pair], offset=pair[0] == "poisson")
    twin = _jax_twin(res, mg.check_family(pair[0]).with_link(pair[1]))
    with jax.enable_x64(False):
        for n_draws, seed in ((1000, 0), (40, 3)):
            for name in ("waic", "loo"):
                got = getattr(res, name)(n_draws=n_draws, seed=seed)
                want = getattr(twin, name)(n_draws=n_draws, seed=seed)
                assert got.keys() == want.keys()
                for k in got:
                    assert np.isfinite(got[k])
                    assert got[k] == pytest.approx(want[k], rel=1e-5), k
            ld_t = res._pointwise_loglik(n_draws, seed)
            ld_j = twin._pointwise_loglik(n_draws, seed)
            assert ld_t.shape == ld_j.shape == (min(n_draws, 150), 150)
            np.testing.assert_allclose(ld_t, ld_j, rtol=1e-5, atol=1e-5)
        for kind, rtol in (("link", 1e-12), ("mean", 2e-6)):
            got = res.predict(kind=kind, n_draws=25, seed=7)
            want = twin.predict(kind=kind, n_draws=25, seed=7)
            assert got.shape == want.shape == (25, 150)
            np.testing.assert_allclose(got, want, rtol=rtol)
        X_new = np.abs(np.random.default_rng(9).normal(size=(5, 3)))
        X_new *= -1.0 if pair == ("binomial", "log") else 1.0
        np.testing.assert_allclose(res.predict(X_new, offset=np.ones(5)),
                                   twin.predict(X_new, offset=np.ones(5)),
                                   rtol=2e-6)


def test_fit_criticism_matches_jax(fit):
    """The same draws of a real fit give the JAX package's numbers."""
    twin = _jax_twin(fit, mg.check_family("binomial"))
    with jax.enable_x64(False):
        for name in ("waic", "loo"):
            got, want = getattr(fit, name)(), getattr(twin, name)()
            for k in got:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
        np.testing.assert_allclose(fit.predict(), twin.predict(), rtol=2e-6)


def test_predict_and_criticism_errors():
    res = _synthetic(("binomial", "logit"), {})
    with pytest.raises(ValueError, match="kind"):
        res.predict(kind="response")
    res.model_matrix = None
    with pytest.raises(ValueError, match="model matrix"):
        res.predict()
    with pytest.raises(ValueError, match="stored data"):
        res.waic()
    # without a family object predict falls back to the default link
    res = _synthetic(("binomial", "logit"), {})
    res.family = None
    eta = res.predict(kind="link")
    np.testing.assert_allclose(res.predict(), 1 / (1 + np.exp(-eta)),
                               rtol=2e-6)


def test_trace_plot_draws_what_the_jax_package_draws():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    res = _synthetic(("gaussian", "identity"), {"sd": 1.0}, d=4)
    twin = _jax_twin(res, mg.check_family("gaussian"))
    for drop in (None, 0, 25):
        figs = [res.trace_plot(samples_drop=drop),
                twin.trace_plot(samples_drop=drop)]
        axes = [[a for a in f.axes if a.get_visible()] for f in figs]
        assert len(axes[0]) == len(axes[1]) == 4
        for a_t, a_j in zip(*axes):
            assert a_t.get_title() == a_j.get_title()
            lines = a_t.get_lines(), a_j.get_lines()
            assert len(lines[0]) == len(lines[1]) == 2 * res.n_chains
            for l_t, l_j in zip(*lines):
                np.testing.assert_array_equal(l_t.get_xydata(),
                                              l_j.get_xydata())
                assert l_t.get_color() == l_j.get_color()
        for f in figs:
            plt.close(f)
