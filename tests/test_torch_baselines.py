"""The port's baselines (``mcmcglm_tpu_torch/baselines``) against the JAX
package's (``mcmcglm_tpu/baselines``, tests/test_baselines.py).

* The log posterior and its gradient against ``make_log_posterior`` and
  ``jax.grad`` for all 21 built-in family/link pairs under IID Normal,
  Laplace and StudentT priors and an MVN prior: float64 at rtol 1e-10,
  float32 at rtol 1e-5 (gradients against their largest entry).
* Dual averaging, the leapfrog integrator, popcount and trailing zeros,
  the U-turn test and the ADVI step (the -ELBO gradient and the Adam path
  under the same normals) against the JAX formulas, float64: rtol 1e-12,
  the ADVI path 1e-9.
* The laws of tests/test_baselines.py on the port, with its problems and
  tolerances: the closed-form gaussian posterior for HMC, NUTS, ADVI and
  the elliptical slice sampler (IID and MVN priors), NUTS against the
  port's CGGibbs and against the JAX NUTS on a logistic problem.
* Chain c bitwise the same at C=3 and C=5 and at loop block lengths 1 and
  4; the state converters; the errors; the profiling helpers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.baselines import advi as jax_advi  # noqa: E402
from mcmcglm_tpu.baselines import ess_mv as jax_ess  # noqa: E402
from mcmcglm_tpu.baselines import hmc as jax_hmc  # noqa: E402
from mcmcglm_tpu.baselines import logdensity as jax_ld  # noqa: E402
from mcmcglm_tpu.baselines import nuts as jax_nuts  # noqa: E402
from mcmcglm_tpu_torch import baselines as tb  # noqa: E402
from mcmcglm_tpu_torch.baselines import advi as t_advi  # noqa: E402
from mcmcglm_tpu_torch.baselines import hmc as t_hmc  # noqa: E402
from mcmcglm_tpu_torch.baselines import nuts as t_nuts  # noqa: E402
from mcmcglm_tpu_torch.baselines.logdensity import value_and_grad  # noqa: E402
from mcmcglm_tpu_torch.datagen import domain_data, example_extra  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402

F64 = torch.float64
MVN_LOC = np.array([0.2, -0.1, 0.4])
MVN_COV = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, -0.2], [0.0, -0.2, 0.5]])


def _priors(d):
    """name -> (JAX prior, port prior)."""
    return {
        "normal": (mg.IIDPrior(mg.Normal(0.0, 1.5), d),
                   mt.IIDPrior(mt.Normal(0.0, 1.5), d)),
        "laplace": (mg.IIDPrior(mg.Laplace(0.1, 0.7), d),
                    mt.IIDPrior(mt.Laplace(0.1, 0.7), d)),
        "studentt": (mg.IIDPrior(mg.StudentT(3.0, 0.0, 1.2), d),
                     mt.IIDPrior(mt.StudentT(3.0, 0.0, 1.2), d)),
        "mvn": (mg.MVNPrior(MVN_LOC, MVN_COV), mt.MVNPrior(MVN_LOC, MVN_COV)),
    }


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol)


def _close_grad(got, want, rtol):
    """Gradients within rtol of their largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# -- (a) the log posterior and its gradient ---------------------------------

@pytest.mark.parametrize("prior", ["normal", "laplace", "studentt", "mvn"])
@pytest.mark.parametrize("pair", list(fb.KERNEL_FAMILIES),
                         ids=lambda p: "/".join(p))
def test_logpost_value_and_grad_match_jax(pair, prior):
    d = 3
    X, y = domain_data(pair, 40, d, seed=0)
    extra = example_extra(pair)
    beta = np.random.default_rng(1).uniform(0.3, 1.2, size=(3, d))
    jprior, tprior = _priors(d)[prior]
    jfam = mg.check_family(pair[0]).with_link(pair[1])
    tfam = mt.check_family(pair[0]).with_link(pair[1])
    for jdt, tdt, rtol in ((jnp.float64, F64, 1e-10),
                           (jnp.float32, torch.float32, 1e-5)):
        jlp = jax_ld.make_log_posterior(X, y, jfam, jprior, extra=extra,
                                        dtype=jdt)
        want_v, want_g = jax.vmap(jax.value_and_grad(jlp))(
            jnp.asarray(beta, jdt))
        lp = tb.make_log_posterior(X, y, tfam, tprior, extra=extra,
                                   dtype=tdt, device="cpu")
        v, g = value_and_grad(lp, torch.tensor(beta, dtype=tdt))
        assert v.dtype == tdt and g.dtype == tdt
        assert np.isfinite(np.asarray(want_g)).all()
        _close(v, want_v, rtol)
        _close_grad(g, want_g, rtol)


# -- (b) the deterministic pieces ------------------------------------------

def test_da_update_matches_jax():
    rng = np.random.default_rng(0)
    eps0 = np.array([0.1, 0.03, 0.5])
    js = jax_hmc._da_init(jnp.asarray(eps0))
    ts = t_hmc._da_init(torch.tensor(eps0))
    for _ in range(12):
        acc = rng.uniform(size=3)
        js = jax.vmap(jax_hmc._da_update, (0, 0, None))(
            js, jnp.asarray(acc), 0.8)
        ts = t_hmc._da_update(ts, torch.tensor(acc), 0.8)
        for a, b in zip(ts, js):
            _close(a, b, 1e-12)


@pytest.fixture(scope="module")
def logistic():
    """The logistic problem of tests/test_baselines.py."""
    rng = np.random.default_rng(2)
    n, d = 800, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([0.4, 1.0, -0.7])
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta))).astype(float)
    return X, y, mg.IIDPrior(mg.Normal(0.0, 2.0), d), mt.IIDPrior(
        mt.Normal(0.0, 2.0), d)


def test_leapfrog_matches_jax(logistic):
    X, y, jprior, tprior = logistic
    rng = np.random.default_rng(3)
    z, r = rng.normal(size=(4, 3)) * 0.5, rng.normal(size=(4, 3))
    eps = np.array([0.05, 0.1, 0.02, 0.08])
    inv_mass = rng.uniform(0.5, 2.0, size=(4, 3))
    jvg = jax.value_and_grad(jax_ld.make_log_posterior(
        X, y, "binomial", jprior, dtype=jnp.float64))
    want = [jax_hmc._leapfrog(jvg, jnp.asarray(z[c]), jnp.asarray(r[c]),
                              eps[c], jnp.asarray(inv_mass[c]), 7)
            for c in range(4)]
    lp = tb.make_log_posterior(X, y, "binomial", tprior, dtype=F64,
                               device="cpu")
    zt, rt, lpt, gt = t_hmc._leapfrog(
        lambda b: value_and_grad(lp, b), torch.tensor(z), torch.tensor(r),
        torch.tensor(eps), torch.tensor(inv_mass), 7)
    _close(zt, np.stack([w[0] for w in want]), 1e-12)
    _close(rt, np.stack([w[1] for w in want]), 1e-12)
    jv, jg = jax.vmap(jvg)(jnp.asarray(zt.numpy()))
    _close(lpt, jv, 1e-12)
    _close_grad(gt, jg, 1e-12)


def test_popcount_and_trailing_zeros_match_jax():
    n = jnp.arange(1024, dtype=jnp.int32)
    assert [t_nuts._popcount(i) for i in range(1024)] == \
        np.asarray(jax_nuts._popcount(n)).tolist()
    assert [t_nuts._tz(i) for i in range(1024)] == \
        np.asarray(jax_nuts._tz(n)).tolist()


def test_uturn_matches_jax_formula():
    """``_uturn`` against the expression of the JAX kernel's ``uturn``
    closure (mcmcglm_tpu/baselines/nuts.py:74-77), over 200 random cases
    with some exactly at the boundary."""
    rng = np.random.default_rng(4)
    s, a, b = (rng.normal(size=(200, 5)) for _ in range(3))
    m = rng.uniform(0.5, 2.0, size=(200, 5))
    a[:20] = 0.0  # dot product exactly 0: a U-turn (<= 0)

    def jax_uturn(sum_r, r_first, r_last, inv_mass):
        return (jnp.dot(sum_r, inv_mass * r_first) <= 0) | (
            jnp.dot(sum_r, inv_mass * r_last) <= 0)

    want = jax.vmap(jax_uturn)(*(jnp.asarray(v) for v in (s, a, b, m)))
    got = t_nuts._uturn(*(torch.tensor(v) for v in (s, a, b, m)))
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert got[:20].all() and 0 < int(got.sum()) < 200


def test_advi_step_and_adam_path_match_jax(logistic):
    """50 steps driven by the same numpy normals on both sides: the -ELBO
    gradient at the start, the ELBO trace (a function of the parameter
    path) and the final parameters, float64 rtol 1e-9."""
    X, y, jprior, tprior = logistic
    S, d, lr = 8, 3, 0.05
    eps = np.random.default_rng(5).normal(size=(50, S, d))
    jlp = jax_ld.make_log_posterior(X, y, "binomial", jprior,
                                    dtype=jnp.float64)

    def neg_elbo(params, e):  # mcmcglm_tpu/baselines/advi.py:54-60
        z = params["m"] + e * jnp.exp(params["log_s"])
        return -(jnp.mean(jax.vmap(jlp)(z)) + jnp.sum(params["log_s"]))

    params = {"m": jnp.zeros(d), "log_s": jnp.full((d,), -1.0)}
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    grad_fn = jax.value_and_grad(neg_elbo)
    elbo = []
    for e in eps:
        loss, g = grad_fn(params, jnp.asarray(e))
        if not elbo:
            g0 = g
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        elbo.append(-float(loss))

    lp = tb.make_log_posterior(X, y, "binomial", tprior, dtype=F64,
                               device="cpu")
    m = torch.zeros(d, dtype=F64, requires_grad=True)
    log_s = torch.full((d,), -1.0, dtype=F64, requires_grad=True)
    t_advi._neg_elbo(lp, m, log_s, torch.tensor(eps[0])).backward()
    _close_grad(m.grad, g0["m"], 1e-9)
    _close_grad(log_s.grad, g0["log_s"], 1e-9)
    res = t_advi._fit(lp, torch.zeros(d, dtype=F64),
                      (torch.tensor(e) for e in eps), lr)
    _close(res.elbo_trace, elbo, 1e-9)
    _close(res.mean, params["m"], 1e-9)
    _close(res.scale, np.exp(np.asarray(params["log_s"])), 1e-9)


# -- (d) the laws of tests/test_baselines.py --------------------------------

@pytest.fixture(scope="module")
def gaussian_problem():
    rng = np.random.default_rng(0)
    n, d = 500, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, -0.5, 0.8, 0.2])
    y = rng.normal(X @ beta, 1.0)
    prec = X.T @ X + np.eye(d)
    cov = np.linalg.inv(prec)
    mu = cov @ (X.T @ y)
    return X, y, mu, cov


@pytest.fixture(scope="module")
def gaussian_logpost(gaussian_problem):
    X, y, _, _ = gaussian_problem
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), X.shape[1])
    return tb.make_log_posterior(X, y, "gaussian", prior, extra={"sd": 1.0},
                                 dtype=F64, device="cpu")


def test_hmc_gaussian_posterior(gaussian_problem, gaussian_logpost):
    X, y, mu, cov = gaussian_problem
    d = X.shape[1]
    res = tb.hmc_sample(0, gaussian_logpost, torch.zeros((4, d), dtype=F64),
                        n_warmup=400, n_samples=400, num_leapfrog=16,
                        device="cpu")
    assert res.samples.shape == (4, 400, d) and res.samples.dtype == F64
    draws = res.samples.numpy().reshape(-1, d)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(draws.mean(0), mu, atol=float(5 * sd.max() / 20))
    np.testing.assert_allclose(draws.std(0), sd, rtol=0.3)
    assert float(res.accept_rate.mean()) > 0.5


def test_nuts_gaussian_posterior(gaussian_problem, gaussian_logpost):
    X, y, mu, cov = gaussian_problem
    d = X.shape[1]
    res = tb.nuts_sample(1, gaussian_logpost, torch.zeros((4, d), dtype=F64),
                         n_warmup=400, n_samples=400, max_depth=8,
                         device="cpu")
    draws = res.samples.numpy().reshape(-1, d)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(draws.mean(0), mu, atol=float(5 * sd.max() / 20))
    np.testing.assert_allclose(draws.std(0), sd, rtol=0.3)
    assert float(res.accept_rate.mean()) > 0.5
    # trees should actually grow (not immediate U-turns)
    assert float(res.mean_depth.mean()) >= 1.0
    assert (res.mean_leaves >= res.mean_depth).all() and res.flag_reads > 0


def test_advi_gaussian_posterior(gaussian_problem, gaussian_logpost):
    X, y, mu, cov = gaussian_problem
    d = X.shape[1]
    res = tb.advi_fit(0, gaussian_logpost, torch.zeros(d, dtype=F64),
                      n_steps=3000, mc_samples=8, learning_rate=0.05,
                      device="cpu")
    np.testing.assert_allclose(res.mean.numpy(), mu, atol=0.05)
    # mean-field underestimates correlated variances; check scale order
    np.testing.assert_allclose(res.scale.numpy(), np.sqrt(np.diag(cov)),
                               rtol=0.6)
    elbo = res.elbo_trace.numpy()
    assert elbo.shape == (3000,)
    assert elbo[-100:].mean() > elbo[:100].mean()


def test_advi_sample_shape(gaussian_logpost):
    res = tb.advi_fit(0, gaussian_logpost, torch.zeros(4, dtype=F64),
                      n_steps=200, device="cpu")
    s = res.sample(1, 64)
    assert s.shape == (64, 4) and s.dtype == F64
    assert torch.equal(s, res.sample(1, 64))


def test_ess_gaussian_posterior(gaussian_problem):
    X, y, mu, cov = gaussian_problem
    d = X.shape[1]
    eng = tb.EllipticalSliceGLM(X, y, "gaussian",
                                mt.IIDPrior(mt.Normal(0.0, 1.0), d),
                                extra={"sd": 1.0}, device="cpu")
    betas, nev, _ = eng.sample(0, 4000, n_chains=8)
    post = betas[:, 1500:, :].reshape(-1, d)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(post.mean(0), mu, atol=float(6 * sd.max() / 30))
    np.testing.assert_allclose(post.std(0), sd, rtol=0.25)
    assert float(np.asarray(nev).mean()) < 20


def test_ess_mvn_prior():
    rng = np.random.default_rng(5)
    n, d = 40, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    y = rng.normal(X @ [0.5, -0.2, 0.3], 2.0)
    cov0 = np.array([[1.0, 0.4, 0.0], [0.4, 1.0, 0.0], [0.0, 0.0, 2.0]])
    eng = tb.EllipticalSliceGLM(X, y, "gaussian", mt.MVNPrior(np.zeros(3), cov0),
                                extra={"sd": 2.0}, device="cpu")
    betas, _, _ = eng.sample(1, 3000, n_chains=8)
    post = betas[:, 500:, :].reshape(-1, d)
    prec = X.T @ X / 4 + np.linalg.inv(cov0)
    mu = np.linalg.solve(prec, X.T @ y / 4)
    sd = np.sqrt(np.diag(np.linalg.inv(prec)))
    np.testing.assert_allclose(post.mean(0), mu, atol=float(6 * sd.max() / 30))


@pytest.fixture(scope="module")
def port_nuts_logistic(logistic):
    X, y, _, tprior = logistic
    lp = tb.make_log_posterior(X, y, "binomial", tprior, dtype=F64,
                               device="cpu")
    res = tb.nuts_sample(3, lp, torch.zeros((4, 3), dtype=F64),
                         n_warmup=300, n_samples=300, device="cpu")
    return res.samples.numpy().reshape(-1, 3)


def test_nuts_matches_cggibbs_logistic(logistic, port_nuts_logistic):
    X, y, _, tprior = logistic
    eng = mt.CGGibbs(X, y, "binomial", tprior, tuning={"w": 0.8},
                     device="cpu")
    g, _, _ = eng.sample(0, 400, n_chains=4)
    gibbs = g[:, 101:, :].reshape(-1, 3)
    nuts = port_nuts_logistic
    np.testing.assert_allclose(gibbs.mean(0), nuts.mean(0), atol=0.08)
    np.testing.assert_allclose(gibbs.std(0), nuts.std(0), rtol=0.3)


def test_nuts_matches_jax_nuts_logistic(logistic, port_nuts_logistic):
    """The port's NUTS against the JAX ``nuts_sample`` on the same
    logistic problem, under the tolerances the JAX test holds NUTS to
    against CGGibbs."""
    X, y, jprior, _ = logistic
    logpost = jax_ld.make_log_posterior(X, y, "binomial", jprior,
                                        dtype=jnp.float64)
    res = jax_nuts.nuts_sample(jax.random.key(3), logpost,
                               jnp.zeros((4, 3), jnp.float64),
                               n_warmup=300, n_samples=300)
    want = np.asarray(res.samples).reshape(-1, 3)
    got = port_nuts_logistic
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.08)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.3)


# -- (e) chain c bitwise at any C and block length --------------------------

@pytest.fixture(scope="module")
def small_logistic():
    X, y, _ = mt.generate_glm_data("binomial", n=200, d=3, seed=1)
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), 3)
    return X, y, prior, tb.make_log_posterior(X, y, "binomial", prior,
                                               device="cpu")


def _inits(C):
    return torch.tensor(np.random.default_rng(6).normal(size=(5, 3)) * 0.3,
                        dtype=torch.float32)[:C]


def test_hmc_chains_independent_of_batch(small_logistic):
    lp = small_logistic[3]
    a, b = (tb.hmc_sample(2, lp, _inits(C), n_warmup=20, n_samples=20,
                          num_leapfrog=6, device="cpu") for C in (3, 5))
    for x, y in zip(a, b):
        assert torch.equal(x, y[:3])


def test_nuts_chains_independent_of_batch_and_block(small_logistic,
                                                   monkeypatch):
    lp = small_logistic[3]
    runs = []
    for C, B in ((3, 1), (5, 1), (3, 4), (5, 4)):
        monkeypatch.setattr(t_nuts, "_block_iters", B)
        runs.append(tb.nuts_sample(2, lp, _inits(C), n_warmup=20,
                                   n_samples=20, max_depth=5, device="cpu"))
    for r in runs[1:]:
        for x, y in zip(runs[0][:6], r[:6]):
            assert torch.equal(x, y[:3])
    assert runs[0].flag_reads > runs[2].flag_reads


def test_ess_chains_independent_of_batch_and_block(small_logistic):
    X, y, prior, _ = small_logistic
    out = []
    for C, B in ((3, 1), (5, 1), (3, 4), (5, 4)):
        eng = tb.EllipticalSliceGLM(X, y, "binomial", prior, device="cpu")
        eng._block_iters = B
        st, betas, nev = eng.run(eng.init(4, C), 30)
        out.append((st.beta[:3], st.eta[:3], betas[:3], nev[:3]))
    for o in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], o))


# -- (f) the converters -----------------------------------------------------

def test_convert_ess_state(small_logistic):
    X, y, prior, _ = small_logistic
    jeng = jax_ess.EllipticalSliceGLM(X, y, "binomial",
                                      mg.IIDPrior(mg.Normal(0.0, 1.0), 3))
    jst, _, _ = jeng.run(jeng.init(jax.random.key(0), 4), 3)
    eng = tb.EllipticalSliceGLM(X, y, "binomial", prior, device="cpu")
    st = mt.convert_ess_state(jst, eng, seed=9)
    np.testing.assert_array_equal(st.beta.numpy(), np.asarray(jst.beta))
    np.testing.assert_array_equal(st.eta.numpy(), np.asarray(jst.eta))
    assert st.step == 0 and st.key.tolist() == [9, 0]
    st2, betas, nev = eng.run(st, 5)
    assert torch.isfinite(betas).all() and st2.step == 5
    assert ((nev >= 1) & (nev <= eng.max_shrink)).all()


def test_convert_advi_result(logistic):
    X, y, jprior, _ = logistic
    jlp = jax_ld.make_log_posterior(X, y, "binomial", jprior,
                                    dtype=jnp.float64)
    jres = jax_advi.advi_fit(jax.random.key(0), jlp, jnp.zeros(3), n_steps=20)
    res = mt.convert_advi_result(jres, device="cpu")
    assert isinstance(res, tb.ADVIResult)
    for a, b in zip(res, jres):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert res.sample(0, 10).shape == (10, 3)


# -- (g) errors and devices -------------------------------------------------

def test_ess_requires_gaussian_prior():
    X = np.ones((10, 2))
    with pytest.raises(ValueError, match="gaussian prior"):
        tb.EllipticalSliceGLM(X, np.zeros(10), "gaussian",
                              mt.IIDPrior(mt.Laplace(0, 1), 2), device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           small_logistic):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, prior, lp = small_logistic
    calls = [
        lambda: tb.make_log_posterior(X, y, "binomial", prior),
        lambda: tb.hmc_sample(0, lp, np.zeros((2, 3))),
        lambda: tb.nuts_sample(0, lp, np.zeros((2, 3))),
        lambda: tb.advi_fit(0, lp, np.zeros(3)),
        lambda: tb.EllipticalSliceGLM(X, y, "binomial", prior),
        lambda: tb.HyperrectSliceGLM(X, y, "binomial", prior),
        lambda: tb.LatentSliceGLM(X, y, "binomial", prior),
        lambda: tb.QuantileSliceGLM(X, y, "binomial", prior),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- the profiling helpers --------------------------------------------------

def test_time_block_and_trace(tmp_path):
    from mcmcglm_tpu_torch.utils.profiling import Timer, time_block, trace

    x = torch.ones(100)
    with time_block(sync=[x, {"a": x}]) as t:
        y = (x * 2).sum()
    assert isinstance(t, Timer) and t.seconds > 0 and float(y) == 200.0
    with trace(str(tmp_path / "prof")) as prof:
        (x + 1).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
