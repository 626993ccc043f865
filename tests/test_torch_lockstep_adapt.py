"""The port's lockstep engine: adaptive warmup (tests/test_adapt.py),
observation weights (tests/test_weights.py), thinned collection and the
``mcmcglm`` routes that reach it, against the JAX package's engine in law
(means within 4 Monte Carlo standard errors) and against closed forms."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402


def _mcse(draws):
    return draws.reshape(-1, draws.shape[-1]).std(0) / np.sqrt(mt.ess(draws))


def _agree(a, b, what):
    """(C, S, d) draws a and b: means within 4 combined MCSE."""
    ma, mb = a.reshape(-1, a.shape[-1]).mean(0), b.reshape(-1, b.shape[-1]).mean(0)
    lim = 4 * np.sqrt(_mcse(a) ** 2 + _mcse(b) ** 2)
    assert (np.abs(ma - mb) < lim).all(), (what, ma, mb, lim)


@pytest.fixture(scope="module")
def readme():
    rng = np.random.default_rng(42)
    n = 300
    X = np.column_stack([np.ones(n), rng.normal(size=n),
                         rng.binomial(1, 0.5, size=n)])
    y = rng.normal(X @ np.array([1.0, 1.5, 2.0]), 1.0)
    return X, y, np.linalg.solve(X.T @ X + np.eye(3), X.T @ y)


@pytest.fixture(scope="module")
def logistic():
    X, y, _ = mg.generate_glm_data("binomial", n=300, d=5, seed=0)
    return X, y


def _binomial(X, y, w, **kw):
    return mt.CGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), 5),
                      tuning={"w": w}, device="cpu", **kw)


def test_bad_w_recovers(logistic):
    """From a pathologically small w the adapted evaluation count is within
    50% of the well-tuned count."""
    X, y = logistic
    good = _binomial(X, y, 0.5)
    sg, _, _ = good.run(good.init(0, 8), 20)
    sg, _, n_good = good.run(sg, 20)
    bad = _binomial(X, y, 0.005)
    sb, _, _ = bad.warmup(bad.init(0, 8), 40)
    sb, _, n_adapted = bad.run(sb, 20)
    assert float(n_adapted.double().mean()) < 1.5 * float(n_good.double().mean())


def test_adapted_posterior_matches_jax(logistic):
    """Frozen adapted widths sample the posterior of the JAX engine's
    adapted run."""
    X, y = logistic
    eng = _binomial(X, y, 0.5)
    st, _, _ = eng.warmup(eng.init(0, 8), 40)
    st, bt, _ = eng.run(st, 150)
    jeng = mg.CGGibbs(X, y, "binomial", mg.IIDPrior(mg.Normal(0, 1), 5),
                      tuning={"w": 0.5})
    sj = jeng.init(jax.random.key(0), 8)
    sj, _, _ = jeng.warmup(sj, 40)
    sj, bj, _ = jeng.run(sj, 150)
    _agree(bt.numpy(), np.asarray(bj), "adapted widths")


def test_widths_stay_frozen_and_mode_flip(logistic):
    """After warmup the log widths stay as warmup left them while sampling
    (the JAX engine writes the kernel's zero state over them after the
    first sampling sweep: ROADMAP, deliberate divergences); the adapted
    mode is a property of the state too, so run() refuses a state from the
    other side of the flip, and reset_adaptation() returns a fresh state to
    a never-adapted engine's draws."""
    X, y = logistic
    eng = _binomial(X, y, 0.5)
    s0 = eng.init(1, 4)
    assert not s0.adapted and bool((s0.kernel_state == 0).all())
    st, _, _ = eng.warmup(s0, 10)
    assert eng._w_adapted and st.adapted
    logw = st.kernel_state.clone()
    assert bool((logw != float(np.log(np.float32(0.5)))).all())
    st2, _, _ = eng.run(st, 3)
    assert torch.equal(st2.kernel_state, logw)
    with pytest.raises(ValueError, match="no adapted widths"):
        eng.run(s0, 1)
    eng.reset_adaptation()
    assert not eng._w_adapted
    with pytest.raises(ValueError, match="engine was reset"):
        eng.run(st2, 1)
    _, b, nev = eng.run(eng.init(7, 4), 3)
    fresh = _binomial(X, y, 0.5)
    _, bf, nevf = fresh.run(fresh.init(7, 4), 3)
    assert torch.equal(b, bf) and torch.equal(nev, nevf)


def test_warmup_of_other_kernels_is_a_run(logistic):
    X, y = logistic
    eng = mt.CGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), 5),
                     config=mt.EngineConfig(slice_kernel="elliptical"),
                     tuning={"mu": 0.0, "sigma": 2.0}, device="cpu")
    st = eng.init(0, 4)
    sw, bw, _ = eng.warmup(st, 3)
    sr, br, _ = eng.run(st, 3)
    assert not eng._w_adapted and not sw.adapted
    assert torch.equal(bw, br) and bool(torch.isfinite(bw).all())


def test_weight_equals_duplication():
    rng = np.random.default_rng(0)
    n = 200
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = rng.normal(X @ [1.0, -0.5], 1.0)
    prior = mt.IIDPrior(mt.Normal(0, 1), 2)
    bw, _, _ = mt.CGGibbs(X, y, "gaussian", prior, extra={"sd": 1.0},
                          tuning={"w": 0.5}, obs_weights=np.full(n, 2.0),
                          device="cpu").sample(0, 250, n_chains=8)
    bd, _, _ = mt.CGGibbs(np.vstack([X, X]), np.concatenate([y, y]),
                          "gaussian", prior, extra={"sd": 1.0},
                          tuning={"w": 0.5}, device="cpu").sample(
        1, 250, n_chains=8)
    _agree(bw[:, 51:], bd[:, 51:], "weight 2 against duplicated data")
    np.testing.assert_allclose(bw[:, 51:].reshape(-1, 2).std(0),
                               bd[:, 51:].reshape(-1, 2).std(0), rtol=0.25)


def test_weighted_against_jax_and_closed_form():
    """The weighted conjugate oracle against the weighted closed form, and
    the weighted slice sampler through mcmcglm(engine="xla") against the
    JAX package's."""
    rng = np.random.default_rng(1)
    n = 300
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = rng.normal(X @ [0.5, 1.0], 1.0)
    w = rng.uniform(0.5, 3.0, n)
    eng = mt.CGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), 2),
                     extra={"sd": 1.0}, obs_weights=w, device="cpu",
                     config=mt.EngineConfig(sample_method="normal-normal"))
    b, _, _ = eng.sample(0, 600, n_chains=4)
    post = b[:, 101:]
    prec = (X * w[:, None]).T @ X + np.eye(2)
    mu = np.linalg.solve(prec, X.T @ (w * y))
    assert (np.abs(post.reshape(-1, 2).mean(0) - mu) < 4 * _mcse(post)).all()
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", weights=w, w=0.5,
                     engine="xla", n_samples=200, burnin=50, n_chains=8,
                     device="cpu")
    jfit = mg.mcmcglm(X=X, y=y, family="gaussian", weights=w, w=0.5,
                      engine="xla", n_samples=200, burnin=50, n_chains=8)
    _agree(fit.post_burnin(), jfit.post_burnin(), "weighted mcmcglm")
    _agree(fit.post_burnin(), post, "weighted slice against the oracle")


def test_run_thinned(readme):
    """run_thinned keeps every thin-th draw of run() bitwise, sums the
    evaluations of each block, and streams per-chain moments of every
    sweep."""
    X, y, _ = readme
    eng = mt.CGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), 3),
                     extra={"sd": 1.0}, tuning={"w": 0.5}, device="cpu")
    s0 = eng.init(2, 4)
    st, mom, draws, nev = eng.run_thinned(s0, 4, 3)
    sr, all_draws, all_nev = eng.run(s0, 12)
    assert torch.equal(draws, all_draws[:, 2::3])
    assert torch.equal(nev, all_nev.reshape(4, 4, 3).sum(-1))
    assert torch.equal(st.beta, sr.beta) and st.sweep == 12
    a = all_draws.double().numpy()
    np.testing.assert_array_equal(mom.count.numpy(), 12.0)
    np.testing.assert_allclose(mom.mean.numpy(), a.mean(1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mom.m2.numpy(), ((a - a.mean(1, keepdims=True))
                                                ** 2).sum(1), rtol=1e-4,
                               atol=1e-6)


def test_mcmcglm_xla_matches_jax(readme):
    X, y, _ = readme
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="xla",
                     n_samples=200, burnin=50, n_chains=8, chunk_size=60,
                     device="cpu")
    assert isinstance(fit.sampler, mt.CGGibbs)
    assert fit.slice_kernel == "stepping_out" and fit.n_evals.shape == (8, 200)
    jfit = mg.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="xla",
                      n_samples=200, burnin=50, n_chains=8)
    _agree(fit.post_burnin(), jfit.post_burnin(), "mcmcglm(engine='xla')")


def test_mcmcglm_custom_kernel_thin_and_adapt(readme):
    """A registered kernel the free-running engine does not serve goes to
    the lockstep engine (qslice_fun), as do thin > 1 and adapt_w there."""
    X, y, mu = readme

    def my_slice(rng, x0, log_target, w, fx0=None, state=None):
        return mt.slice_stepping_out(rng, x0, log_target, w, fx0=fx0)

    k = mt.register_slice_kernel(mt.SliceKernel("my_slice", my_slice, ("w",)))
    try:
        fit = mt.mcmcglm(X=X, y=y, family="gaussian", qslice_fun=k, w=0.5,
                         n_samples=100, burnin=30, n_chains=4, device="cpu")
        assert isinstance(fit.sampler, mt.CGGibbs)
        assert fit.slice_kernel == "my_slice"
        np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0),
                                   mu, atol=0.1)
        with pytest.raises(ValueError, match="engine='freerun' requires"):
            mt.mcmcglm(X=X, y=y, family="gaussian", qslice_fun="my_slice",
                       w=0.5, engine="freerun", device="cpu")
    finally:
        del mt.SLICE_KERNELS["my_slice"]
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="xla",
                     thin=3, n_samples=110, burnin=20, n_chains=4,
                     device="cpu")
    assert fit.beta.shape == (4, 31, 3) and fit.burnin == 0
    assert fit.n_evals.shape == (4, 30)
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.1, engine="xla",
                     adapt_w=True, n_samples=100, burnin=30, n_chains=4,
                     device="cpu")
    assert fit.sampler._w_adapted and fit.state.adapted
    assert fit.beta.shape == (4, 101, 3) and fit.n_evals.shape == (4, 100)
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0), mu,
                               atol=0.1)
