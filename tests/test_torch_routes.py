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


# -- the free-running pass's route (ops/freerun_automaton.configure_pass) ---

Q_ADAPT = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}


class _UserDist(mt.Normal):
    """A distribution the kernels do not know (a subclass is not its
    parent in KERNEL_PRIORS)."""


class _UserPrior(mt.IIDPrior):
    """An IIDPrior whose density the user may have redefined."""


# id -> (engine keywords, battery request, on a CUDA device object, hook,
# pass_impl, a phrase of its reason).  The benchmark's free-running cells
# and every prior of KERNEL_PRIORS resolve to "cuda"; each condition of
# the rule that fails sends its configuration to "torch".
ROUTE_CASES = {
    "cell-logistic-p1000-quantile": (
        dict(family="binomial", slice_kernel="quantile", tuning=Q_ADAPT,
             spec_k=4), "auto", True, None, "cuda", "IID Normal"),
    "cell-logistic-quantile-bf16-rows": (
        dict(family="binomial", slice_kernel="quantile", tuning=Q_ADAPT,
             spec_k=4, x_storage="bf16"), "auto", True, None, "cuda",
        "'cuda3'"),
    "cell-poisson-laplace-stepping-out": (
        dict(family="poisson", dist=mt.Laplace(0.0, 1.0),
             tuning={"w": 0.3}, spec_k=4), "auto", True, None, "cuda",
        "IID Laplace"),
    "battery-cuda2-k32": (
        dict(tuning={"w": 0.5}, spec_k=32), "cuda2", True, None, "cuda",
        "'cuda2'"),
    "prior-gamma": (dict(dist=mt.Gamma(2.0, 1.0), tuning={"w": 0.5},
                         spec_k=2), "auto", True, None, "cuda", "Gamma"),
    "prior-exponential": (dict(dist=mt.Exponential(1.0), tuning={"w": 0.5},
                               spec_k=4), "auto", True, None, "cuda",
                          "Exponential"),
    "prior-student-t": (dict(dist=mt.StudentT(3.0, 0.0, 1.0),
                             slice_kernel="quantile", spec_k=4), "auto",
                        True, None, "cuda", "StudentT"),
    "prior-uniform": (dict(dist=mt.Uniform(-5.0, 5.0), tuning={"w": 0.5},
                           spec_k=4), "auto", True, None, "cuda", "Uniform"),
    "cpu": (dict(tuning={"w": 0.5}, spec_k=4), "auto", False, None, "torch",
            "is not CUDA"),
    "spec-k-1": (dict(tuning={"w": 0.5}, spec_k=1), "auto", True, None,
                 "torch", "spec_k=1"),
    "battery-torch": (dict(tuning={"w": 0.5}, spec_k=4), "torch", True,
                      None, "torch", "battery_impl='torch'"),
    "battery-cuda": (dict(tuning={"w": 0.5}, spec_k=4), "cuda", True, None,
                     "torch", "battery_impl='cuda'"),
    "latent": (dict(slice_kernel="latent", spec_k=4), "auto", True, None,
               "torch", "slice_kernel='latent'"),
    "elliptical": (dict(slice_kernel="elliptical", tuning={"sigma": 2.0},
                        spec_k=4), "auto", True, None, "torch",
                   "slice_kernel='elliptical'"),
    "genelliptical": (dict(slice_kernel="genelliptical",
                           tuning={"sigma": 2.0, "df": 5.0}, spec_k=4),
                      "auto", True, None, "torch",
                      "slice_kernel='genelliptical'"),
    "doubling": (dict(slice_kernel="doubling", tuning={"w": 0.5}), "auto",
                 True, None, "torch", "slice_kernel='doubling'"),
    "conjugate": (dict(coord_sampler="conjugate"), "auto", True, None,
                  "torch", "coord_sampler='conjugate'"),
    "mvn-prior": (dict(prior="mvn", tuning={"w": 0.5}, spec_k=4), "auto",
                  True, None, "torch", "MVNPrior"),
    "stacked-prior": (dict(prior="stacked", tuning={"w": 0.5}, spec_k=4),
                      "auto", True, None, "torch", "StackedPrior"),
    "user-distribution": (dict(dist=_UserDist(), tuning={"w": 0.5},
                               spec_k=4), "auto", True, None, "torch",
                          "not in KERNEL_PRIORS"),
    "iidprior-subclass": (dict(prior="subclass", tuning={"w": 0.5},
                               spec_k=4), "auto", True, None, "torch",
                          "_UserPrior"),
    "user-reduce-fn": (dict(tuning={"w": 0.5}, spec_k=4,
                            reduce_fn=lambda t: t.sum(-1)), "auto", True,
                       None, "torch", "battery_impl='torch'"),
    "obs-shard-combine-sums": (
        dict(tuning={"w": 0.5}, spec_k=4), "cuda", True,
        lambda eng: setattr(eng, "combine_sums", lambda t: t), "torch",
        "combine_sums"),
}


def _routed(data, kw, battery, on_cuda, hook):
    """An engine built on the CPU, then (``on_cuda``) given a CUDA device
    object and its battery and pass resolved as on the card: both rules
    read only the engine's attributes, so no card is needed."""
    from mcmcglm_tpu_torch.ops.freerun_automaton import configure_pass
    from mcmcglm_tpu_torch.ops.freerun_batteries import configure_battery

    kw = dict(kw)
    fam = kw.pop("family", "gaussian")
    dist = kw.pop("dist", mt.Normal(0.0, 1.0))
    prior = kw.pop("prior", None)
    if fam == "gaussian":
        X, y, _ = data
        extra = {"sd": 1.0}
    else:
        X, y, _ = mt.generate_glm_data(fam, n=300, d=3, seed=0)
        extra = None
    d = X.shape[1]
    prior = (mt.MVNPrior(np.zeros(d), np.eye(d)) if prior == "mvn"
             else mt.StackedPrior([dist] * d) if prior == "stacked"
             else _UserPrior(dist, d) if prior == "subclass"
             else mt.IIDPrior(dist, d))
    eng = mt.FreeRunCGGibbs(X, y, fam, prior, extra=extra, device="cpu",
                            **kw)
    if on_cuda:
        eng.device = torch.device("cuda")
        configure_battery(eng, battery, user_reduce_fn="reduce_fn" in kw)
    if hook is not None:
        hook(eng)
    configure_pass(eng)
    return eng


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_pass_impl_rule(data, case):
    kw, battery, on_cuda, hook, want, why = ROUTE_CASES[case]
    eng = _routed(data, kw, battery, on_cuda, hook)
    assert eng.pass_impl == want, eng.pass_impl_reason
    assert why in eng.pass_impl_reason


def test_cpu_engines_keep_the_torch_pass(data):
    """Construction records the route: on the CPU every engine runs the
    PyTorch pass, which the tests hold against the JAX package."""
    X, y, _ = data
    for kernel, tuning in (("stepping_out", {"w": 0.5}),
                           ("quantile", Q_ADAPT)):
        eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(),
                                                              3),
                                extra={"sd": 1.0}, tuning=tuning,
                                slice_kernel=kernel, spec_k=4, device="cpu")
        assert eng.pass_impl == "torch"
        assert "is not CUDA" in eng.pass_impl_reason
