"""The port's sampler in law against the JAX engine: evaluation counts per
coordinate (spec_k=1 against spec_k=4, tests/test_freerun_spec.py:51),
the binomial posterior (tests/test_freerun_spec.py:69) and the adapted
quantile kernel's evaluation rate.  The generators differ, so these
compare distributions, never draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402

ADAPTED = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 5.0}


def test_spec_eval_count_matches_classic_in_law():
    """nev counts algorithmic evaluations; their per-coordinate mean must
    agree between spec_k=1 and spec_k=4 (same kernel, same law)."""
    d = 8
    X, y, _ = mt.generate_glm_data("binomial", n=600, d=d, seed=0)
    rates = []
    for K in (1, 4):
        eng = mt.FreeRunCGGibbs(
            X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), d),
            tuning={"w": 0.5}, spec_k=K, device="cpu",
        )
        st = eng.init(0, 16)
        st, _, _ = eng.warmup(st, 40)
        nev0 = st.nev.numpy().copy()
        st, _, nev = eng.run(st, 150)
        rates.append((nev.numpy()[:, -1] - nev0).mean() / (150 * d))
    assert abs(rates[0] - rates[1]) / rates[0] < 0.05


def test_binomial_posterior_matches_jax_engine():
    """The port's spec_k=4 sampler and the JAX package's, on the same
    problem: agreeing posterior means and spreads, and evaluation rates."""
    d = 6
    X, y, _ = mg.generate_glm_data("binomial", n=500, d=d, seed=3)
    fj = JaxFreeRun(X, y, "binomial", mg.IIDPrior(mg.Normal(0.0, 1.0), d),
                    tuning={"w": 0.5}, spec_k=4)
    bj, nev_j, _ = fj.sample(jax.random.key(2), 500, n_chains=8)
    ft = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0),
                                                         d),
                           tuning={"w": 0.5}, spec_k=4, device="cpu")
    bt, nev_t, _ = ft.sample(2, 500, n_chains=8)
    pj, pt = bj[:, 150:, :].reshape(-1, d), bt[:, 150:, :].reshape(-1, d)
    assert np.abs(pj.mean(0) - pt.mean(0)).max() < 0.05
    assert np.abs(pj.std(0) / pt.std(0) - 1.0).max() < 0.15
    assert abs(nev_j.mean() / nev_t.mean() - 1.0) < 0.06


def test_adapted_quantile_matches_jax_eval_rate():
    """Evaluations per sweep of the adapted quantile kernel agree with the
    JAX engine's on the same problem (a law check of the adaptation)."""
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    et = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                           extra={"sd": 1.0}, slice_kernel="quantile",
                           tuning=ADAPTED, spec_k=4, device="cpu")
    st = et.init(0, 8)
    st, _, _ = et.warmup(st, 50)
    nev0 = st.nev.numpy().copy()
    st, _, _ = et.run(st, 200)
    nev_t = (st.nev.numpy() - nev0).mean() / 200
    ej = JaxFreeRun(X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), d),
                    extra={"sd": 1.0}, slice_kernel="quantile",
                    tuning=ADAPTED, spec_k=4)
    s = ej.init(jax.random.key(0), 8)
    s, _, _ = ej.warmup(s, 50)
    nev0 = np.asarray(s.nev).copy()
    s, _, _ = ej.run(s, 200)
    nev_j = (np.asarray(s.nev) - nev0).mean() / 200
    assert abs(nev_t / nev_j - 1.0) < 0.1, (nev_t, nev_j)
