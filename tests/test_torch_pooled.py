"""The port's pooled streaming diagnostics (``parallel/pooled.py``)
against the JAX package's on the same numpy draws, against the host ESS
(the mirror of tests/test_pooled.py and tests/test_streaming_ess.py), and
``run_thinned`` with the on-device ESS."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu.parallel.pooled as jpool  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
import mcmcglm_tpu_torch.parallel.pooled as tpool  # noqa: E402
from mcmcglm_tpu_torch.diagnostics import ess as ess_host  # noqa: E402

F64 = torch.float64


def _ar1_draws(C, K, d, rho=0.5, seed=0):
    """AR(1) chains with known autocorrelation, plus a per-parameter
    offset."""
    rng = np.random.default_rng(seed)
    x = np.zeros((C, K, d))
    x[:, 0] = rng.normal(size=(C, d))
    innov = rng.normal(size=(C, K, d)) * np.sqrt(1 - rho ** 2)
    for t in range(1, K):
        x[:, t] = rho * x[:, t - 1] + innov[:, t]
    return x + rng.normal(size=(1, 1, d))


def _stream_torch(draws, max_lag=64, dtype=F64):
    C, K, d = draws.shape
    st = tpool.init_ess(C, d, planned=K, max_lag=max_lag, dtype=dtype,
                        device="cpu")
    for t in range(K):
        st = tpool.update_ess(st, torch.tensor(draws[:, t], dtype=dtype))
    return st


def _stream_jax(draws, max_lag=64):
    C, K, d = draws.shape
    st = jpool.init_ess(C, d, planned=K, max_lag=max_lag, dtype=jnp.float64)
    up = jax.jit(jpool.update_ess)
    for t in range(K):
        st = up(st, jnp.asarray(draws[:, t], jnp.float64))
    return st


@pytest.mark.parametrize("per_chain", [False, True])
def test_moments_and_pooled_summary_match_jax(per_chain):
    rng = np.random.default_rng(0)
    draws = rng.normal(size=(60, 6, 3))  # (K, C, d)
    draws[:, 0, :] += 3.0  # one far-away chain: R-hat above 1
    mt_m = tpool.init_moments(6, 3, F64, device="cpu")
    mj = jpool.init_moments(6, 3, jnp.float64)
    for k in range(60):
        mt_m = tpool.update_moments(mt_m, torch.tensor(draws[k]))
        mj = jpool.update_moments(mj, jnp.asarray(draws[k]))
    np.testing.assert_allclose(mt_m.mean.numpy(), draws.mean(0), rtol=1e-12)
    np.testing.assert_allclose(mt_m.m2.numpy() / 59.0, draws.var(0, ddof=1),
                               rtol=1e-12)
    if per_chain:  # the free-running engine's (C,) counts
        mt_m = mt_m._replace(count=mt_m.count.expand(6).clone())
        mj = mj._replace(count=jnp.broadcast_to(mj.count, (6,)))
    got, want = tpool.pooled_summary(mt_m), jpool.pooled_summary(mj)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-12, err_msg=k)
    assert (got["rhat"].numpy() > 1.5).all()


@pytest.mark.parametrize("K,max_lag", [(200, 64), (201, 64), (40, 64),
                                       (400, 32)])
def test_streaming_ess_matches_jax(K, max_lag):
    """The streamed accumulator and its ESS equal the JAX package's on the
    same draws (float64, arithmetic order aside); odd K skips the middle
    draw, K=40 clamps the window, rho=0.995 truncates inside it."""
    rho = 0.995 if max_lag == 32 else 0.5
    draws = _ar1_draws(C=4, K=K, d=3, rho=rho, seed=K)
    st_t, st_j = _stream_torch(draws, max_lag), _stream_jax(draws, max_lag)
    for name in ("s", "ring", "first", "total"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   rtol=1e-12, atol=1e-9, err_msg=name)
    assert int(st_t.count) == int(st_j.count) == K
    got = tpool.ess_from_state(st_t).numpy()
    np.testing.assert_allclose(got, np.asarray(jpool.ess_from_state(st_j)),
                               rtol=1e-9)
    assert np.isfinite(got).all() and (got > 0).all()


@pytest.mark.parametrize("K,d,rho,seed,rtol", [(200, 3, 0.5, 0, 0.02),
                                               (201, 3, 0.5, 0, 0.02),
                                               (40, 2, 0.3, 5, 0.07)])
def test_streaming_ess_matches_host_ess(K, d, rho, seed, rtol):
    """The JAX tests' cases and agreement with the host FFT estimator: 2%
    for the long chains, 7% where the window clamps to 20 lags."""
    draws = _ar1_draws(C=4, K=K, d=d, rho=rho, seed=seed)
    st = _stream_torch(draws)
    if K == 40:
        assert st.s.shape[2] == 20
    np.testing.assert_allclose(tpool.ess_from_state(st).numpy(),
                               ess_host(draws), rtol=rtol)


def test_streaming_ess_float32_within_5pct():
    draws = _ar1_draws(C=8, K=300, d=4, rho=0.6, seed=1)
    st = _stream_torch(draws, dtype=torch.float32)
    np.testing.assert_allclose(tpool.ess_from_state(st).numpy(),
                               ess_host(draws), rtol=0.05)


@pytest.mark.parametrize("K", [120, 121])
def test_ess_device_matches_jax_and_host(K):
    draws = _ar1_draws(C=4, K=K, d=3, rho=0.4, seed=2)
    got = tpool.ess_device(torch.tensor(draws)).numpy()
    want = np.asarray(jpool.ess_device(jnp.asarray(draws)))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(got, ess_host(draws), rtol=0.02)


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    return mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                             extra={"sd": 1.0}, tuning={"w": 0.5}, spec_k=4,
                             device="cpu")


def test_run_thinned_ess_stream(engine):
    """The mirror of tests/test_streaming_ess.py:117: the streamed ESS of
    the kept draws against the host ESS of the same draws."""
    st = engine.init(0, 8)
    st, _, _ = engine.warmup(st, 50)
    st, mom, kept, nev, es = engine.run_thinned(st, 120, 2, ess=True)
    assert kept.shape == (8, 120, 4) and int(es.count) == 120
    np.testing.assert_allclose(tpool.ess_from_state(es).numpy(),
                               ess_host(kept.numpy()), rtol=0.05)
    assert torch.equal(nev, st.nev)


def test_run_thinned_is_a_loop_of_runs(engine):
    """run_thinned(n_outer, thin) advances exactly as n_outer run(thin)
    calls; its kept draws are their last sweeps and its moments the
    Welford moments of all their sweeps."""
    st0 = engine.init(3, 6)
    st1, mom, kept, _ = engine.run_thinned(st0, 10, 3)
    st2, blocks = st0, []
    for _ in range(10):
        st2, draws, _ = engine.run(st2, 3)
        blocks.append(draws)
    full = torch.cat(blocks, 1).double().numpy()  # (C, 30, d)
    for name, a, b in zip(st1._fields, st1, st2):
        assert torch.equal(a, b), name
    assert torch.equal(kept, torch.stack([b[:, -1] for b in blocks], 1))
    np.testing.assert_array_equal(mom.count.numpy(), np.full(6, 30.0))
    np.testing.assert_allclose(mom.mean.numpy(), full.mean(1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mom.m2.numpy() / 29.0, full.var(1, ddof=1),
                               rtol=1e-4, atol=1e-7)
    summary = tpool.pooled_summary(mom)
    assert np.isfinite(summary["rhat"].numpy()).all()
