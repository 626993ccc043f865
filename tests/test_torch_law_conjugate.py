"""The port's exact conjugate coordinate draws: the mirror of
tests/test_freerun_conjugate.py:38 (recovery of the closed-form posterior
with an IID normal prior, marginal KS), :58 (a StackedPrior of normals),
:167 (exactly d evaluations per sweep), the observation weights and
offset cases, and the law against the slice sampler."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.stats as sps  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402


def _problem(n=300, d=5, sd=1.2, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ rng.normal(size=d), sd)
    return X, y, sd


def _exact_posterior(X, y, sd, m, s2):
    P = X.T @ X / sd ** 2 + np.diag(1.0 / s2)
    Sig = np.linalg.inv(P)
    return Sig @ (X.T @ y / sd ** 2 + m / s2), Sig


def _draws(X, y, sd, prior, seed, warm, sweeps, **kw):
    fr = mt.FreeRunCGGibbs(X, y, "gaussian", prior, extra={"sd": sd},
                           coord_sampler="conjugate", device="cpu", **kw)
    st = fr.init(seed, 16)
    st, _, _ = fr.warmup(st, warm)
    st, dr, _ = fr.run(st, sweeps)
    return dr.numpy().reshape(-1, X.shape[1])


def test_posterior_recovery_iid_prior():
    X, y, sd = _problem()
    d = X.shape[1]
    mu, Sig = _exact_posterior(X, y, sd, np.zeros(d), np.ones(d))
    dr = _draws(X, y, sd, mt.IIDPrior(mt.Normal(0, 1), d), 0, 50, 400)
    assert np.abs(dr.mean(0) - mu).max() < 4 * dr.std(0).max() / np.sqrt(
        dr.shape[0] / 10)
    assert np.allclose(dr.std(0), np.sqrt(np.diag(Sig)), rtol=0.05)
    for j in range(d):
        ks = sps.kstest(dr[::7, j], "norm", args=(mu[j], np.sqrt(Sig[j, j])))
        assert ks.pvalue > 1e-4, f"coord {j}: {ks}"


def test_stacked_normal_prior():
    X, y, sd = _problem(seed=1)
    locs = np.array([1.0, -0.5, 0.0, 2.0, 0.3])
    scales = np.array([0.5, 2.0, 1.0, 0.7, 3.0])
    mu, Sig = _exact_posterior(X, y, sd, locs, scales ** 2)
    prior = mt.StackedPrior([mt.Normal(m, s) for m, s in zip(locs, scales)])
    dr = _draws(X, y, sd, prior, 2, 50, 300)
    assert np.abs((dr.mean(0) - mu) / np.sqrt(np.diag(Sig))).max() < 0.12
    assert np.allclose(dr.std(0), np.sqrt(np.diag(Sig)), rtol=0.06)


def test_obs_weights():
    """Weighted likelihood; oracle: observation i repeated w_i times."""
    X, y, sd = _problem(n=80, d=3, seed=5)
    w = np.random.default_rng(6).integers(1, 4, X.shape[0]).astype(float)
    mu, Sig = _exact_posterior(np.repeat(X, w.astype(int), axis=0),
                               np.repeat(y, w.astype(int)), sd, np.zeros(3),
                               np.ones(3))
    dr = _draws(X, y, sd, mt.IIDPrior(mt.Normal(0, 1), 3), 7, 50, 300,
                obs_weights=w)
    assert np.abs((dr.mean(0) - mu) / np.sqrt(np.diag(Sig))).max() < 0.12
    assert np.allclose(dr.std(0), np.sqrt(np.diag(Sig)), rtol=0.06)


def test_offset():
    X, y, sd = _problem(n=200, d=3, seed=8)
    off = np.linspace(-1, 1, X.shape[0])
    mu, Sig = _exact_posterior(X, y - off, sd, np.zeros(3), np.ones(3))
    dr = _draws(X, y, sd, mt.IIDPrior(mt.Normal(0, 1), 3), 9, 50, 300,
                offset=off)
    assert np.abs((dr.mean(0) - mu) / np.sqrt(np.diag(Sig))).max() < 0.12


def test_matches_slice_sampler_in_law():
    X, y, sd = _problem(seed=3)
    d = X.shape[1]
    prior = mt.IIDPrior(mt.Normal(0, 1), d)
    a = _draws(X, y, sd, prior, 4, 60, 250)
    fr = mt.FreeRunCGGibbs(X, y, "gaussian", prior, extra={"sd": sd},
                           tuning={"w": 0.5}, spec_k=4, device="cpu")
    st = fr.init(4, 16)
    st, _, _ = fr.warmup(st, 60)
    st, dr, _ = fr.run(st, 250)
    b = dr.numpy().reshape(-1, d)
    for j in range(d):
        ks = sps.ks_2samp(a[::11, j], b[::11, j])
        assert ks.pvalue > 1e-4, f"coord {j}: {ks}"


def test_evals_exactly_d_per_sweep_and_chunked_run_is_bitwise():
    """Every active lane commits every pass, so a sweep is exactly d
    passes and chunked collection has no boundary tail."""
    X, y, sd = _problem(seed=12)
    d = X.shape[1]
    fr = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                           extra={"sd": sd}, coord_sampler="conjugate",
                           device="cpu")
    st = fr.init(2, 4)
    st1, dr1, _ = fr.run(st, 25)
    assert torch.equal(st1.nev, torch.full((4,), 25 * d, dtype=torch.int32))
    st2, da, _ = fr.run(st, 10)
    st2, db, _ = fr.run(st2, 15)
    assert torch.equal(dr1, torch.cat([da, db], 1))
    assert torch.equal(st1.beta, st2.beta)
