"""The port's tuning-parameter sweep (``sweep.py``) and update-against-
naive timing (``perf.py``), as tests/test_sweep_perf.py drives the JAX
package's, on the CPU (``device="cpu"``): the batched sweep against the
sequential one in schema and in law, the fallbacks, the timing rows and
their schema with and without worker processes; and every new entry point
raising without CUDA unless it is given ``device="cpu"``."""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.perf import eta_comptime_rows_across_nvars  # noqa: E402


@pytest.fixture(scope="module")
def dat_norm():
    rng = np.random.default_rng(1)
    n = 200
    x1 = rng.normal(size=n)
    x2 = rng.binomial(1, 0.5, n).astype(float)
    y = rng.normal(1.0 + 1.5 * x1 + 2.0 * x2, 1.0)
    return pd.DataFrame({"Y": y, "X1": x1, "X2": x2})


def test_sequential_sweep(dat_norm):
    fits = mt.mcmcglm_across_tuningparams(
        [0.5, 2.0], tuning_parameter_name="w", formula="Y ~ .",
        family="gaussian", data=dat_norm, n_samples=60, burnin=20, seed=0,
        device="cpu")
    assert len(fits) == 2 and fits.tuning_parameter_name == "w"
    assert fits[0].tuning["w"] == 0.5 and fits[1].tuning["w"] == 2.0
    for f in fits:
        np.testing.assert_allclose(f.coef().values, [1.0, 1.5, 2.0], atol=0.6)


def test_batched_sweep_matches_sequential(dat_norm):
    """parallelise=True: one lockstep run, the values along the chain
    axis; the same fields, shapes and columns as the sequential fits and
    posterior means within 4 combined MCSE of theirs."""
    common = dict(formula="Y ~ .", family="gaussian", data=dat_norm,
                  n_samples=200, burnin=50, n_chains=4, seed=0, device="cpu")
    seq = mt.mcmcglm_across_tuningparams([0.5, 1.5], "w", **common)
    par = mt.mcmcglm_across_tuningparams([0.5, 1.5], "w", parallelise=True,
                                         **common)
    assert len(par) == 2 and par.tuning_parameter_name == "w"
    assert par[0].sampler is par[1].sampler  # one batched engine
    assert isinstance(par[0].sampler, mt.CGGibbs)
    for fs, fp in zip(seq, par):
        assert fp.beta.shape == fs.beta.shape == (4, 201, 3)
        assert fp.columns == fs.columns and fp.burnin == fs.burnin
        assert fp.slice_kernel == fs.slice_kernel == "stepping_out"
        assert fp.tuning == fs.tuning
        assert list(fp.coef().index) == list(fs.coef().index)
        _assert_means_agree(fs.post_burnin(), fp.post_burnin())


def _assert_means_agree(a, b):
    """Posterior means of (chains, draws, d) draws within 4 combined MCSE."""
    d = a.shape[-1]
    se = np.sqrt(a.reshape(-1, d).var(0) / mt.ess(a)
                 + b.reshape(-1, d).var(0) / mt.ess(b))
    diff = np.abs(a.reshape(-1, d).mean(0) - b.reshape(-1, d).mean(0))
    assert (diff < 4 * se).all(), (diff, se)


def test_batched_sweep_matches_jax(dat_norm):
    """parallelise=True against the JAX package's batched sweep on the same
    data, values, chains and seed: the same schema, and each value's
    posterior means within 4 combined MCSE."""
    common = dict(formula="Y ~ .", family="gaussian", data=dat_norm,
                  n_samples=200, burnin=50, n_chains=4, seed=0)
    ref = mg.mcmcglm_across_tuningparams([0.5, 1.5], "w", parallelise=True,
                                         **common)
    par = mt.mcmcglm_across_tuningparams([0.5, 1.5], "w", parallelise=True,
                                         device="cpu", **common)
    assert len(par) == len(ref) == 2
    assert par.tuning_parameter_name == ref.tuning_parameter_name == "w"
    for fr, fp in zip(ref, par):
        assert fp.beta.shape == fr.beta.shape == (4, 201, 3)
        assert fp.columns == list(fr.columns) and fp.burnin == fr.burnin
        assert fp.slice_kernel == fr.slice_kernel
        assert fp.tuning == dict(fr.tuning)
        assert list(fp.coef().index) == list(fr.coef().index)
        _assert_means_agree(np.asarray(fr.post_burnin()), fp.post_burnin())


def test_batched_sweep_unsupported_opts_fall_back(dat_norm):
    with pytest.warns(UserWarning, match="adapt_w.*falling back"):
        fits = mt.mcmcglm_across_tuningparams(
            [0.5, 2.0], "w", parallelise=True, formula="Y ~ .",
            family="gaussian", data=dat_norm, n_samples=40, burnin=10,
            adapt_w=True, device="cpu")
    assert len(fits) == 2
    for f in fits:
        np.testing.assert_allclose(f.coef().values, [1.0, 1.5, 2.0], atol=0.7)


def test_batched_sweep_threads_offset_and_intercept(dat_norm):
    """offset() terms and add_intercept reach the batched engine."""
    dat = dat_norm.copy()
    dat["off"] = 3.0  # a known constant shift of eta
    par = mt.mcmcglm_across_tuningparams(
        [0.5, 1.5], "w", parallelise=True,
        formula="Y ~ X1 + X2 + offset(off)", family="gaussian", data=dat,
        n_samples=150, burnin=50, n_chains=2, seed=0, device="cpu")
    # with eta = offset + Xb the intercept centers near 1 - 3 = -2
    assert par[0].coef().values[0] < -1.0
    X = np.column_stack([dat_norm["X1"], dat_norm["X2"]])
    par = mt.mcmcglm_across_tuningparams(
        [0.5, 1.5], "w", parallelise=True, X=X, y=np.asarray(dat_norm["Y"]),
        family="gaussian", add_intercept=True, n_samples=150, burnin=50,
        n_chains=2, seed=0, device="cpu")
    for f in par:
        assert f.beta.shape == (2, 151, 3) and f.columns[0] == "(Intercept)"
        np.testing.assert_allclose(f.coef().values, [1.0, 1.5, 2.0], atol=0.3)


def test_sweep_other_param_and_plot(dat_norm):
    fits = mt.mcmcglm_across_tuningparams(
        [2.0, 50.0], tuning_parameter_name="df", formula="Y ~ .",
        family="gaussian", data=dat_norm, slice_fn="genelliptical", mu=1.0,
        sigma=2.0, n_samples=40, burnin=10, device="cpu")
    assert fits[0].tuning["df"] == 2.0 and fits[0].tuning["mu"] == 1.0
    par = mt.mcmcglm_across_tuningparams(
        [2.0, 50.0], tuning_parameter_name="df", parallelise=True,
        formula="Y ~ .", family="gaussian", data=dat_norm,
        slice_fn="genelliptical", mu=1.0, sigma=2.0, n_samples=40, burnin=10,
        device="cpu")
    assert par[1].tuning == {"mu": 1.0, "sigma": 2.0, "df": 50.0}
    assert np.isfinite(par[1].beta).all()
    fig = mt.plot_mcmcglm_across_tuningparams(fits)
    assert len(fig.axes) >= 2


def test_compare_across_nvars_and_plot():
    df = mt.compare_eta_comptime_across_nvars(n_vars=[2, 5], n=50,
                                              n_samples=6, burnin=0,
                                              device="cpu")
    # the JAX package's columns, its parallelised flag last, with the
    # port's three before the flag
    want = mg.compare_eta_comptime_across_nvars(n_vars=[2], n=30,
                                                n_samples=1, burnin=0)
    assert list(df.columns) == list(want.columns[:-1]) + [
        "device", "evals_per_sweep", "flag_reads_per_sweep", "parallelised"]
    for col in ("linear_predictor_calc", "n_vars", "n_obs", "n_samples",
                "n_chains", "beta_mean", "beta_variance", "family",
                "slice_fn", "w", "sd"):
        assert list(df[col][:2]) == [want[col][0], want[col][1]] or \
            col in ("n_obs", "n_samples"), col
    assert set(df.linear_predictor_calc) == {"update", "naive"}
    assert sorted(df.n_vars.unique()) == [2, 5]
    assert (df.time > 0).all() and (df.w == 0.5).all()
    assert (df.device == "cpu").all() and not df.parallelised.any()
    # one random stream: the naive rows evaluate as the update rows do
    for d in (2, 5):
        sub = df[df.n_vars == d].set_index("linear_predictor_calc")
        assert sub.evals_per_sweep["update"] == sub.evals_per_sweep["naive"]
    fig = mt.plot_eta_comptime(df)
    assert fig.axes


def test_parallelise_matches_sequential_schema():
    """Spawned CPU workers give the rows of the sequential path (the same
    draws: one seed, one counter-based stream), flagged parallelised."""
    kw = dict(n_vars=[2, 4], n=40, n_samples=3, burnin=0, device="cpu")
    seq = eta_comptime_rows_across_nvars(**kw)
    par = eta_comptime_rows_across_nvars(parallelise=True, n_cores=2, **kw)
    assert [list(r) for r in par] == [list(r) for r in seq]
    assert all(r["parallelised"] for r in par)
    assert not any(r["parallelised"] for r in seq)
    for a, b in zip(seq, par):
        assert (a["n_vars"], a["linear_predictor_calc"]) == (
            b["n_vars"], b["linear_predictor_calc"])
        assert a["evals_per_sweep"] == b["evals_per_sweep"]
        assert b["time"] > 0 and b["device"] == "cpu"


@pytest.mark.parametrize("cuda_available", [True, False])
def test_parallelise_needs_device_cpu(monkeypatch, cuda_available):
    """The worker processes run on the CPU, so the card is never swapped
    for it silently: parallelise=True asks for device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda_available)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="device='cpu'"):
            mt.compare_eta_comptime_across_nvars([2], n=20, n_samples=1,
                                                 parallelise=True,
                                                 device=device)


def test_new_entry_points_need_cuda_or_cpu(monkeypatch, dat_norm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = np.asarray(dat_norm[["X1", "X2"]]), np.asarray(dat_norm["Y"])
    calls = [
        lambda: mt.compare_eta_comptime("Y ~ .", dat_norm, w=0.5),
        lambda: mt.compare_eta_comptime_across_nvars([2], n=20, n_samples=1),
        lambda: mt.mcmcglm_across_tuningparams([0.5], "w", X=X, y=y),
        lambda: mt.mcmcglm_across_tuningparams([0.5], "w", X=X, y=y,
                                               parallelise=True),
        lambda: mt.mcmcglm(X=X, y=y, w=0.5, engine="xla"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.CGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(), 2),
                   tuning={"w": 0.5}, device="cuda")
    rows = mt.compare_eta_comptime("Y ~ .", dat_norm, n_samples=2, w=0.5,
                                   device="cpu")
    assert list(rows.linear_predictor_calc) == ["update", "naive"]
