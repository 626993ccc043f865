"""The port imports without JAX and without triton, names what it has
not ported yet instead of silently doing something else, and runs what it
once named as unported."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402


def test_import_loads_neither_jax_nor_triton():
    code = (
        "import sys, mcmcglm_tpu_torch, mcmcglm_tpu_torch.ops.freerun_passes, "
        "mcmcglm_tpu_torch.ops._build, mcmcglm_tpu_torch.convert, "
        "mcmcglm_tpu_torch.ops.fused_cggibbs, mcmcglm_tpu_torch.fused, "
        "mcmcglm_tpu_torch.engine, mcmcglm_tpu_torch.perf, "
        "mcmcglm_tpu_torch.sweep; "
        # the GPU machine has no pandas: the port imports it lazily only
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'mcmcglm_tpu', 'pandas', "
        "'matplotlib')]; "
        "print(','.join(bad)); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


def _problem(n=50, d=3):
    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    return X, rng.normal(size=n)


@pytest.mark.parametrize("kw,item", [
    (dict(slice_kernel="latent"), "item 7"),
    (dict(slice_kernel="doubling"), "item 7"),
    (dict(coord_sampler="conjugate"), "item 7"),
    (dict(slice_kernel="elliptical"), "item 7"),
])
def test_engine_names_unported_options(kw, item):
    """The engine options that ROADMAP queue 1 named under ``item`` as
    unported have landed: each builds and completes two sweeps on the
    CPU, with finite draws."""
    X, y = _problem()
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(), 3),
                            tuning={"w": 0.5, "sigma": 1.0}, device="cpu",
                            **kw)
    st, draws, _ = eng.run(eng.init(0, 4), 2)
    assert draws.shape == (4, 2, 3) and bool(torch.isfinite(draws).all())
    assert bool((st.nev > 0).all())


def _one_rank_mesh():
    """A (1, 1) mesh on a world of one "gloo" process (this process)."""
    from mcmcglm_tpu_torch.parallel import distributed

    distributed.initialize(device_type="cpu")
    return mt.make_mesh(device_type="cpu")


# the options that once raised naming ROADMAP item 9 run the lockstep engine
_LOCKSTEP = {"engine": "xla", "sample_method": "normal-normal",
             "linear_predictor_calc": "naive"}


@pytest.mark.parametrize("kw", [
    dict(engine="xla"), dict(slice_fn="doubling"), dict(thin=2),
    dict(sample_method="normal-normal"), dict(slice_fn="elliptical"),
    dict(linear_predictor_calc="naive"), dict(mesh="a mesh"),
])
def test_api_names_unported_options(kw):
    """Every option listed here once raised and runs now; ``mesh`` (ROADMAP
    item 10) on a one-rank CPU mesh fits through ShardedFreeRunCGGibbs."""
    X, y = _problem()
    (name, value), = kw.items()
    if name == "mesh":
        fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, n_samples=8,
                         burnin=2, device="cpu", mesh=_one_rank_mesh())
        assert isinstance(fit.sampler, mt.ShardedFreeRunCGGibbs)
        assert np.isfinite(fit.beta).all() and fit.beta.shape == (1, 9, 3)
        return
    lockstep = _LOCKSTEP.get(name) == value
    # the lockstep kernels take exactly their own tuning, as in the JAX
    # package; the free-running engine ignores what it does not read
    tuning = {"w": 0.5} if lockstep else {"w": 0.5, "sigma": 1.0}
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", n_samples=8, burnin=2,
                     device="cpu", **tuning, **kw)
    assert np.isfinite(fit.beta).all() and fit.beta.shape[::2] == (1, 3)
    assert isinstance(fit.sampler, mt.CGGibbs) == lockstep


def test_engine_requires_an_explicit_device():
    X, y = _problem()
    with pytest.raises(TypeError, match="device"):
        mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(), 3),
                          tuning={"w": 0.5})


def test_mcmcglm_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5)


def test_results_methods_not_ported_raise():
    """predict, waic, loo and trace_plot are ported now (ROADMAP queue 1,
    item 6): each runs on a small fit; so does ``mesh`` (item 10), on a
    one-rank CPU mesh."""
    X, y = _problem()
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, n_samples=6,
                     burnin=2, device="cpu")
    assert fit.predict().shape == (fit.n_chains * 4, X.shape[0])
    for name in ("waic", "loo"):
        assert all(np.isfinite(v) for v in getattr(fit, name)().values())
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    plt.close(fit.trace_plot())
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, n_samples=6,
                     burnin=2, mesh=_one_rank_mesh(), device="cpu")
    assert isinstance(fit.sampler, mt.ShardedFreeRunCGGibbs)
    assert fit.predict().shape == (fit.n_chains * 4, X.shape[0])
