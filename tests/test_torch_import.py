"""The port imports without JAX and without triton, and names what it has
not ported yet instead of silently doing something else."""

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
        "mcmcglm_tpu_torch.ops._build, mcmcglm_tpu_torch.convert; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'mcmcglm_tpu')]; "
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
    (dict(x_storage="bf16"), "queue 2"),
])
def test_engine_names_unported_options(kw, item):
    X, y = _problem()
    with pytest.raises(NotImplementedError, match=item):
        mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(), 3),
                          tuning={"w": 0.5}, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(engine="xla"), dict(engine="fused"), dict(thin=2),
    dict(sample_method="normal-normal"), dict(slice_fn="elliptical"),
    dict(linear_predictor_calc="naive"),
])
def test_api_names_unported_options(kw):
    X, y = _problem()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, device="cpu", **kw)


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
    X, y = _problem()
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, n_samples=6,
                     burnin=2, device="cpu")
    for name in ("predict", "waic", "loo", "trace_plot"):
        with pytest.raises(NotImplementedError, match="item 6"):
            getattr(fit, name)()
