"""x_storage="bf16" in the port: the mirror of TestBf16XStorage
(tests/test_freerun_spec.py:483-548).  The design is rounded to bfloat16
once, up front, and every path computes on the rounded values, so the
engine samples the posterior of X' = bf16(X) exactly: the posterior shift
against float32 storage is far below the posterior sd, and eta tracks X'
beta, not X beta.  On the card the cuda3 kernel streams the rows as
bfloat16 (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402


def _problem(n=600, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta_true = rng.normal(size=d) * 0.5
    y = rng.binomial(1, 1.0 / (1.0 + np.exp(-X @ beta_true))).astype(float)
    return X, y


def _engine(X, y, x_storage):
    return mt.FreeRunCGGibbs(
        X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), X.shape[1]),
        tuning={"w": 0.5}, spec_k=4, x_storage=x_storage, device="cpu",
    )


def test_posterior_shift_below_sd():
    X, y = _problem()
    posts = []
    for x_storage in ("f32", "bf16"):
        fr = _engine(X, y, x_storage)
        st = fr.init(3, 16)
        st, _, _ = fr.warmup(st, 30)
        st, draws, _ = fr.run(st, 200)
        posts.append(draws.numpy()[:, 40:, :].reshape(-1, X.shape[1]))
    p32, p16 = posts
    # the X' perturbation is ~2^-9 relative; the posterior shift it causes
    # must drown in the posterior spread
    assert (np.abs(p16.mean(0) - p32.mean(0)) / p32.std(0)).max() < 0.2


def test_eta_consistent_with_rounded_design():
    X, y = _problem()
    fr = _engine(X, y, "bf16")
    # the rounding is the JAX package's (round to nearest even)
    Xr = np.asarray(jnp.asarray(X.astype(np.float32)).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    np.testing.assert_array_equal(fr.Xt.numpy(), Xr.T)
    assert fr._Xt_rows is fr.Xt  # the bf16 row copy is the cuda3 kernel's
    st = fr.init(0, 8)
    st, _, _ = fr.run(st, 3)
    eta, beta = st.eta.numpy(), st.beta.numpy()
    # eta tracks the ROUNDED design (f32 accumulation of incremental
    # updates), not the original X
    assert np.abs(eta - beta @ Xr.T).max() < 5e-4
    assert np.abs(eta - beta @ X.T).max() > 1e-3


def test_gather_battery_plain_version_takes_bf16_rows():
    X, y = _problem(n=300, d=5)
    fr = _engine(X, y, "bf16")
    rng = np.random.default_rng(1)
    C, K = 8, 4
    f32 = torch.float32
    eta = torch.tensor(rng.normal(scale=0.5, size=(C, fr.n)), dtype=f32)
    j = torch.tensor(rng.integers(0, fr.d, C), dtype=torch.int32)
    deltas = torch.tensor(rng.normal(scale=0.3, size=(C, K)), dtype=f32)
    fprior = torch.zeros(C, K)
    scal = torch.stack([torch.full((C,), -1.0), torch.zeros(C),
                        torch.ones(C), torch.full((C,), float(K))], 1)
    args = (eta, deltas, fprior, scal, fr.y, fr._mask, fr.family, {})
    got = fb.battery_gather_commit(j, fr.Xt.to(torch.bfloat16), *args)
    want = fb.battery_gather_commit(j, fr.Xt, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bad_x_storage_raises():
    X, y = _problem(n=200, d=4)
    with pytest.raises(ValueError, match="x_storage"):
        _engine(X, y, "fp8")
