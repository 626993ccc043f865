"""The port's proposal batteries against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version, which is
held here against ``build_battery`` / ``build_battery2`` /
``build_battery3`` run through a JAX ``FreeRunCGGibbs(battery_impl=
"pallas*")`` in interpret mode, at C=16, n=500 (padded to 512 on the JAX
side), K=4.  Tolerances: lsum rtol 2e-5 / atol 2e-3 (the reduction order
differs), eta_new atol 1e-5.  The CUDA kernels themselves are held against
the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402

C, N, K, D = 16, 500, 4, 8
LSUM_TOL = dict(rtol=2e-5, atol=2e-3)


def _problem(family, seed=1):
    X, y, _ = mg.generate_glm_data(family, n=N, d=D, seed=seed)
    extra = {"sd": 1.3} if family == "gaussian" else {}
    return X, y, extra


def _operands(eng_t, seed=0):
    """Random battery operands (numpy f32) with a real mix of decisions:
    ld0 is the sum at the current eta, so f is O(1) against the level."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    eta = (0.5 * rng.normal(size=(C, N))).astype(f32)
    j = rng.integers(0, D, C).astype(np.int32)
    deltas = (0.3 * rng.normal(size=(C, K))).astype(f32)
    xg = eng_t.Xt.numpy()[j]
    ld0 = fb.battery_sums(
        torch.from_numpy(eta), torch.from_numpy(xg), torch.zeros(C, 1),
        eng_t.y, eng_t._mask, eng_t.family, eng_t._extra_host,
    )[:, 0].numpy()
    fprior = (0.5 * rng.normal(size=(C, K))).astype(f32)
    level = np.log1p(-rng.uniform(size=C)).astype(f32)
    gate = (rng.uniform(size=C) < 0.8).astype(f32)
    rem = rng.integers(0, K + 1, C).astype(f32)
    scal = np.stack([level, ld0, gate, rem], 1).astype(f32)
    return dict(eta=eta, j=j, xg=xg, deltas=deltas, fprior=fprior,
                scal=scal)


def _engines(family, impl):
    X, y, extra = _problem(family)
    prior_j = mg.IIDPrior(mg.Normal(0, 1), D)
    ej = JaxFreeRun(X, y, family, prior_j, extra=extra, tuning={"w": 0.5},
                    spec_k=K, eval_cache="scalar", battery_impl=impl)
    et = mt.FreeRunCGGibbs(X, y, family, mt.IIDPrior(mt.Normal(0, 1), D),
                           extra=extra, tuning={"w": 0.5}, spec_k=K,
                           eval_cache="scalar", device="cpu")
    return ej, et


def _pad(a, n_pad):
    return np.pad(a, ((0, 0), (0, n_pad - a.shape[1])))


def _replay(lsum, a):
    t = torch.tensor  # copies: lsum may be a read-only view of a JAX array
    return fb.replay_delta_star(t(lsum), t(a["deltas"]), t(a["fprior"]),
                                t(a["scal"])).numpy()


def _f(lsum, a):
    return (lsum - a["scal"][:, 1:2]) + a["fprior"]


def _assert_decisions_agree(lsum_t, lsum_j, a):
    """The decisions replayed from the two lsums agree, except on lanes
    whose f sits within the lsum tolerance of the slice level."""
    d_t, d_j = _replay(lsum_t, a), _replay(lsum_j, a)
    differ = d_t != d_j
    near = (np.abs(_f(lsum_j, a) - a["scal"][:, :1])
            <= LSUM_TOL["atol"] + LSUM_TOL["rtol"] * np.abs(lsum_j)).any(1)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    # the operands exercise both outcomes
    assert 0 < (d_t != 0).sum() < C
    return d_t


@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_battery_sums_matches_pallas(family):
    ej, et = _engines(family, "pallas")
    a = _operands(et)
    n_pad = int(ej.Xt.shape[1])
    assert n_pad == 512
    lsum_j = np.asarray(ej._battery_fn(C)(
        jnp.asarray(_pad(a["eta"], n_pad)),
        jnp.take(ej.Xt, jnp.asarray(a["j"]), axis=0),
        jnp.asarray(a["deltas"]),
    ))
    lsum_t = fb.battery_sums(
        torch.from_numpy(a["eta"]), torch.from_numpy(a["xg"]),
        torch.from_numpy(a["deltas"]), et.y, et._mask, et.family,
        et._extra_host,
    ).numpy()
    np.testing.assert_allclose(lsum_t, lsum_j, **LSUM_TOL)
    _assert_decisions_agree(lsum_t, lsum_j, a)


@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_battery_commit_matches_pallas2(family):
    ej, et = _engines(family, "pallas2")
    a = _operands(et)
    n_pad = int(ej.Xt.shape[1])
    lsum_j, eta_j = ej._battery2_fn(C)(
        jnp.asarray(_pad(a["eta"], n_pad)),
        jnp.take(ej.Xt, jnp.asarray(a["j"]), axis=0),
        jnp.asarray(a["deltas"]), jnp.asarray(a["fprior"]),
        jnp.asarray(a["scal"]),
    )
    lsum_j, eta_j = np.asarray(lsum_j), np.asarray(eta_j)[:, :N]
    t = torch.from_numpy
    lsum_t, eta_t = fb.battery_commit(
        t(a["eta"]), t(a["xg"]), t(a["deltas"]), t(a["fprior"]),
        t(a["scal"]), et.y, et._mask, et.family, et._extra_host,
    )
    np.testing.assert_allclose(lsum_t.numpy(), lsum_j, **LSUM_TOL)
    np.testing.assert_allclose(eta_t.numpy(), eta_j, rtol=0, atol=1e-5)
    d_t = _assert_decisions_agree(lsum_t.numpy(), lsum_j, a)
    # the commit is the replayed decision, exactly
    np.testing.assert_array_equal(eta_t.numpy(),
                                  a["eta"] + a["xg"] * d_t[:, None])


@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_battery_gather_commit_matches_pallas3(family):
    ej, et = _engines(family, "pallas3")
    a = _operands(et)
    S, L = ej._eta3
    lsum_j, eta_j = ej._battery3_fn(C)(
        jnp.asarray(a["j"]),
        jnp.asarray(_pad(a["eta"], S * L).reshape(C, S, L)),
        jnp.asarray(a["deltas"]), jnp.asarray(a["fprior"]),
        jnp.asarray(a["scal"]),
    )
    lsum_j = np.asarray(lsum_j)
    eta_j = np.asarray(eta_j).reshape(C, S * L)[:, :N]
    t = torch.from_numpy
    lsum_t, eta_t = fb.battery_gather_commit(
        t(a["j"]), et.Xt, t(a["eta"]), t(a["deltas"]), t(a["fprior"]),
        t(a["scal"]), et.y, et._mask, et.family, et._extra_host,
    )
    np.testing.assert_allclose(lsum_t.numpy(), lsum_j, **LSUM_TOL)
    np.testing.assert_allclose(eta_t.numpy(), eta_j, rtol=0, atol=1e-5)
    _assert_decisions_agree(lsum_t.numpy(), lsum_j, a)


def test_masked_sum_drops_non_finite_zero_weight_terms():
    t = torch.tensor([[1.0, float("nan"), 2.0], [float("inf"), 1.0, 1.0]])
    m = torch.tensor([1.0, 0.0, 2.0])
    np.testing.assert_allclose(fb.masked_sum(t, m).numpy(),
                               [5.0, float("inf")])


def test_first_acceptor_is_the_lowest_valid_index():
    f = torch.tensor([[0.0, 2.0, 3.0], [1.0, 1.0, -5.0], [-9.0, -9.0, -9.0],
                      [5.0, 5.0, 5.0]])
    level = torch.tensor([1.0, 0.0, 0.0, 0.0])
    rem = torch.tensor([3, 3, 3, 0])
    any_acc, idx = fb.first_acceptor(f, level, rem)
    assert any_acc.tolist() == [True, True, False, False]
    assert idx.tolist()[:2] == [1, 0]


def test_wrappers_never_run_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU reaches the kernel path, which
    refuses anything but CUDA; it never falls back to the plain battery."""
    fam = mt.check_family("binomial")
    meta = dict(device="meta", dtype=torch.float32)
    eta = torch.empty(4, 10, **meta)
    args = (eta, torch.empty(4, 10, **meta), torch.empty(4, 2, **meta),
            torch.empty(10, **meta), torch.empty(10, **meta))
    before = dict(fb.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        fb.battery_sums(*args, fam, {})
    with pytest.raises(ValueError, match="CUDA"):
        fb.battery_commit(*args[:3], torch.empty(4, 2, **meta),
                          torch.empty(4, 4, **meta), *args[3:], fam, {})
    assert fb.launch_counts == before


def _stub(device, family="binomial", **kw):
    fam = mt.check_family(family)
    base = dict(family=fam, extra={}, spec_k=4, eval_cache="scalar",
                dtype=torch.float32, device=torch.device(device))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_auto_picks_cuda3_for_a_cuda_device_and_a_table_pair():
    eng = _stub("cuda")
    fb.configure_battery(eng, "auto", user_reduce_fn=False)
    assert eng.battery_impl == "cuda3"
    assert eng._kernel_family == (1, 0.0)


@pytest.mark.parametrize("stub_kw,why", [
    (dict(device="cpu"), "not CUDA"),
    (dict(device="cuda", family="inverse_gaussian"), "KERNEL_FAMILIES"),
    (dict(device="cuda", spec_k=1), "spec_k=1"),
    (dict(device="cuda", eval_cache="per_obs"), "eval_cache"),
])
def test_auto_picks_torch_and_says_why(stub_kw, why):
    eng = _stub(**stub_kw)
    fb.configure_battery(eng, "auto", user_reduce_fn=False)
    assert eng.battery_impl == "torch"
    assert why in eng.battery_reason


@pytest.mark.parametrize("impl", ["cuda", "cuda2", "cuda3"])
def test_explicit_kernel_request_that_cannot_be_served_raises(impl):
    with pytest.raises(ValueError, match="not CUDA"):
        fb.configure_battery(_stub("cpu"), impl, user_reduce_fn=False)
    with pytest.raises(ValueError, match="KERNEL_FAMILIES"):
        fb.configure_battery(_stub("cuda", family="inverse_gaussian"), impl,
                             user_reduce_fn=False)


def test_battery_impl_validation():
    with pytest.raises(ValueError, match="battery_impl"):
        fb.configure_battery(_stub("cpu"), "pallas3", user_reduce_fn=False)


def test_kernel_table_pairs_all_have_relative_densities():
    """Every pair in the kernel table is a built-in family/link whose
    relative log density the plain battery evaluates (the CUDA kernel's
    version of each is checked against it on the card)."""
    for (name, link), (fid, pname, _) in fb.KERNEL_FAMILIES.items():
        fam = mt.check_family(name).with_link(link)
        assert link in fam._eta_rel_paths or fam.log_density_rel is not None
        assert pname is None or isinstance(pname, str)
    ids = [v[0] for v in fb.KERNEL_FAMILIES.values()]
    assert sorted(ids) == list(range(len(ids)))


def test_jax_backend_is_cpu():
    assert jax.default_backend() == "cpu"
