"""The port's proposal batteries against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version, which is
held here against ``build_battery`` / ``build_battery2`` /
``build_battery3`` run through a JAX ``FreeRunCGGibbs(battery_impl=
"pallas*")`` in interpret mode, at C=16, n=500 (padded to 512 on the JAX
side, where the padded slots have y = 1 and eta = 0, so linkinv(0) = inf
under the inverse and 1/mu^2 links), K=4, for binomial/logit,
gaussian/identity and the fifteen pairs of the kernels' composed route.
Tolerances: lsum rtol 2e-5 / atol 2e-3 (the reduction order differs),
eta_new atol 1e-5.  The CUDA kernels themselves are held against the same
plain versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.freerun import FreeRunCGGibbs as JaxFreeRun  # noqa: E402
from mcmcglm_tpu_torch.datagen import (  # noqa: E402
    domain_data,
    eta_sign,
    example_extra,
    family_response,
)
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402

C, N, K, D = 16, 500, 4, 8
LSUM_TOL = dict(rtol=2e-5, atol=2e-3)

# the fifteen pairs of the kernels' composed route: (family, link) -> extra
COMPOSED = {p: example_extra(p) for p in fb.COMPOSED_PAIRS}
# the families the Pallas tests run: the two with a data generator by
# name, and the composed pairs as "family/link"
FAMILIES = ["binomial", "gaussian"] + [f"{f}/{l}" for f, l in COMPOSED]

# a family the user registers (for this module's tests only): no kernel
# can serve it
USER_FAMILY = "user_gaussian"


@pytest.fixture(autouse=True, scope="module")
def _user_family():
    from mcmcglm_tpu_torch.models.families import FAMILIES

    mt.register_family(
        USER_FAMILY,
        lambda: dataclasses.replace(mt.gaussian(), name=USER_FAMILY))
    yield
    del FAMILIES[USER_FAMILY]


def _pair(family):
    return tuple(family.split("/", 1)) if "/" in family else None


def _problem(family, seed=1):
    pair = _pair(family)
    if pair is None:
        X, y, _ = mg.generate_glm_data(family, n=N, d=D, seed=seed)
        extra = {"sd": 1.3} if family == "gaussian" else {}
        return X, y, extra, family
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)) / np.sqrt(D)
    return X, family_response(pair[0], N, rng), COMPOSED[pair], pair[0]


def _operands(eng_t, seed=0):
    """Random battery operands (numpy f32) with a real mix of decisions:
    ld0 is the sum at the current eta, so f is O(1) against the level.
    For a pair whose mean needs a sign of eta, eta lies in [1, 1.5] (or
    its negative) and the moves are small enough to stay there."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    eta = (0.5 * rng.normal(size=(C, N))).astype(f32)
    j = rng.integers(0, D, C).astype(np.int32)
    deltas = (0.3 * rng.normal(size=(C, K))).astype(f32)
    sign = eta_sign(eng_t.family)
    if (eng_t.family.name, eng_t.family.link.name) in COMPOSED and sign:
        eta = (sign * (1.0 + 0.5 * rng.uniform(size=(C, N)))).astype(f32)
        deltas = (0.2 * deltas).astype(f32)
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
    X, y, extra, name = _problem(family)
    pair = _pair(family)
    fam_j = mg.check_family(name).with_link(pair[1]) if pair else family
    fam_t = mt.check_family(name).with_link(pair[1]) if pair else family
    prior_j = mg.IIDPrior(mg.Normal(0, 1), D)
    ej = JaxFreeRun(X, y, fam_j, prior_j, extra=extra, tuning={"w": 0.5},
                    spec_k=K, eval_cache="scalar", battery_impl=impl)
    et = mt.FreeRunCGGibbs(X, y, fam_t, mt.IIDPrior(mt.Normal(0, 1), D),
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


@pytest.mark.parametrize("family", FAMILIES)
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


@pytest.mark.parametrize("family", FAMILIES)
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


@pytest.mark.parametrize("family", FAMILIES)
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
                eval_cache_reason="requested", dtype=torch.float32,
                device=torch.device(device))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_auto_picks_cuda3_for_a_cuda_device_and_a_table_pair():
    eng = _stub("cuda")
    fb.configure_battery(eng, "auto", user_reduce_fn=False)
    assert eng.battery_impl == "cuda3"
    assert eng._kernel_family == fb.KernelFamily(1, 0.0, 1, 2)


@pytest.mark.parametrize("stub_kw,why", [
    (dict(device="cpu"), "not CUDA"),
    (dict(device="cuda", family=USER_FAMILY), "KERNEL_FAMILIES"),
    (dict(device="cuda", spec_k=1), "spec_k=1"),
    (dict(device="cuda", eval_cache="per_obs"), "eval_cache"),
])
def test_auto_picks_torch_and_says_why(stub_kw, why):
    eng = _stub(**stub_kw)
    with warnings.catch_warnings():  # a user family on CUDA also warns
        warnings.simplefilter("ignore", RuntimeWarning)
        fb.configure_battery(eng, "auto", user_reduce_fn=False)
    assert eng.battery_impl == "torch"
    assert why in eng.battery_reason


@pytest.mark.parametrize("impl", ["cuda", "cuda2", "cuda3"])
def test_explicit_kernel_request_that_cannot_be_served_raises(impl):
    with pytest.raises(ValueError, match="not CUDA"):
        fb.configure_battery(_stub("cpu"), impl, user_reduce_fn=False)
    with pytest.raises(ValueError, match="KERNEL_FAMILIES"):
        fb.configure_battery(_stub("cuda", family=USER_FAMILY), impl,
                             user_reduce_fn=False)


def test_battery_impl_validation():
    with pytest.raises(ValueError, match="battery_impl"):
        fb.configure_battery(_stub("cpu"), "pallas3", user_reduce_fn=False)


def test_kernel_table_pairs_all_have_relative_densities():
    """Every pair in the kernel table is a built-in family/link whose
    relative log density (or, for binomial, its log density in eta) the
    plain battery evaluates (the CUDA kernel's version of each is checked
    against it on the card).  The six pairs with a path of their own take
    template ids 0-5, every other pair the composed id 6."""
    for (name, link), (fid, rfam, rlink) in fb.KERNEL_FAMILIES.items():
        fam = mt.check_family(name).with_link(link)
        assert (link in fam._eta_rel_paths or fam.log_density_rel is not None
                or link in fam._eta_paths or name == "binomial")
        assert rfam == fb.COMPOSED_FAMILIES[name]
        assert rlink == fb.COMPOSED_LINKS[link]
    own = sorted(v[0] for v in fb.KERNEL_FAMILIES.values() if v[0] < 6)
    assert own == list(range(6))
    assert sum(v[0] == fb.FAM_COMPOSED
               for v in fb.KERNEL_FAMILIES.values()) == 15


def test_jax_backend_is_cpu():
    assert jax.default_backend() == "cpu"


BUILTIN_PAIRS = [(f, l) for f, links in fb.BUILTIN_LINKS.items()
                 for l in links]


def test_the_table_holds_the_21_builtin_pairs():
    assert len(BUILTIN_PAIRS) == 21
    assert set(fb.KERNEL_FAMILIES) == set(BUILTIN_PAIRS)
    # the fifteen without a path of their own are the composed route's
    assert len(fb.COMPOSED_PAIRS) == 15
    assert set(fb.COMPOSED_PAIRS) == set(BUILTIN_PAIRS) - set(fb.OWN_PATHS)


@pytest.mark.parametrize("pair", BUILTIN_PAIRS, ids="/".join)
def test_kernel_family_resolves_every_builtin_pair(pair):
    """The template id, the runtime ids and the family's scalar: sd,
    size, shape, inverse-gaussian's dispersion, each with its default."""
    name, link = pair
    fam = mt.check_family(name).with_link(link)
    extra = {"sd": 1.3, "size": 2.5, "shape": 4.0, "dispersion": 0.5}
    kf = fb.kernel_family(fam, extra)
    assert kf.fid == fb.OWN_PATHS.get(pair, fb.FAM_COMPOSED)
    assert (kf.rfam, kf.rlink) == (fb.COMPOSED_FAMILIES[name],
                                   fb.COMPOSED_LINKS[link])
    want = {"gaussian": 1.3, "negative.binomial": 2.5, "Gamma": 4.0,
            "inverse.gaussian": 0.5}.get(name, 0.0)
    assert kf.param == pytest.approx(want)
    default = {"binomial": 0.0, "poisson": 0.0}.get(name, 1.0)
    assert fb.kernel_family(fam, {}).param == default


def test_inverse_gaussian_shape_gives_phi():
    """phi = 1 / shape (in float32, as the plain density computes it) when
    only ``shape`` is given; ``dispersion`` wins when both are."""
    fam = mt.check_family("inverse.gaussian")
    assert fb.kernel_family(fam, {"shape": 3.0}).param == float(
        np.float32(1.0) / np.float32(3.0))
    assert fb.kernel_family(fam, {"shape": 3.0, "dispersion": 0.7}).param \
        == pytest.approx(0.7)
    # the plain density sees the same phi: scaling the dispersion by 2
    # halves every relative density
    e, y = torch.tensor([0.3, 1.1]), torch.tensor([0.5, 2.0])
    a = fam.log_density_eta_rel(e, y, {"shape": 3.0})
    b = fam.log_density_eta_rel(e, y, {"dispersion": 2.0 / 3.0})
    torch.testing.assert_close(b, 0.5 * a)


@pytest.mark.parametrize("pair", BUILTIN_PAIRS, ids="/".join)
def test_auto_picks_cuda3_for_every_builtin_pair(pair):
    eng = _stub("cuda")
    eng.family = mt.check_family(pair[0]).with_link(pair[1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a built-in pair never warns
        fb.configure_battery(eng, "auto", user_reduce_fn=False)
    assert eng.battery_impl == "cuda3", eng.battery_reason
    assert eng._kernel_family.fid == fb.KERNEL_FAMILIES[pair][0]
    # and the fused engine takes its kernels for the pair
    fused = types.SimpleNamespace(family=eng.family, extra={},
                                  prior=mt.IIDPrior(mt.Normal(), 2),
                                  device=torch.device("cuda"))
    mt.FusedCGGibbs._configure(fused)
    assert fused.impl == "cuda", fused.impl_reason


def test_user_family_warns_and_runs_plain():
    """A family the user registered has no kernel: on a CUDA device "auto"
    warns, naming the pair, and picks the plain battery, and so does the
    fused engine; the plain route runs it (here on the CPU, where it draws
    exactly what the built-in family it copies draws)."""
    eng = _stub("cuda", family=USER_FAMILY)
    with pytest.warns(RuntimeWarning, match=f"{USER_FAMILY}/identity"):
        fb.configure_battery(eng, "auto", user_reduce_fn=False)
    assert eng.battery_impl == "torch" and eng._kernel_family is None
    fused = types.SimpleNamespace(family=eng.family, extra={},
                                  prior=mt.IIDPrior(mt.Normal(), 2),
                                  device=torch.device("cuda"))
    with pytest.warns(RuntimeWarning, match=f"{USER_FAMILY}/identity"):
        mt.FusedCGGibbs._configure(fused)
    assert fused.impl == "torch" and "KERNEL_FAMILIES" in fused.impl_reason
    # no warning on the CPU, where the plain route is the only one
    X, y, extra, _ = _problem("gaussian")
    runs = []
    for family in (USER_FAMILY, "gaussian"):
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            e = mt.FreeRunCGGibbs(X, y, family, mt.IIDPrior(mt.Normal(), D),
                                  extra=extra, tuning={"w": 0.5}, spec_k=K,
                                  device="cpu")
        assert e.battery_impl == "torch"
        runs.append(e.run(e.init(0, 8), 3)[1])
    assert torch.isfinite(runs[0]).all() and torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("pair", BUILTIN_PAIRS, ids="/".join)
def test_eval_cache_auto_reads_the_roundoff_inside_the_domain(pair):
    """eval_cache="auto" estimates the scalar cache's roundoff from the
    densities at eta = 0, as the JAX package does, where the mean there
    lies inside the family's ``mean_domain``; otherwise (the inverse and 1/mu^2
    links, identity and sqrt links of a positive mean, binomial/log) at
    the intercept-only predictor g(mean y).  On data in the pair's domain
    every built-in pair then gets the scalar cache the kernels need."""
    from mcmcglm_tpu_torch.freerun import _roundoff_eta

    name, link = pair
    X, y = domain_data(pair, 400, 3, seed=0)
    fam = mt.check_family(name).with_link(link)
    extra = {"sd": 1.3, "size": 2.5, "shape": 2.0, "dispersion": 0.5}
    eng = mt.FreeRunCGGibbs(X, y, fam, mt.IIDPrior(mt.Gamma(2.0, 2.0), 3),
                            extra=extra, tuning={"w": 0.5}, spec_k=K,
                            device="cpu")
    assert eng.eval_cache == "scalar"
    eta0 = _roundoff_eta(fam, torch.tensor(y, dtype=torch.float32))
    if pair in fb.OWN_PATHS:  # the JAX package's point, unchanged
        assert eta0 == 0.0
    else:
        interior = link in ("log", "probit", "cauchit") and pair != (
            "binomial", "log")
        assert (eta0 == 0.0) == interior


def test_eval_cache_auto_keeps_eta_zero_for_a_family_without_a_domain():
    """A family that states no mean_domain (the whole line) is read at
    eta = 0, the JAX package's point, wherever the mean there is finite:
    a copy of Gamma/identity at 0, the built-in Gamma/identity (mean 0 is
    outside its domain) at g(mean y)."""
    from mcmcglm_tpu_torch.freerun import _roundoff_eta

    y = torch.tensor([0.5, 2.0])
    fam = dataclasses.replace(mt.gamma("identity"), name=USER_FAMILY,
                              mean_domain=mt.gaussian().mean_domain)
    assert _roundoff_eta(fam, y) == 0.0
    assert _roundoff_eta(mt.gamma("identity"), y) == pytest.approx(1.25)


def test_auto_per_obs_cache_warns_on_cuda():
    """Where eval_cache="auto" resolves to "per_obs" (its roundoff
    estimate reaches 0.01: Gamma/inverse of shape 2 at n=10,000), "auto"
    on a CUDA device warns that it runs the plain battery; a requested
    "per_obs" does not warn."""
    X, y = domain_data(("Gamma", "inverse"), 10_000, 2, seed=0)
    eng = mt.FreeRunCGGibbs(X, y, "Gamma", mt.IIDPrior(mt.Gamma(2.0, 2.0), 2),
                            extra={"shape": 2.0}, tuning={"w": 0.5},
                            spec_k=K, device="cpu")
    assert eng.eval_cache == "per_obs"
    assert eng.eval_cache_reason.startswith("auto: roundoff estimate")
    stub = _stub("cuda", family="Gamma", eval_cache="per_obs",
                 eval_cache_reason=eng.eval_cache_reason)
    with pytest.warns(RuntimeWarning, match="chose 'per_obs'"):
        fb.configure_battery(stub, "auto", user_reduce_fn=False)
    assert stub.battery_impl == "torch"
    stub = _stub("cuda", family="Gamma", eval_cache="per_obs")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        fb.configure_battery(stub, "auto", user_reduce_fn=False)
    assert stub.battery_impl == "torch"
