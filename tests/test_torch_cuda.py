"""The CUDA kernels (batteries and fused coordinate updates), the engines
and the free-running engine's CUDA-graph pass loop on the card.

Every test here needs a CUDA GPU and skips elsewhere.  On the card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not have; this file imports neither JAX nor the JAX package).
``python3 chip_smoke.py`` runs the same checks at the main path's shapes.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import (  # noqa: E402
    domain_data,
    eta_sign,
    example_extra,
)
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402
from mcmcglm_tpu_torch.ops import fused_cggibbs as fc  # noqa: E402
from mcmcglm_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (python3 chip_smoke.py runs these "
                    "checks on the card)")
    return torch.device("cuda")


# the six pairs with a density path of their own, and the fifteen of the
# composed route: (family, link) -> extra
FAMILY_EXTRA = {p: example_extra(p) for p in fb.OWN_PATHS}
COMPOSED_EXTRA = {p: example_extra(p) for p in fb.COMPOSED_PAIRS}
ALL_EXTRA = {**FAMILY_EXTRA, **COMPOSED_EXTRA}

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


def _operands(fam, extra, C, n, K, device, seed=0, d=16):
    g = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def randn(*s):
        return torch.randn(s, generator=g, device=device, dtype=f32)

    def rand(*s):
        return torch.rand(s, generator=g, device=device, dtype=f32)

    if fam.name == "binomial":
        y = (rand(n) < 0.4).to(f32)
    elif fam.name == "gaussian":
        y = randn(n)
    elif fam.name in ("Gamma", "inverse.gaussian"):
        y = rand(n) * 3 + 0.05
    else:
        y = torch.floor(rand(n) * 5)
    Xt = randn(d, n) / math.sqrt(d)
    eta = 0.5 * randn(C, n)
    j = torch.randint(0, d, (C,), generator=g, device=device,
                      dtype=torch.int32)
    j[0] = 1  # an odd row: misaligned in Xt whenever n % 4 != 0
    xg = Xt[j.long()].contiguous()
    deltas = 0.3 * randn(C, K)
    m = torch.where(rand(n) < 0.9, 1.0 + rand(n), torch.zeros(n, device=device))
    sign = eta_sign(fam)
    if (fam.name, fam.link.name) in COMPOSED_EXTRA:
        # every proposal in the pair's domain: |x delta| < 0.4 about
        # eta in [1, 1.5] (or its negative)
        if sign:
            eta = sign * (1.0 + 0.5 * rand(C, n))
            deltas = 0.2 * deltas
        # padded slots as the JAX package pads: weight 0, y = 1, eta and
        # x 0, where linkinv(0) is inf under inverse and 1/mu^2
        pad = m == 0
        y = torch.where(pad, 1.0, y)
        eta[:, pad] = 0.0
        Xt[:, pad] = 0.0
        xg = Xt[j.long()].contiguous()
    ld0 = fb.battery_sums(eta, xg, torch.zeros(C, 1, device=device), y, m,
                          fam, extra)[:, 0]
    scal = torch.stack([torch.log1p(-rand(C)), ld0, (rand(C) < 0.8).to(f32),
                        torch.randint(0, K + 1, (C,), generator=g,
                                      device=device).to(f32)], 1)
    return dict(y=y, Xt=Xt, eta=eta, j=j, xg=xg, deltas=deltas, m=m,
                fprior=0.5 * randn(C, K), scal=scal.contiguous())


# (C, n, K): the battery kernel's paths.  n % 4 == 0 takes 16-byte vector
# loads (bf16 rows in 8 bytes), any other n scalar loads of the same
# layout; a chain's cluster has the fewest CTAs (at most 8) whose slices
# fit a register tile of 1,536 observations each, and n beyond 8 tiles
# (12,288) walks its slices in chunks and reads eta and the row again for
# the commit; K of 1 and 4 run their own instantiations, every other K the
# runtime-K one.
BATTERY_SHAPES = [
    (1, 1, 1), (5, 257, 2), (64, 1003, 7), (33, 4099, 32),
    (16, 4096, 4),       # vector loads, K=4, a cluster of 3
    (16, 10_000, 1),     # the main path's n, vector loads, K=1
    (7, 10_002, 4),      # n % 4 != 0: misaligned rows, K=4
    (9, 10_004, 4),      # n % 8 != 0 (bf16 rows in 8-byte vectors)
    (3, 12_300, 32),     # two chunks, vector loads, runtime K
    (4, 200_000, 7),     # chunked, vector loads, runtime K
    (4, 200_003, 4),     # chunked, misaligned rows, K=4
    (300, 8192, 4),      # more clusters than the card holds at once
    (257, 10_000, 7),    # the same, runtime K
]


@pytest.mark.parametrize("pair", list(ALL_EXTRA))
@pytest.mark.parametrize("C,n,K", BATTERY_SHAPES)
def test_kernels_match_plain(cuda, pair, C, n, K):
    fam = mt.check_family(pair[0]).with_link(pair[1])
    extra = ALL_EXTRA[pair]
    a = _operands(fam, extra, C, n, K, cuda)

    def plain(**kw):
        return fb.plain_battery(
            a["eta"], a["xg"], a["deltas"], a["y"],
            lambda e, y: fam.log_density_eta_rel(e, y, extra),
            lambda t: fb.masked_sum(t, a["m"]), **kw)

    before = dict(fb.launch_counts)
    s_k = fb.battery_sums(a["eta"], a["xg"], a["deltas"], a["y"], a["m"], fam,
                          extra)
    l2, e2 = fb.battery_commit(a["eta"], a["xg"], a["deltas"], a["fprior"],
                               a["scal"], a["y"], a["m"], fam, extra)
    l3, e3 = fb.battery_gather_commit(a["j"], a["Xt"], a["eta"], a["deltas"],
                                      a["fprior"], a["scal"], a["y"], a["m"],
                                      fam, extra)
    l16, e16 = fb.battery_gather_commit(a["j"], a["Xt"].to(torch.bfloat16),
                                        a["eta"], a["deltas"], a["fprior"],
                                        a["scal"], a["y"], a["m"], fam, extra)
    torch.cuda.synchronize()
    for k in fb.launch_counts:
        assert fb.launch_counts[k] == before[k] + 1
    # bf16 rows: the same kernel on the rounded rows, exactly
    xr = a["Xt"].to(torch.bfloat16).float()
    l3r, e3r = fb.battery_gather_commit(a["j"], xr, a["eta"], a["deltas"],
                                        a["fprior"], a["scal"], a["y"],
                                        a["m"], fam, extra)
    assert torch.equal(l16, l3r) and torch.equal(e16, e3r)
    lsum_p, eta_p = plain(fprior=a["fprior"], scal=a["scal"])
    for lsum in (s_k, l2, l3):
        torch.testing.assert_close(lsum, lsum_p, rtol=2e-5, atol=2e-3)
    # the three launchers reduce in the same order: identical sums
    assert torch.equal(s_k, l2) and torch.equal(l2, l3)
    dstar_p = fb.replay_delta_star(lsum_p, a["deltas"], a["fprior"],
                                   a["scal"])
    for lsum, eta_new in ((l2, e2), (l3, e3)):
        dstar = fb.replay_delta_star(lsum, a["deltas"], a["fprior"], a["scal"])
        # the commit is the decision replayed from the kernel's own sums
        assert torch.equal(eta_new, a["eta"] + a["xg"] * dstar[:, None])
        # and agrees with the plain version wherever the two decisions do,
        # which is everywhere but at the float tolerance of the level
        same = dstar == dstar_p
        f = (lsum_p - a["scal"][:, 1:2]) + a["fprior"]
        near = ((f - a["scal"][:, :1]).abs()
                <= 2e-3 + 2e-5 * lsum_p.abs()).any(1)
        assert bool((same | near).all())
        torch.testing.assert_close(eta_new[same], eta_p[same], rtol=0,
                                   atol=1e-5)


def test_sums_repeat_bitwise(cuda):
    fam = mt.check_family("binomial")
    a = _operands(fam, {}, 128, 10_000, 4, cuda)
    first = fb.battery_sums(a["eta"], a["xg"], a["deltas"], a["y"], a["m"],
                            fam, {})
    for _ in range(5):
        again = fb.battery_sums(a["eta"], a["xg"], a["deltas"], a["y"],
                                a["m"], fam, {})
        assert torch.equal(first, again)
    # the main path's launcher at its shape: C=256, n=10,000, K=4, d=1,000
    a = _operands(fam, {}, 256, 10_000, 4, cuda, d=1000)

    def gather():
        return fb.battery_gather_commit(a["j"], a["Xt"], a["eta"],
                                        a["deltas"], a["fprior"], a["scal"],
                                        a["y"], a["m"], fam, {})

    lsum, eta_new = gather()
    for _ in range(5):
        l2, e2 = gather()
        assert torch.equal(lsum, l2) and torch.equal(eta_new, e2)


@pytest.mark.parametrize("n", [4096, 10_000, 200_000])
def test_scalar_loads_reduce_like_vector_loads(cuda, n):
    """Operands that are not 16-byte aligned take scalar loads of the same
    layout: the sums and the commit equal the aligned run's bitwise."""
    fam = mt.check_family("binomial")
    a = _operands(fam, {}, 200, n, 4, cuda)
    args = ("j", "Xt", "eta", "deltas", "fprior", "scal", "y", "m")

    def run(ops):
        return fb.battery_gather_commit(*(ops[k] for k in args), fam, {})

    want = run(a)
    shifted = dict(a)
    for k in ("eta", "y", "m"):  # one float past a 16-byte boundary
        buf = torch.empty(a[k].numel() + 1, device=cuda)
        shifted[k] = buf[1:].view(a[k].shape).copy_(a[k])
        assert shifted[k].data_ptr() % 16 == 4
    got = run(shifted)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_wrappers_reject_bad_operands(cuda):
    fam = mt.check_family("binomial")
    a = _operands(fam, {}, 8, 100, 4, cuda)
    with pytest.raises(TypeError, match="dtype"):
        fb.battery_sums(a["eta"].double(), a["xg"], a["deltas"], a["y"],
                        a["m"], fam, {})
    with pytest.raises(ValueError, match="contiguous"):
        fb.battery_sums(a["eta"].t().contiguous().t(), a["xg"], a["deltas"],
                        a["y"], a["m"], fam, {})
    with pytest.raises(ValueError, match="K <= 32"):
        fb.battery_sums(a["eta"], a["xg"], torch.zeros(8, 33, device=cuda),
                        a["y"], a["m"], fam, {})
    with pytest.raises(ValueError, match="KERNEL_FAMILIES"):
        fb.battery_sums(a["eta"], a["xg"], a["deltas"], a["y"], a["m"],
                        mt.check_family(USER_FAMILY), {})


@pytest.mark.parametrize("impl", ["cuda3", "cuda2", "cuda"])
def test_gaussian_oracle_through_each_kernel(cuda, impl):
    rng = np.random.default_rng(0)
    n, d = 400, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = X @ np.linspace(1.0, -0.5, d) + rng.normal(size=n)
    P = X.T @ X + np.eye(d)
    mu = np.linalg.solve(P, X.T @ y)
    sd = np.sqrt(np.diag(np.linalg.inv(P)))
    fr = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(), d),
                           extra={"sd": 1.0}, tuning={"w": 0.7},
                           battery_impl=impl, device=cuda)
    assert fr.spec_k == 4 and fr.battery_impl == impl
    fb.reset_launch_counts()
    st = fr.init(1, 64)
    st, _, _ = fr.warmup(st, 100)
    st, draws, _ = fr.run(st, 300)
    name = {"cuda": "battery_sums", "cuda2": "battery_commit",
            "cuda3": "battery_gather_commit"}[impl]
    assert fb.launch_counts[name] > 0
    post = draws.cpu().numpy()[:, 50:, :].reshape(-1, d)
    assert np.abs(post.mean(0) - mu).max() < 0.02
    assert np.abs(post.std(0) / sd - 1.0).max() < 0.08
    eta_ref = st.beta.double() @ fr.Xt.double()
    assert float((st.eta.double() - eta_ref).abs().max()) < 1e-3


def test_auto_resolves_to_cuda3_and_mcmcglm_runs(cuda):
    rng = np.random.default_rng(42)
    n = 1000
    X = np.column_stack([np.ones(n), rng.normal(size=n),
                         rng.binomial(1, 0.5, size=n)])
    y = rng.normal(X @ np.array([1.0, 1.5, 2.0]), 1.0)
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(), 3),
                            extra={"sd": 1.0}, tuning={"w": 0.5}, device=cuda)
    assert (eng.spec_k, eng.battery_impl) == (4, "cuda3")
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, n_samples=400,
                     burnin=100, n_chains=16)
    assert fit.device.startswith("cuda")
    post_mean = np.linalg.solve(X.T @ X + np.eye(3), X.T @ y)
    coef = fit.post_burnin().reshape(-1, 3).mean(0)
    np.testing.assert_allclose(coef, post_mean, atol=0.03)


# -- the fused coordinate kernels ------------------------------------------

def test_fused_sweep_span_matches_event_timing(cuda):
    """A ``fused.sweep`` span's device time is within 5% of CUDA events
    around the whole one-sweep ``run`` that holds it, and not above; a
    spin kernel queued first keeps the device busy while the host enqueues
    the run, so the outer events time the device's work and not the
    host's."""
    rng = np.random.default_rng(1)
    n, d, C = 4_000, 64, 64
    X = rng.normal(size=(n, d)) / math.sqrt(d)
    y = rng.binomial(1, 0.4, size=n)
    eng = mt.FusedCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1), d),
                          tuning={"w": 0.5}, device=cuda)
    st, _, _ = eng.run(eng.init(0, C), 2)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda.synchronize()
        profiling.reset_spans()
        torch.cuda._sleep(5_000_000)  # about 2.5 ms of spinning
        t0.record()
        st, _, _ = eng.run(st, 1)
        t1.record()
        torch.cuda.synchronize()
        (sweep,) = [s for s in profiling.spans()
                    if s["name"] == "fused.sweep"]
        outer = 1e3 * t0.elapsed_time(t1)
        assert 0.95 * outer <= sweep["dev_us"] <= outer
        assert sweep["dev0"] is not None and sweep["dev1"] is not None


PRIORS = [mt.Normal(0.2, 1.5), mt.Gamma(2.0, 1.0), mt.Exponential(1.5),
          mt.StudentT(3.0, 0.0, 1.0), mt.Laplace(0.0, 0.7),
          mt.Uniform(-3.0, 3.0)]


def _fused_engine(pair, prior, C, n, d, device, block_chains=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) / math.sqrt(d)
    name = pair[0]
    y = {"binomial": lambda: rng.binomial(1, 0.4, size=n),
         "gaussian": lambda: rng.normal(size=n),
         "Gamma": lambda: rng.gamma(2.0, 1.0, size=n) + 0.05}.get(
        name, lambda: rng.poisson(2.0, size=n))()
    fam = mt.check_family(name).with_link(pair[1])
    eng = mt.FusedCGGibbs(X, y, fam, mt.IIDPrior(prior, d),
                          extra=FAMILY_EXTRA[pair], tuning={"w": 0.5},
                          block_chains=block_chains, device=device)
    assert eng.impl == "cuda"
    return eng, eng.init(seed, C)


def _assert_fused_matches_plain(got, want, margin, block_chains):
    """nev identical, beta and eta within 1e-5, except chains whose plain
    run evaluated g within 1e-3 of the level (their block, for nev)."""
    excused = margin <= 1e-3
    block = excused.view(-1, block_chains).any(1).repeat_interleave(
        block_chains)
    assert torch.equal(got[2][~block], want[2][~block])
    keep = ~excused
    torch.testing.assert_close(got[1][keep], want[1][keep], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(got[0][keep], want[0][keep], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("prior", PRIORS, ids=lambda p: type(p).__name__)
@pytest.mark.parametrize("pair", list(FAMILY_EXTRA))
def test_fused_kernels_match_plain(cuda, pair, prior):
    C, n, d = 16, 257, 3
    eng, st = _fused_engine(pair, prior, C, n, d, cuda)
    kw = dict(seed=st.seed, sweep=2, w=0.5, block_chains=8)
    fns = eng._plain_fns()
    before = dict(fc.launch_counts)
    got = fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y, eng.family,
                         eng.extra, prior, **kw)
    want = fc.plain_fused_sweep(st.eta, st.beta, eng.Xt, eng.y, **fns, **kw)
    _assert_fused_matches_plain(got, want[:3], want[3], 8)
    # the sweep kernel is d coordinate launches, bitwise
    eta, beta = st.eta, st.beta.clone()
    nev = torch.zeros_like(got[2])
    for j in range(d):
        eta, bj, nev_j = fc.fused_coord_update(
            eta, beta[:, j].contiguous(), eng.Xt[j], eng.y, eng.family,
            eng.extra, prior, j=j, **kw)
        beta[:, j] = bj
        nev += nev_j
    torch.cuda.synchronize()
    assert torch.equal(eta, got[0]) and torch.equal(beta, got[1])
    assert torch.equal(nev, got[2])
    assert fc.launch_counts["fused_sweep"] == before["fused_sweep"] + 1
    assert (fc.launch_counts["fused_coord_update"]
            == before["fused_coord_update"] + d)


@pytest.mark.parametrize("pair", list(COMPOSED_EXTRA))
def test_fused_composed_pairs_match_plain(cuda, pair):
    """The composed route through both fused kernels: the sweep against the
    plain version and against d coordinate launches (bitwise), at a ragged
    n with the rows on chip and one n past ON_CHIP_N on the global rows."""
    for n in (1003, fc.ON_CHIP_N + 5):
        C, d = 16, 3
        X, y = domain_data(pair, n, d)
        prior = mt.Gamma(2.0, 2.0)
        fam = mt.check_family(pair[0]).with_link(pair[1])
        eng = mt.FusedCGGibbs(X, y, fam, mt.IIDPrior(prior, d),
                              extra=COMPOSED_EXTRA[pair], tuning={"w": 0.5},
                              device=cuda)
        assert eng.impl == "cuda"
        st = eng.init(0, C)
        kw = dict(seed=st.seed, sweep=2, w=0.5, block_chains=8)
        got = fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y, eng.family,
                             eng.extra, prior, **kw)
        want = fc.plain_fused_sweep(st.eta, st.beta, eng.Xt, eng.y,
                                    **eng._plain_fns(), **kw)
        _assert_fused_matches_plain(got, want[:3], want[3], 8)
        assert torch.isfinite(got[1]).all() and torch.isfinite(got[0]).all()
        eta, beta = st.eta, st.beta.clone()
        for j in range(d):
            eta, bj, _ = fc.fused_coord_update(
                eta, beta[:, j].contiguous(), eng.Xt[j], eng.y, eng.family,
                eng.extra, prior, j=j, **kw)
            beta[:, j] = bj
        torch.cuda.synchronize()
        assert torch.equal(eta, got[0]) and torch.equal(beta, got[1])


# per family: y values in its domain
EDGE_Y = {"gaussian": (-1.5, 0.0, 2.0), "binomial": (0.0, 1.0),
          "poisson": (0.0, 3.0), "negative.binomial": (0.0, 3.0),
          "Gamma": (0.05, 2.0), "inverse.gaussian": (0.05, 2.0)}
EDGE_ETA = (-40.0, -9.0, -1.5, -1.0, -0.3, -1e-30, 0.0, 1e-30, 0.3, 1.0,
            2.5, 9.0, 40.0, 100.0)


@pytest.mark.parametrize("pair", list(COMPOSED_EXTRA))
def test_composed_densities_at_domain_edges(cuda, pair):
    """One density per value (n = 1, the predictor 0 + 1 * delta_k): the
    composed route equals the plain version across each link's domain and
    past it, -inf where the plain version gives -inf and NaN only where it
    gives NaN (probit's tails down to eta = -40 included)."""
    fam = mt.check_family(pair[0]).with_link(pair[1])
    extra = COMPOSED_EXTRA[pair]
    one = torch.ones(1, 1, device=cuda)
    deltas = torch.tensor([EDGE_ETA], device=cuda)
    for yv in EDGE_Y[pair[0]]:
        y = torch.full((1,), yv, device=cuda)
        m = torch.ones(1, device=cuda)
        got = fb.battery_sums(torch.zeros(1, 1, device=cuda), one, deltas, y,
                              m, fam, extra)
        want = fam.log_density_eta_rel(deltas, y, extra)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)


@pytest.mark.parametrize("pair", list(ALL_EXTRA))
def test_every_builtin_pair_runs_its_kernels(cuda, pair):
    """battery_impl="auto" resolves to "cuda3" and FusedCGGibbs to "cuda"
    for every built-in pair, and a short run through each stays finite with
    eta equal to X beta."""
    n, d, C = 300, 3, 16
    X, y = domain_data(pair, n, d)
    fam = mt.check_family(pair[0]).with_link(pair[1])
    prior = mt.IIDPrior(mt.Gamma(2.0, 2.0), d)
    extra = ALL_EXTRA[pair]
    fr = mt.FreeRunCGGibbs(X, y, fam, prior, extra=extra, tuning={"w": 0.5},
                           device=cuda)
    assert fr.battery_impl == "cuda3", fr.battery_reason
    fu = mt.FusedCGGibbs(X, y, fam, prior, extra=extra, tuning={"w": 0.5},
                         device=cuda)
    assert fu.impl == "cuda", fu.impl_reason
    fb.reset_launch_counts()
    fc.reset_launch_counts()
    st = fr.init(0, C)
    st, draws, _ = fr.run(st, 5)
    sf, betas, _ = fu.run(fu.init(0, C), 2)
    torch.cuda.synchronize()
    assert fb.launch_counts["battery_gather_commit"] > 0
    assert fc.launch_counts["fused_sweep"] == 2
    assert torch.isfinite(draws).all() and torch.isfinite(betas).all()
    for s, eng in ((st, fr), (sf, fu)):
        ref = s.beta.double() @ eng.Xt.double()
        assert float((s.eta.double() - ref).abs().max()) < 1e-4


def test_auto_per_obs_cache_warns_and_runs_plain(cuda):
    """Gamma/inverse of shape 2 at n=10,000: eval_cache="auto" resolves to
    "per_obs" (its roundoff estimate passes 0.01), so "auto" warns and runs
    the plain battery; eval_cache="scalar" runs the kernels."""
    X, y = domain_data(("Gamma", "inverse"), 10_000, 2)
    prior = mt.IIDPrior(mt.Gamma(2.0, 2.0), 2)
    with pytest.warns(RuntimeWarning, match="chose 'per_obs'"):
        eng = mt.FreeRunCGGibbs(X, y, "Gamma", prior, extra={"shape": 2.0},
                                tuning={"w": 0.5}, device=cuda)
    assert eng.eval_cache == "per_obs" and eng.battery_impl == "torch"
    eng = mt.FreeRunCGGibbs(X, y, "Gamma", prior, extra={"shape": 2.0},
                            tuning={"w": 0.5}, eval_cache="scalar",
                            device=cuda)
    assert eng.battery_impl == "cuda3"


def test_composed_route_refuses_other_pairs(cuda):
    """The C entry points launch the composed route only for the fifteen
    pairs it serves; any other runtime ids (gaussian/logit here) return
    cudaErrorInvalidValue (1) and launch nothing."""
    from mcmcglm_tpu_torch.ops._build import load_library

    lib = load_library()
    fam = mt.check_family("gaussian")
    a = _operands(fam, {"sd": 1.0}, 8, 100, 4, cuda)
    lsum = torch.zeros(8, 4, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [a[k].data_ptr() for k in ("eta", "xg", "deltas", "y", "m")]
    gaussian_logit = (fb.FAM_COMPOSED, 1.0, fb.COMPOSED_FAMILIES["gaussian"],
                      fb.COMPOSED_LINKS["logit"])
    assert lib.battery_sums(*ptr, lsum.data_ptr(), 8, 100, 4,
                            *gaussian_logit, stream) == 1
    gaussian_log = gaussian_logit[:3] + (fb.COMPOSED_LINKS["log"],)
    assert lib.battery_sums(*ptr, lsum.data_ptr(), 8, 100, 4,
                            *gaussian_log, stream) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(lsum).all() and bool((lsum != 0).all())


def test_user_family_warns_and_runs_plain_on_the_card(cuda):
    X, y = domain_data(("gaussian", "identity"), 100, 2)
    with pytest.warns(RuntimeWarning, match=USER_FAMILY):
        fr = mt.FreeRunCGGibbs(X, y, USER_FAMILY,
                               mt.IIDPrior(mt.Normal(), 2),
                               tuning={"w": 0.5}, device=cuda)
    assert fr.battery_impl == "torch"
    with pytest.raises(ValueError, match="KERNEL_FAMILIES"):
        mt.FreeRunCGGibbs(X, y, USER_FAMILY, mt.IIDPrior(mt.Normal(), 2),
                          tuning={"w": 0.5}, battery_impl="cuda3",
                          device=cuda)
    st, draws, _ = fr.run(fr.init(0, 8), 3)
    assert torch.isfinite(draws).all()


@pytest.mark.parametrize("C,n,block_chains", [(8, 1, 8), (24, 1003, 8),
                                              (32, 4099, 16), (32, 300, 32)])
def test_fused_kernels_at_ragged_shapes(cuda, C, n, block_chains):
    pair = ("binomial", "logit")
    eng, st = _fused_engine(pair, mt.Normal(), C, n, 4, cuda,
                            block_chains=block_chains)
    kw = dict(seed=st.seed, sweep=0, w=0.5, block_chains=block_chains)
    got = fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y, eng.family,
                         eng.extra, eng.prior.dist, **kw)
    want = fc.plain_fused_sweep(st.eta, st.beta, eng.Xt, eng.y,
                                **eng._plain_fns(), **kw)
    _assert_fused_matches_plain(got, want[:3], want[3], block_chains)


# (C, n, d, block_chains): the largest rows on chip (n = 29,000, one CTA
# per SM, and ON_CHIP_N itself), the global-row path above it (n % 4 != 0
# takes scalar loads; n = 65,536 is MAX_FUSED_N), scalar loads on chip, and
# one block's counts spread over 32 CTAs
LARGE_FUSED_SHAPES = [(8, 29_000, 2, 8), (8, fc.ON_CHIP_N, 2, 8),
                      (8, fc.ON_CHIP_N + 1, 2, 8), (8, 65_536, 2, 8),
                      (16, 10_001, 2, 8), (64, 1003, 3, 32)]


@pytest.mark.parametrize("C,n,d,block_chains", LARGE_FUSED_SHAPES)
def test_fused_kernels_on_chip_and_global_rows(cuda, C, n, d, block_chains):
    """Both row paths and cross-CTA block counts against the plain version;
    the sweep equals d coordinate launches bitwise, and block_chains=1
    gives the same moves with each chain's own counts, at most the
    block's."""
    pair = ("binomial", "logit")
    eng, st = _fused_engine(pair, mt.Normal(), C, n, d, cuda,
                            block_chains=block_chains)
    kw = dict(seed=st.seed, sweep=1, w=0.5, block_chains=block_chains)
    got = fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y, eng.family,
                         eng.extra, eng.prior.dist, **kw)
    want = fc.plain_fused_sweep(st.eta, st.beta, eng.Xt, eng.y,
                                **eng._plain_fns(), **kw)
    _assert_fused_matches_plain(got, want[:3], want[3], block_chains)
    eta, beta = st.eta, st.beta.clone()
    nev = torch.zeros_like(got[2])
    for j in range(d):
        eta, bj, nev_j = fc.fused_coord_update(
            eta, beta[:, j].contiguous(), eng.Xt[j], eng.y, eng.family,
            eng.extra, eng.prior.dist, j=j, **kw)
        beta[:, j] = bj
        nev += nev_j
    assert torch.equal(eta, got[0]) and torch.equal(beta, got[1])
    assert torch.equal(nev, got[2])
    own = fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y, eng.family,
                         eng.extra, eng.prior.dist,
                         **dict(kw, block_chains=1))
    torch.cuda.synchronize()
    assert torch.equal(own[0], got[0]) and torch.equal(own[1], got[1])
    blocks = own[2].view(-1, block_chains)
    assert bool((got[2].view(-1, block_chains)[:, 0]
                 >= blocks.amax(1)).all())


def test_fused_wrappers_reject_bad_operands(cuda):
    eng, st = _fused_engine(("binomial", "logit"), mt.Normal(), 16, 100, 3,
                            cuda)
    args = (st.eta, st.beta, eng.Xt, eng.y, eng.family, eng.extra)
    kw = dict(seed=0, sweep=0, w=0.5)
    with pytest.raises(ValueError, match="block_chains"):
        fc.fused_sweep(*args, mt.Normal(), block_chains=5, **kw)
    with pytest.raises(ValueError, match="KERNEL_PRIORS"):
        fc.fused_sweep(*args, object(), **kw)
    with pytest.raises(ValueError, match="KERNEL_FAMILIES"):
        fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y,
                       mt.check_family(USER_FAMILY), {}, mt.Normal(), **kw)
    with pytest.raises(TypeError, match="dtype"):
        fc.fused_sweep(st.eta, st.beta.double(), eng.Xt, eng.y, eng.family,
                       eng.extra, mt.Normal(), **kw)
    big = torch.zeros(8, fc.MAX_FUSED_N + 1, device=cuda)
    with pytest.raises(ValueError, match="MAX_FUSED_N"):
        fc.fused_coord_update(big, st.beta[:8, 0].contiguous(), big[0],
                              big[0], eng.family, eng.extra, mt.Normal(),
                              j=0, **kw)
    # a family outside the kernel table runs the plain version, by name,
    # and warns
    X = np.random.default_rng(0).uniform(0.5, 1.5, size=(50, 2))
    with pytest.warns(RuntimeWarning, match=USER_FAMILY):
        e2 = mt.FusedCGGibbs(X, X[:, 0] + 1.0, USER_FAMILY,
                             mt.IIDPrior(mt.Normal(), 2), tuning={"w": 0.5},
                             device=cuda)
    assert e2.impl == "torch" and "KERNEL_FAMILIES" in e2.impl_reason


def test_fused_gaussian_oracle_and_mcmcglm(cuda):
    rng = np.random.default_rng(0)
    n, d = 200, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    y = rng.normal(X @ np.array([1.0, 1.5, 2.0]), 1.0)
    eng = mt.FusedCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                          extra={"sd": 1.0}, tuning={"w": 0.5}, device=cuda)
    betas, _, st = eng.sample(0, 300, n_chains=32)
    post = betas[:, 101:, :].reshape(-1, d)
    prec = X.T @ X + np.eye(d)
    mu = np.linalg.solve(prec, X.T @ y)
    sd = np.sqrt(np.diag(np.linalg.inv(prec)))
    np.testing.assert_allclose(post.mean(0), mu, atol=float(6 * sd.max() / 50))
    np.testing.assert_allclose(post.std(0), sd, rtol=0.3)
    eta_ref = st.beta.double() @ eng.Xt.double()
    assert float((st.eta.double() - eta_ref).abs().max()) < 1e-3
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="fused",
                     n_samples=300, burnin=100, n_chains=16)
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, d).mean(0), mu,
                               atol=0.03)


def test_bf16_engine_streams_bf16_rows(cuda):
    X, y, _ = mt.generate_glm_data("binomial", n=1000, d=8, seed=0)
    fr = mt.FreeRunCGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(), 8),
                           tuning={"w": 0.5}, x_storage="bf16", device=cuda)
    assert fr.battery_impl == "cuda3"
    assert fr._Xt_rows.dtype == torch.bfloat16
    assert torch.equal(fr._Xt_rows.float(), fr.Xt)
    fb.reset_launch_counts()
    st = fr.init(0, 16)
    st, draws, _ = fr.run(st, 3)
    assert fb.launch_counts["battery_gather_commit_bf16"] > 0
    assert fb.launch_counts["battery_gather_commit"] == 0
    eta_ref = st.beta.double() @ fr.Xt.double()
    assert float((st.eta.double() - eta_ref).abs().max()) < 1e-3


# -- the free-running pass loop: CUDA graphs against the eager loop ---------

SAMPLERS = {
    "stepping_out": dict(tuning={"w": 0.5}),
    "quantile": dict(slice_kernel="quantile",
                     tuning={"pseudo_scale": 2.0, "pseudo_adapt": True,
                             "pseudo_c": 3.0}),
    "latent": dict(slice_kernel="latent", tuning={"rate": 0.5}),
    "elliptical": dict(slice_kernel="elliptical",
                       tuning={"mu": 0.0, "sigma": 2.0}),
    "genelliptical": dict(slice_kernel="genelliptical",
                          tuning={"mu": 0.0, "sigma": 2.0, "df": 5.0}),
    "doubling": dict(slice_kernel="doubling", tuning={"w": 0.5}),
    "conjugate": dict(coord_sampler="conjugate"),
}


def _loop_engines(name, device, block_passes=16):
    """The same engine twice: one on the graph loop, one forced onto the
    eager loop (the switch only tests and the smoke use)."""
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)

    def make():
        eng = mt.FreeRunCGGibbs(X, y, "gaussian",
                                mt.IIDPrior(mt.Normal(0, 1), d),
                                extra={"sd": 1.0}, device=device,
                                **SAMPLERS[name])
        eng._block_passes = block_passes
        return eng

    graph, eager = make(), make()
    eager._graph_loop = False
    return graph, eager


def _assert_states_equal(a, b):
    for name, x, z in zip(a._fields, a, b):
        assert torch.equal(x, z), name


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_graph_loop_equals_eager_loop_bitwise(cuda, name):
    """warmup, run and pass-bounded runs replayed from CUDA graphs give the
    eager loop's states and draws bitwise, with one host read per block."""
    graph, eager = _loop_engines(name, cuda)
    if name in ("latent", "elliptical", "genelliptical", "stepping_out",
                "quantile"):
        assert graph.battery_impl == "cuda3"
    out = []
    for eng in (graph, eager):
        st = eng.init(3, 32)
        st, wd, _ = eng.warmup(st, 6)
        st, draws, nevbuf = eng.run(st, 8)
        sc = dr = nb = None
        for _ in range(10_000):
            st, sc, dr, nb = eng.run_passes(st, sc, dr, nb, 5, 37)
            if bool((sc >= 5).all()):
                break
        out.append((st, wd, draws, nevbuf, dr, nb))
    (s1, *r1), (s2, *r2) = out
    _assert_states_equal(s1, s2)
    for x, z in zip(r1, r2):
        assert torch.equal(x, z)
    assert bool(torch.isfinite(r1[1]).all())
    stats = graph.loop_stats
    assert stats["captures"] >= 3 and stats["capture_seconds"] > 0
    assert stats["flag_reads"] == eager.loop_stats["flag_reads"] > 0


def test_replay_spans_carry_device_intervals(cuda):
    """The graph loop's ``loop.replay`` spans carry device times from CUDA
    events, one per flag read, ordered and not overlapping, every gap at
    or above 0; each replay ends on the host clock before its flag read
    returns, one (the call's anchor) at it; the eager loop records the same
    spans with no device interval."""
    graph, eager = _loop_engines("stepping_out", cuda, block_passes=8)
    for eng in (graph, eager):
        st = eng.init(3, 32)
        st, _, _ = eng.run(st, 2)  # captures
        torch.cuda.synchronize()
        profiling.reset_spans()
        reads0 = eng.loop_stats["flag_reads"]
        eng.run(st, 4)
        torch.cuda.synchronize()
        got = profiling.spans()
        (call,) = [s for s in got if s["name"] == "freerun.run"]
        reps = [s for s in got if s["name"] == "loop.replay"]
        reads = [s for s in got if s["name"] == "loop.flag_read"]
        assert len(reps) == len(reads) == (eng.loop_stats["flag_reads"]
                                           - reads0) > 1
        assert {s["call"] for s in reps + reads} == {call["id"]}
        if eng is eager:
            assert all(s["dev_us"] is None and s["dev0"] is None
                       for s in reps)
            continue
        for i, (r, f) in enumerate(zip(reps, reads)):
            assert r["dev_us"] > 0
            assert r["dev1"] - r["dev0"] == pytest.approx(
                1e3 * r["dev_us"], abs=1)
            assert r["dev1"] <= f["t1"] + 1  # the rounding to whole ns
            if i:
                assert r["prev"] == reps[i - 1]["id"] and r["gap_us"] >= 0
                assert r["dev0"] >= reps[i - 1]["dev1"] - 1
        assert any(r["dev1"] == f["t1"] for r, f in zip(reps, reads))


def test_launch_counts_include_graph_replays(cuda):
    """A captured block's kernel launches count once per replay, plus the
    capture's warm-up block, which launches for real."""
    graph, eager = _loop_engines("stepping_out", cuda, block_passes=8)
    counts = {}
    for eng in (graph, eager):
        st = eng.init(0, 32)
        before = eng.loop_stats["flag_reads"]
        fb.reset_launch_counts()
        st, _, _ = eng.run(st, 3)
        torch.cuda.synchronize()
        counts[eng is graph] = (fb.launch_counts["battery_gather_commit"],
                                eng.loop_stats["flag_reads"] - before)
        # a second call replays the cached graph without a new capture
        fb.reset_launch_counts()
        before = eng.loop_stats["flag_reads"]
        eng.run(st, 3)
        torch.cuda.synchronize()
        assert fb.launch_counts["battery_gather_commit"] == \
            8 * (eng.loop_stats["flag_reads"] - before)
    (g_launch, g_blocks), (e_launch, e_blocks) = counts[True], counts[False]
    assert g_blocks == e_blocks > 0
    assert e_launch == 8 * e_blocks
    assert g_launch == 8 * g_blocks + 8  # + the warm-up block
    assert graph.loop_stats["captures"] == 1


def test_eager_switch_bypasses_captured_graphs(cuda, monkeypatch):
    """A replay runs no Python block; with the graph loop switched off,
    a configuration captured before runs the eager block again (the
    stepping_out engine takes the kernel route, whose block calls
    ``freerun_automaton._pass`` once per pass)."""
    from mcmcglm_tpu_torch.ops import freerun_automaton as fa

    graph, _ = _loop_engines("stepping_out", cuda)
    assert graph.pass_impl == "cuda"
    st = graph.init(0, 8)
    want = graph.run(st, 2)  # captures
    calls = []
    one_pass = fa._pass
    monkeypatch.setattr(fa, "_pass",
                        lambda *a: calls.append(1) or one_pass(*a))
    graph.run(st, 2)
    assert not calls
    graph._graph_loop = False
    got = graph.run(st, 2)
    assert calls
    _assert_states_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_capture_survives_dead_engines(cuda):
    """A dropped engine frees its captured graphs at once (its cached loops
    hold no reference back to it), so no collection can destroy a dead
    engine's graph in the middle of a later capture."""
    import gc
    import weakref

    collecting = gc.isenabled()
    gc.disable()  # reference counting alone must free the dead engines
    try:
        for _ in range(3):
            dead, _ = _loop_engines("stepping_out", cuda)
            dead.run(dead.init(0, 8), 2)
            assert dead.loop_stats["captures"] == 1
            ref = weakref.ref(dead)
            del dead
            assert ref() is None
        graph, _ = _loop_engines("latent", cuda)
        st, draws, _ = graph.run(graph.init(0, 8), 2)
        torch.cuda.synchronize()
    finally:
        if collecting:
            gc.enable()
    assert bool(torch.isfinite(draws).all())
    assert graph.loop_stats["captures"] == 1


def test_run_lengths_share_one_capture(cuda):
    """The sweep quota rides in the carry: pass-bounded warmups toward
    different quotas replay one captured block, bitwise the eager loop;
    the graph cache stays bounded across many run lengths (each ``run``
    records into a buffer of its own length, so each captures)."""
    from mcmcglm_tpu_torch import freerun

    graph, eager = _loop_engines("stepping_out", cuda)
    outs = []
    for eng in (graph, eager):
        st = eng.init(0, 16)
        sc = torch.zeros(16, dtype=torch.int32, device=cuda)
        st, sc = eng.warmup_passes(st, sc, 4, 100_000)
        st, sc = eng.warmup_passes(st, sc, 7, 100_000)
        assert bool((sc == 7).all())
        outs.append(st)
    _assert_states_equal(*outs)
    assert graph.loop_stats["captures"] == 1
    st = outs[0]
    for n in range(1, freerun._MAX_GRAPHS + 4):
        st, draws, _ = graph.run(st, n)
        assert len(graph._loops) <= freerun._MAX_GRAPHS
    assert bool(torch.isfinite(draws).all())


def test_exhausted_gamma_raises_at_the_flag_read(cuda, monkeypatch):
    from mcmcglm_tpu_torch import freerun

    graph, _ = _loop_engines("genelliptical", cuda)
    st = graph.init(0, 8)
    monkeypatch.setattr(freerun, "standard_gamma",
                        lambda alpha, u: torch.full(u.shape[:-1], math.nan,
                                                    device=u.device))
    with pytest.raises(RuntimeError, match="Marsaglia-Tsang"):
        graph.run(st, 2)


@pytest.mark.parametrize("name", ["latent", "elliptical", "genelliptical",
                                  "doubling", "conjugate"])
def test_new_samplers_match_the_gaussian_oracle(cuda, name):
    rng = np.random.default_rng(0)
    n, d = 300, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    cov = np.linalg.inv(X.T @ X + np.eye(d))
    mean = cov @ (X.T @ y)
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                            extra={"sd": 1.0}, device=cuda, **SAMPLERS[name])
    fb.reset_launch_counts()
    st = eng.init(0, 32)
    st, _, _ = eng.warmup(st, 50)
    st, draws, _ = eng.run(st, 300)
    if name in ("latent", "elliptical", "genelliptical"):
        assert fb.launch_counts["battery_gather_commit"] > 0
    post = draws.cpu().numpy()[:, 100:, :].reshape(-1, d)
    np.testing.assert_allclose(post.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(post.std(0), np.sqrt(np.diag(cov)), rtol=0.15)
    eta_ref = st.beta.double() @ eng.Xt.double()
    assert float((st.eta.double() - eta_ref).abs().max()) < 1e-3


# -- the automaton kernels around the battery against the PyTorch pass ------

# (slice kernel, tuning, family, prior, K, C, mode, max_shrink[, battery]):
# every slice kernel and pseudo-target the kernels take, the two families
# of the cells and the six priors of KERNEL_PRIORS, K in {2, 4, 7}, C in
# {37, 256}, both batteries ("auto", which is "cuda3", and "cuda2"),
# and the pass's three uses: "sample" (run_passes: shrink only, unless
# "full", which steps out), "adapt" (warmup with every lane stepping out)
# and "twophase" (warmup whose lanes switch to shrink only at 2 sweeps)
Q_ADAPT = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}
PASS_CASES = {
    "so-logit-normal-K4-C256-twophase": (
        "stepping_out", {"w": 0.5}, "binomial", mt.Normal(0, 1), 4, 256,
        "twophase", 64),
    "so-log-laplace-K7-C37-sample": (
        "stepping_out", {"w": 0.3}, "poisson", mt.Laplace(0, 1), 7, 37,
        "sample", 3),
    "so-log-laplace-K2-C256-full": (
        "stepping_out", {"w": 0.3}, "poisson", mt.Laplace(0, 1), 2, 256,
        "full", 64),
    "so-logit-normal-K7-C37-adapt": (
        "stepping_out", {"w": 0.5}, "binomial", mt.Normal(0, 1), 7, 37,
        "adapt", 64),
    "q-adapted-logit-normal-K4-C256-adapt": (
        "quantile", Q_ADAPT, "binomial", mt.Normal(0, 1), 4, 256, "adapt",
        64),
    "q-adapted-logit-normal-K2-C37-sample": (
        "quantile", Q_ADAPT, "binomial", mt.Normal(0, 1), 2, 37, "sample",
        4),
    "q-fixed-log-laplace-K7-C256-sample": (
        "quantile", {"pseudo_scale": 2.0}, "poisson", mt.Laplace(0, 1), 7,
        256, "sample", 64),
    "q-fixed-normalpsi-logit-normal-K4-C37-twophase": (
        "quantile", {"pseudo_family": "normal", "pseudo_scale": 1.5},
        "binomial", mt.Normal(0, 1), 4, 37, "twophase", 64),
    "q-adapted-normalpsi-log-laplace-K4-C256-adapt": (
        "quantile", {**Q_ADAPT, "pseudo_family": "normal"}, "poisson",
        mt.Laplace(0, 1), 4, 256, "adapt", 64),
    "so-gauss-studentt-K4-C37-sample": (
        "stepping_out", {"w": 0.5}, "gaussian", mt.StudentT(4.0, 0.0, 1.5),
        4, 37, "sample", 64),
    "so-gauss-gamma-K4-C37-twophase": (
        "stepping_out", {"w": 0.5}, "gaussian", mt.Gamma(2.0, 1.0), 4, 37,
        "twophase", 64),
    "q-fixed-gauss-exponential-K4-C37-sample": (
        "quantile", {"pseudo_loc": 0.5, "pseudo_scale": 1.0}, "gaussian",
        mt.Exponential(1.0), 4, 37, "sample", 64),
    "so-gauss-uniform-K4-C37-full": (
        "stepping_out", {"w": 0.5}, "gaussian", mt.Uniform(-3.0, 3.0), 4,
        37, "full", 64),
    "q-adapted-logit-normal-K4-C37-twophase-cuda2": (
        "quantile", Q_ADAPT, "binomial", mt.Normal(0, 1), 4, 37, "twophase",
        64, "cuda2"),
}
PASS_D = 5  # short sweeps: wraps and draws-slot writes every few passes
PASS_QUOTA = 150  # lanes reach it within the run, so idle lanes are hit


def _pass_engines(case, device):
    """The same engine twice, the reference pinned to the PyTorch pass."""
    kernel, tuning, fam, dist, K, C, mode, max_shrink, *battery = \
        PASS_CASES[case]
    beta = (np.abs(np.linspace(0.2, 0.8, PASS_D))
            if fam == "gaussian" else None)
    X, y, _ = mt.generate_glm_data(fam, n=400, d=PASS_D, beta=beta, seed=1)

    def make():
        return mt.FreeRunCGGibbs(
            X, y, fam, mt.IIDPrior(dist, PASS_D), tuning=tuning,
            extra={"sd": 1.0} if fam == "gaussian" else None,
            slice_kernel=kernel, spec_k=K, max_shrink=max_shrink,
            shrink_only=mode != "full", battery_impl=battery[0]
            if battery else "auto", device=device)

    ref, ker = make(), make()
    assert ker.pass_impl == "cuda", ker.pass_impl_reason
    ref.pass_impl = "torch"
    return ref, ker, C, mode


def _pass_states(ref, C, mode, n_states=87, every=23):
    """States every ``every`` passes along a PyTorch-route run, with the
    arguments of the pass that made them (``every`` prime, so that lanes
    that commit every pass are met at every coordinate)."""
    st = ref.init(7, C)
    if mode in ("sample", "full"):
        st, _, _ = ref.warmup(st, 3)
    sc = torch.zeros(C, dtype=torch.int32, device=ref.device)
    dr, nb = ref._buffers(C, PASS_QUOTA)
    stepout = {"adapt": PASS_QUOTA, "twophase": 2}.get(mode)
    out = []
    for _ in range(n_states):
        if mode in ("sample", "full"):
            out.append((st, sc, dr.clone(), nb.clone()))
            st, sc, dr, nb = ref.run_passes(st, sc, dr, nb, PASS_QUOTA, every)
        else:
            out.append((st, sc, None, None))
            st, sc = ref.warmup_passes(st, sc, PASS_QUOTA, every, stepout)
    adapt = mode in ("adapt", "twophase")
    return out, dict(n_sweeps=PASS_QUOTA, adapt=adapt,
                     shrink_only=ref.shrink_only if not adapt else False,
                     stepout_sweeps=stepout)


def _margin(ref, st):
    """Each lane's smallest |f - level| over its K proposals, relative to
    max(1, |level|), on the PyTorch route's own numbers."""
    from mcmcglm_tpu_torch.ops import freerun_passes as fp
    from mcmcglm_tpu_torch.ops.philox import pass_uniforms

    C, K = st.beta.shape[0], ref.spec_k
    U = pass_uniforms(st.key, st.ctr, 1, C, K + 3)[0]
    p = fp.spec_proposals(ref, st, U[:, :K])
    lsum = fb.battery_sums(st.eta, ref.Xt[st.j.long()], p["deltas"], ref.y,
                           ref._mask, ref.family, ref._extra_host)
    f = (lsum - st.ld0[:, None]) + p["fprior"]
    rel = (f - st.level[:, None]).abs() / st.level.abs().clamp(min=1)[:, None]
    return torch.nan_to_num(rel, nan=math.inf).amin(1)


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_pass_kernels_match_the_torch_pass(cuda, case):
    """One pass from states every 23 passes of a 2,000-pass PyTorch-route
    run, on both routes: on every lane whose f lies more than 1e-4
    (relative) from its level, the same integer registers, coordinate,
    sweep count and accept/exhaust decision, float registers and rows
    within 1e-5 (relative), and eta bitwise; the pass index the same.
    The run covers stepping and shrinking lanes, exhaustion where
    max_shrink is small, sweep wraps, draws-slot writes and idle lanes."""
    from mcmcglm_tpu_torch.ops import freerun_automaton as fa
    from mcmcglm_tpu_torch.ops import freerun_passes as fp

    ref, ker, C, mode = _pass_engines(case, cuda)
    states, kw = _pass_states(ref, C, mode)
    seen = dict(lanes=0, close=0, stepping=0, exhausted=0, wraps=0,
                draws=0, idle=0)
    ints = ("j", "phase", "stepdir", "budL", "budR", "n_shrink", "nev")
    floats = ("level", "L", "R", "b0", "lp0", "w", "xprop", "ld0")
    rows = ("beta", "logw") + (("qloc",) if ref.q_adapt else ())
    for st, sc, dr, nb in states:
        dr2 = None if dr is None else dr.clone()
        nb2 = None if nb is None else nb.clone()
        t_st, t_sc, t_dr, t_nb = fp.run_pass_spec(ref, st, sc, dr, nb, **kw)
        k_st, k_sc, k_dr, k_nb = fa.run_pass_kernels(ker, st, sc, dr2, nb2,
                                                     **kw)
        ok = _margin(ref, st) > 1e-4
        seen["lanes"] += C
        seen["close"] += int((~ok).sum())
        assert int(t_st.ctr) == int(k_st.ctr)
        for name in ints:
            a, b = getattr(t_st, name), getattr(k_st, name)
            assert torch.equal(a[ok], b[ok]), name
        assert torch.equal(t_sc[ok], k_sc[ok])
        for name in floats:
            torch.testing.assert_close(getattr(k_st, name)[ok],
                                       getattr(t_st, name)[ok], rtol=1e-5,
                                       atol=1e-6, msg=name)
        for name in rows:
            torch.testing.assert_close(getattr(k_st, name)[ok],
                                       getattr(t_st, name)[ok], rtol=1e-5,
                                       atol=1e-6, msg=name)
        assert torch.equal(k_st.eta[ok], t_st.eta[ok])
        if dr is not None:
            torch.testing.assert_close(k_dr[ok], t_dr[ok], rtol=1e-5,
                                       atol=1e-6)
            assert torch.equal(k_nb[ok], t_nb[ok])
        # what the pass did, by the PyTorch route's registers
        moved = t_st.j != st.j
        jl = st.j.long()[:, None]
        kept_b0 = torch.gather(t_st.beta, 1, jl)[:, 0] == st.b0
        seen["stepping"] += int((st.phase == 0).sum())
        seen["exhausted"] += int((moved & kept_b0 & (st.phase == 1)).sum())
        seen["wraps"] += int((moved & (t_st.j == 0)).sum())
        seen["draws"] += int((t_sc > sc).sum())
        seen["idle"] += int((sc >= PASS_QUOTA).sum())
    assert seen["close"] <= 0.01 * seen["lanes"], seen
    assert seen["wraps"] > 0 and seen["draws"] > 0, seen
    if mode != "sample" and PASS_CASES[case][0] == "stepping_out":
        assert seen["stepping"] > 0, seen
    if PASS_CASES[case][7] <= 4:
        assert seen["exhausted"] > 0, seen


def test_pass_kernel_uniforms_are_pass_uniforms(cuda, monkeypatch):
    """The kernel's Philox draws at a pass index past 2^32 under a key of
    two full words equal ``pass_uniforms`` bit for bit (read from the
    block's workspace, ``u``)."""
    from mcmcglm_tpu_torch.ops import freerun_automaton as fa
    from mcmcglm_tpu_torch.ops.philox import key_tensor, pass_uniforms

    made = []
    workspace = fa._workspace
    monkeypatch.setattr(fa, "_workspace",
                        lambda *a: made.append(workspace(*a)) or made[-1])

    _, ker, C, _ = _pass_engines("so-log-laplace-K7-C37-sample", cuda)
    st = ker.init(0, C)
    st = st._replace(key=key_tensor(0xDEADBEEF12345678, cuda),
                     ctr=torch.tensor((1 << 33) + 5, dtype=torch.int64,
                                      device=cuda))
    sc = torch.zeros(C, dtype=torch.int32, device=cuda)
    out, _, _, _ = fa.run_pass_kernels(ker, st, sc, None, None, 10, False,
                                       True)
    want = pass_uniforms(st.key, st.ctr, 1, C, ker.spec_k + 3)[0]
    assert len(made) == 1 and torch.equal(made[0]["u"], want)
    assert int(out.ctr) == (1 << 33) + 6


@pytest.mark.parametrize("why", ["live_false", "quota_met"])
def test_all_idle_kernel_pass_is_the_identity(cuda, why):
    """A pass with every lane idle changes nothing, the pass index and the
    draws buffers included (eta is eta + x * 0: equal values)."""
    from mcmcglm_tpu_torch.ops import freerun_automaton as fa

    for case in ("so-logit-normal-K4-C256-twophase",
                 "q-adapted-logit-normal-K4-C256-adapt"):
        _, ker, C, _ = _pass_engines(case, cuda)
        st = ker.init(2, C)
        st, _, _ = ker.warmup(st, 2)
        quota = 4
        sc = torch.full((C,), quota if why == "quota_met" else 1,
                        dtype=torch.int32, device=cuda)
        dr, nb = ker._buffers(C, quota)
        dr0, nb0 = dr.clone(), nb.clone()
        out, sc2, dr, nb = fa.run_pass_kernels(
            ker, st, sc, dr, nb, quota, False, True,
            budget=0 if why == "live_false" else 1)
        for name, a, b in zip(st._fields, st, out):
            assert torch.equal(a, b), name
        assert torch.equal(sc2, sc)
        assert torch.equal(dr, dr0) and torch.equal(nb, nb0)


@pytest.mark.parametrize("name", ["stepping_out", "quantile"])
def test_kernel_route_run_passes_equals_run(cuda, name):
    """On the kernel route run_passes is bitwise one run, and the graph
    loop bitwise the eager loop; each pass launches the two kernels and
    the battery once."""
    from mcmcglm_tpu_torch.ops import freerun_automaton as fa

    graph, eager = _loop_engines(name, cuda)
    assert graph.pass_impl == eager.pass_impl == "cuda"
    out = []
    for eng in (graph, eager):
        st = eng.init(5, 24)
        st, _, _ = eng.warmup(st, 4)
        s1, draws, nevbuf = eng.run(st, 9)
        fa.reset_launch_counts()
        fb.reset_launch_counts()
        c0 = int(st.ctr)
        s2, sc, dr, nb = st, None, None, None
        for _ in range(10_000):
            s2, sc, dr, nb = eng.run_passes(s2, sc, dr, nb, 9, 29)
            if bool((sc >= 9).all()):
                break
        _assert_states_equal(s1, s2)
        assert torch.equal(draws, dr) and torch.equal(nevbuf, nb)
        replayed = fa.launch_counts["pass_propose"]
        assert replayed == fa.launch_counts["pass_advance"] == \
            fb.launch_counts["battery_gather_commit"] >= int(s2.ctr) - c0
        out.append((s1, draws, nevbuf))
    (a, *ra), (b, *rb) = out
    _assert_states_equal(a, b)
    assert all(torch.equal(x, z) for x, z in zip(ra, rb))


def test_run_thinned_device_ess_matches_host(cuda):
    from mcmcglm_tpu_torch.diagnostics import ess
    from mcmcglm_tpu_torch.parallel.pooled import ess_from_state

    graph, _ = _loop_engines("stepping_out", cuda)
    st = graph.init(0, 16)
    st, _, _ = graph.warmup(st, 30)
    st, mom, kept, nev, es = graph.run_thinned(st, 60, 2, ess=True)
    assert kept.shape == (16, 60, 4) and int(es.count) == 60
    np.testing.assert_allclose(ess_from_state(es).cpu().numpy(),
                               ess(kept.cpu().numpy()),
                               rtol=0.05)
    np.testing.assert_allclose(mom.count.cpu().numpy(), 120.0)


def _lockstep(X, y, device, calc="update", **kw):
    return mt.CGGibbs(X, y, "binomial", mt.IIDPrior(mt.Normal(0, 1),
                                                    X.shape[1]),
                      tuning={"w": 0.5}, device=device,
                      config=mt.EngineConfig(linear_predictor_calc=calc), **kw)


@pytest.mark.parametrize("calc", ["update", "naive"])
def test_lockstep_on_the_card_follows_the_cpu(cuda, calc):
    """The lockstep engine on CUDA against the CPU from the same Philox
    stream and the same initial beta: the proposals are the same numbers,
    so the chains take the same decisions and agree to 1e-4 unless a g
    value lies within the two devices' rounding (~1e-6) of its level;
    at least 15 of 16 chains must agree over 3 sweeps."""
    X, y, _ = mt.generate_glm_data("binomial", n=500, d=4, seed=0)
    beta0 = np.random.default_rng(1).normal(size=(16, 4))
    out = []
    for dev in ("cpu", cuda):
        eng = _lockstep(X, y, dev, calc)
        st, draws, nev = eng.run(eng.init(3, 16, beta0=beta0), 3)
        out.append((draws.cpu().numpy(), nev.cpu().numpy()))
    (dc, nc), (dg, ng) = out
    same = (nc == ng).all(1) & (np.abs(dc - dg) < 1e-4).all((1, 2))
    assert same.sum() >= 15, same


def test_lockstep_block_length_bitwise_on_the_card(cuda):
    X, y, _ = mt.generate_glm_data("binomial", n=2000, d=4, seed=0)
    got = []
    for B in (1, 2, 5):
        eng = _lockstep(X, y, cuda)
        eng._block_iters = B
        st, draws, nev = eng.run(eng.init(0, 32), 3)
        got.append((draws, nev, st.eta, st.ld_cur))
    for g in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got[0], g))


def test_mvn_prior_through_cuda3_and_the_torch_battery(cuda):
    """An MVN prior on the free-running engine: "auto" resolves to cuda3
    (the battery sees only the (C, K) prior terms) and samples the closed-
    form posterior as the plain "torch" battery does."""
    rng = np.random.default_rng(0)
    n, d = 400, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, 1.5, -0.5, 0.3]), 1.0)
    loc = np.array([0.5, 0.0, -0.5, 0.2])
    cov = 0.5 * np.eye(d) + 0.3
    P = np.linalg.inv(cov)
    mean = np.linalg.solve(X.T @ X + P, X.T @ y + P @ loc)
    sd = np.sqrt(np.diag(np.linalg.inv(X.T @ X + P)))
    for impl in ("auto", "torch"):
        eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.MVNPrior(loc, cov),
                                extra={"sd": 1.0}, tuning={"w": 0.7},
                                battery_impl=impl, device=cuda)
        assert eng.battery_impl == ("cuda3" if impl == "auto" else "torch")
        fb.reset_launch_counts()
        st, _, _ = eng.warmup(eng.init(1, 64), 60)
        st, draws, _ = eng.run(st, 200)
        assert (fb.launch_counts["battery_gather_commit"] > 0) == (
            impl == "auto")
        post = draws.cpu().numpy()[:, 20:, :].reshape(-1, d)
        assert np.abs(post.mean(0) - mean).max() < 0.03, impl
        assert np.abs(post.std(0) / sd - 1.0).max() < 0.1, impl


def test_new_entry_points_default_to_the_card(cuda, monkeypatch):
    rng = np.random.default_rng(0)
    n = 300
    X = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = rng.normal(X @ [1.0, -0.5], 1.0)
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="xla",
                     n_samples=40, burnin=10, n_chains=8)
    assert fit.device == "cuda" and isinstance(fit.sampler, mt.CGGibbs)
    assert fit.state.beta.is_cuda
    fits = mt.mcmcglm_across_tuningparams([0.5, 1.0], "w", X=X, y=y,
                                          parallelise=True, n_samples=30,
                                          burnin=10, n_chains=4)
    assert fits[0].sampler.device.type == "cuda"
    from mcmcglm_tpu_torch.perf import eta_comptime_rows_across_nvars

    rows = eta_comptime_rows_across_nvars([3], n=200, n_samples=2,
                                          n_chains=8)
    assert [r["device"] for r in rows] == ["cuda", "cuda"]
    assert all(r["time"] > 0 for r in rows)
    with pytest.raises(ValueError, match="device='cpu'"):
        eta_comptime_rows_across_nvars([3], n=200, n_samples=2,
                                       parallelise=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eta_comptime_rows_across_nvars([3], n=200, n_samples=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.mcmcglm_across_tuningparams([0.5], "w", X=X, y=y)


def _bench_like(n=2_000, d=20):
    X, y, _ = mt.generate_glm_data("binomial", n=n, d=d, seed=0)
    kw = dict(tuning={"pseudo_scale": 2.0, "pseudo_adapt": True,
                      "pseudo_c": 3.0}, slice_kernel="quantile", spec_k=4,
              device="cuda")
    return X, y, mt.IIDPrior(mt.Normal(0.0, 1.0), d), kw


@pytest.fixture
def nccl_world_of_one(cuda):
    import torch.distributed as dist

    from mcmcglm_tpu_torch.parallel import distributed

    if dist.is_initialized():
        pytest.skip("this process already has a process group")
    distributed.initialize(device_type="cuda")
    yield mt.make_mesh(1, 1)
    dist.destroy_process_group()


def _runs_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and all(
        torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


def test_nccl_world_of_one_captures_the_all_reduce(nccl_world_of_one):
    """On a (1, 1) NCCL mesh the obs-sharded engine's blocks are CUDA
    graphs with the all-reduce inside; they equal the eager loop and the
    unsharded engine on the same kernel (battery_sums) bitwise, and the
    chain-sharded engine equals the unsharded cuda3 engine."""
    from mcmcglm_tpu_torch.ops.philox import fold_seed

    X, y, prior, kw = _bench_like()
    mesh = nccl_world_of_one
    graph = mt.ObsShardedFreeRunCGGibbs(X, y, "binomial", prior, mesh=mesh,
                                        **kw)
    eager = mt.ObsShardedFreeRunCGGibbs(X, y, "binomial", prior, mesh=mesh,
                                        graph=False, **kw)
    alone = mt.FreeRunCGGibbs(X, y, "binomial", prior, battery_impl="cuda",
                              **kw)
    assert graph.inner.battery_impl == "cuda"
    assert graph.loop_reason.startswith("nccl") and graph.inner._graph_loop
    assert not eager.inner._graph_loop
    runs = []
    fb.reset_launch_counts()
    for eng, seed in ((graph, 0), (eager, 0), (alone, fold_seed(0, 0))):
        st = eng.init(seed, 64)
        st, _, _ = eng.warmup(st, 2)
        runs.append(eng.run(st, 3))
    assert fb.launch_counts["battery_sums"] > 0
    assert graph.inner.loop_stats["captures"] >= 2
    assert _runs_equal(runs[0], runs[1]) and _runs_equal(runs[0], runs[2])
    chain = mt.ShardedFreeRunCGGibbs(X, y, "binomial", prior, mesh=mesh, **kw)
    c3 = mt.FreeRunCGGibbs(X, y, "binomial", prior, **kw)
    a = chain.run(chain.init(0, 64), 3)
    b = c3.run(c3.init(fold_seed(0, 0), 64), 3)
    assert chain.inner.battery_impl == "cuda3" and _runs_equal(a, b)


def test_checkpoint_round_trip_on_cuda(cuda, tmp_path):
    """A graph-loop state on the card saved, restored onto the card in a
    fresh engine and continued equals the uninterrupted run bitwise."""
    X, y, prior, kw = _bench_like()
    eng = mt.FreeRunCGGibbs(X, y, "binomial", prior, **kw)
    st = eng.init(1, 64)
    st, _, _ = eng.warmup(st, 2)
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(2, st)
    want = eng.run(st, 3)
    fresh = mt.FreeRunCGGibbs(X, y, "binomial", prior, **kw)
    step, st_r, _ = cm.restore(fresh.init(0, 64))
    assert step == 2 and all(t.is_cuda for t in st_r)
    assert _runs_equal(fresh.run(st_r, 3), want)


# -- the baselines (plain PyTorch on the card) ------------------------------

def _baseline_gaussian():
    """tests/test_baselines.py's gaussian problem and closed form."""
    rng = np.random.default_rng(0)
    n, d = 500, 4
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.array([1.0, -0.5, 0.8, 0.2]), 1.0)
    cov = np.linalg.inv(X.T @ X + np.eye(d))
    return X, y, cov @ (X.T @ y), np.sqrt(np.diag(cov))


@pytest.mark.parametrize("pair", [("binomial", "logit"), ("poisson", "log"),
                                  ("Gamma", "inverse"),
                                  ("inverse.gaussian", "1/mu^2")],
                         ids=lambda p: "/".join(p))
def test_baseline_logpost_on_the_card_matches_float64(cuda, pair):
    """float32 on the card against float64 on the host: values rtol 1e-5,
    gradients within 1e-4 of their norm (chip_smoke phase 8a's limits)."""
    from mcmcglm_tpu_torch import baselines as tb
    from mcmcglm_tpu_torch.baselines.logdensity import value_and_grad

    X, y = domain_data(pair, 5_000, 6, seed=0)
    fam = mt.check_family(pair[0]).with_link(pair[1])
    prior = mt.IIDPrior(mt.StudentT(3.0, 0.0, 1.0), 6)
    kw = dict(extra=example_extra(pair))
    lp = tb.make_log_posterior(X, y, fam, prior, **kw)
    lp64 = tb.make_log_posterior(X, y, fam, prior, dtype=torch.float64,
                                 device="cpu", **kw)
    b = torch.tensor(np.random.default_rng(1).uniform(0.3, 1.2, (5, 6)),
                     dtype=torch.float32)
    v, g = value_and_grad(lp, b.to(cuda))
    assert v.is_cuda and g.is_cuda
    v64, g64 = value_and_grad(lp64, b.double())
    v, g = v.double().cpu(), g.double().cpu()
    assert ((v - v64).abs() <= 1e-5 * v64.abs()).all()
    assert ((g - g64).norm(dim=1) <= 1e-4 * g64.norm(dim=1)).all()


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_baseline_nuts_and_hmc_recover_the_gaussian_posterior(cuda,
                                                              sampler):
    """tests/test_baselines.py's law test on the card (float64)."""
    from mcmcglm_tpu_torch import baselines as tb

    X, y, mu, sd = _baseline_gaussian()
    lp = tb.make_log_posterior(X, y, "gaussian", mt.IIDPrior(mt.Normal(), 4),
                               extra={"sd": 1.0}, dtype=torch.float64)
    fn = tb.nuts_sample if sampler == "nuts" else tb.hmc_sample
    res = fn(1, lp, torch.zeros((4, 4), dtype=torch.float64),
             n_warmup=400, n_samples=400)
    assert res.samples.is_cuda
    draws = res.samples.cpu().numpy().reshape(-1, 4)
    np.testing.assert_allclose(draws.mean(0), mu, atol=float(5 * sd.max() / 20))
    np.testing.assert_allclose(draws.std(0), sd, rtol=0.3)
    assert float(res.accept_rate.mean()) > 0.5


def test_baseline_chains_independent_of_batch_on_the_card(cuda,
                                                         monkeypatch):
    """Chain c bitwise the same at C=3 and C=5 and at loop block lengths 1
    and 4, on the card, for every baseline sampler with chains."""
    from mcmcglm_tpu_torch import baselines as tb
    from mcmcglm_tpu_torch.baselines import nuts as t_nuts

    X, y, _ = mt.generate_glm_data("binomial", n=2_000, d=3, seed=1)
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), 3)
    lp = tb.make_log_posterior(X, y, "binomial", prior)
    init = torch.tensor(np.random.default_rng(6).normal(size=(5, 3)) * 0.3,
                        dtype=torch.float32)

    def same(runs, k):
        return all(torch.equal(a, b[:3]) for r in runs[1:]
                   for a, b in zip(runs[0][:k], r[:k]))

    cases = ((3, 1), (5, 1), (3, 4), (5, 4))
    nuts = []
    for C, B in cases:
        monkeypatch.setattr(t_nuts, "_block_iters", B)
        nuts.append(tb.nuts_sample(2, lp, init[:C], n_warmup=20,
                                   n_samples=20, max_depth=5))
    assert same(nuts, 6)
    hmc = [tb.hmc_sample(2, lp, init[:C], n_warmup=20, n_samples=20,
                         num_leapfrog=6) for C in (3, 5)]
    assert same(hmc, 4)
    for cls in (tb.EllipticalSliceGLM, tb.HyperrectSliceGLM,
                tb.LatentSliceGLM, tb.QuantileSliceGLM):
        runs = []
        for C, B in cases:
            smp = cls(X, y, "binomial", prior)
            smp._block_iters = B
            st, betas, nev = smp.run(smp.init(4, C), 20)
            runs.append((st.beta, betas, nev))
        assert same(runs, 3), cls.__name__


def test_failed_capture_raises(cuda):
    """A pass that reads the device on the host cannot be captured: the
    loop raises instead of falling back to the eager loop.  (Last in the
    file: a refused capture leaves the stream's capture state behind.)"""
    graph, _ = _loop_engines("stepping_out", cuda)

    class HostReadingPrior(mt.IIDPrior):
        def coord_log_prob(self, beta, j, b):
            float(b.sum())  # a device read inside the pass
            return super().coord_log_prob(beta, j, b)

    from mcmcglm_tpu_torch.ops import freerun_automaton as fa

    graph.prior = HostReadingPrior(mt.Normal(0, 1), graph.d)
    fa.configure_pass(graph)  # a redefined density keeps the PyTorch pass
    assert graph.pass_impl == "torch"
    st = graph.init(0, 8)
    with pytest.raises(RuntimeError):
        graph.run(st, 1)
