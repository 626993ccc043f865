"""The CUDA battery kernels and the engine on the card.

Every test here needs a CUDA GPU and skips elsewhere.  On the card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not have; this file imports neither JAX nor the JAX package).
``python3 chip_smoke.py`` runs the same checks at the main path's shapes.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (python3 chip_smoke.py runs these "
                    "checks on the card)")
    return torch.device("cuda")


FAMILY_EXTRA = {
    ("gaussian", "identity"): {"sd": 1.3},
    ("binomial", "logit"): {},
    ("poisson", "log"): {},
    ("negative.binomial", "log"): {"size": 2.5},
    ("Gamma", "log"): {"shape": 2.0},
    ("binomial", "cloglog"): {},
}


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
    elif fam.name == "Gamma":
        y = rand(n) * 3 + 0.05
    else:
        y = torch.floor(rand(n) * 5)
    Xt = randn(d, n) / math.sqrt(d)
    eta = 0.5 * randn(C, n)
    j = torch.randint(0, d, (C,), generator=g, device=device,
                      dtype=torch.int32)
    xg = Xt[j.long()].contiguous()
    deltas = 0.3 * randn(C, K)
    m = torch.where(rand(n) < 0.9, 1.0 + rand(n), torch.zeros(n, device=device))
    ld0 = fb.battery_sums(eta, xg, torch.zeros(C, 1, device=device), y, m,
                          fam, extra)[:, 0]
    scal = torch.stack([torch.log1p(-rand(C)), ld0, (rand(C) < 0.8).to(f32),
                        torch.randint(0, K + 1, (C,), generator=g,
                                      device=device).to(f32)], 1)
    return dict(y=y, Xt=Xt, eta=eta, j=j, xg=xg, deltas=deltas, m=m,
                fprior=0.5 * randn(C, K), scal=scal.contiguous())


@pytest.mark.parametrize("pair", list(FAMILY_EXTRA))
@pytest.mark.parametrize("C,n,K", [(1, 1, 1), (5, 257, 2), (64, 1003, 7),
                                   (33, 4099, 32)])
def test_kernels_match_plain(cuda, pair, C, n, K):
    fam = mt.check_family(pair[0]).with_link(pair[1])
    extra = FAMILY_EXTRA[pair]
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
    torch.cuda.synchronize()
    for k in fb.launch_counts:
        assert fb.launch_counts[k] == before[k] + 1
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
                        mt.check_family("inverse_gaussian"), {})


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
