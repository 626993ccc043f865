"""The port's fused engine against the JAX package's Pallas kernels.

On the CPU ``FusedCGGibbs`` runs the plain PyTorch versions
(``plain_fused_sweep`` / ``plain_fused_coord_update``); the JAX package's
``FusedCGGibbs`` runs ``make_fused_sweep`` / ``make_fused_coord_update``
in Pallas interpret mode.  The interpreter's PRNG returns zero bits, so
its uniforms are the clamp 1e-12; patching the module's ``_uniform`` to a
constant gives a deterministic run that exercises every branch.  The port
gets the same uniforms by patching its Philox stream, and both start from
the same state (``convert_fused_state``), at n=256 (no padding on the
JAX side), d=3, C=16.

Tolerances: evaluation counts exact; beta and eta within 1e-5.  beta is
not bitwise: XLA on the CPU may contract L + (R - L) u into an FMA, and
the JAX sweep writes beta through a one-hot contraction, b0 + (bnew -
b0), which rounds otherwise than bnew; over 3 sweeps these stay below
1e-6.  The CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu.fused import FusedCGGibbs as JaxFused  # noqa: E402
from mcmcglm_tpu.ops import pallas_cggibbs  # noqa: E402
from mcmcglm_tpu_torch.datagen import domain_data, example_extra  # noqa: E402
from mcmcglm_tpu_torch.ops import freerun_batteries as fb  # noqa: E402
from mcmcglm_tpu_torch.ops import fused_cggibbs as fc  # noqa: E402
from mcmcglm_tpu_torch.ops.philox import philox4x32, philox_uniform  # noqa: E402

C, N, D, SWEEPS = 16, 256, 3, 3
EXTRA = {"gaussian": {"sd": 1.3}, "binomial": {}, "poisson": {}}


def _problem(family, n=N, d=D, seed=1):
    X, y, _ = mg.generate_glm_data(family, n=n, d=d, seed=seed)
    return X, y


def _constant_stream(value):
    def uniform(seed, sweep, j, t, n_chains, device):
        return torch.full((t.numel(), n_chains), value, dtype=torch.float32,
                          device=device)
    return uniform


def _check_against_pallas(monkeypatch, X, y, fams, prior, extra, stream):
    """Both packages' fused engines on (X, y) at both granularities, from
    the same state and with the same uniforms; fams = (JAX family, port
    family), prior = (JAX distribution, port distribution)."""
    if stream == "zero_bits":
        # the interpreter's own PRNG: zero bits, clamped to 1e-12
        monkeypatch.setattr(fc, "philox_uniform",
                            _constant_stream(np.float32(1e-12)))
    else:
        monkeypatch.setattr(pallas_cggibbs, "_uniform",
                            lambda shape: jnp.full(shape, stream, jnp.float32))
        monkeypatch.setattr(fc, "philox_uniform", _constant_stream(stream))
    runs = {}
    for gran in ("sweep", "coord"):
        ej = JaxFused(X, y, fams[0], mg.IIDPrior(prior[0], D), extra=extra,
                      tuning={"w": 0.5}, granularity=gran)
        et = mt.FusedCGGibbs(X, y, fams[1], mt.IIDPrior(prior[1], D),
                             extra=extra, tuning={"w": 0.5},
                             granularity=gran, device="cpu")
        assert et.impl == "torch" and "not CUDA" in et.impl_reason
        sj = ej.init(jax.random.key(0), C)
        st = mt.convert_fused_state(sj, et)
        assert st.eta.shape == (C, N) and np.asarray(sj.eta).shape == (C, N)
        sj, betas_j, nev_j = ej.run(sj, SWEEPS)
        st, betas_t, nev_t = et.run(st, SWEEPS)
        np.testing.assert_array_equal(nev_t.numpy(), np.asarray(nev_j))
        np.testing.assert_allclose(betas_t.numpy(), np.asarray(betas_j),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(st.eta.numpy(), np.asarray(sj.eta),
                                   rtol=0, atol=1e-5)
        runs[gran] = (st, betas_t, nev_t)
    # the port's two granularities are one computation
    (s1, b1, n1), (s2, b2, n2) = runs["sweep"], runs["coord"]
    assert torch.equal(b1, b2) and torch.equal(n1, n2)
    assert torch.equal(s1.eta, s2.eta) and s1.sweep == s2.sweep == SWEEPS
    if stream != "zero_bits":  # the constant stream moves beta
        assert not torch.equal(b1[-1], b1[0])
    return b1


@pytest.mark.parametrize("stream", ["zero_bits", 0.37, 0.81])
@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson"])
def test_fused_engine_matches_pallas_interpret(monkeypatch, family, stream):
    X, y = _problem(family)
    _check_against_pallas(monkeypatch, X, y, (family, family),
                          (mg.Normal(0, 1), mt.Normal(0, 1)), EXTRA[family],
                          stream)


# the fifteen pairs of the kernels' composed route: (family, link) -> extra
COMPOSED = {p: example_extra(p) for p in fb.COMPOSED_PAIRS}


@pytest.mark.parametrize("pair", list(COMPOSED), ids="/".join)
def test_fused_composed_pairs_match_pallas_interpret(monkeypatch, pair):
    """The pairs of the composed route (the CUDA kernels' FAM_COMPOSED)
    through the port's plain fused updates against make_fused_sweep /
    make_fused_coord_update in interpret mode, with the uniforms 0.37."""
    X, y = domain_data(pair, N, D, seed=1)
    fams = (mg.check_family(pair[0]).with_link(pair[1]),
            mt.check_family(pair[0]).with_link(pair[1]))
    betas = _check_against_pallas(monkeypatch, X, y, fams,
                                  (mg.Gamma(2.0, 2.0), mt.Gamma(2.0, 2.0)),
                                  COMPOSED[pair], 0.37)
    assert torch.isfinite(betas).all()


# Random123's known answers for Philox4x32-10 (kat_vectors)
@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expect):
    assert tuple(int(w) for w in philox4x32(counter, key)) == expect


def test_philox_uniform_is_chain_local_and_maps_bits_like_the_tpu():
    u = philox_uniform(2**40 + 7, 5, 11, 3, 64, "cpu")
    w0 = philox4x32((5, 11, torch.arange(64), 3), (7, 2**8))[0]
    expect = torch.clamp((w0 >> 9).float() * 2.0**-23, min=1e-12)
    assert u.dtype == torch.float32 and torch.equal(u, expect)
    # chain c's draw does not depend on how many chains are drawn
    assert torch.equal(philox_uniform(2**40 + 7, 5, 11, 3, 8, "cpu"), u[:8])
    block = philox_uniform(2**40 + 7, 5, 11, torch.arange(5), 64, "cpu")
    assert block.shape == (5, 64) and torch.equal(block[3], u)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0


def _engine_inputs(family="binomial", C=16, n=300, d=5, seed=3):
    X, y = _problem(family, n=n, d=d, seed=seed)
    eng = mt.FusedCGGibbs(X, y, family, mt.IIDPrior(mt.Normal(0, 1), d),
                          extra=EXTRA[family], tuning={"w": 0.5},
                          device="cpu")
    return eng, eng.init(4, C)


def test_plain_sweep_is_a_loop_of_coord_updates():
    eng, st = _engine_inputs()
    fns = eng._plain_fns()
    kw = dict(seed=st.seed, sweep=6, w=0.5, block_chains=8)
    eta, beta, nev, margin = fc.plain_fused_sweep(
        st.eta, st.beta, eng.Xt, eng.y, **fns, **kw)
    eta2, beta2 = st.eta, st.beta.clone()
    nev2 = torch.zeros_like(nev)
    for j in range(eng.d):
        eta2, bj, nev_j, _ = fc.plain_fused_coord_update(
            eta2, beta2[:, j], eng.Xt[j], eng.y, j=j, **fns, **kw)
        beta2[:, j] = bj
        nev2 += nev_j
    assert torch.equal(eta, eta2) and torch.equal(beta, beta2)
    assert torch.equal(nev, nev2)
    assert bool((margin > 0).all())
    # the launchers on CPU tensors are the plain versions
    fam, dist = eng.family, eng.prior.dist
    out = fc.fused_sweep(st.eta, st.beta, eng.Xt, eng.y, fam, eng.extra, dist,
                         **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, (eta, beta, nev)))
    out = fc.fused_coord_update(st.eta, st.beta[:, 0].contiguous(), eng.Xt[0],
                                eng.y, fam, eng.extra, dist, j=0, **kw)
    ref = fc.plain_fused_coord_update(st.eta, st.beta[:, 0], eng.Xt[0], eng.y,
                                      j=0, **fns, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref[:3]))


def test_draws_do_not_depend_on_block_chains_but_counts_do():
    eng, st = _engine_inputs()
    fns = eng._plain_fns()
    out = {}
    for bc in (8, 16):
        eta, beta = st.eta, st.beta
        total = torch.zeros(16, dtype=torch.int32)
        for s in range(3):
            eta, beta, nev, _ = fc.plain_fused_sweep(
                eta, beta, eng.Xt, eng.y, **fns, seed=st.seed, sweep=s,
                w=0.5, block_chains=bc)
            total += nev
        out[bc] = (eta, beta, total)
    assert torch.equal(out[8][0], out[16][0])
    assert torch.equal(out[8][1], out[16][1])
    # the count is the block's: every chain of a block reports the same
    assert out[16][2].unique().numel() == 1
    assert out[8][2].view(2, 8).unique(dim=1).shape[1] == 1
    assert not torch.equal(out[8][2], out[16][2])
    assert bool((out[16][2] >= out[8][2]).all())


def test_block_chains_one_counts_each_chains_own_evaluations():
    """At block_chains=1 nev is each chain's own nL + nR + nShrink (the
    chain updated alone, on its own draws); at block_chains=8 it is the
    block's max nL + max nR + max nShrink, so at least the largest own
    count of the block, on the same draws."""
    eng, st = _engine_inputs()
    fns = eng._plain_fns()
    kw = dict(seed=st.seed, sweep=1, w=0.5)
    b0, x0 = st.beta[:, 0], eng.Xt[0]
    runs = {bc: fc.plain_fused_coord_update(st.eta, b0, x0, eng.y, j=0,
                                            block_chains=bc, **fns, **kw)
            for bc in (1, 8)}
    own = []
    for c in range(16):
        def chain_c(seed, sweep, j, t, n_chains, device, c=c):
            return philox_uniform(seed, sweep, j, t, 16, device)[:, c:c + 1]

        eta_c, b_c, nev_c, _ = fc.plain_fused_coord_update(
            st.eta[c:c + 1], b0[c:c + 1], x0, eng.y, j=0, block_chains=1,
            uniform_fn=chain_c, **fns, **kw)
        torch.testing.assert_close(b_c, runs[1][1][c:c + 1], rtol=0,
                                   atol=0)
        own.append(int(nev_c))
    own = torch.tensor(own, dtype=torch.int32)
    assert torch.equal(runs[1][2], own)
    # the same draws, so the same moves; one count per block, at least
    # the block's largest own count
    assert torch.equal(runs[8][0], runs[1][0])
    assert torch.equal(runs[8][1], runs[1][1])
    blocks = runs[8][2].view(2, 8)
    assert bool((blocks == blocks[:, :1]).all())
    assert bool((blocks[:, 0] >= own.view(2, 8).amax(1)).all())
    assert bool((runs[8][2] >= own).all())
    assert not torch.equal(runs[8][2], own)


def test_n_limit_is_the_reference_limit():
    """The port's fused engine takes exactly the n that the JAX package's
    takes: n padded to 128 within MAX_FUSED_N = 65,536."""
    assert fc.MAX_FUSED_N == pallas_cggibbs.MAX_FUSED_N == 65_536
    assert fc.ON_CHIP_N < fc.MAX_FUSED_N
    for n, ok in ((65_536, True), (65_537, False)):
        X = np.ones((n, 1), np.float32)
        y = np.zeros(n, np.float32)
        makers = (
            lambda: JaxFused(X, y, "gaussian", mg.IIDPrior(mg.Normal(0, 1), 1),
                             tuning={"w": 0.5}),
            lambda: mt.FusedCGGibbs(X, y, "gaussian",
                                    mt.IIDPrior(mt.Normal(0, 1), 1),
                                    tuning={"w": 0.5}, device="cpu"),
        )
        for make in makers:
            if ok:
                make()
            else:
                with pytest.raises(ValueError, match="exceeds"):
                    make()


def test_gaussian_conjugate_oracle_through_fused_sweep():
    rng = np.random.default_rng(0)
    n, d = 200, 3
    X = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    y = rng.normal(X @ np.array([1.0, 1.5, 2.0]), 1.0)
    eng = mt.FusedCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                          extra={"sd": 1.0}, tuning={"w": 0.5}, device="cpu")
    betas, nev, st = eng.sample(0, 300, n_chains=16, chunk_size=100)
    assert betas.shape == (16, 301, d) and nev.shape == (300,)
    post = betas[:, 101:, :].reshape(-1, d)
    prec = X.T @ X + np.eye(d)
    mu = np.linalg.solve(prec, X.T @ y)
    sd = np.sqrt(np.diag(np.linalg.inv(prec)))
    np.testing.assert_allclose(post.mean(0), mu, atol=float(6 * sd.max() / 50))
    np.testing.assert_allclose(post.std(0), sd, rtol=0.3)
    # eta is still X beta after 300 sweeps of incremental commits
    ref = st.beta.double() @ eng.Xt.double()
    assert float((st.eta.double() - ref).abs().max()) < 1e-4


def test_binomial_posterior_matches_freerun_engine():
    X, y, _ = mt.generate_glm_data("binomial", n=400, d=4, seed=2)
    prior = mt.IIDPrior(mt.Normal(0, 1), 4)
    fused = mt.FusedCGGibbs(X, y, "binomial", prior, tuning={"w": 0.5},
                            device="cpu")
    betas, _, _ = fused.sample(1, 240, n_chains=16)
    p_fused = betas[:, 41:, :].reshape(-1, 4)
    fr = mt.FreeRunCGGibbs(X, y, "binomial", prior, tuning={"w": 0.5},
                           device="cpu")
    st = fr.init(1, 16)
    st, _, _ = fr.warmup(st, 40)
    st, draws, _ = fr.run(st, 200)
    p_free = draws.numpy().reshape(-1, 4)
    sd = p_free.std(0)
    assert (np.abs(p_fused.mean(0) - p_free.mean(0)) / sd).max() < 0.15
    assert np.abs(p_fused.std(0) / sd - 1.0).max() < 0.15


class TestValidation:
    """The JAX package's FusedCGGibbs errors (tests/test_fused.py:60-71),
    and mcmcglm's eligibility rule for engine='fused'."""

    def _args(self):
        rng = np.random.default_rng(0)
        X = np.column_stack([np.ones(50), rng.normal(size=(50, 2))])
        return X, rng.normal(size=50)

    def test_engine_errors(self):
        X, y = self._args()
        prior = mt.IIDPrior(mt.Normal(0, 1), 3)

        class NotIID(mt.BetaPrior):
            d = 3

        with pytest.raises(ValueError, match="IIDPrior"):
            mt.FusedCGGibbs(X, y, "gaussian", NotIID(), tuning={"w": 0.5},
                            device="cpu")
        with pytest.raises(ValueError, match="w"):
            mt.FusedCGGibbs(X, y, "gaussian", prior, device="cpu")
        with pytest.raises(ValueError, match="granularity"):
            mt.FusedCGGibbs(X, y, "gaussian", prior, tuning={"w": 0.5},
                            granularity="block", device="cpu")
        with pytest.raises(TypeError, match="device"):
            mt.FusedCGGibbs(X, y, "gaussian", prior, tuning={"w": 0.5})
        eng = mt.FusedCGGibbs(X, y, "gaussian", prior, extra={"sd": 1.0},
                              tuning={"w": 0.5}, device="cpu")
        with pytest.raises(ValueError, match="multiple"):
            eng.init(0, 5)

    @pytest.mark.parametrize("kw,match", [
        (dict(slice_fn="elliptical"), "requires stepping_out"),
        (dict(n_chains=5), "requires stepping_out"),
        (dict(linear_predictor_calc="naive"), "requires stepping_out"),
        (dict(mesh=object()), "single-chip"),
        (dict(weights=np.ones(50)), "weights"),
    ])
    def test_mcmcglm_eligibility(self, kw, match):
        X, y = self._args()
        kw.setdefault("n_chains", 8)
        with pytest.raises(ValueError, match=match):
            mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="fused",
                       device="cpu", **kw)


def test_mcmcglm_engine_fused_on_cpu(readme_gaussian_data):
    X, y, _ = readme_gaussian_data
    fit = mt.mcmcglm(X=X, y=y, family="gaussian", w=0.5, engine="fused",
                     n_samples=60, burnin=10, n_chains=8, device="cpu")
    assert fit.beta.shape == (8, 61, 3)
    assert fit.n_evals.shape == (8, 60)
    post_mean = np.linalg.solve(X.T @ X + np.eye(3), X.T @ y)
    np.testing.assert_allclose(fit.post_burnin().reshape(-1, 3).mean(0),
                               post_mean, atol=0.05)
