"""The port's pass loop: blocks of passes with one host read each, on the
counter-based Philox stream (the mirror of tests/test_freerun_spec.py:662
and the run_passes tests of tests/test_freerun_latent.py,
test_freerun_elliptical.py, test_freerun_doubling.py and
test_freerun_conjugate.py, for every block length).

A pass in which every lane is idle must change nothing, not even the
stream's pass index: that is what lets a block of passes run past the
quota, and it makes a run bitwise independent of the block length."""

import gc
import math
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import scipy.stats as sps  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch import freerun  # noqa: E402
from mcmcglm_tpu_torch.ops.philox import key_tensor, pass_uniforms  # noqa: E402
from mcmcglm_tpu_torch.utils import profiling  # noqa: E402

SAMPLERS = {
    "stepping_out": dict(tuning={"w": 0.5}, spec_k=4),
    "quantile": dict(slice_kernel="quantile", spec_k=4,
                     tuning={"pseudo_scale": 2.0, "pseudo_adapt": True,
                             "pseudo_c": 3.0}),
    "latent": dict(slice_kernel="latent", tuning={"rate": 0.5}, spec_k=2),
    "elliptical": dict(slice_kernel="elliptical",
                       tuning={"mu": 0.0, "sigma": 2.0}),
    "genelliptical": dict(slice_kernel="genelliptical", spec_k=3,
                          tuning={"mu": 0.0, "sigma": 2.0, "df": 5.0}),
    "doubling": dict(slice_kernel="doubling", tuning={"w": 0.2}),
    "conjugate": dict(coord_sampler="conjugate"),
}


def _engine(name, block_passes=None, n=150, d=3):
    """An engine on blocks of ``block_passes`` passes (None: the default)."""
    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.linspace(1.0, -0.5, d), 1.0)
    eng = mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Normal(0, 1), d),
                            extra={"sd": 1.0}, device="cpu", **SAMPLERS[name])
    if block_passes is not None:
        eng._block_passes = block_passes
    return eng


def _assert_states_equal(a, b):
    assert type(a) is type(b)
    for name, x, z in zip(a._fields, a, b):
        assert torch.equal(x, z), name


@pytest.mark.parametrize("B", [1, 3, 7, 64])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_run_passes_bitwise_matches_run(name, B):
    """Adaptive warmup, then sampling: ``run`` on the default blocks, and
    ``run_passes`` on blocks of B passes in calls of at most 33 passes,
    give the same draws, counts and state bitwise."""
    e1 = _engine(name)
    s1 = e1.init(7, 8)
    s1, _, _ = e1.warmup(s1, 4)
    s1, d1, n1 = e1.run(s1, 10)

    e2 = _engine(name, block_passes=B)
    s2 = e2.init(7, 8)
    s2, _, _ = e2.warmup(s2, 4)
    reads0 = e2.loop_stats["flag_reads"]
    profiling.reset_spans()
    sc = dr = nb = None
    for _ in range(10_000):
        s2, sc, dr, nb = e2.run_passes(s2, sc, dr, nb, 10, 33)
        if bool((sc >= 10).all()):
            break
    else:
        raise AssertionError("run_passes never completed")
    assert torch.equal(d1, dr) and torch.equal(n1, nb)
    _assert_states_equal(s1, s2)
    # the loop read one flag per block
    replays = [s for s in profiling.spans() if s["name"] == "loop.replay"]
    assert e2.loop_stats["flag_reads"] - reads0 == len(replays) > 0


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_warmup_passes_bitwise_matches_warmup(name):
    e1 = _engine(name)
    s1 = e1.init(5, 8)
    s1, _, _ = e1.warmup(s1, 6)
    e2 = _engine(name, block_passes=3)
    s2 = e2.init(5, 8)
    sc = torch.zeros(8, dtype=torch.int32)
    for _ in range(10_000):
        s2, sc = e2.warmup_passes(s2, sc, 6, 29)
        if bool((sc >= 6).all()):
            break
    else:
        raise AssertionError("warmup_passes never completed")
    _assert_states_equal(s1, s2)


@pytest.mark.parametrize("idle", ["quota", "budget"])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_all_idle_pass_is_the_identity(name, idle):
    """Every lane idle (sweep quota filled, or the pass budget spent):
    state, buffers and the stream's pass index stay bitwise as they were."""
    eng = _engine(name)
    st = eng.init(1, 8)
    st, _, _ = eng.warmup(st, 2)
    st, _, _, _ = eng.run_passes(st, None, None, None, 50, 5)  # mid-coord
    gen = torch.Generator().manual_seed(0)
    draws = torch.randn(8, 3, eng.d, generator=gen)
    nevbuf = torch.randint(0, 99, (8, 3), generator=gen, dtype=torch.int32)
    if idle == "quota":
        sc, live = torch.tensor([3, 4, 3, 5, 3, 3, 9, 3], dtype=torch.int32), None
    else:
        sc, live = torch.zeros(8, dtype=torch.int32), torch.tensor(False)
    d0, n0, sc0 = draws.clone(), nevbuf.clone(), sc.clone()
    step = eng._step_fn()
    for adapt in (False, True):
        out, sc2, dr2, nb2 = step(eng, st, sc, draws, nevbuf, 3, adapt,
                                  eng.shrink_only, None, live=live)
        _assert_states_equal(out, st)
        assert torch.equal(sc2, sc0) and torch.equal(dr2, d0)
        assert torch.equal(nb2, n0)


def test_pass_uniforms_depend_on_the_pass_index_only():
    key = key_tensor(123, "cpu")
    p0 = torch.tensor((1 << 32) - 2, dtype=torch.int64)  # crosses 2^32
    block = pass_uniforms(key, p0, 5, 6, 7)
    for i in range(5):
        one = pass_uniforms(key, p0 + i, 1, 6, 7)[0]
        assert torch.equal(block[i], one)
    assert not torch.equal(block[0], block[1])
    assert float(block.min()) > 0.0 and float(block.max()) < 1.0
    other = pass_uniforms(key_tensor(124, "cpu"), p0, 1, 6, 7)[0]
    assert not torch.equal(block[0], other)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 3.0])
def test_standard_gamma_law(alpha):
    """Marsaglia-Tsang on the Philox stream is Gamma(alpha, 1) exactly (KS
    against scipy), with no exhausted draw in 20,000."""
    u = pass_uniforms(key_tensor(9, "cpu"), torch.tensor(0), 1, 20_000,
                      2 * freerun._GAMMA_CANDIDATES + 1)[0]
    g = freerun.standard_gamma(alpha, u)
    assert bool(torch.isfinite(g).all()) and bool((g > 0).all())
    ks = sps.kstest(g.numpy(), "gamma", args=(alpha,))
    assert ks.pvalue > 1e-3, ks


def test_standard_gamma_exhaustion_is_nan_not_an_approximation():
    m = freerun._GAMMA_CANDIDATES
    u = torch.full((4, 2 * m + 1), 0.5)
    u[:2, :m] = 1e-12  # every normal score far below -1/c: v <= 0, rejected
    g = freerun.standard_gamma(3.0, u)
    assert bool(torch.isnan(g[:2]).all()) and bool(torch.isfinite(g[2:]).all())


def test_exhausted_gamma_raises_at_the_flag_read(monkeypatch):
    eng = _engine("genelliptical")
    st = eng.init(0, 8)
    monkeypatch.setattr(freerun, "standard_gamma",
                        lambda alpha, u: torch.full(u.shape[:-1], math.nan))
    with pytest.raises(RuntimeError, match="Marsaglia-Tsang"):
        eng.run(st, 2)
    with pytest.raises(RuntimeError, match="Marsaglia-Tsang"):
        eng.init(0, 8)


def test_validation():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 2))
    y = rng.normal(size=20)
    prior = mt.IIDPrior(mt.Normal(0, 1), 2)

    def make(**kw):
        return mt.FreeRunCGGibbs(X, y, "gaussian", prior, device="cpu", **kw)

    with pytest.raises(ValueError, match="spec_k=1"):
        make(slice_kernel="doubling", tuning={"w": 0.5}, spec_k=4)
    with pytest.raises(ValueError, match="one-evaluation"):
        make(slice_kernel="doubling", tuning={"w": 0.5}, battery_impl="cuda3")
    with pytest.raises(ValueError, match="batteries"):
        make(coord_sampler="conjugate", battery_impl="cuda")
    with pytest.raises(ValueError, match="conjugate"):
        make(slice_kernel="latent", coord_sampler="conjugate")
    with pytest.raises(ValueError, match="sigma"):
        make(slice_kernel="elliptical")
    with pytest.raises(ValueError, match="df"):
        make(slice_kernel="genelliptical", tuning={"sigma": 1.0})
    eng = make(slice_kernel="doubling",
               tuning={"w": 0.5, "max_doublings": 500})
    assert eng.max_doublings == 60 and eng.spec_k == 1
    assert make(slice_kernel="latent").spec_k == 1  # latent needs no w
    with pytest.raises(ValueError, match="gaussian family"):
        mt.FreeRunCGGibbs(X, (y > 0).astype(float), "binomial", prior,
                          coord_sampler="conjugate", device="cpu")
    with pytest.raises(ValueError, match="independent normal"):
        mt.FreeRunCGGibbs(X, y, "gaussian", mt.IIDPrior(mt.Laplace(0, 1), 2),
                          coord_sampler="conjugate", device="cpu")


def test_engine_and_cached_loops_form_no_cycle():
    """A cached loop takes its engine per call and holds no reference to
    it, so a dropped engine (graphs, static carries and all) is freed at
    once, without the cycle collector."""
    eng = _engine("latent")
    eng._graph_loop = True  # cache the loop (building one captures nothing)
    eng._loop(8, 32, False, True, False, 10)
    assert len(eng._loops) == 1
    ref = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_graph_cache_is_bounded_and_keyed_without_the_quota():
    """The quota rides in the carry, so run lengths that share buffer
    shapes share one loop; the cache keeps the most recently used
    ``_MAX_GRAPHS`` loops."""
    eng = _engine("stepping_out")
    eng._graph_loop = True
    first = eng._loop(8, 32, True, False, True, None)
    assert eng._loop(8, 32, True, False, True, None) is first
    for slots in range(2 * freerun._MAX_GRAPHS):
        eng._loop(8, 32, False, True, False, slots)
        assert len(eng._loops) <= freerun._MAX_GRAPHS
    assert first not in eng._loops.values()
    recent = [k[-1] for k in eng._loops]
    assert recent == list(range(freerun._MAX_GRAPHS,
                                2 * freerun._MAX_GRAPHS))
