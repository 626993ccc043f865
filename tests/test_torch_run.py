"""The port's run loops: pass-bounded runs are bitwise the same as whole
runs, and idle lanes freeze (the mirror of tests/test_freerun_spec.py:373,
:580, :610, :662 and tests/test_freerun_elliptical.py:337)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402


def _binomial(d=6, n=400, seed=5, **kw):
    X, y, _ = mt.generate_glm_data("binomial", n=n, d=d, seed=seed)
    return mt.FreeRunCGGibbs(
        X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), d),
        tuning=kw.pop("tuning", {"w": 0.5}), spec_k=kw.pop("spec_k", 4),
        device="cpu", **kw,
    )


@pytest.mark.parametrize("kernel", ["stepping_out", "quantile"])
def test_run_passes_bitwise_matches_run(kernel):
    kw = {} if kernel == "stepping_out" else dict(
        slice_kernel="quantile",
        tuning={"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0})
    fr1 = _binomial(**kw)
    st1 = fr1.init(7, 8)
    st1, _, _ = fr1.warmup(st1, 10)
    st1, draws1, nev1 = fr1.run(st1, 12)

    fr2 = _binomial(**kw)
    st2 = fr2.init(7, 8)
    st2, _, _ = fr2.warmup(st2, 10)
    sc, draws2, nb = None, None, None
    for _ in range(10_000):
        st2, sc, draws2, nb = fr2.run_passes(st2, sc, draws2, nb, 12, 37)
        if bool((sc >= 12).all()):
            break
    else:
        raise AssertionError("run_passes never completed")
    assert torch.equal(st1.beta, st2.beta)
    assert torch.equal(draws1, draws2)
    assert torch.equal(nev1, nb)
    # both consumed the same random numbers: the same passes drew
    assert torch.equal(st1.key, st2.key) and torch.equal(st1.ctr, st2.ctr)


def test_warmup_passes_bitwise_matches_warmup():
    fr1 = _binomial()
    st1 = fr1.init(7, 8)
    st1, _, _ = fr1.warmup(st1, 20)
    fr2 = _binomial()
    st2 = fr2.init(7, 8)
    sc = torch.zeros(8, dtype=torch.int32)
    for _ in range(10_000):
        st2, sc = fr2.warmup_passes(st2, sc, 20, 37)
        if bool((sc >= 20).all()):
            break
    else:
        raise AssertionError("warmup_passes never completed")
    for name in ("beta", "logw", "nev", "eta"):
        assert torch.equal(getattr(st1, name), getattr(st2, name)), name
    assert torch.equal(st1.ctr, st2.ctr)


def test_idle_lanes_do_not_burn_shrink_budget_across_boundaries():
    """After a chain fills its sweep quota it idles while slower chains
    finish; its automaton must freeze, or it resumes with an exhausted
    shrink budget and skips the first coordinate (the intercept).  Metric:
    the intercept move rate across 30 one-sweep run boundaries."""
    fr = _binomial(d=3, seed=1, max_shrink=16)
    st = fr.init(0, 256)
    st, _, _ = fr.warmup(st, 20)
    kept = []
    for _ in range(30):
        st, draws, _ = fr.run(st, 1)
        kept.append(draws.numpy())
    col0 = np.concatenate(kept, axis=1)[:, :, 0]
    move_rate = float((np.abs(np.diff(col0, axis=1)) > 0).mean())
    assert move_rate > 0.95, f"intercept move rate {move_rate:.3f}"


def test_idle_lanes_never_saturate_shrink_budget():
    """The persisted n_shrink register never reaches max_shrink: an active
    lane that would reach it exhaust-commits in the same pass, and idle
    lanes are frozen."""
    fr = _binomial(d=3, seed=1, max_shrink=8)
    st = fr.init(0, 256)
    st, _, _ = fr.warmup(st, 10)
    worst = 0
    for _ in range(10):
        st, _, _ = fr.run(st, 1)
        worst = max(worst, int(st.n_shrink.max()))
    assert worst < fr.max_shrink


@pytest.mark.parametrize("spec_k", [4, 1])
@pytest.mark.parametrize("kernel", ["stepping_out", "quantile"])
def test_scalar_cache_is_the_fresh_sum_of_the_committed_eta(kernel, spec_k):
    """On acceptance the cache takes the accepted proposal's FRESH sum,
    never ld0 + dll (whose f32 error random-walks per chain): with the
    plain battery that sum is bitwise the reduction of ld at the
    committed eta, on every lane after every pass."""
    kw = {} if kernel == "stepping_out" else dict(
        slice_kernel="quantile",
        tuning={"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0})
    fr = _binomial(d=3, n=300, seed=4, spec_k=spec_k, **kw)
    st = fr.init(0, 32)
    sc = torch.zeros(32, dtype=torch.int32)
    moved = 0
    for _ in range(60):
        prev = st.eta
        st, sc, _, _ = fr._run_pass_block(
            st, sc, n_sweeps=10**6, n_passes=1, adapt=True,
            shrink_only=False, stepout_sweeps=2)
        moved += int((st.eta != prev).any(1).sum())
        fresh = fr.reduce_fn(fr._ld_eta(st.eta, fr.y, fr.extra))
        assert torch.equal(st.ld0, fresh)
    assert moved > 0


def test_sweep_buffers_drop_writes_past_the_buffer():
    """The masked sweep write has the JAX drop-mode semantics: a lane
    writes slot sweep_count only when it completed a sweep and the slot
    exists."""
    C, S, d = 4, 2, 3
    draws = torch.zeros(C, S, d)
    nevbuf = torch.zeros(C, S, dtype=torch.int32)
    beta = torch.arange(C * d, dtype=torch.float32).reshape(C, d) + 1
    sc = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    done = torch.tensor([True, True, True, False])
    nev = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    mt.FreeRunCGGibbs._sweep_buffers(draws, nevbuf, sc, beta, nev, done)
    assert torch.equal(draws[0, 0], beta[0]) and torch.equal(draws[1, 1],
                                                             beta[1])
    assert draws[2].abs().sum() == 0 and draws[3].abs().sum() == 0
    assert nevbuf.tolist() == [[5, 0], [0, 6], [0, 0], [0, 0]]


def test_commit_row_is_scatter_semantics():
    rng = np.random.default_rng(5)
    C, d = 9, 7
    arr = torch.tensor(rng.normal(size=(C, d)), dtype=torch.float32)
    j = torch.tensor(rng.integers(0, d, C), dtype=torch.int32)
    val = torch.tensor(rng.normal(size=C), dtype=torch.float32)
    gate = torch.tensor(rng.integers(0, 2, C).astype(bool))
    want = arr.clone()
    want[torch.arange(C), j.long()] = val
    assert torch.equal(mt.FreeRunCGGibbs._commit_row(arr, j, val), want)
    want_g = arr.clone()
    rows = torch.nonzero(gate)[:, 0]
    want_g[rows, j.long()[rows]] = val[rows]
    got = mt.FreeRunCGGibbs._commit_row(arr, j, val, gate=gate)
    assert torch.equal(got, want_g)
    assert not torch.equal(arr, want)  # the input is left untouched
