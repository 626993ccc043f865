"""The pooled monitor of BASELINE config 5 on the CPU: ``run_thinned`` at
thin=1 as one ``run`` call with its draws folded at once, the batched
fold of moments and ESS state, the monitor's spans, the merged summaries
of a two-rank "gloo" chain mesh against the plain float64 reference
(``benchmark/reference/pooled_monitor.py``), and the benchmark's readers
of the monitor's spans (``monitor_pct``, ``merge_ms``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402
import torch_pooled_cases as cases  # noqa: E402
from benchmark import spec  # noqa: E402
from benchmark.reference import pooled_monitor  # noqa: E402
from mcmcglm_tpu_torch.parallel import pooled  # noqa: E402
from mcmcglm_tpu_torch.parallel.launch import run_local  # noqa: E402
from mcmcglm_tpu_torch.utils import profiling  # noqa: E402

F64 = torch.float64
# the merged float32 summaries against the float64 reference, two ranks
# of 8 chains, d=8, 64 draws a chain: sound runs read 1e-8-1e-7 on the
# mean (in sds), the variance, R-hat and the ESS (relative), float32's
# rounding of the folds and of the streamed sums; the moments folded in
# bfloat16 read 1e-3 and more
TOL = {"mean": 1e-5, "var": 1e-5, "rhat": 1e-5, "ess": 1e-4}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def engine():
    X, y = cases.problem()
    return mt.FreeRunCGGibbs(X, y, "binomial",
                             mt.IIDPrior(mt.Normal(0.0, 1.0), cases.D),
                             tuning=cases.QUANTILE, slice_kernel="quantile",
                             spec_k=4, device="cpu")


@pytest.fixture(scope="module")
def warm(engine):
    st, _, _ = engine.warmup(engine.init(3, 6), 10)
    return st


def _welford(draws, dtype=F64):
    C, K, d = draws.shape
    m = pooled.init_moments(C, d, dtype, device="cpu")
    m = m._replace(count=torch.zeros(C, dtype=dtype))
    for k in range(K):
        m = pooled.update_moments(m, draws[:, k].to(dtype))
    return m


def _streamed(draws, planned, max_lag, dtype=F64):
    C, K, d = draws.shape
    st = pooled.init_ess(C, d, planned, max_lag, dtype=dtype, device="cpu")
    for k in range(K):
        st = pooled.update_ess(st, draws[:, k].to(dtype))
    return st


# -- the batched folds ------------------------------------------------------


@pytest.mark.parametrize("planned,max_lag,blocks", [
    (32, 64, [32]), (33, 64, [5, 11, 17]), (40, 8, [3, 17, 20]),
    (7, 64, [1] * 7), (200, 64, [50, 51, 99]), (31, 16, [16, 15])])
def test_update_ess_block_is_a_loop_of_update_ess(planned, max_lag, blocks):
    """Blocks of consecutive draws, within a half, across the middle draw
    of an odd collection and across the halves, leave the state that one
    update per draw leaves (float64, the sums' order aside)."""
    gen = torch.Generator().manual_seed(planned)
    xs = torch.randn(3, planned, 4, dtype=F64, generator=gen).cumsum(1)
    want = _streamed(xs, planned, max_lag)
    got = pooled.init_ess(3, 4, planned, max_lag, dtype=F64, device="cpu")
    k = 0
    for b in blocks:
        got = pooled.update_ess_block(got, xs[:, k:k + b])
        k += b
    for name in ("s", "ring", "first", "total"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert int(got.count) == int(want.count) == planned
    np.testing.assert_allclose(pooled.ess_from_state(got).numpy(),
                               pooled.ess_from_state(want).numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("per_chain", [False, True])
def test_fold_moments_is_welford(per_chain):
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn(5, 40, 3, dtype=F64, generator=gen) + 2.0
    want = _welford(xs)
    got = pooled.init_moments(5, 3, F64, device="cpu")
    if per_chain:
        got = got._replace(count=torch.zeros(5, dtype=F64))
    for a, b in ((0, 7), (7, 30), (30, 40)):
        got = pooled.fold_moments(got, xs[:, a:b])
    np.testing.assert_allclose(got.mean.numpy(), want.mean.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(got.m2.numpy(), want.m2.numpy(), rtol=1e-11)
    assert got.count.shape == ((5,) if per_chain else ())
    assert (got.count == 40.0).all()


# -- run_thinned at thin=1 ----------------------------------------------------


def test_thin_one_is_one_run(engine, warm):
    """Every draw kept, bitwise those of one ``run(state, n_outer)``; the
    counter at each kept draw is the run's; the last draw is the final
    state; the moments and ESS state are those of one update per draw,
    to float32 rounding."""
    st_r, d_r, n_r = engine.run(warm, 24)
    st, mom, kept, nev, es, nev_at = engine.run_thinned(
        warm, 24, 1, ess=True, ess_max_lag=64, nev_at_draws=True)
    assert all(torch.equal(a, b) for a, b in zip(st, st_r))
    assert torch.equal(kept, d_r) and torch.equal(nev_at, n_r)
    assert torch.equal(kept[:, -1], st.beta) and torch.equal(nev, st.nev)
    assert nev_at.shape == (6, 24)
    ref = _welford(kept, torch.float32)
    np.testing.assert_allclose(mom.mean.numpy(), ref.mean.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mom.m2.numpy(), ref.m2.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert (mom.count == 24.0).all()
    ref_es = _streamed(kept, 24, 64, torch.float32)
    assert es.s.shape[2] == 12 and int(es.count) == 24
    for name in ("s", "ring", "first", "total"):
        np.testing.assert_allclose(getattr(es, name).numpy(),
                                   getattr(ref_es, name).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_thin_one_moments_carry_over_calls(engine, warm):
    st, mom, k1, _ = engine.run_thinned(warm, 10, 1)
    st, mom, k2, _ = engine.run_thinned(st, 14, 1, moments=mom)
    every = torch.cat([k1, k2], 1).double().numpy()
    np.testing.assert_allclose(mom.mean.numpy(), every.mean(1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mom.m2.numpy() / 23.0, every.var(1, ddof=1),
                               rtol=1e-4, atol=1e-7)


def test_thinned_unpacking_and_counters(engine, warm):
    """The callers' unpacking is unchanged without ``nev_at_draws``; at
    thin > 1 the counter at each kept draw is the last of its block's."""
    assert len(engine.run_thinned(warm, 3, 1)) == 4
    assert len(engine.run_thinned(warm, 3, 2, ess=True)) == 5
    st, mom, kept, nev, es, nev_at = engine.run_thinned(
        warm, 3, 2, ess=True, nev_at_draws=True)
    s2, cols = warm, []
    for _ in range(3):
        s2, _, nb = engine.run(s2, 2)
        cols.append(nb[:, -1])
    assert torch.equal(nev_at, torch.stack(cols, 1))
    assert torch.equal(nev_at[:, -1], nev.to(nev_at.dtype))


def test_thin_one_records_one_call_and_the_fold_beside_it(engine, warm):
    engine.run_thinned(warm, 12, 1, ess=True)
    got = profiling.spans()
    calls = [s for s in got if s["id"] == s["call"]]
    assert [s["name"] for s in calls] == ["freerun.run", "pooled.fold"]
    run, fold = calls
    assert run["args"] == {"C": 6, "n_sweeps": 12}
    assert fold["args"] == {"C": 6, "n_draws": 12}
    # beside the call, never inside it
    assert fold["parent"] is None and fold["t0"] >= run["t1"]
    assert not any(s["name"].startswith("pooled.") for s in got
                   if s["call"] == run["id"])


def test_thin_two_keeps_a_call_per_kept_draw(engine, warm):
    engine.run_thinned(warm, 3, 2)
    calls = [s["name"] for s in profiling.spans() if s["id"] == s["call"]]
    assert calls == ["freerun.run", "pooled.fold"] * 3


def test_synced_span_off_and_on():
    with profiling.synced_span("pooled.merge", "cpu", bytes=8,
                               ranks=2) as sp:
        assert sp is not None
    (got,) = profiling.spans()
    assert got["name"] == "pooled.merge" and got["args"] == {"bytes": 8,
                                                             "ranks": 2}
    assert got["dev_us"] is None and got["t1"] >= got["t0"]
    profiling.set_span_recording(False)
    with profiling.synced_span("pooled.merge", "cpu") as sp:
        assert sp is None


# -- two ranks over gloo ------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    return run_local(cases.monitor_world, 2, device_type="cpu",
                     timeout=300.0)


def _reference(draws):
    x = torch.as_tensor(draws)
    ref = {k: v.numpy() for k, v in pooled_monitor.summary(x).items()}
    ref["ess"] = pooled_monitor.ess(x[:, -cases.SWEEPS:], cases.LAG).numpy()
    return ref


def test_merged_summaries_match_the_reference(world):
    """Both ranks merge the same summaries of all 16 chains; they match
    the float64 reference on the gathered draws (the pooled mean,
    variance and R-hat of both steps' 64 draws a chain, the ESS of the
    last step's 32) within ``TOL``."""
    r0, r1 = world
    assert r0["draws"].shape == (cases.C, cases.STEPS * cases.SWEEPS,
                                 cases.D)
    np.testing.assert_array_equal(r0["count"], np.full(cases.C, 64.0))
    for k in r0["summ"]:
        np.testing.assert_array_equal(r0["summ"][k], r1["summ"][k])
    gaps = pooled_monitor.gaps(r0["summ"], _reference(r0["draws"]))
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


def test_bfloat16_fold_fails_the_tolerances(world):
    """The control: the same draws folded in bfloat16 fall outside at
    least one tolerance."""
    r0 = world[0]
    gaps = pooled_monitor.gaps(r0["summ_bf16"], _reference(r0["draws"]))
    assert any(gaps[k] > TOL[k] for k in gaps), gaps


def test_thin_one_on_the_mesh_is_one_run(world):
    for r in world:
        assert r["as_run"] and r["last_is_state"] and r["nev_is_state"]
        assert r["es_count"] == cases.SWEEPS


def test_merge_spans_and_counter(world):
    """One step's spans: the run's call, the fold beside it, a
    ``pooled.merge`` per gathered tensor with its bytes and the ranks
    (the moments' count, mean, m2, then the ESS state's s, ring, first,
    total), and a ``pooled.summary`` after each merge."""
    for r in world:
        names = [n for n, top, *_ in r["spans"] if top]
        assert names == (["freerun.run", "pooled.fold"]
                         + ["pooled.merge"] * 3 + ["pooled.summary"]
                         + ["pooled.merge"] * 4 + ["pooled.summary"])
        merges = [a for n, _, a, *_ in r["spans"] if n == "pooled.merge"]
        assert [a["bytes"] for a in merges] == r["sizes"]
        assert all(a["ranks"] == 2 for a in merges)
        assert r["counts"] == {"gathers": 7, "bytes_sent": sum(r["sizes"]),
                               "bytes_received": 2 * sum(r["sizes"])}


# -- the benchmark's readers of the monitor's spans ---------------------------


class _Hand:
    def __init__(self, **fields):
        self.fields = fields

    def as_dict(self):
        return dict(self.fields)


def _row(name, sid, t0, t1, *, args=None, call=None, profiled=False):
    call = sid if call is None else call
    return dict(name=name, id=sid, parent=None if call == sid else call,
                call=call, args=args or {}, t0=t0, t1=t1, dev0=None,
                dev1=None, dev_us=None, gap_us=None, prev=None,
                profiled=profiled)


def _monitor_rows(steps, fold_us=300, merge_us=(1000, 2000), sum_us=100):
    """A warm step before the window, then ``steps`` window steps: a
    ``freerun.run`` call of 32 sweeps (with a replay inside) and its
    monitor spans; then a profiled ``run_passes``.  Times in ns."""
    rows, sid, t = [], 1, 0
    for k in range(steps + 1):
        rows.append(_row("freerun.run", sid, t, t + 4_000_000,
                         args={"C": 8, "n_sweeps": 32}))
        rows.append(_row("loop.replay", sid + 1, t + 10, t + 20,
                         args={"B": 32}, call=sid))
        t += 4_000_000
        sid += 2
        for name, us in ([("pooled.fold", fold_us)]
                         + [("pooled.merge", u) for u in merge_us]
                         + [("pooled.summary", sum_us)]):
            rows.append(_row(name, sid, t, t + 1_000 * us))
            t += 1_000 * us
            sid += 1
    rows.append(_row("freerun.run_passes", sid, t, t + 10, profiled=True))
    rows.append(_row("pooled.merge", sid + 1, t, t + 10**9, profiled=True))
    return rows


def _read(name, rec):
    return spec.load_file(spec.ROOT / "metrics" / f"{name}.py").read(rec)


def _rec(sweeps, seconds):
    return {"window": {"seconds": seconds, "sweeps": sweeps, "evals": 0},
            "work": {"chunk_sweeps": 32}}


def test_monitor_readers(monkeypatch):
    rec = profiling.Recorder()
    rec.ring.extend(_Hand(**r) for r in _monitor_rows(3))
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    r = _rec(sweeps=96, seconds=13.0)
    # the three window steps' 3.4 ms each, of 13 s; the warm step's and
    # the profiled spans left out
    assert _read("monitor_pct", r) == pytest.approx(100 * 3 * 3.4e-3 / 13.0)
    assert _read("merge_ms", r) == pytest.approx(3.0)


def test_monitor_readers_read_none_without_the_spans(monkeypatch):
    rows = [s for s in _monitor_rows(3) if not s["name"].startswith("pooled.")]
    rec = profiling.Recorder()
    rec.ring.extend(_Hand(**r) for r in rows)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    r = _rec(sweeps=96, seconds=13.0)
    assert _read("monitor_pct", r) is None and _read("merge_ms", r) is None
    # a window whose calls spans.window cannot find (the sweeps differ)
    rec.ring.clear()
    rec.ring.extend(_Hand(**r) for r in _monitor_rows(3))
    r = _rec(sweeps=90, seconds=13.0)
    assert _read("monitor_pct", r) is None and _read("merge_ms", r) is None
    monkeypatch.delattr(profiling, "spans")  # a program without a recorder
    assert _read("monitor_pct", _rec(96, 13.0)) is None
