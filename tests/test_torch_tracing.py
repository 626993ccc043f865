"""The port's span recorder (``mcmcglm_tpu_torch.utils.profiling``) and the
benchmark's readers of it, on the CPU.

The spans of an eager run and warmup form one tree per engine call; the
recorder switched off records nothing and changes no draw; the ring keeps
the newest spans and counts what it drops; the graph loop adds the launch
counts of its replays once per call; the five per-layer metrics that read
the spans (``benchmark/metrics/``) select the window's calls and compute
their figures on a hand-built recorder, and read None in a tiny run of the
harness on the CPU, where nothing is timed on a card.  The card's side
(device intervals, their order and gaps, a sweep against CUDA events) is
in ``tests/test_torch_cuda.py``."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402
from benchmark import harness, spec  # noqa: E402
from benchmark.tests import tinyroot  # noqa: E402
from mcmcglm_tpu_torch.passloop import BlockLoop, new_stats  # noqa: E402
from mcmcglm_tpu_torch.utils import profiling  # noqa: E402

NEW_METRICS = ("replay_pass_us", "flag_gap_pct", "call_gap_pct",
               "idle_pass_pct", "fused_sweep_ms")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _problem(n=120, d=3):
    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    return X, rng.normal(X @ np.linspace(1.0, -0.5, d), 1.0)


def _freerun(**kw):
    X, y = _problem()
    return mt.FreeRunCGGibbs(X, y, "gaussian",
                             mt.IIDPrior(mt.Normal(0, 1), X.shape[1]),
                             extra={"sd": 1.0}, tuning={"w": 0.5}, spec_k=4,
                             device="cpu", **kw)


def _by_call(got):
    calls = {}
    for s in got:
        calls.setdefault(s["call"], []).append(s)
    return calls


@pytest.mark.parametrize("block_passes", [4, 32])
def test_span_tree_of_eager_run_and_warmup(block_passes):
    eng = _freerun()
    eng._block_passes = block_passes
    st = eng.init(3, 4)
    reads0 = eng.loop_stats["flag_reads"]
    st, _, _ = eng.warmup(st, 3)
    st, _, _ = eng.run(st, 2)
    got = profiling.spans()
    calls = _by_call(got)
    assert [c[0]["name"] for c in calls.values()] == ["freerun.warmup",
                                                      "freerun.run"]
    for members in calls.values():
        call = members[0]
        assert call["id"] == call["call"] and call["parent"] is None
        assert call["args"] == {"C": 4, "n_sweeps": 3 if "warmup" in
                                call["name"] else 2}
        inner = members[1:]
        assert inner and all(s["parent"] == call["id"] for s in inner)
        names = [s["name"] for s in inner]
        # one replay then its flag read, block after block
        assert names == ["loop.replay", "loop.flag_read"] * (len(inner) // 2)
        for s in inner:
            assert call["t0"] <= s["t0"] <= s["t1"] <= call["t1"]
            assert s["dev0"] is s["dev1"] is s["dev_us"] is None
            assert not s["profiled"]
        assert all(s["args"] == {"B": block_passes} for s in inner[::2])
    replays = [s for s in got if s["name"] == "loop.replay"]
    assert len(replays) == eng.loop_stats["flag_reads"] - reads0
    assert len({s["id"] for s in got}) == len(got)
    assert profiling.dropped_spans() == 0


def test_fused_run_records_a_sweep_span_per_sweep():
    X, y = _problem()
    eng = mt.FusedCGGibbs(X, y, "gaussian",
                          mt.IIDPrior(mt.Normal(0, 1), X.shape[1]),
                          extra={"sd": 1.0}, tuning={"w": 0.5},
                          granularity="coord", device="cpu")
    eng.run(eng.init(0, 8), 3)
    call, *sweeps = profiling.spans()
    assert call["name"] == "fused.run"
    assert call["args"] == {"C": 8, "n_sweeps": 3}
    assert [s["name"] for s in sweeps] == ["fused.sweep"] * 3
    assert all(s["call"] == s["parent"] == call["id"] for s in sweeps)


def test_recorder_off_records_nothing_and_draws_the_same():
    out = []
    for on in (True, False):
        profiling.reset_spans()
        profiling.set_span_recording(on)
        eng = _freerun()
        st = eng.init(5, 4)
        st, _, _ = eng.warmup(st, 2)
        st, draws, nev = eng.run(st, 3)
        st2, sc, dr, nb = eng.run_passes(st, None, None, None, 2, 40)
        out.append((draws, nev, dr, nb, st2.beta, len(profiling.spans())))
    (*on, n_on), (*off, n_off) = out
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert n_on > 0 and n_off == 0


def test_ring_drops_the_oldest_and_counts_them():
    profiling.reset_spans(capacity=5)
    for i in range(12):
        with profiling.span("s", i=i):
            pass
    got = profiling.spans()
    assert [s["args"]["i"] for s in got] == list(range(7, 12))
    assert profiling.dropped_spans() == 7
    profiling.set_span_recording(False)
    with profiling.span("s") as sp:
        assert sp is None
    assert profiling.dropped_spans() == 7 and len(profiling.spans()) == 5


class _Replayed:
    """A stand-in for a captured block on the CPU: a replay adds one to
    the static counter and sets the flag (go while the counter is below
    ``stop``; ``bad`` in the last block)."""

    def __init__(self, static, flag, stop, bad=0):
        self.static, self.flag, self.stop, self.bad = static, flag, stop, bad

    def replay(self):
        self.static[0] += 1
        go = int(self.static[0]) < self.stop
        self.flag.copy_(torch.tensor([int(go), 0 if go else self.bad]))


class _Event:
    """A timing event at a known device time (ms), complete."""

    def __init__(self, ms):
        self.ms = ms

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.ms - self.ms


class _Stream:
    device_index = 0


@pytest.mark.parametrize("latencies_us", [(5, 40, 5), (60, 5, 10),
                                          (8, 8, 30)])
def test_call_sits_at_the_tightest_flag_read(latencies_us):
    """A free-running call's replays are placed on the host clock by the
    flag read that bounds them most tightly: each replay ends at or before
    its own read's host return, and the replay whose read returned soonest
    after its end (the device's times known here) ends exactly at it."""
    rec = profiling.recorder()
    rec._pool[0] = []  # the events' pool, which timing_event makes
    host0 = 10_000_000  # ns: the device's time 0 on the host clock
    ends_ms = (0.2, 0.5, 0.8)
    with profiling.span("freerun.run", C=4, n_sweeps=1):
        for end, lat in zip(ends_ms, latencies_us):
            ev = (_Event(end - 0.1), _Event(end))
            sp = rec.add("loop.replay", 0, 0, {"B": 8}, _Stream(), ev)
            ret = host0 + round(1e6 * end) + 1_000 * lat
            rec.add("loop.flag_read", ret - 500, ret, {})
            rec.anchor(sp, ret)
    got = profiling.spans()
    reps = [s for s in got if s["name"] == "loop.replay"]
    reads = [s for s in got if s["name"] == "loop.flag_read"]
    slack = [f["t1"] - r["dev1"] for r, f in zip(reps, reads)]
    assert min(slack) == 0 and all(v >= 0 for v in slack)
    # the tightest read is the one of least latency: every replay is
    # placed that latency late, and no later
    best = min(latencies_us)
    for r, end in zip(reps, ends_ms):
        assert r["dev1"] - (host0 + round(1e6 * end)) == \
            pytest.approx(1_000 * best, abs=2)


@pytest.mark.parametrize("bad", [0, 2])
def test_graph_loop_adds_launch_counts_once_per_call(bad):
    """The graph loop adds each replay's launches (the capture's deltas)
    times the replays, once per call, also when the last read raises."""
    counts = {"k": 5, "other": 0}
    stats = new_stats()
    loop = BlockLoop(None, passes=4, graph=True, counters=[counts],
                     stats=stats)
    static = [torch.zeros((), dtype=torch.int64)]
    flag = torch.zeros(2, dtype=torch.int64)
    loop._g = (_Replayed(static, flag, stop=6, bad=bad), static, flag,
               [{"k": 3, "other": 0}])
    if bad:
        with pytest.raises(RuntimeError, match="Marsaglia-Tsang"):
            loop(None, (torch.zeros((), dtype=torch.int64),))
    else:
        (out,) = loop(None, (torch.zeros((), dtype=torch.int64),))
        assert int(out) == 6
    assert stats["flag_reads"] == 6 and "blocks" not in stats
    assert counts == {"k": 5 + 3 * 6, "other": 0}
    reps = [s for s in profiling.spans() if s["name"] == "loop.replay"]
    assert len(reps) == 6 and all(s["args"] == {"B": 4} for s in reps)


# -- the benchmark's readers on a hand-built recorder ----------------------


class _Hand:
    """A span as the recorder reads it out."""

    def __init__(self, **fields):
        self.fields = fields

    def as_dict(self):
        return dict(self.fields)


def _hand_recorder(monkeypatch, rows):
    rec = profiling.Recorder()
    rec.ring.extend(_Hand(**r) for r in rows)
    monkeypatch.setattr(profiling, "_RECORDER", rec)


def _row(name, sid, call, *, args=None, dev_us=None, gap_us=None, prev=None,
         profiled=False):
    return dict(name=name, id=sid, parent=None if sid == call else call,
                call=call, args=args or {}, t0=sid, t1=sid + 1, dev0=None,
                dev1=None, dev_us=dev_us, gap_us=gap_us, prev=prev,
                profiled=profiled)


def _freerun_rows(calls, profiled_after=True):
    """Call spans of ``freerun.run`` with (n_sweeps, [(B, dev_us, gap_us)])
    each, device spans chained through ``prev``; then a profiled run and
    an unprofiled ``run_passes`` (neither is a window call)."""
    rows, sid, prev = [], 1, None
    for n_sweeps, reps in calls:
        call = sid
        rows.append(_row("freerun.run", call, call,
                         args={"C": 8, "n_sweeps": n_sweeps}))
        sid += 1
        for B, dev_us, gap_us in reps:
            rows.append(_row("loop.replay", sid, call, args={"B": B},
                             dev_us=dev_us, gap_us=gap_us, prev=prev))
            rows.append(_row("loop.flag_read", sid + 1, call))
            prev, sid = sid, sid + 2
    if profiled_after:
        rows.append(_row("freerun.run", sid, sid, args={"n_sweeps": 2},
                         profiled=True))
        rows.append(_row("freerun.run_passes", sid + 1, sid + 1,
                         args={"n_sweeps": 2}))
    return rows


def _read(name, rec):
    return spec.load_file(spec.ROOT / "metrics" / f"{name}.py").read(rec)


def _rec(sweeps, chunk, seconds, passes=None):
    window = {"seconds": seconds, "sweeps": sweeps, "evals": 0}
    if passes is not None:
        window["passes"] = passes
    return {"window": window, "work": {"chunk_sweeps": chunk}}


def test_readers_select_the_window_and_compute(monkeypatch):
    # a warm call before the window, then two window calls of 2 sweeps
    calls = [(2, [(32, 900.0, 5.0)]),
             (2, [(32, 1000.0, 40.0), (32, 1100.0, 20.0), (32, 1200.0, 30.0)]),
             (2, [(32, 1300.0, 60.0), (32, 1400.0, 10.0)])]
    _hand_recorder(monkeypatch, _freerun_rows(calls))
    rec = _rec(sweeps=4, chunk=2, seconds=0.01, passes=150)
    assert _read("replay_pass_us", rec) == pytest.approx(
        6000.0 / (5 * 32))
    # gaps inside a call: 20 + 30 and 10 us, of a 10,000 us window
    assert _read("flag_gap_pct", rec) == pytest.approx(100 * 60 / 1e4)
    # the second window call's first replay: 60 us
    assert _read("call_gap_pct", rec) == pytest.approx(100 * 60 / 1e4)
    assert _read("idle_pass_pct", rec) == pytest.approx(
        100 * (160 - 150) / 160)
    assert _read("fused_sweep_ms", rec) is None  # not a fused window


def test_readers_check_the_window_sweeps(monkeypatch):
    calls = [(2, [(32, 1000.0, 40.0)]), (3, [(32, 1000.0, 10.0)])]
    _hand_recorder(monkeypatch, _freerun_rows(calls))
    rec = _rec(sweeps=4, chunk=2, seconds=0.01, passes=60)
    for name in NEW_METRICS:
        assert _read(name, rec) is None, name


def test_readers_need_device_times(monkeypatch):
    calls = [(2, [(32, None, None)]), (2, [(32, None, None)])]
    _hand_recorder(monkeypatch, _freerun_rows(calls))
    rec = _rec(sweeps=4, chunk=2, seconds=0.01, passes=60)
    for name in NEW_METRICS:
        assert _read(name, rec) is None, name


def test_fused_readers(monkeypatch):
    rows, prev = [], None
    for call, sweeps in ((1, (44_000.0, 45_000.0)),
                         (4, (43_000.0, 46_000.0))):
        rows.append(_row("fused.run", call, call,
                         args={"C": 8, "n_sweeps": 2}))
        for k, dev_us in enumerate(sweeps):
            rows.append(_row("fused.sweep", call + 1 + k, call,
                             dev_us=dev_us, gap_us=100.0 * (call + k),
                             prev=prev))
            prev = call + 1 + k
    rows.append(_row("fused.run", 7, 7, args={"n_sweeps": 2}, profiled=True))
    _hand_recorder(monkeypatch, rows)
    rec = _rec(sweeps=4, chunk=2, seconds=0.2)
    assert _read("fused_sweep_ms", rec) == pytest.approx(178.0 / 4)
    assert _read("call_gap_pct", rec) == pytest.approx(100 * 400.0 / 2e5)
    for name in ("replay_pass_us", "flag_gap_pct", "idle_pass_pct"):
        assert _read(name, rec) is None, name


def test_readers_without_the_recorder(monkeypatch):
    """A program without ``spans()`` (the parent's) reads None."""
    monkeypatch.delattr(profiling, "spans")
    rec = _rec(sweeps=4, chunk=2, seconds=0.01, passes=60)
    for name in NEW_METRICS:
        assert _read(name, rec) is None, name


@pytest.mark.parametrize("cell", ["tiny_logit.freerun", "tiny_logit.fused"])
def test_tiny_harness_run_reads_no_device_metric(tmp_path, cell):
    root = tinyroot.tiny_root(tmp_path)
    line, _, _ = harness.run_cell(cell, 2**31 + 7, 0.3, True, "cpu",
                                  t_start=time.perf_counter(), root=root)
    assert "evals_per_coord" in line["metrics"]
    assert not set(NEW_METRICS) & set(line["metrics"])
    calls = [s for s in profiling.spans()
             if s["name"] in ("freerun.run", "fused.run")
             and not s["profiled"]]
    assert calls and all(s["dev_us"] is None for s in profiling.spans())
