"""Graph-capture modes of the free-running pass: the same block of passes,
captured several times from one state, timed and profiled capture by
capture, at the bench configuration on the card.

One CUDA graph of the engine's block of 32 passes can replay about 25%
slower than another capture of the same block at the same state and clock
(PERF.md, section 5).  This script takes the engine's own block
(``FreeRunCGGibbs._block_fn``, captured as ``passloop.BlockLoop._capture``
does: static copies of the carry, a warm-up block on a throwaway copy, the
block ending by copying its outputs into the static inputs) from the state
after ``WARMUP`` warmup sweeps, every lane active and no flag read, and
times ``TRIALS`` trials of each arm, the arms in turns:

* ``private``: a fresh capture (new static carry, new private memory pool),
  as ``BlockLoop`` makes one; with, under torch.profiler, each kernel
  name's device us and launches per pass, the busy time and span, each
  launch's duration in order, and the addresses of the static carry and
  of the pool's segments (``torch.cuda.memory_snapshot``);
* ``reinstantiate``: one capture kept (``keep_graph=True``) and
  instantiated afresh by ``CUDAGraph.instantiate``: the same kernels at the
  same addresses in a new executable; also timed on a side stream;
* ``exec_flags0``, ``exec_priority``, ``exec_device_launch``: the kept
  capture instantiated and uploaded through libcuda
  (``cuGraphInstantiateWithFlags``, ``cuGraphUpload``) with those flags;
* ``engine_probe``: the bench's own pass probe (``bench_torch.pass_probe``:
  the engine's loop cache cleared, a capture, then ``PROBE_PASSES`` passes
  on the host clock with one flag read per block).

Each figure is device us per pass over ``REPLAYS`` launches between CUDA
events, in ``WINDOWS`` windows (the probe: host clock).  The next rows give
each arm's figures and compare the fastest and the slowest ``private``
captures kernel by kernel.

Then timelines: one capture of the block and one "canary" graph of
``CANARY_KERNELS`` one-element additions in a chain (launch latency and
nothing else) are timed in turns, ``TIMELINE`` times, each over
``TIMELINE_REPLAYS`` replays between events, with nvidia-smi's clocks and
active clock-event reasons every ``SMI_EVERY`` turns, under the variants
of ``timelines`` (between turns: nothing, an L2 flush, a host sleep, a
profiled replay; and a smaller problem): what moves the block between its
two speeds, and whether the canary's launch latency moves with it.

    python scripts/torch_capture_modes.py   # rows to results/torch_capture_modes_h100.jsonl
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402
import ctypes  # noqa: E402
import statistics  # noqa: E402

import torch  # noqa: E402

import bench_torch  # noqa: E402
from mcmcglm_tpu_torch.passloop import _flatten, _unflatten  # noqa: E402
from torch_study import Records, card_clocks, resolve_device, sync  # noqa: E402

WARMUP = 10
TRIALS = 6  # per arm, the arms in turns
REPLAYS = 20  # blocks timed between events, per window
WINDOWS = 2  # timed windows per trial
PROFILE_REPLAYS = 2
PROBE_PASSES = 640  # the engine_probe arm's passes (20 blocks)
# instantiation flags of the exec arms (cuda.h CUgraphInstantiate_flags)
EXEC_FLAGS = {"exec_flags0": 0, "exec_priority": 8, "exec_device_launch": 4}
TIMELINE = 60  # turns of the block and the canary, per variant
TIMELINE_REPLAYS = 5
CANARY_KERNELS = 1000
SMI_EVERY = 10
FAST_BELOW = 400.0  # us per pass: the fast speed (about 347) against 433
SMALL_N = 2_500  # the timeline's small variant


def capture(eng, carry, pool=None, keep_graph=False):
    """The engine's block captured as ``BlockLoop._capture`` does, into
    ``pool`` (None: a new private pool); returns (graph, static carry).
    ``keep_graph``: keep the captured cudaGraph_t, not yet instantiated."""
    block = eng._block_fn(eng._block_passes, False, eng.shrink_only)
    flat, spec = _flatten(carry)
    dev = flat[0].device
    static = [t.clone() for t in flat]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block(eng, _unflatten([t.clone() for t in flat], spec))
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph, pool=pool):
        out, _ = block(eng, _unflatten(static, spec))
        out_flat, _ = _flatten(out)
        for dst, src in zip(static, out_flat):
            if src is not dst:
                dst.copy_(src)
    torch.cuda.synchronize(dev)
    return graph, static


class LibCuda:
    """libcuda's graph calls (through ctypes), for executables of
    one captured graph instantiated with other flags than PyTorch's."""

    def __init__(self):
        P = ctypes.c_void_p
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphInstantiateWithFlags.argtypes = [
            ctypes.POINTER(P), P, ctypes.c_ulonglong]
        lib.cuGraphLaunch.argtypes = [P, P]
        lib.cuGraphUpload.argtypes = [P, P]
        lib.cuGraphExecDestroy.argtypes = [P]
        for fn in (lib.cuGraphInstantiateWithFlags, lib.cuGraphLaunch,
                   lib.cuGraphUpload, lib.cuGraphExecDestroy):
            fn.restype = ctypes.c_int
        self.lib = lib

    def check(self, rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUresult {rc}")

    def instantiate(self, graph, flags):
        ex = ctypes.c_void_p()
        self.check(self.lib.cuGraphInstantiateWithFlags(
            ctypes.byref(ex), ctypes.c_void_p(graph.raw_cuda_graph()),
            flags), "cuGraphInstantiateWithFlags")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        self.check(self.lib.cuGraphUpload(ex, stream), "cuGraphUpload")
        return ex

    def launcher(self, ex):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        return lambda: self.check(self.lib.cuGraphLaunch(ex, stream),
                                  "cuGraphLaunch")

    def destroy(self, ex):
        torch.cuda.synchronize()
        self.check(self.lib.cuGraphExecDestroy(ex), "cuGraphExecDestroy")


def replay_us(launch, passes_per_replay, stream=None):
    """Device us per pass of ``REPLAYS`` launches between CUDA events, in
    each of ``WINDOWS`` windows, on ``stream`` (the current one if None)."""
    out = []
    with torch.cuda.stream(stream or torch.cuda.current_stream()):
        launch()
        for _ in range(WINDOWS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(REPLAYS):
                launch()
            t1.record()
            torch.cuda.synchronize()
            out.append(1e3 * t0.elapsed_time(t1)
                       / (REPLAYS * passes_per_replay))
    return out


def profiled(graph, passes_per_replay):
    """Kernel device times of ``PROFILE_REPLAYS`` replays: (us per pass by
    name, launches per pass by name, busy us per pass, span us per pass,
    each launch's (name, us) in order)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPLAYS):
            graph.replay()
        torch.cuda.synchronize()
    ker = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    passes = PROFILE_REPLAYS * passes_per_replay
    us, count = {}, {}
    for e in ker:
        us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us() / passes
        count[e.name] = count.get(e.name, 0) + 1 / passes
    busy = sum(us.values())
    span = ((ker[-1].time_range.end - ker[0].time_range.start) / passes
            if ker else 0.0)
    seq = [(e.name, e.time_range.elapsed_us()) for e in ker]
    return us, count, busy, span, seq


def smi_state():
    """nvidia-smi's SM and memory clocks, power, performance state and
    active clock-event reasons, now."""
    import subprocess

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,pstate,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (proc.stdout or proc.stderr).strip()


def canary_graph(device):
    """A captured chain of ``CANARY_KERNELS`` one-element additions."""
    x = torch.zeros(1, device=device)

    def run():
        for _ in range(CANARY_KERNELS):
            x.add_(1.0)

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    torch.cuda.synchronize(device)
    return graph


def timeline(rec, label, block, canary, B, between=None):
    """The block and the canary in turns (module docstring), with
    ``between(i)`` called after turn i; writes the turns and a summary."""
    import time

    t_start = time.perf_counter()
    turns = []
    for i in range(TIMELINE):
        row = {"turn": i, "t": time.perf_counter() - t_start}
        for name, graph, per in (("block_us_per_pass", block, B),
                                 ("canary_us_per_kernel", canary,
                                  CANARY_KERNELS)):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(TIMELINE_REPLAYS):
                graph.replay()
            t1.record()
            torch.cuda.synchronize()
            row[name] = 1e3 * t0.elapsed_time(t1) / (TIMELINE_REPLAYS * per)
        if i % SMI_EVERY == 0:
            row["smi"] = smi_state()
        turns.append(row)
        if between is not None:
            between(i)
    a = [r["block_us_per_pass"] for r in turns]
    b = [r["canary_us_per_kernel"] for r in turns]
    rec.write({"timeline": label, "turns": turns})
    rec.write({
        "timeline_summary": label,
        "block_min_median_max": [min(a), statistics.median(a), max(a)],
        "canary_min_median_max": [min(b), statistics.median(b), max(b)],
        "correlation": statistics.correlation(a, b) if len(set(a)) > 1
        and len(set(b)) > 1 else None,
        "turns_below_400": sum(1 for x in a if x < FAST_BELOW),
    })


def timelines(rec, eng, carry, device, small):
    """The timeline variants: ``plain``; ``flush`` (a 256 MB buffer zeroed
    after each turn: the 50 MB L2 holds nothing of the block after it);
    ``idle`` (the host sleeps 20 ms after each turn); ``profiled`` (one
    block replay under torch.profiler after every 10th turn); ``small``
    (the same configuration at n=2,500: a quarter of eta and X^T);
    ``plain`` again."""
    import time

    from torch.profiler import ProfilerActivity, profile

    B = eng._block_passes
    block, static = capture(eng, carry)
    canary = canary_graph(device)
    junk = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def flush(i):
        junk.zero_()
        torch.cuda.synchronize()

    def idle(i):
        time.sleep(0.02)

    def profiled_replay(i):
        if i % 10 == 9:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                block.replay()
                torch.cuda.synchronize()

    s_eng, s_carry = small
    s_block, s_static = capture(s_eng, s_carry)
    for label, graph, hook in (("plain", block, None), ("flush", block, flush),
                               ("idle", block, idle),
                               ("profiled", block, profiled_replay),
                               ("small", s_block, None),
                               ("plain_again", block, None)):
        timeline(rec, label, graph, canary, B, hook)


def pool_segments(pool):
    """(address, total size, type) of the segments of ``pool``."""
    out = []
    for s in torch.cuda.memory_snapshot():
        if tuple(s.get("segment_pool_id", ())) == tuple(pool):
            out.append([s["address"], s["total_size"], s["segment_type"]])
    return sorted(out)


def compare(fast, slow):
    """Kernel-by-kernel difference of two captures' profiles."""
    names = set(fast["kernel_us"]) | set(slow["kernel_us"])
    diff = sorted(((slow["kernel_us"].get(k, 0.0)
                    - fast["kernel_us"].get(k, 0.0), k) for k in names),
                  reverse=True)
    rows = [{"kernel": k[:100], "fast_us": fast["kernel_us"].get(k, 0.0),
             "slow_us": slow["kernel_us"].get(k, 0.0), "diff_us": dv,
             "launches_per_pass": slow["launches"].get(k, 0.0)}
            for dv, k in diff[:15]]
    fs, ss = fast.pop("_seq"), slow.pop("_seq")
    by_launch = []
    if [n for n, _ in fs] == [n for n, _ in ss]:
        deltas = sorted(((b - a, i, n) for i, ((n, a), (_, b))
                         in enumerate(zip(fs, ss))), reverse=True)
        n_slower = sum(1 for d, _, _ in deltas if d > 0)
        by_launch = {"same_launch_order": True,
                     "launches": len(fs),
                     "launches_slower": n_slower,
                     "median_delta_us": statistics.median(
                         d for d, _, _ in deltas),
                     "top": [[i, n[:60], d] for d, i, n in deltas[:20]]}
    else:
        by_launch = {"same_launch_order": False,
                     "launches": [len(fs), len(ss)]}
    return {"fast": fast["trial"], "slow": slow["trial"],
            "us_per_pass": [fast["us_per_pass"], slow["us_per_pass"]],
            "busy_us": [fast["busy_us"], slow["busy_us"]],
            "span_us": [fast["span_us"], slow["span_us"]],
            "kernels_by_diff": rows, "by_launch": by_launch}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device("cuda")
    cfg = bench_torch.CONFIGS["cuda"]
    X, y, prior = bench_torch.bench_problem(cfg["n"], cfg["d"])
    eng = bench_torch.bench_engine(X, y, prior, cfg["spec_k"], device)
    rec = Records("capture_modes", device, args.out)
    C = cfg["n_chains"]
    st = eng.warmup(eng.init(0, C), WARMUP)[0]
    sync(device)

    def scalar(v):
        return torch.full((), v, dtype=torch.int64, device=device)

    # every lane active for as long as the replays run, no flag read
    carry = (st, torch.zeros(C, dtype=torch.int32, device=device), None,
             None, scalar(1 << 62), scalar(0), scalar(1 << 30), None)
    B = eng._block_passes
    drv = LibCuda()
    side = torch.cuda.Stream(device)
    kept, kept_static = capture(eng, carry, keep_graph=True)
    rows = []

    def write(arm, k, us, **extra):
        row = {"arm": arm, "trial": k, "us_per_pass": us,
               "clocks_after": card_clocks(device), **extra}
        rec.write(row)
        rows.append(row)
        return row

    for k in range(TRIALS):
        # a fresh capture, as BlockLoop makes one: new static, new pool
        graph, static = capture(eng, carry)
        us = replay_us(graph.replay, B)
        kus, cnt, busy, span, seq = profiled(graph, B)
        row = write("private", k, us, busy_us=busy, span_us=span,
                    kernels_per_pass=len(seq) / (PROFILE_REPLAYS * B),
                    static_addresses=[t.data_ptr() for t in static],
                    pool_segments=pool_segments(graph.pool()))
        row.update(kernel_us=kus, launches=cnt, _seq=seq)
        del graph, static
        # the one kept capture instantiated afresh: the same addresses
        try:
            kept.instantiate()
            write("reinstantiate", k, replay_us(kept.replay, B),
                  side_stream=replay_us(kept.replay, B, side))
        except (RuntimeError, AttributeError) as exc:
            write("reinstantiate", k, None, error=repr(exc))
        for arm, flags in EXEC_FLAGS.items():
            try:
                ex = drv.instantiate(kept, flags)
            except (RuntimeError, TypeError, AttributeError) as exc:
                write(arm, k, None, error=repr(exc))
                continue
            write(arm, k, replay_us(drv.launcher(ex), B))
            drv.destroy(ex)
        # the engine's own loop and the bench's probe: host clock, flag reads
        probe, _ = bench_torch.pass_probe(eng, st, PROBE_PASSES, 1)
        write("engine_probe", k, probe)
        torch.cuda.synchronize()
    private = sorted((r for r in rows if r["arm"] == "private"),
                     key=lambda r: min(r["us_per_pass"]))
    summary = {}
    for r in rows:
        if r["us_per_pass"] is not None:
            summary.setdefault(r["arm"], []).append(min(r["us_per_pass"]))
    rec.write({"us_per_pass_by_arm": summary,
               "private_fastest_vs_slowest": compare(private[0],
                                                     private[-1])})
    Xs, ys, ps = bench_torch.bench_problem(SMALL_N, cfg["d"])
    s_eng = bench_torch.bench_engine(Xs, ys, ps, cfg["spec_k"], device)
    s_st = s_eng.warmup(s_eng.init(0, C), WARMUP)[0]
    s_carry = (s_st,) + carry[1:]
    timelines(rec, eng, carry, device, (s_eng, s_carry))
    rec.write({"summary": "bench configuration", "warmup": WARMUP,
               "chains": C, "torch": torch.__version__,
               "cuda": torch.version.cuda})


if __name__ == "__main__":
    main()
