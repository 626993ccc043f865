"""One run of one cell, and the line it prints.

A run: load the port's kernels from the checkout's fixed build cache;
make the data from the seed with the benchmark's own generator; build the
engine the cell names (``drivers/<engine>.py``); burn in; make one
untimed chunk, which captures the sampling graph, and then the cell's
``warm_chunks`` untimed chunks; then run chunks, keeping their draws on
the device, until ``seconds`` have passed (the window).  The warm chunks
are there because the H100 runs dependent small kernels about 0.2 us
slower each for some seconds after a graph capture (the canary, read
after the capture and before and after the window, shows which level a
run saw).  ``setup_s`` runs from the process's start to the window's.
After the window: the peak of device memory, the profiled segment of a
traced run, the ESS of the window's draws, and the comparison with the
reference (``check.py``), run once the engine is freed.  Each metric is a
reader of its own, ``metrics/<name>.py``, over the run's record.
``run.py`` looks for JAX in ``sys.modules`` last, before it prints.

A cell on N > 1 cards runs as N processes, one per card (``ranks.py``),
each with its :class:`ranks.World`.  Rank 0 loads the kernels first and
the others then find them built.  Every rank makes the same data from the
seed and builds, burns in, captures and warms its own driver on its own
card.  The window starts once every rank has synchronised its card and
passed a barrier, on rank 0's clock; after each chunk rank 0 decides by
its clock whether to stop and broadcasts the decision, so every rank runs
the same chunks; the window ends once every rank has synchronised its
card and passed a barrier, so it covers the slowest card.  ``rec["C"]`` is
the cell's chains and ``window.evals`` and ``window.passes`` the sums over
the ranks (each rank's own counts, clocks and profiled busy time are in
``rec["ranks"]``, and ``rec["cards"]`` is N).  With ``--trace 1`` every
rank runs its profiled segment, which may hold collectives; rank 0's is
the breakdown.  Each rank then frees its engine, the ranks report their
cards (the one that holds each rank's outputs, its name and its peak
memory), and the chain-leading outputs (``CHAIN_KEYS``) are gathered to
rank 0 in rank order along the chain axis, where the ESS, the check and
the metric readers run as on one card.  Outputs sharded along the
observation axis are left to the change that adds such a cell.
"""

from __future__ import annotations

import gc
import importlib
import subprocess
import sys
import time

import torch

from . import check, spec, trace
from .datagen import glm_data
from .ess import ess_torch

__all__ = ["CHAIN_KEYS", "FORBIDDEN", "device_report", "forbidden_modules",
           "report_checks", "run_cell"]

# top-level module names that may not be loaded in a run: JAX, its kin,
# the JAX package and the JAX package's bench entry points
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mcmcglm_tpu", "bench",
                       "bench_torch"})
# the outputs a multi-card run gathers to rank 0 along the chain axis
CHAIN_KEYS = ("draws", "nev", "beta", "eta")
# before each line of standard error: each rank of a multi-card run sets
# its own
TAG = ""


def say(msg: str) -> None:
    # one write a line, so that the ranks' lines do not run into each other
    sys.stderr.write(f"# {TAG}{msg}\n")
    sys.stderr.flush()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is in
    ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({exc})"


def _device_info(device, peak):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def device_report(reports, chips: int) -> dict:
    """The ``device`` of a multi-card run from each rank's report (the card
    that holds its outputs, the card's name and its peak memory): the
    count of distinct cards used, their common name and the fullest
    card's peak.  Raises when the names differ or fewer cards were used
    than the cell's ``chips``."""
    kinds = sorted({r["kind"] for r in reports})
    if len(kinds) != 1:
        raise RuntimeError(f"the ranks ran on cards of different kinds: "
                           f"{kinds}")
    cards = sorted({r["card"] for r in reports})
    if len(cards) < chips:
        raise RuntimeError(f"the run used {len(cards)} card(s) ({cards}); "
                           f"the cell asks for {chips}")
    return {"platform": "gpu" if kinds[0] != "cpu" else "cpu",
            "kind": kinds[0], "count": len(cards),
            "memory_peak_bytes": max(int(r["peak"]) for r in reports)}


def _window(drv, device, seconds, world):
    """Chunks until rank 0's clock has passed ``seconds``, every rank
    running as many; (window seconds, chunks, the window's start, this
    rank's clocks).  The window opens and closes with every card
    synchronised and a barrier passed."""
    _sync(device)
    world.barrier()
    t0 = time.perf_counter()
    chunks, stops = 0, []
    while True:
        drv.chunk(keep=True)
        chunks += 1
        t = time.perf_counter()
        stop = world.agree(t - t0 >= seconds)
        stops.append(time.perf_counter() - t)
        if stop:
            break
    last = time.perf_counter()
    _sync(device)
    synced = time.perf_counter()
    world.barrier()
    window_s = time.perf_counter() - t0
    return window_s, chunks, t0, {"last_chunk_end": last, "synced": synced,
                                  "stop_s": sum(stops),
                                  "stop_min_s": min(stops)}


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, device,
             *, t_start: float, root=spec.ROOT, driver_opts=None,
             controls: bool = False, world=None):
    """Run cell ``name`` once; returns (the result line as a dict, the
    numbers compared as [(name, value, limit, within)], and with
    ``controls`` the controls' numbers and whether they, held to the same
    limits, come out correct, or None).  With ``world`` (a rank of a
    multi-card run) ranks other than 0 return (None, None, None)."""
    device = torch.device(device)
    work, config = spec.cell(name, root)
    drivers = importlib.import_module(f"{__package__}.drivers")
    mod = importlib.import_module(f"{__package__}.drivers.{work['engine']}")
    steps = {}

    t = time.perf_counter()
    if world is not None and world.rank:
        world.barrier()  # rank 0 builds the kernels; the others find them
    build = drivers.load_kernels(device)
    if world is not None and not world.rank:
        world.barrier()
    steps["kernels"] = time.perf_counter() - t
    say(f"kernel library: {build}")
    t = time.perf_counter()
    model = spec.Model(config, root)
    X, y, _ = glm_data(model.sample, config["n"], config["d"], seed)
    steps["data"] = time.perf_counter() - t
    t = time.perf_counter()
    drv = mod.Driver(config, work, X, y, seed, device, **(driver_opts or {}))
    steps["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    drv.burn_in()
    _sync(device)
    steps["burn_in"] = time.perf_counter() - t
    canary = None
    if device.type == "cuda":
        from .canary import Canary

        canary = Canary(device)
    t = time.perf_counter()
    drv.chunk(keep=False)  # captures the sampling graph
    _sync(device)
    steps["capture_chunk"] = time.perf_counter() - t
    if canary is not None:
        say(f"canary after the capture: {canary.read():.4f} us per kernel")
    t = time.perf_counter()
    for _ in range(int(work["warm_chunks"])):
        drv.chunk(keep=False)
    _sync(device)
    steps["warm_chunks"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    steps["before_engine"] = setup_s - sum(steps.values())
    say("set-up seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in steps.items()))
    if canary is not None:
        say(f"canary before the window: {canary.read():.4f} us per kernel;"
            f" nvidia-smi: {_smi()}")

    c0 = drv.counts()
    if world is None:
        chunks = 0
        t0 = time.perf_counter()
        while True:
            drv.chunk(keep=True)
            chunks += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
    else:
        window_s, chunks, t0, clocks = _window(drv, device, seconds, world)
        setup_s = t0 - t_start
    c1 = drv.counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if canary is not None:
        say(f"canary after the window: {canary.read():.4f} us per kernel;"
            f" nvidia-smi: {_smi()}")
    sweeps = chunks * int(work["chunk_sweeps"])
    C, d, n = int(work["chains"]), int(config["d"]), int(config["n"])
    rec = {"cell": name, "work": work, "config": config, "C": C, "d": d,
           "n": n, "setup_s": setup_s, "engine": drv.describe(),
           "cards": 1 if world is None else world.size,
           "window": {"seconds": window_s, "sweeps": sweeps,
                      "evals": c1["evals"] - c0["evals"]}}
    if "passes" in c1:
        rec["window"]["passes"] = c1["passes"] - c0["passes"]
    if world is not None:
        mine = dict(clocks, rank=world.rank, chunks=chunks,
                    **{k: v for k, v in rec["window"].items()
                       if k in ("evals", "passes")})
        rec["ranks"] = world.all_objects(mine)
        for k in ("evals", "passes"):
            if k in mine:
                rec["window"][k] = sum(r[k] for r in rec["ranks"])
        if not world.rank:
            _say_ranks(rec["ranks"], t0)
    say(f"window {window_s:.3f} s, {chunks} chunks, {sweeps} sweeps; "
        f"{rec['window']}; {rec['engine']}")
    if trace_on:
        if world is not None:
            world.barrier()
        rec["trace"] = drv.profile(trace)
        say(f"profiled segment: {rec['trace']['units']} {drv.unit}s, "
            f"{rec['trace']['ops']} device operations, busy "
            f"{rec['trace']['busy_s']:.6f} s of {rec['trace']['wall_s']:.6f}")
        if world is not None:
            segs = world.all_objects({k: rec["trace"][k]
                                      for k in ("busy_s", "wall_s")})
            for r, seg in zip(rec["ranks"], segs):
                r.update(seg)

    out = drv.outputs()
    del drv
    gc.collect()
    if world is not None:
        card = out["draws"].device
        reports = world.all_objects({
            "rank": world.rank, "peak": int(peak),
            "card": (f"cuda:{card.index}" if card.type == "cuda"
                     else f"cpu:{world.rank}"),
            "kind": (torch.cuda.get_device_name(card)
                     if card.type == "cuda" else "cpu")})
        dev_info = device_report(reports, int(work["chips"]))
        for r in reports if not world.rank else ():
            say(f"rank {r['rank']} on {r['card']}: peak {r['peak']} bytes")
        for k in CHAIN_KEYS:
            if out.get(k) is not None:
                out[k] = world.gather_chains(out[k])
        if world.rank:
            return None, None, None
    draws = out["draws"]
    t = time.perf_counter()
    ess = ess_torch(draws)
    out["ess"] = ess
    rec["ess"] = {"min": float(ess.min()), "median": float(ess.median()),
                  "argmin": int(ess.argmin())}
    say(f"ESS {rec['ess']} in {time.perf_counter() - t:.3f} s")

    finite = torch.isfinite(draws).all(2)
    attempted, failed = int(finite.numel()), int((~finite).sum())
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    X64 = torch.as_tensor(X, device=device)
    y64 = torch.as_tensor(y, device=device)
    nums, ctl = check.run_checks(model, X64, y64, out, seed, work,
                                 controls=controls)
    limits = work.get("limits", {})
    rows = check.verdict(nums, limits)
    if ctl is not None:
        ctl = {"numbers": ctl,
               "correct": all(r[3] for r in check.verdict(ctl, limits))}
    say(f"check in {time.perf_counter() - t:.3f} s")

    metrics = {}
    for m in spec.metric_entries(name, trace_on, root):
        reader = spec.load_file(root / "metrics" / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if world is None:
        dev_info = _device_info(device, peak)
    line = {"correct": failed == 0 and all(r[3] for r in rows),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev_info}
    if trace_on:
        tr = rec["trace"]
        if world is None:
            dev_info["busy_s"] = tr["busy_s"]
            dev_info["window_s"] = tr["wall_s"]
        else:  # busy time averaged over the cards; the longest segment
            dev_info["busy_s"] = (sum(r["busy_s"] for r in rec["ranks"])
                                  / len(rec["ranks"]))
            dev_info["window_s"] = max(r["wall_s"] for r in rec["ranks"])
        per = tr["units"]
        line["breakdown"] = {
            "device_ops": trace.top({k: v[0] for k, v in
                                     tr["by_name"].items()}, per),
            "idle_gaps": trace.top(tr["gaps"], per)}
    line["checks"] = {r[0]: {"value": r[1], "limit": r[2]} for r in rows}
    return line, rows, ctl


def _say_ranks(ranks, t0) -> None:
    """Each rank's window on rank 0's clock (the ranks share the host's
    monotonic clock): its last chunk's end, its card synchronised, and the
    stop broadcast's host time, a chunk's mean (with the wait for the
    slowest rank: over gloo the broadcast returns once every rank has
    reached it) and least (the collective nearly alone)."""
    for r in ranks:
        say(f"rank {r['rank']}: {r['chunks']} chunks, {r['evals']} evals, "
            f"{r.get('passes')} passes, last chunk ends "
            f"{r['last_chunk_end'] - t0:.6f} s, synchronised "
            f"{r['synced'] - t0:.6f} s, stop broadcast "
            f"{1e6 * r['stop_s'] / r['chunks']:.1f} us a chunk, least "
            f"{1e6 * r['stop_min_s']:.1f} us")
    ends = [r["last_chunk_end"] for r in ranks]
    say(f"ranks: last chunk ends spread {1e3 * (max(ends) - min(ends)):.3f}"
        f" ms")


def report_checks(rows) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, value, lim, ok in rows:
        print(f"check {name} {value!r} limit {lim!r} "
              f"{'within' if ok else 'OUTSIDE'}", file=sys.stderr,
              flush=True)
