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

__all__ = ["FORBIDDEN", "forbidden_modules", "report_checks", "run_cell"]

# top-level module names that may not be loaded in a run: JAX, its kin,
# the JAX package and the JAX package's bench entry points
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mcmcglm_tpu", "bench",
                       "bench_torch"})


def say(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


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


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, device,
             *, t_start: float, root=spec.ROOT, driver_opts=None,
             controls: bool = False):
    """Run cell ``name`` once; returns (the result line as a dict, the
    numbers compared as [(name, value, limit, within)], and with
    ``controls`` the controls' numbers and whether they, held to the same
    limits, come out correct, or None)."""
    device = torch.device(device)
    work, config = spec.cell(name, root)
    drivers = importlib.import_module(f"{__package__}.drivers")
    mod = importlib.import_module(f"{__package__}.drivers.{work['engine']}")
    steps = {}

    t = time.perf_counter()
    build = drivers.load_kernels(device)
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
    chunks = 0
    t0 = time.perf_counter()
    while True:
        drv.chunk(keep=True)
        chunks += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
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
           "window": {"seconds": window_s, "sweeps": sweeps,
                      "evals": c1["evals"] - c0["evals"]}}
    if "passes" in c1:
        rec["window"]["passes"] = c1["passes"] - c0["passes"]
    say(f"window {window_s:.3f} s, {chunks} chunks, {sweeps} sweeps; "
        f"{rec['window']}; {rec['engine']}")
    if trace_on:
        rec["trace"] = drv.profile(trace)
        say(f"profiled segment: {rec['trace']['units']} {drv.unit}s, "
            f"{rec['trace']['ops']} device operations, busy "
            f"{rec['trace']['busy_s']:.6f} s of {rec['trace']['wall_s']:.6f}")

    out = drv.outputs()
    del drv
    gc.collect()
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
    dev_info = _device_info(device, peak)
    line = {"correct": failed == 0 and all(r[3] for r in rows),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev_info}
    if trace_on:
        tr = rec["trace"]
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["wall_s"]
        per = tr["units"]
        line["breakdown"] = {
            "device_ops": trace.top({k: v[0] for k, v in
                                     tr["by_name"].items()}, per),
            "idle_gaps": trace.top(tr["gaps"], per)}
    line["checks"] = {r[0]: {"value": r[1], "limit": r[2]} for r in rows}
    return line, rows, ctl


def report_checks(rows) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, value, lim, ok in rows:
        print(f"check {name} {value!r} limit {lim!r} "
              f"{'within' if ok else 'OUTSIDE'}", file=sys.stderr,
              flush=True)
