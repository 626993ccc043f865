"""Helpers of the benchmark's CPU tests: a copy of the benchmark with tiny
cells added as files, and runs of the harness in a fresh process on the
CPU (the plain batteries and fused updates; no card)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_CELLS = ("tiny_logit.freerun", "tiny_pois.freerun", "tiny_logit.fused")
# the tiny cells' limits: sound tiny runs read eta_gap about 3e-6, pit_ks
# 0.03-0.07 over 256 updates, ess_gap about 1e-16
TINY_LIMITS = {"eta_gap": 1e-4, "pit_ks": 0.15, "ess_gap": 1e-9}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``benchmark/``) in
    ``tmp`` with two tiny configurations and three tiny cells added as new
    files and entries; returns the copy's ``benchmark/``."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    root = tmp / "benchmark"
    for src, name, n, d in (("logistic_p1000", "tiny_logit", 300, 6),
                            ("poisson_laplace_p100", "tiny_pois", 300, 5)):
        cfg = json.loads((root / "configs" / f"{src}.json").read_text())
        cfg.update(name=name, n=n, d=d)
        _dump(cfg, root / "configs" / f"{name}.json")
    for src, name, cfg, extra in (
            ("logistic_p1000.freerun.c256", "tiny_logit.freerun",
             "tiny_logit", {}),
            ("poisson_laplace_p100.freerun.c64", "tiny_pois.freerun",
             "tiny_pois", {"chunk_sweeps": 5}),
            ("logistic_p1000.fused.c256", "tiny_logit.fused", "tiny_logit",
             {"chunk_sweeps": 5, "burnin_sweeps": 5})):
        work = json.loads((root / "workloads" / f"{src}.json").read_text())
        work.update(config=cfg, chains=8, profile_passes=16, warm_chunks=1,
                    check={"pit_updates": 256, "ess_coords": 4},
                    limits=dict(TINY_LIMITS), **extra)
        _dump(work, root / "workloads" / f"{name}.json")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    for name in TINY_CELLS:
        cfg = name.split(".")[0]
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": name.split(".", 1)[1],
                                  "chips": 1, "why": "a CPU test"})
    for cfg in ("tiny_logit", "tiny_pois"):
        spec["configs"].append({"name": cfg, "source": "a CPU test",
                                "file": f"benchmark/configs/{cfg}.json",
                                "reduced": ["n", "d"], "why": "a CPU test"})
    # each per-layer metric reads the tiny cells of the engines it reads
    tiny = {"freerun": ["tiny_logit.freerun", "tiny_pois.freerun"],
            "fused": ["tiny_logit.fused"]}
    for m in spec["per_layer"]:
        engines = {w.split(".")[1] for w in m["workloads"]}
        m["workloads"] += [c for e in sorted(engines) for c in tiny[e]]
    _dump(spec, tmp / "BENCHMARK.json")
    return root


RUNNER = """
import json, sys, time
T = time.perf_counter()
from benchmark import harness
from benchmark.run import emit as _emit
{prelude}
line, rows, ctl = harness.run_cell({cell!r}, {seed!r}, {seconds!r},
                                   {trace!r}, "cpu", t_start=T,
                                   driver_opts={opts!r}, controls={controls!r})
print("MODULES " + json.dumps(sorted(sys.modules)))
print("CONTROLS " + json.dumps(ctl))
sys.exit(_emit(line, rows))
"""


def run_harness(root: Path, cell: str, *, seed: int = 2**31 + 11,
                seconds: float = 1.0, trace: bool = False, prelude: str = "",
                opts=None, controls: bool = False, rc: int = 0):
    """Run ``cell`` once on the CPU in a fresh process with the copy
    ``root`` first on the path, through ``run.emit`` as ``run.py`` ends a
    run; returns (the result line, or None where the run printed none, the
    loaded modules, the controls' readings, the process), and fails
    unless the process exits with ``rc``."""
    code = RUNNER.format(prelude=prelude, cell=cell, seed=seed,
                         seconds=seconds, trace=trace, opts=opts,
                         controls=controls)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(root.parent), str(REPO)]),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root.parent,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != rc:
        raise AssertionError(f"harness exited {proc.returncode}, not {rc}:"
                             f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    tagged = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
              for ln in lines if ln.startswith(("MODULES ", "CONTROLS "))}
    line = None
    if lines and not lines[-1].startswith(("MODULES ", "CONTROLS ")):
        line = json.loads(lines[-1])
    return line, tagged["MODULES"], tagged["CONTROLS"], proc


RANKS_RUNNER = """
import sys, time
T = time.perf_counter()
from benchmark import run
sys.exit(run.run_ranks({cell!r}, {seed!r}, {seconds!r}, {trace!r}, "cpu",
                       {chips!r}, t_start=T, limit_s={limit!r}))
"""


def run_ranks(root: Path, cell: str, *, chips: int = 2,
              seed: int = 2**31 + 11, seconds: float = 1.0,
              trace: bool = False, limit_s=None, env=None, rc: int = 0):
    """Run ``cell`` once on ``chips`` gloo ranks on the CPU, as ``run.py``
    runs a cell on several cards, from a fresh process with the copy
    ``root`` first on the path; returns (the result line, or None where
    the run printed none, the process), and fails unless the process exits
    with ``rc``."""
    code = RANKS_RUNNER.format(cell=cell, seed=seed, seconds=seconds,
                               trace=trace, chips=chips, limit=limit_s)
    env = dict(os.environ, **(env or {}),
               PYTHONPATH=os.pathsep.join([str(root.parent), str(REPO)]),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root.parent,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != rc:
        raise AssertionError(f"run exited {proc.returncode}, not {rc}:"
                             f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    line = (json.loads(lines[-1]) if lines and lines[-1].startswith("{")
            else None)
    return line, proc
