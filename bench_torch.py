"""North-star benchmark of the PyTorch + CUDA port: min-ESS/s on a p=1000
logistic GLM on one GPU.

The port's counterpart of ``bench.py``, with its configuration, protocol
and output line; it imports torch, numpy and ``mcmcglm_tpu_torch``, never
JAX.

    python3 bench_torch.py               # on the card; raises without CUDA
    python3 bench_torch.py --device cpu  # bench.py's CPU branch, small

Protocol (``bench.py:150-360``)
-------------------------------
* binomial/logit data from ``generate_glm_data(n, d, seed=0)``, an IID
  Normal(0, 1) prior, ``FreeRunCGGibbs`` with the quantile slice kernel and
  pseudo-targets adapted in warmup, ``spec_k=4`` and ``battery_impl="auto"``
  (``"cuda3"`` on the card), C=256 chains from seed 0.
* ``burnin`` adaptive warmup sweeps; one untimed ``run(state, CHUNK)``,
  which captures the sampling graph; then ``timed_sweeps`` sweeps timed on
  the host clock in chunks of ``CHUNK``, the draws kept on the device.
* ``value``: the minimum over coordinates of the pooled bulk ESS of the
  timed draws (``diagnostics.ess``, on the host, after the timed section)
  over the timed seconds.  ``vs_baseline``: that over ``bench.py``'s NumPy
  single-chain CGGibbs proxy, credited with 1 ESS per sweep.
* Pass probe: ``_run_pass_block`` with an unreachable sweep quota runs
  exactly ``probe_passes`` passes, every lane active.  The same captured
  block runs at one of two speeds about 25% apart, between which the card
  switches over seconds, whatever the capture (PERF.md, section 5), so the
  probe is timed in ``PROBE_CAPTURES`` windows, each after a fresh capture
  (the engine's loop cache cleared before it), never across one;
  ``pass_microseconds`` is their median.

``kernel_launches``: each battery kernel's launches in the run (graph
replays counted per kernel; the plain battery on the CPU launches none).
Seconds: ``compile_seconds`` is the kernel build (0 on a cache hit under
``build/mcmcglm_tpu_torch/``) plus the graph captures before the probe;
``burnin_seconds`` the warmup without its captures; ``timed_ms_per_pass``
the timed section less its captures over its passes with an active lane.

Output: ONE JSON line, the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import mcmcglm_tpu_torch as mt
from bench import _numpy_baseline_sweep_rate
from mcmcglm_tpu_torch.diagnostics import ess
from mcmcglm_tpu_torch.ops import _build
from mcmcglm_tpu_torch.ops import freerun_batteries as fb

METRIC = "min_ess_per_sec_p{d}_logistic_1chip"
# bench.py:150-162 and :217-220: the accelerator branch ("cuda") and the
# CPU branch
CONFIGS = {
    "cuda": dict(n=10_000, d=1_000, n_chains=256, burnin=30,
                 timed_sweeps=120, np_sweeps=2, spec_k=4, probe_passes=1500),
    "cpu": dict(n=2_000, d=100, n_chains=8, burnin=30, timed_sweeps=100,
                np_sweeps=3, spec_k=1, probe_passes=20),
}
# bench.py:215-216: the quantile kernel reads the pseudo-target keys; "w"
# is the stepping-out width, unused under adapted pseudo-targets
TUNING = {"w": 0.5, "pseudo_scale": 2.0, "pseudo_adapt": True,
          "pseudo_c": 3.0}
SLICE_KERNEL = "quantile"
BATTERY_IMPL = "auto"
CHUNK = 30  # sweeps per timed run call (bench.py:293)
PROBE_CAPTURES = 5
# (C, n) float32 streams a pass moves, by battery (bench.py:326-341): the
# gather battery reads eta and the X rows and writes eta; "cuda2" adds the
# row gather's write and read, "cuda" the commit's; the plain battery ~3 + 2K
STREAMS = {"cuda3": 3, "cuda2": 5, "cuda": 6}
# HBM peak by nvidia-smi's card name (NVIDIA's data sheet; no default).  At
# the bench's shape the 3-stream operand is 30.7 MB, which the H100's 50 MB
# L2 holds, so hbm_gbps is a modelled rate, not a measured HBM rate
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def _stage(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line() -> str:
    """The card's "name, power limit" as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def bench_problem(n: int, d: int):
    """The bench's data and prior: (X, y, prior)."""
    X, y, _ = mt.generate_glm_data("binomial", n=n, d=d, seed=0)
    return X, y, mt.IIDPrior(mt.Normal(0.0, 1.0), d)


def bench_engine(X, y, prior, spec_k: int, device):
    return mt.FreeRunCGGibbs(X, y, "binomial", prior, tuning=TUNING,
                             slice_kernel=SLICE_KERNEL, spec_k=spec_k,
                             battery_impl=BATTERY_IMPL, device=device)


def pass_probe(eng, state, n_passes: int, captures: int):
    """Microseconds per pass of ``n_passes`` probe passes, timed after each
    of ``captures`` fresh captures of the probe's block; returns (the
    figures, the passes each timed call ran by the state's counter)."""
    dev, stats = eng.device, eng.loop_stats
    sc0 = torch.zeros(state.beta.shape[0], dtype=torch.int32, device=dev)

    def probe(st):
        return eng._run_pass_block(st, sc0, n_sweeps=1 << 30,
                                   n_passes=n_passes, adapt=False,
                                   shrink_only=True)[0]

    us, ran = [], []
    for _ in range(captures):
        eng._loops.clear()  # the next call captures the block afresh
        state = probe(state)
        _sync(dev)
        n_cap, ctr0 = stats["captures"], int(state.ctr)
        t0 = time.perf_counter()
        state = probe(state)
        _sync(dev)
        dt = time.perf_counter() - t0
        if stats["captures"] != n_cap:
            raise RuntimeError("the pass probe's timed call captured a graph")
        us.append(1e6 * dt / n_passes)
        ran.append(int(state.ctr) - ctr0)
    return us, ran


def run_bench(device, *, n, d, n_chains, burnin, timed_sweeps, np_sweeps,
              spec_k, probe_passes):
    """One bench run on ``device``; returns (the JSON line as a dict, what
    it was computed from: the timed draws, ``nev`` before and after the
    timed sweeps, and the probe's passes by the state's counter)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: CUDA is not available; pass "
                           "--device cpu for bench.py's CPU branch")
    build_s, cache_hit, card = 0.0, None, "cpu"
    if dev.type == "cuda":
        card = card_line()
        t0 = time.perf_counter()
        _build.load_library()
        build_s = time.perf_counter() - t0
        cache_hit = _build.BUILD_INFO["cached"]
        _stage(f"build {build_s:.1f} s (cache hit: {cache_hit})")
    X, y, prior = bench_problem(n, d)
    fb.reset_launch_counts()  # the run's own battery kernel launches
    eng = bench_engine(X, y, prior, spec_k, dev)
    stats = eng.loop_stats
    state = eng.init(0, n_chains)
    _sync(dev)
    t0 = time.perf_counter()
    state, _, _ = eng.warmup(state, burnin)
    _sync(dev)
    burn_s = time.perf_counter() - t0 - stats["capture_seconds"]
    _stage(f"warmup({burnin}) {burn_s:.1f} s without its captures")

    state, _, _ = eng.run(state, CHUNK)  # captures the sampling graph
    _sync(dev)
    nev0 = state.nev.cpu().numpy().copy()
    cap0, ctr0 = stats["capture_seconds"], int(state.ctr)
    parts = []
    done = 0
    t0 = time.perf_counter()
    while done < timed_sweeps:
        step = min(CHUNK, timed_sweeps - done)
        state, draws, _ = eng.run(state, step)
        parts.append(draws)
        done += step
    _sync(dev)
    timed_s = time.perf_counter() - t0
    capture_s = stats["capture_seconds"]
    timed_passes = int(state.ctr) - ctr0
    timed_ms = 1e3 * (timed_s - (capture_s - cap0)) / timed_passes
    nev1 = state.nev.cpu().numpy().copy()
    _stage(f"timed {timed_sweeps} sweeps {timed_s:.2f} s")

    probe_us, probe_ran = pass_probe(eng, state, probe_passes,
                                     PROBE_CAPTURES)
    launches = dict(fb.launch_counts)
    pass_s = statistics.median(probe_us) / 1e6
    _stage(f"pass probe, us per pass by capture: {probe_us}")
    n_obs = int(eng.Xt.shape[1])
    streams = STREAMS.get(eng.battery_impl, 3 + 2 * eng.spec_k)
    bytes_per_pass = streams * n_chains * n_obs * 4
    hbm_gbps = bytes_per_pass / pass_s / 1e9
    hbm_peak = HBM_PEAK_GBPS.get(card.split(",")[0].strip())

    draws = np.concatenate([p.cpu().numpy() for p in parts], axis=1)
    ess_all = ess(draws)
    min_ess = float(np.min(ess_all))
    ess_per_sec = min_ess / timed_s
    np_rate = _numpy_baseline_sweep_rate(X, y, n_sweeps=np_sweeps)
    line = {
        "metric": METRIC.format(d=d),
        "value": ess_per_sec,
        "unit": "ESS/s",
        "vs_baseline": ess_per_sec / np_rate,
        "backend": dev.type,
        "n": n,
        "d": d,
        "n_chains": n_chains,
        "timed_sweeps": timed_sweeps,
        "timed_seconds": timed_s,
        "compile_seconds": build_s + capture_s,
        "burnin_seconds": burn_s,
        "median_ess_per_sec": float(np.median(ess_all)) / timed_s,
        "sweeps_per_sec": timed_sweeps / timed_s,
        "slice_evals_per_sweep": float(np.mean((nev1 - nev0)
                                               / timed_sweeps)),
        "baseline_proxy_sweeps_per_sec": np_rate,
        "baseline_proxy_ess_per_sec": np_rate,
        "battery": eng.battery_impl,
        "slice_kernel": SLICE_KERNEL,
        "pseudo_adapt": TUNING["pseudo_adapt"],
        "pass_microseconds": statistics.median(probe_us),
        "bytes_per_pass": bytes_per_pass,
        "modeled_streams_per_pass": streams,
        "hbm_gbps": hbm_gbps,
        "pct_hbm_peak": (100.0 * hbm_gbps / hbm_peak if hbm_peak else None),
        "hbm_peak_gbps_assumed": hbm_peak,
        "device": card,
        "build_cache_hit": cache_hit,
        "build_seconds": build_s,
        "capture_seconds": capture_s,
        "timed_ms_per_pass": timed_ms,
        "passes_per_sweep": timed_passes / timed_sweeps,
        "pass_microseconds_captures": probe_us,
        "kernel_launches": launches,
    }
    return line, dict(draws=draws, nev0=nev0, nev1=nev1,
                      probe_passes_ran=probe_ran)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=tuple(CONFIGS), default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu "
                         "(bench.py's small CPU configuration)")
    args = ap.parse_args(argv)
    line, _ = run_bench(args.device, **CONFIGS[args.device])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
