"""Old against new battery and fused kernels, and the paths around them,
on one GPU.

    python scripts/torch_battery_ab.py --parent build/parent [--out FILE]

``--parent`` is an unpacked copy of another tree of this repository (for
example ``git archive <commit> | tar -x -C build/parent``).  The script runs
one worker process per tree in the order parent, change, change, parent,
each importing ``mcmcglm_tpu_torch`` from its own tree (and building that
tree's kernels there), and measures in each, on the card:

* ``battery_gather_commit`` with float32 and with bf16 rows at the main
  path's shape (C=256, n=10,000, K=4, binomial/logit, an X^T of d=1,000
  rows, 40 MB, and eta at 10 MB), as device time: CUDA events around
  replays of a captured CUDA graph of 20 launches back to back, and of 20
  launches each after a 128 MB write that evicts the 50 MB L2, less the
  graph of the 20 writes alone; and at three diagnostic shapes (132
  chains, one wave of clusters; K=1; rows of n=1,024);
* the main path at the bench configuration of ``chip_smoke.py`` phase 4
  (``battery_impl="auto"``, graph loop): ms per pass and sweeps/s over
  ``--sweeps`` sampling sweeps after ``--warmup`` warmup sweeps, graph
  captures excluded, and the battery's device time per pass under
  ``torch.profiler``;
* ``fused_coord_update`` (one coordinate) and ``fused_sweep`` (d=16) on
  the operands of ``chip_smoke.py`` phase 3b (C=256, n=10,000,
  binomial/logit, Normal(0, 1), w=0.5, block_chains=8), as device time by
  replays of a captured CUDA graph of 20 launches;
* the full-width fused path, by ``chip_smoke.fused_path`` (phase 4b:
  ``FusedCGGibbs`` at d=1,000, ``FUSED_SWEEPS`` sweeps at granularity
  "sweep", then one by coordinate launches): ms per sweep on the host
  clock for each granularity.

Each worker also records nvcc's version and, from the nvcc log kept
beside the tree's library, the kernel functions that ptxas reports as
spilling and every kernel instantiation's registers and spill bytes
(``chip_smoke.ptxas_table``).
It prints one line per worker, then the instantiations of the six
family/link pairs with a density path of their own (template ids 0-5)
whose registers or spills differ between the trees, then the card's name
and power limit, and writes every number to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

C, N, K, D = 256, 10_000, 4, 1_000


def load_smoke():
    """chip_smoke.py of this script's own tree, for its operands and
    timers (it imports the package only inside its functions, so the
    worker's tree supplies ``mcmcglm_tpu_torch``)."""
    import importlib.util

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def cold_ms(smoke, fn):
    """Device milliseconds of one call after a write that evicts the L2."""
    import torch

    junk = torch.empty(32 * 2**20, device="cuda")  # 128 MB

    def flush():
        junk.fill_(1.0)

    def both():
        flush()
        fn()

    return smoke.graph_ms(both) - smoke.graph_ms(flush)


# diagnostic shapes (C, n, K), float32 rows at d=1,000: one wave of
# clusters, a quarter of the arithmetic on the same bytes, short rows
DIAGNOSTICS = {"one_wave": (132, N, K), "k1": (C, N, 1),
               "short_rows": (C, 1_024, K)}


def kernel_times(fb):
    import torch

    smoke = load_smoke()
    out = {}

    def timer(a, rows):
        def kern():
            return fb.battery_gather_commit(a["j"], rows, a["eta"],
                                            a["deltas"], a["fprior"],
                                            a["scal"], a["y"], a["m"],
                                            a["fam"], a["extra"])
        return kern

    a = smoke.battery_inputs(C, N, K, "binomial", d=D, seed=3)
    for name, rows in (("f32", a["Xt"]), ("bf16", a["Xt"].to(torch.bfloat16))):
        kern = timer(a, rows)
        out[f"gather_{name}_ms"] = smoke.graph_ms(kern)
        out[f"gather_{name}_cold_ms"] = cold_ms(smoke, kern)
    for name, (c, n, k) in DIAGNOSTICS.items():
        a = smoke.battery_inputs(c, n, k, "binomial", d=D, seed=3)
        out[f"{name}_ms"] = smoke.graph_ms(timer(a, a["Xt"]))
    return out


def main_path(mt):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    X, y, _ = mt.generate_glm_data("binomial", n=N, d=D, seed=0)
    eng = mt.FreeRunCGGibbs(
        X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), D),
        tuning={"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0},
        slice_kernel="quantile", spec_k=4, battery_impl="auto",
        device="cuda")
    assert eng.battery_impl == "cuda3", eng.battery_impl
    stats = eng.loop_stats
    st = eng.init(0, C)
    st, _, _ = eng.warmup(st, ARGS.warmup)
    torch.cuda.synchronize()
    cap0, ctr0 = stats["capture_seconds"], int(st.ctr)
    t0 = time.perf_counter()
    st, _, _ = eng.run(st, ARGS.sweeps)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0 - (stats["capture_seconds"] - cap0)
    passes = int(st.ctr) - ctr0
    n_prof = 2 * eng._block_passes
    eng.run_passes(st, None, None, None, 1, n_prof)  # captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_passes(st, None, None, None, 1, n_prof)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev)
    battery = sum(e.time_range.elapsed_us() for e in dev
                  if "battery" in e.name)
    return dict(ms_per_pass=1e3 * t / passes, sweeps_per_s=ARGS.sweeps / t,
                passes_per_sweep=passes / ARGS.sweeps,
                device_busy_us_per_pass=busy / n_prof,
                battery_us_per_pass=battery / n_prof,
                device_ops_per_pass=len(dev) / n_prof)


def fused_times(mt, fc):
    smoke = load_smoke()
    eng, st = smoke.fused_problem("binomial", mt.Normal(0.0, 1.0), C, N, 16,
                                  seed=1)
    args = (eng.family, eng.extra, eng.prior.dist)
    kw = dict(seed=st.seed, sweep=0, w=0.5, block_chains=eng.block_chains)
    b0 = st.beta[:, 0].contiguous()
    return dict(
        fused_coord_ms=smoke.graph_ms(lambda: fc.fused_coord_update(
            st.eta, b0, eng.Xt[0], eng.y, *args, j=0, **kw)),
        fused_sweep_d16_ms=smoke.graph_ms(lambda: fc.fused_sweep(
            st.eta, st.beta, eng.Xt, eng.y, *args, **kw)))


def build_report(build):
    """nvcc's version, the kernel functions that ptxas reports as spilling
    and the per-instantiation ptxas table, from the build's log."""
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    spills, fn = [], None
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and not line.strip().startswith(
                "0 bytes stack frame, 0 bytes spill"):
            spills.append(f"{fn}: {line.strip()}")
    return dict(nvcc=nvcc[-1] if nvcc else None, ptxas_spills=spills,
                ptxas=load_smoke().ptxas_table(
                    build.BUILD_INFO.get("log", "")))


def worker(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import mcmcglm_tpu_torch as mt
    from mcmcglm_tpu_torch.ops import _build
    from mcmcglm_tpu_torch.ops import freerun_batteries as fb
    from mcmcglm_tpu_torch.ops import fused_cggibbs as fc

    if not os.path.abspath(mt.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {mt.__file__}, not the tree {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    t0 = time.perf_counter()
    _build.load_library()
    rec = dict(root=root, build_s=time.perf_counter() - t0)
    rec.update(build_report(_build))
    rec.update(kernel_times(fb))
    rec.update(main_path(mt))
    rec.update(fused_times(mt, fc))
    ms = load_smoke().fused_path()[1]
    rec.update(fused_ms_per_sweep=ms["sweep"],
               fused_coord_ms_per_sweep=ms["coord"])
    print(json.dumps(rec), flush=True)


def compare():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(ARGS.parent)
    runs = []
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root,
             "--warmup", str(ARGS.warmup), "--sweeps", str(ARGS.sweeps)],
            capture_output=True, text=True, timeout=1200, cwd=root)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise RuntimeError(f"the {label} worker failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"] = label
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    built = {r["tree"]: r["ptxas"] for r in runs if r["ptxas"]}
    if len(built) == 2:
        own = [k for k in built["parent"]
               if int(k.split("<")[1].split(",")[0]) < 6]
        differ = {k: (built["parent"][k], built["change"].get(k))
                  for k in own if built["parent"][k] != built["change"].get(k)}
        print(json.dumps(dict(own_pair_instantiations=len(own),
                              ptxas_differ=differ)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    if ARGS.out:
        os.makedirs(os.path.dirname(os.path.abspath(ARGS.out)), exist_ok=True)
        with open(ARGS.out, "w") as f:
            json.dump(dict(card=card, runs=runs), f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked tree to compare with")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--out")
    ARGS = ap.parse_args()
    if ARGS.worker:
        worker(ARGS.worker)
    elif ARGS.parent:
        compare()
    else:
        ap.error("--parent is required")
