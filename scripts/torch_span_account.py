"""The span account of one benchmark run: where the window's device time
goes, from the program's own spans (``utils/profiling.py``).

Runs one cell as ``benchmark/run.py`` does (same set-up, window, trace,
check and result line, printed last on standard output) and then reads
the recorder: the window's calls (``benchmark/spans.py``), their device
spans' time (``loop.replay`` or ``fused.sweep``), the gaps between them
inside a call and between calls, the stretch from the first call's host
start to its first device span and from the last device span to the
window's end on the host clock; their sum against the window's seconds
(the account); and the error of the host-clock mapping: each replay's
mapped end against the host return of its own flag read (at least 0: the
call sits at the tightest bound its reads give, and its anchor's own
reads 0), and each pair of consecutive calls' mapped gap
against the elapsed time between their events; and the block boundary's
host time (the flag read, the host from its return to the next replay,
the replay's enqueue) beside its device gap.  ``--spans off`` switches
the recorder off before the run (its cost, on against off); no account is
taken then.  The account goes to standard error as one JSON line and,
with ``--out``, appended to that file.

    python3 scripts/torch_span_account.py \\
        --workload logistic_p1000.freerun.c256 --seed 3000000017 \\
        --seconds 51 --trace 1 --out chiprun_out/account.jsonl
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness, spans, spec  # noqa: E402
from benchmark.run import emit  # noqa: E402
from mcmcglm_tpu_torch.utils import profiling  # noqa: E402


def _quantiles(xs):
    if not xs:
        return None
    xs = sorted(xs)
    return {"n": len(xs), "min": xs[0], "median": statistics.median(xs),
            "p95": xs[min(len(xs) - 1, int(0.95 * len(xs)))],
            "max": xs[-1]}


def account(rec_window, got, every) -> dict:
    """The window's account (module docstring) from its calls ``got``
    (``benchmark.spans.window``) and all recorded spans ``every``."""
    w_us = 1e6 * rec_window["seconds"]
    devs = [s for _, d in got for s in d]
    dev_us = sum(s["dev_us"] for s in devs)
    block_gaps = sum(s["gap_us"] for _, d in got for s in d[1:])
    call_gaps = sum(d[0]["gap_us"] for _, d in got[1:])
    first_call, last_dev = got[0][0], got[-1][1][-1]
    before = (got[0][1][0]["dev0"] - first_call["t0"]) / 1e3
    after = (first_call["t0"] + 1e3 * w_us - last_dev["dev1"]) / 1e3
    total = dev_us + block_gaps + call_gaps + before + after
    # the mapping's error: a replay's end against its own flag read
    reads = {}
    for s in every:
        if s["name"] == "loop.flag_read":
            reads.setdefault(s["call"], []).append(s)
    flag_err = []
    for call, d in got:
        rd = reads.get(call["id"], [])
        if len(rd) == len(d):
            flag_err += [(f["t1"] - r["dev1"]) / 1e3
                         for r, f in zip(d, rd)]
    anchors = [((d1[0]["dev0"] - d0[-1]["dev1"]) / 1e3 - d1[0]["gap_us"])
               for (_, d0), (_, d1) in zip(got, got[1:])]
    # the block boundary on the host: the flag read, the host from its
    # return to the next replay span, the replay's enqueue (its events and
    # cudaGraphLaunch); beside each boundary's device gap
    host = {"flag_read": [], "read_to_next_replay": [], "replay_enqueue": [],
            "device_gap": []}
    for call, d in got:
        rd = reads.get(call["id"], [])
        if len(rd) != len(d):
            continue
        for i, (r, f) in enumerate(zip(d, rd)):
            host["flag_read"].append((f["t1"] - f["t0"]) / 1e3)
            host["replay_enqueue"].append((r["t1"] - r["t0"]) / 1e3)
            if i + 1 < len(d):
                host["read_to_next_replay"].append(
                    (d[i + 1]["t0"] - f["t1"]) / 1e3)
                host["device_gap"].append(d[i + 1]["gap_us"])
    per_call_before = [(d[0]["dev0"] - c["t0"]) / 1e3 for c, d in got]
    per_call_after = [(c["t1"] - d[-1]["dev1"]) / 1e3 for c, d in got]
    return {"window_us": w_us, "calls": len(got), "device_spans": len(devs),
            "device_us": dev_us, "block_gap_us": block_gaps,
            "call_gap_us": call_gaps, "before_us": before,
            "after_us": after, "sum_us": total,
            "sum_over_window": total / w_us,
            "shares_pct": {k: 100.0 * v / w_us for k, v in (
                ("device", dev_us), ("block_gaps", block_gaps),
                ("call_gaps", call_gaps), ("before", before),
                ("after", after))},
            "mapping_error_us": {
                "flag_read_after_replay_end": _quantiles(flag_err),
                "anchor_disagreement_between_calls": _quantiles(anchors)},
            "block_boundary_us": {k: _quantiles(v) for k, v in host.items()},
            "call_host_start_to_device_us": _quantiles(per_call_before),
            "call_last_device_to_host_return_us": _quantiles(per_call_after),
            "dropped_spans": profiling.dropped_spans()}


def _keep_record(seen: dict) -> None:
    """The harness hands its record of the run only to the metric
    readers: wrap their loading so that the record they read is kept in
    ``seen["rec"]``."""
    load = spec.load_file

    def load_keeping(path):
        mod = load(path)
        read = getattr(mod, "read", None)
        if path.parent.name != "metrics" or read is None:
            return mod

        def keep(rec):
            seen["rec"] = rec
            return read(rec)

        mod.read = keep
        return mod

    spec.load_file = load_keeping


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", choices=("on", "off"), default="on")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_account.py: CUDA is not available",
              file=sys.stderr)
        return 2
    profiling.set_span_recording(args.spans == "on")
    seen = {}
    _keep_record(seen)
    line, rows, _ = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        t_start=T_START)
    out = {"workload": args.workload, "seed": args.seed,
           "trace": args.trace, "spans": args.spans,
           "card": harness._smi(), "metrics": line["metrics"]}
    got = spans.timed(seen["rec"]) if args.spans == "on" else None
    if got is not None:
        out["account"] = account(seen["rec"]["window"], got,
                                 profiling.spans())
    print("ACCOUNT " + json.dumps(out), file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return emit(line, rows)


if __name__ == "__main__":
    sys.exit(main())
