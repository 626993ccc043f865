"""Readings that set a cell's limits: the program's numbers on many seeds
and the controls' on a few, in one process (the kernel library loads
once).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 10 --out <file.jsonl>

Each seed runs the cell as ``run.py`` does (with a window of ``seconds``)
and gives one row of the numbers compared.  On a control seed the row also
holds the reference's bfloat16 controls (``check.run_checks``), and a
free-running cell runs once more with the program's own lower precision,
``x_storage="bf16"``, for another row.  Each control is held to the
cell's limits as a run is (``check.verdict``).  The last lines summarise,
for each number, the largest sound reading and the smallest control
reading, and whether each control came out correct (it must not).
A cell on several cards runs each seed as ``run.py`` does, one process
per card (``ranks.py``).  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness, ranks, spec  # noqa: E402


def _ints(text):
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    work, _ = spec.cell(args.workload)
    sound, control, verdicts = {}, {}, []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        def write(row):
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), flush=True)

        runs = [(s, None) for s in args.seeds]
        if work["engine"] in ("freerun", "chainmesh"):
            runs += [(s, {"x_storage": "bf16"}) for s in args.control_seeds]
        for seed, opts in runs:
            ctl = opts is None and seed in args.control_seeds
            kw = dict(t_start=time.perf_counter(), driver_opts=opts,
                      controls=ctl)
            if int(work["chips"]) == 1:
                line, rows, refctl = harness.run_cell(
                    args.workload, seed, args.seconds, False, "cuda", **kw)
            else:
                line, rows, refctl, _ = ranks.run_cell(
                    args.workload, seed, args.seconds, False, "cuda",
                    int(work["chips"]), **kw)
            nums = {r[0]: r[1] for r in rows}
            kind = "program" if opts is None else "program_bf16"
            row = {"cell": args.workload, "seed": seed, "kind": kind,
                   "numbers": nums, "correct": line["correct"],
                   "metrics": line["metrics"], "device": line["device"]}
            if refctl is not None:
                row["reference_bf16"] = refctl["numbers"]
                row["reference_bf16_correct"] = refctl["correct"]
                verdicts.append(refctl["correct"])
                for k, v in refctl["numbers"].items():
                    control.setdefault(k, []).append(v)
            if opts is not None:
                verdicts.append(line["correct"])
            write(row)
            for k, v in nums.items():
                book = sound if opts is None else control
                book.setdefault(k, []).append(v)
            torch.cuda.empty_cache()
    for k in sound:
        c = control.get(k, [])
        print(f"summary {args.workload} {k}: sound max {max(sound[k])!r} "
              f"over {len(sound[k])}; control min "
              f"{min(c) if c else None!r} over {len(c)}", flush=True)
    print(f"summary {args.workload} controls correct: {verdicts}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
