"""Render the port's example walkthroughs into docs/torch/ with executed output.

The counterpart of ``scripts/render_docs.py`` for ``mcmcglm_tpu_torch``:
each ``examples/torch_0*.py`` runs in a subprocess, a non-zero exit fails
the run, and the source and its captured output are written as one
markdown document per example plus an index (``README.md``).  Each
document's header names the device it ran on: on CUDA, the card's name and
power limit as nvidia-smi reports them.

Every example runs under a small wrapper (``run_example``) that records,
after the example finishes, the top-level modules the process imported and
the launch counts of the port's CUDA kernels.  The wrapper also hands
every ``parallel.launch.run_local`` call of the example a rank function
that returns the same record from each spawned rank (``RankReport``), so
the rank processes of examples 04 and 06 are checked and counted as well
(the report's ``ranks`` holds their records; ``modules`` and ``launches``
cover every process).  ``check`` fails a run that
exited non-zero, imported JAX, the JAX package, pandas or matplotlib, or
printed a plain-battery ``RuntimeWarning`` other than example 02's
documented one (its user-registered family has no hand kernel).
``chip_smoke.py`` drives the same runner.

    python scripts/torch_render_docs.py                    # on the card, into docs/torch/
    python scripts/torch_render_docs.py --device cpu --small --out build/docs_cpu
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    (
        "torch_01_families_and_priors.py",
        "Families and priors tour",
        "Every scenario of the reference's main vignette (`pospkg.Rmd`): "
        "gaussian/identity, binomial/logit, binomial/probit, poisson/log, "
        "negative binomial; IID, strongly misspecified, per-coordinate list "
        "and multivariate-normal priors; the normal-normal conjugate "
        "cross-check.",
    ),
    (
        "torch_02_customising.py",
        "Adding a new family",
        "The reference's extension recipe (`customising.Rmd`) as one "
        "`register_family` call with a log density written in torch.  No "
        "hand kernel can compile a Python density, so this family runs the "
        "plain battery, and the engine says so with a `RuntimeWarning` "
        "naming the pair.  A chain drawn far out can stay on this density's "
        "flat tail; the example names such chains by their log likelihood.",
    ),
    (
        "torch_03_performance.py",
        "Update-against-naive runtime",
        "The reference's methodology (`performance.Rmd`) on the lockstep "
        "engine through the pandas-free timing core "
        "(`perf.eta_comptime_rows_across_nvars`), with the log-log slopes of "
        "both calculations.  The lockstep engine is host-bound, so the "
        "timed sweeps are cut (the example's docstring says how far).",
    ),
    (
        "torch_04_multichip.py",
        "Multi-card sharded sampling",
        "The sharded lockstep engine over a (chain x obs) mesh, one process "
        "per card, with pooled streaming diagnostics (`parallel/`).",
    ),
    (
        "torch_05_speculative_batteries.py",
        "Speculative proposal batteries",
        "K slice proposals per device pass, evaluated in one hand-written "
        "CUDA battery kernel and consumed first-acceptor: spec_k=1 against "
        "spec_k=4 on one problem.",
    ),
    (
        "torch_06_tall_data_and_recovery.py",
        "Tall data, on-device diagnostics, alternative kernels",
        "The obs-sharded free-running engine (one all-reduce of the "
        "battery's partial sums per pass), streaming min-ESS on the device, "
        "and the latent, doubling and adapted-quantile slice kernels on the "
        "free-running engine.",
    ),
]

# the examples that spawn one process per card (``--procs`` on the CPU)
MULTI_PROCESS = ("torch_04_multichip.py", "torch_06_tall_data_and_recovery.py")
# modules no example may import: the card has none of them
FORBIDDEN = ("jax", "jaxlib", "mcmcglm_tpu", "pandas", "matplotlib")
# the one plain-battery warning an example may print: example 02 registers
# a family no hand kernel serves
ALLOWED_WARNING = {"torch_02_customising.py": "my.inverse.gaussian/log"}

_WRAPPER = r"""
import json, runpy, sys
path, report, scripts = sys.argv[1], sys.argv[2], sys.argv[3]
sys.argv = [path] + sys.argv[4:]
sys.path.insert(0, scripts)
import torch_render_docs as rd
ranks = rd.report_ranks()
try:
    runpy.run_path(path, run_name="__main__")
finally:
    with open(report, "w") as fh:
        json.dump(rd.merged_report(rd.process_report(), ranks), fh)
"""


def process_report():
    """This process's top-level modules and the port's kernel launch
    counts."""
    modules = sorted({m.split(".")[0] for m in sys.modules})
    launches = {}
    if "mcmcglm_tpu_torch" in sys.modules:
        from mcmcglm_tpu_torch.ops import (freerun_automaton,
                                           freerun_batteries, fused_cggibbs)

        launches = {**freerun_batteries.launch_counts,
                    **fused_cggibbs.launch_counts,
                    **freerun_automaton.launch_counts}
    return {"modules": modules, "launches": launches}


class RankReport:
    """A rank function for ``run_local`` that returns ``fn``'s value with
    the rank process's :func:`process_report`."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, rank, *args):
        return {"value": self.fn(rank, *args), "report": process_report()}


def report_ranks():
    """Make ``parallel.launch.run_local`` run every rank function under
    :class:`RankReport` and hand back the values alone; returns the list
    that gathers the ranks' reports."""
    from mcmcglm_tpu_torch.parallel import launch

    ranks, run_local = [], launch.run_local

    def reporting(fn, *args, **kwargs):
        out = run_local(RankReport(fn), *args, **kwargs)
        ranks.extend(r["report"] for r in out)
        return [r["value"] for r in out]

    launch.run_local = reporting
    return ranks


def merged_report(parent, ranks):
    """The parent's report with the ranks' modules and launches added."""
    modules, launches = set(parent["modules"]), dict(parent["launches"])
    for rep in ranks:
        modules.update(rep["modules"])
        for k, v in rep["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"modules": sorted(modules), "launches": launches,
            "ranks": ranks}


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def run_example(path, args=(), *, cwd=None, env=None, timeout=1800):
    """Run the script ``path`` with ``args`` under the wrapper: a dict of
    its ``returncode``, ``stdout``, ``stderr``, ``seconds`` and the
    wrapper's report (``modules`` imported and kernel ``launches``, over
    the example's process and its ``run_local`` ranks, and ``ranks``, each
    rank's own; None when the wrapper wrote none)."""
    full_env = dict(os.environ if env is None else env)
    full_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, full_env.get("PYTHONPATH", "")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _WRAPPER, os.path.abspath(path), report,
             os.path.dirname(os.path.abspath(__file__)), *args],
            capture_output=True, text=True, timeout=timeout,
            cwd=cwd or REPO, env=full_env,
        )
        seconds = time.perf_counter() - t0
        rep = None
        if os.path.exists(report):
            with open(report) as fh:
                rep = json.load(fh)
    return {"returncode": proc.returncode, "stdout": proc.stdout,
            "stderr": proc.stderr, "seconds": seconds, "report": rep}


def check(fname, result):
    """The reasons ``result`` (of :func:`run_example`) fails: a non-zero
    exit, a missing report, a forbidden module, or a plain-battery
    ``RuntimeWarning`` other than the example's allowed one."""
    problems = []
    if result["returncode"]:
        problems.append(f"exit code {result['returncode']}")
    rep = result["report"]
    if rep is None:
        problems.append("no report from the wrapper")
    else:
        bad = sorted(set(rep["modules"]) & set(FORBIDDEN))
        if bad:
            problems.append(f"imported {bad}")
    allowed = ALLOWED_WARNING.get(fname)
    for line in result["stderr"].splitlines():
        if "RuntimeWarning" in line and "plain torch" in line and not (
                allowed and allowed in line):
            problems.append(f"plain-battery warning: {line.strip()}")
    return problems


def example_args(fname, device="cuda", small=False, procs=2):
    """The command-line arguments of example ``fname`` for ``device``: the
    multi-process examples take ``--procs`` on the CPU."""
    args = ["--device", device] + (["--small"] if small else [])
    if fname in MULTI_PROCESS and not device.startswith("cuda"):
        args += ["--procs", str(procs)]
    return args


def where_line(device="cuda", small=False):
    """Where the documents were executed, for their headers."""
    if device.startswith("cuda"):
        return f"on {nvidia_smi_line()} (nvidia-smi name, power limit)"
    return "on the CPU (`--device cpu`" + (", `--small`)" if small else ")")


def write_docs(out_dir, results, where):
    """One document per example of ``results`` ({file name: the
    :func:`run_example` result}), with its source and captured output, and
    the index ``README.md``."""
    os.makedirs(out_dir, exist_ok=True)
    index = [
        "# mcmcglm_tpu_torch: rendered walkthroughs",
        "",
        "The port's example walkthroughs with their executed output, written",
        "by `scripts/torch_render_docs.py` " + where + ".",
        "Re-run it to refresh the numbers.",
        "",
    ]
    for fname, title, blurb in EXAMPLES:
        res = results[fname]
        path = os.path.join(REPO, "examples", fname)
        with open(path) as fh:
            src = fh.read()
        out_md = os.path.join(out_dir, fname.replace(".py", ".md"))
        rel = os.path.relpath(path, out_dir)
        with open(out_md, "w") as f:
            f.write(f"# {title}\n\n{blurb}\n\n")
            f.write(f"Executed {where} in {res['seconds']:.1f} s.\n\n")
            f.write(f"Source: [`examples/{fname}`]({rel}); run it from the "
                    f"repository root with `PYTHONPATH=. python "
                    f"examples/{fname}`.\n\n")
            f.write("## Code\n\n```python\n")
            f.write(src.rstrip())
            f.write("\n```\n\n## Executed output\n\n```\n")
            f.write(res["stdout"].rstrip())
            f.write("\n```\n")
        index.append(f"- [{title}]({fname.replace('.py', '.md')})")
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")


def render(out_dir, device="cuda", small=False, procs=2, env=None,
           jobs=1):
    """Run every example from ``out_dir`` with :func:`example_args`, ``jobs``
    at a time (1 for the documents, so that each example's time is its
    own), on CUDA after building the kernels (the examples load the cached
    build), then write the documents there; returns {file name: the
    :func:`run_example` result}.  Raises RuntimeError naming every example
    that fails :func:`check`."""
    os.makedirs(out_dir, exist_ok=True)
    if device.startswith("cuda"):
        # build the kernels once, so that no example's time carries nvcc
        from mcmcglm_tpu_torch.ops import _build

        _build.load_library()

    def one(fname):
        res = run_example(os.path.join(REPO, "examples", fname),
                          example_args(fname, device, small, procs),
                          cwd=out_dir, env=env)
        print(f"{fname}: exit {res['returncode']} in {res['seconds']:.1f} s",
              flush=True)
        return res

    names = [fname for fname, _, _ in EXAMPLES]
    with ThreadPoolExecutor(max(1, int(jobs))) as pool:
        results = dict(zip(names, pool.map(one, names)))
    problems = {f: check(f, r) for f, r in results.items()}
    failed = {f: p for f, p in problems.items() if p}
    for fname in failed:
        print(results[fname]["stdout"])
        print(results[fname]["stderr"], file=sys.stderr)
    if failed:
        raise RuntimeError("; ".join(f"{f} failed: {', '.join(p)}"
                                     for f, p in failed.items()))
    write_docs(out_dir, results, where_line(device, small))
    print(f"wrote {len(results)} documents and README.md to {out_dir}",
          flush=True)
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "torch"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--procs", type=int, default=2,
                    help="CPU processes of the multi-process examples")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; pass "
                               "--device cpu to render on the CPU")
    render(os.path.abspath(args.out), device=args.device, small=args.small,
           procs=args.procs)


if __name__ == "__main__":
    main()
