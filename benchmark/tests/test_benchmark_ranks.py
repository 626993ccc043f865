"""A cell on several cards, run on the CPU as gloo ranks: one process per
rank, the window bounded by barriers, the outputs gathered to rank 0 in
rank order, the device report taken over every rank, and a failing rank
failing the run; and a one-card run starting no process group.

    python -m pytest benchmark/tests -q
"""

import json
import re
import subprocess
import sys
import time

import pytest
import torch

from benchtools import REPO, run_ranks, tiny_root

sys.path[:0] = [str(REPO)]

from benchmark import harness  # noqa: E402

CELL = "tiny_logit.chainmesh"
SEED = 2**31 + 11

# a chain-mesh driver with a fault planted on one rank, named by the
# workload's "fault": raise, import a module, sleep once near the window's
# end, or hang
FAULTY = """
import importlib
import time

import torch.distributed as dist

from benchmark.drivers import chainmesh


class Driver(chainmesh.Driver):

    def __init__(self, config, work, *args, **kw):
        super().__init__(config, work, *args, **kw)
        self.fault, self.t_first = work["fault"], None

    def chunk(self, keep):
        if keep and self.t_first is None:
            self.t_first = time.perf_counter()
        super().chunk(keep)
        f = self.fault
        if not keep or dist.get_rank() != f["rank"]:
            return
        if f["kind"] == "raise":
            raise RuntimeError("a planted fault")
        if f["kind"] == "import":
            importlib.import_module(f["module"])
        if f["kind"] == "hang":
            time.sleep(3600)
        if (f["kind"] == "sleep" and not f.get("slept")
                and time.perf_counter() - self.t_first >= f["after"]):
            f["slept"] = True
            time.sleep(f["seconds"])
"""

# the gathered outputs, saved where the check receives them
DUMP = """

_run_checks = run_checks


def run_checks(model, X, y, out, seed, work, controls=False):
    import os
    torch.save({k: out[k].cpu() for k in ("draws", "nev", "beta", "eta")},
               os.environ["BENCH_TEST_DUMP"])
    return _run_checks(model, X, y, out, seed, work, controls=controls)
"""


def _add_cell(root, name, engine, **extra):
    work = json.loads((root / "workloads" / "tiny_logit.freerun.json")
                      .read_text())
    work.update(engine=engine, chips=2, **extra)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(work))
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": "tiny_logit",
                              "traffic": name.split(".", 1)[1], "chips": 2,
                              "why": "a CPU test"})
    for m in spec["per_layer"]:
        if "tiny_logit.freerun" in m["workloads"]:
            m["workloads"].append(name)
    (root.parent / "BENCHMARK.json").write_text(json.dumps(spec))


def mesh_root(tmp):
    """A tiny copy with the two-rank chain-mesh cell and a cell of the
    faulty driver per fault."""
    root = tiny_root(tmp)
    _add_cell(root, CELL, "chainmesh")
    (root / "drivers" / "faulty.py").write_text(FAULTY)
    for kind, fault in (
            ("raise", {}), ("import", {"module": "jax"}), ("hang", {}),
            ("sleep", {"after": 0.8, "seconds": 3.0})):
        _add_cell(root, f"tiny_logit.{kind}", "faulty",
                  fault=dict(fault, kind=kind, rank=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return mesh_root(tmp_path_factory.mktemp("ranks"))


def _window_s(stderr: str) -> float:
    return float(re.search(r"# \[rank 0\] window ([0-9.]+) s",
                           stderr).group(1))


def _ranks(stderr: str):
    """{rank: (chunks, evals, passes)} from rank 0's lines."""
    got = re.findall(r"# \[rank 0\] rank (\d+): (\d+) chunks, (\d+) evals, "
                     r"(\d+) passes", stderr)
    return {int(r): tuple(map(int, v)) for r, *v in got}


@pytest.mark.parametrize("trace", [False, True])
def test_chain_mesh_cell_prints_a_well_formed_line(root, trace):
    line, proc = run_ranks(root, CELL, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 2
    assert line["device"]["platform"] == "cpu"
    ranks = _ranks(proc.stderr)
    assert sorted(ranks) == [0, 1]
    (chunks, ev0, p0), (chunks1, ev1, p1) = ranks[0], ranks[1]
    assert chunks == chunks1  # every rank ran rank 0's chunks
    sweeps = chunks * 5
    # every draw of the cell's 8 chains, both ranks' 4
    assert line["attempted"] == 8 * sweeps
    if not trace:
        assert set(line["metrics"]) == {"min_ess_per_s", "draws_per_s",
                                        "setup_s"}
        draws = line["metrics"]["draws_per_s"]["value"]
        assert draws * _window_s(proc.stderr) == pytest.approx(8 * sweeps,
                                                          rel=1e-3)
        return
    m = {k: v["value"] for k, v in line["metrics"].items()}
    # the counts are the sums over the ranks, the pass readers per card
    assert m["evals_per_coord"] == pytest.approx((ev0 + ev1) / (8 * sweeps
                                                                * 6))
    assert m["passes_per_sweep"] == pytest.approx((p0 + p1) / 2 / sweeps)
    assert m["pass_us"] == pytest.approx(
        1e6 * _window_s(proc.stderr) / ((p0 + p1) / 2), rel=1e-3)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_gathered_draws_are_each_shard_in_rank_order(tmp_path):
    """The draws the check receives hold all 8 chains in rank order, each
    rank's 4 bitwise a standalone ``FreeRunCGGibbs`` run of 4 chains under
    ``fold_seed(seed, rank)``, chunk for chunk as the harness ran it."""
    from mcmcglm_tpu_torch.ops.philox import fold_seed

    from benchmark import datagen, spec
    from benchmark.drivers import freerun

    root = mesh_root(tmp_path)
    with open(root / "check.py", "a") as f:
        f.write(DUMP)
    dump = tmp_path / "gathered.pt"
    line, proc = run_ranks(root, CELL,
                           env={"BENCH_TEST_DUMP": str(dump)})
    assert line["correct"] is True
    got = torch.load(dump)
    work, config = spec.cell(CELL, root)
    C, chunk = work["chains"], work["chunk_sweeps"]
    assert got["draws"].shape[0] == C
    K = got["draws"].shape[1] // chunk
    assert K == _ranks(proc.stderr)[0][0]
    X, y, _ = datagen.glm_data(spec.Model(config, root).sample, config["n"],
                               config["d"], SEED)
    for r in range(2):
        alone = dict(work, chains=C // 2)
        drv = freerun.Driver(config, alone, X, y, fold_seed(SEED, r),
                             torch.device("cpu"))
        drv.burn_in()
        for _ in range(1 + work["warm_chunks"]):
            drv.chunk(keep=False)
        for _ in range(K):
            drv.chunk(keep=True)
        want = drv.outputs()
        rows = slice(r * C // 2, (r + 1) * C // 2)
        for k in ("draws", "nev", "beta", "eta"):
            assert torch.equal(got[k][rows], want[k]), (r, k)


def test_a_rank_that_sleeps_at_the_end_lengthens_the_window(root):
    line, proc = run_ranks(root, "tiny_logit.sleep")
    assert line["correct"] is True
    # rank 1 sleeps 3 s once 0.8 s of its window have passed; the window
    # (1 s on rank 0's clock) ends only when rank 1 has synchronised and
    # reached the barrier
    assert _window_s(proc.stderr) >= 0.8 + 3.0
    ranks = _ranks(proc.stderr)
    assert ranks[0][0] == ranks[1][0]


def test_a_rank_that_raises_fails_the_run(root):
    line, proc = run_ranks(root, "tiny_logit.raise", rc=4)
    assert line is None and proc.stdout.strip() == ""
    assert "rank 1 exited with 1" in proc.stderr
    assert "a planted fault" in proc.stderr


def test_a_rank_that_hangs_fails_the_run_at_the_limit(root):
    t = time.perf_counter()
    line, proc = run_ranks(root, "tiny_logit.hang", limit_s=25.0, rc=4)
    assert line is None and proc.stdout.strip() == ""
    assert time.perf_counter() - t < 25.0 + 30.0
    assert "outlived the time limit" in proc.stderr


def test_a_forbidden_module_in_one_rank_stops_the_run(tmp_path):
    root = mesh_root(tmp_path)
    (root.parent / "jax").mkdir()
    (root.parent / "jax" / "__init__.py").write_text("")
    line, proc = run_ranks(root, "tiny_logit.import", rc=3)
    assert line is None
    assert "forbidden modules loaded: jax" in proc.stderr


def test_controls_through_the_ranks(root):
    """What ``calibrate.py`` reads of a multi-card cell: the reference's
    bfloat16 control beside a sound run, and the program's own bfloat16
    path on every rank, each held to the cell's limits, are not correct."""
    code = f"""
import json, time
from benchmark import ranks
got = {{}}
line, _, ctl, _ = ranks.run_cell({CELL!r}, 5, 1.0, False, "cpu", 2,
                                 t_start=time.perf_counter(), controls=True)
got.update(sound=line["correct"], reference_bf16=ctl["correct"])
line, _, _, _ = ranks.run_cell({CELL!r}, 5, 1.0, False, "cpu", 2,
                               t_start=time.perf_counter(),
                               driver_opts={{"x_storage": "bf16"}})
got.update(program_bf16=line["correct"])
print(json.dumps(got))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root.parent, capture_output=True,
        text=True, timeout=600,
        env={"PYTHONPATH": f"{root.parent}:{REPO}", "PATH": "/usr/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"sound": True, "reference_bf16": False,
                   "program_bf16": False}


def test_one_card_run_starts_no_process_group(tmp_path):
    root = tiny_root(tmp_path)
    code = f"""
import time
import torch.distributed as dist
from benchmark import harness
line, rows, _ = harness.run_cell("tiny_logit.freerun", 5, 0.3, False, "cpu",
                                 t_start=time.perf_counter())
print(line["correct"], line["device"]["count"], dist.is_initialized())
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root.parent, capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": f"{root.parent}:{REPO}", "PATH": "/usr/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-3:] == ["True", "1", "False"]


def test_the_launcher_loads_nothing_of_the_program():
    """``run.py`` and the rank launcher start the ranks with the
    benchmark's own code: no module of the port (its ``parallel.launch``
    included) is loaded until a rank's driver loads the engine."""
    code = """
import json, sys
from benchmark import ranks, run
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"mcmcglm_tpu_torch", "mcmcglm_tpu", "jax"}


@pytest.mark.parametrize("reports,chips,want", [
    ([("cuda:0", "H100", 5), ("cuda:1", "H100", 7)], 2, (2, 7)),
    ([("cpu:0", "cpu", 0), ("cpu:1", "cpu", 0), ("cpu:2", "cpu", 0)], 3,
     (3, 0)),
    ([("cuda:0", "H100", 5), ("cuda:0", "H100", 7)], 2, "card"),
    ([("cuda:0", "H100", 5), ("cuda:1", "A100", 7)], 2, "kinds"),
])
def test_device_report(reports, chips, want):
    """The count is the distinct cards that held the ranks' outputs,
    never the cell's chips: two ranks on one card fail a two-card cell,
    and so do cards of two kinds."""
    reps = [{"card": c, "kind": k, "peak": p} for c, k, p in reports]
    if isinstance(want, str):
        with pytest.raises(RuntimeError, match=want):
            harness.device_report(reps, chips)
        return
    got = harness.device_report(reps, chips)
    assert (got["count"], got["memory_peak_bytes"]) == want
    assert got["kind"] == reports[0][1]
