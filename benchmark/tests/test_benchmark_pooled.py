"""The chain mesh with the pooled monitor (``drivers/chainmesh_pooled.py``,
the driver of ``logistic_p1000.chainmesh.c4096x4``) as two gloo ranks on
the CPU at a tiny size: a well-formed, correct line; one ``freerun.run``
call a chunk, which ``spans.window`` still picks; the monitor's readers;
a clean failure on a program whose ``run_thinned`` returns no counter
at each kept draw; and the cell's configuration, BASELINE config 5's
deployment over the north star's data.

    python -m pytest benchmark/tests -q
"""

import json
import re
import time

import numpy as np
import pytest

from benchtools import BENCH, REPO, run_ranks, tiny_root

CELL = "tiny_logit.chainmesh_pooled"
CHUNK = 8
MONITOR = ("monitor_pct", "merge_ms")

# a metric planted in the tiny copy: how many window calls spans.window
# picks
WINDOW_CALLS = """
from benchmark import spans


def read(rec):
    got = spans.window(rec)
    return None if got is None else float(len(got))
"""

# run_thinned as a program without the per-draw counter has it
OLD_PROGRAM = """
import mcmcglm_tpu_torch.freerun as _f

_run_thinned = _f.FreeRunCGGibbs.run_thinned


def run_thinned(self, state, n_outer, thin, moments=None, ess=False,
                ess_max_lag=64):
    return _run_thinned(self, state, n_outer, thin, moments=moments,
                        ess=ess, ess_max_lag=ess_max_lag)


_f.FreeRunCGGibbs.run_thinned = run_thinned
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("pooled"))
    work = json.loads((root / "workloads" / "tiny_logit.freerun.json")
                      .read_text())
    full = json.loads((root / "workloads"
                       / "logistic_p1000.chainmesh.c4096x4.json").read_text())
    work.update(engine="chainmesh_pooled", chips=2, chunk_sweeps=CHUNK,
                monitor=full["monitor"])
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(work))
    (root / "metrics" / "tiny_window_calls.py").write_text(WINDOW_CALLS)
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny_logit",
                              "traffic": "chainmesh_pooled", "chips": 2,
                              "why": "a CPU test"})
    for m in spec["per_layer"]:
        if "tiny_logit.freerun" in m["workloads"] or m["name"] in MONITOR:
            m["workloads"].append(CELL)
    spec["per_layer"].append({
        "name": "tiny_window_calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "engine",
        "moves": "draws_per_s", "workloads": [CELL]})
    (root.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _chunks(stderr: str) -> list:
    return [int(c) for c in re.findall(
        r"# \[rank 0\] rank \d+: (\d+) chunks", stderr)]


@pytest.mark.parametrize("trace", [False, True])
def test_pooled_cell_prints_a_correct_line(root, trace):
    line, proc = run_ranks(root, CELL, trace=trace, seconds=1.5)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 2
    chunks = _chunks(proc.stderr)
    assert len(chunks) == 2 and chunks[0] == chunks[1]
    # every draw of the 8 chains kept, every sweep counted by the check
    assert line["attempted"] == 8 * CHUNK * chunks[0]
    assert line["checks"]["short_sweeps"]["value"] == 0
    # a step after the capture chunk, the warm chunk and each window chunk
    steps = re.findall(r"# \[rank 0\] monitor step (\d+): max R-hat "
                       r"[0-9.]+, min ESS [0-9.]+ over (\d+) draws a chain",
                       proc.stderr)
    assert [int(s) for s, _ in steps] == list(range(1, chunks[0] + 3))
    assert [int(k) for _, k in steps] == [CHUNK * (i + 1)
                                          for i in range(len(steps))]
    assert "[rank 1] monitor step" not in proc.stderr
    m = {k: v["value"] for k, v in line["metrics"].items()}
    if not trace:
        assert set(m) == {"min_ess_per_s", "draws_per_s", "setup_s"}
        return
    # one freerun.run call a chunk: spans.window picks the window's
    assert m["tiny_window_calls"] == chunks[0]
    assert 0 < m["monitor_pct"] < 100 and m["merge_ms"] > 0
    # no device times on the CPU
    assert not {"call_gap_pct", "replay_pass_us"} & set(m)


def test_a_program_without_the_counter_fails_soon(root):
    """The parent program's ``run_thinned`` has no ``nev_at_draws``: the
    driver's import raises in every rank and the run exits 4 with no
    result line, before any kernel, data or engine."""
    (root.parent / "sitecustomize.py").write_text(OLD_PROGRAM)
    try:
        t = time.perf_counter()
        line, proc = run_ranks(root, CELL, rc=4)
    finally:
        (root.parent / "sitecustomize.py").unlink()
    assert line is None and proc.stdout.strip() == ""
    assert "nev_at_draws" in proc.stderr
    assert "kernel library" not in proc.stderr
    assert time.perf_counter() - t < 120.0


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_config_5_is_its_own_configuration():
    """The four-card cell runs ``logistic_p1000_pooled``: its entry names
    its own file and source, the file holds the north star's model (the
    same family, link, prior, n, d and data) and states the deployment the
    cell runs: 4,096 chains, config 5's 30 burn-in sweeps, thin 1."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"]
                if w["name"] == "logistic_p1000.chainmesh.c4096x4")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    work = json.loads((BENCH / "workloads" / f"{cell['name']}.json")
                      .read_text())
    cfg, north = _cfg(cell["config"]), _cfg("logistic_p1000")
    assert work["config"] == cell["config"] == cfg["name"]
    assert entry["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert entry["source"] == cfg["source"] != north["source"]
    assert entry["reduced"] == cfg["reduced"] == []
    for key in ("family", "link", "prior", "n", "d", "extra", "dtype",
                "data"):
        assert cfg[key] == north[key], key
    assert (cfg["chains"], cfg["burnin_sweeps"], cfg["thin"]) == (
        work["chains"], work["burnin_sweeps"], 1)
    assert cell["chips"] == work["chips"] == 4


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_config_5_data_is_the_north_stars(seed):
    """The same seed gives config 5's cell the north star's data."""
    from benchmark import datagen, spec

    got, want = (datagen.glm_data(spec.Model(_cfg(c)).sample, 60, 9, seed)
                 for c in ("logistic_p1000_pooled", "logistic_p1000"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
