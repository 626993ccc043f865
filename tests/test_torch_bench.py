"""The port's bench entry point (``bench_torch.py``) on the CPU: its JSON
line at a tiny size, the numbers in it against what they were computed
from, its refusal to run without CUDA unless asked for the CPU, its imports,
and its configuration against ``bench.py``'s own (read from bench.py's
source, so a change to either shows)."""

import ast
import json
import math
import os
import statistics
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402
from mcmcglm_tpu_torch.diagnostics import ess  # noqa: E402

TINY = dict(n=500, d=20, n_chains=4, burnin=5, timed_sweeps=10, np_sweeps=1,
            spec_k=4, probe_passes=40)
CAPTURES = bench_torch.PROBE_CAPTURES
# keys bench_torch adds to bench.py's line; keys it leaves out (TPU only)
ADDED = {"device", "build_cache_hit", "build_seconds", "capture_seconds",
         "timed_ms_per_pass", "passes_per_sweep",
         "pass_microseconds_captures", "kernel_launches"}
DROPPED = {"selection_cache_hit", "note"}
# keys with no value on the CPU (no card, no build)
CARD_ONLY = {"pct_hbm_peak", "hbm_peak_gbps_assumed", "build_cache_hit"}


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
            "CUDA_VISIBLE_DEVICES": ""}


def _bench_main():
    tree = ast.parse((REPO / "bench.py").read_text())
    return next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")


def bench_settings(on_accel: bool) -> dict:
    """The local settings of ``bench.main()`` on one branch: its plain
    assignments and the ``if`` blocks made only of assignments, executed
    with an empty environment (no ``BENCH_*`` override) where their
    right-hand sides need nothing else; plus the engine's keywords."""
    main = _bench_main()
    ns = {"os": types.SimpleNamespace(environ={}), "float": float,
          "on_accel": on_accel}
    for node in main.body:
        simple = isinstance(node, ast.Assign) or (
            isinstance(node, ast.If)
            and all(isinstance(b, ast.Assign)
                    for b in node.body + node.orelse))
        if simple and not (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "on_accel"
                for t in node.targets)):
            try:
                exec(compile(ast.Module([node], []), "bench.py", "exec"), ns)
            except (NameError, AttributeError, TypeError):
                pass  # needs jax or a run-time value
    call = next(c for c in ast.walk(main) if isinstance(c, ast.Call)
                and getattr(c.func, "id", None) == "FreeRunCGGibbs")
    kw = {k.arg: k.value for k in call.keywords}
    out = {name: ns[name] for name in (
        "n", "d", "n_chains", "burnin", "timed_sweeps", "np_sweeps",
        "chunk", "probe_passes")}
    out["tuning"] = eval(compile(ast.Expression(kw["tuning"]), "bench.py",
                                 "eval"), ns)
    out["slice_kernel"] = eval(compile(ast.Expression(kw["slice_kernel"]),
                                       "bench.py", "eval"), ns)
    out["spec_k"] = eval(compile(ast.Expression(kw["spec_k"]), "bench.py",
                                 "eval"), ns)
    out["family"] = ast.literal_eval(call.args[2])
    out["prior"] = ast.unparse(call.args[3])
    data = next(c for c in ast.walk(main) if isinstance(c, ast.Call)
                and getattr(c.func, "id", None) == "generate_glm_data")
    out["data"] = (ast.literal_eval(data.args[0]),
                   {k.arg: ast.unparse(k.value) for k in data.keywords})
    return out


def bench_line_keys() -> set:
    """The keys of the JSON line ``bench.py`` prints."""
    main = _bench_main()
    dumps = next(c for c in ast.walk(main) if isinstance(c, ast.Call)
                 and ast.unparse(c.func) == "json.dumps")
    return {ast.literal_eval(k) for k in dumps.args[0].keys}


@pytest.fixture(scope="module")
def tiny():
    return bench_torch.run_bench("cpu", **TINY)


@pytest.mark.parametrize("device,on_accel", [("cuda", True), ("cpu", False)])
def test_configuration_is_bench_py(device, on_accel):
    want = bench_settings(on_accel)
    cfg = bench_torch.CONFIGS[device]
    for key in ("n", "d", "n_chains", "burnin", "timed_sweeps", "np_sweeps",
                "probe_passes", "spec_k"):
        assert cfg[key] == want[key], key
    assert bench_torch.CHUNK == want["chunk"]
    assert bench_torch.TUNING == want["tuning"]  # in full, "w" included
    assert bench_torch.SLICE_KERNEL == want["slice_kernel"] == "quantile"
    assert want["family"] == "binomial"
    assert want["prior"] == "mg.IIDPrior(mg.Normal(0.0, 1.0), d)"
    assert want["data"] == ("binomial", {"n": "n", "d": "d", "seed": "0"})
    X, y, prior = bench_torch.bench_problem(50, 6)
    want_X, want_y, _ = bench_torch.mt.generate_glm_data(
        "binomial", n=50, d=6, seed=0)
    assert np.array_equal(X, want_X) and np.array_equal(y, want_y)
    assert prior == bench_torch.mt.IIDPrior(bench_torch.mt.Normal(0.0, 1.0), 6)


def test_line_has_bench_py_keys_and_finite_values(tiny):
    line, _ = tiny
    assert set(line) == (bench_line_keys() - DROPPED) | ADDED
    assert line["metric"] == "min_ess_per_sec_p20_logistic_1chip"
    assert line["backend"] == "cpu" and line["device"] == "cpu"
    assert line["battery"] == "torch" and line["slice_kernel"] == "quantile"
    assert line["n_chains"] == 4 and line["timed_sweeps"] == 10
    for key, v in line.items():
        if key in CARD_ONLY:
            assert v is None, key
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            assert math.isfinite(v), key
    assert line["value"] > 0 and line["vs_baseline"] > 0
    # the plain battery on the CPU: no kernel launched
    assert line["kernel_launches"] and not any(
        line["kernel_launches"].values())
    assert json.loads(json.dumps(line)) == line


def test_value_and_counts_from_the_draws(tiny):
    line, got = tiny
    draws = got["draws"]
    assert draws.shape == (4, 10, 20)
    assert line["value"] == pytest.approx(
        float(np.min(ess(draws))) / line["timed_seconds"], rel=1e-12)
    assert line["median_ess_per_sec"] == pytest.approx(
        float(np.median(ess(draws))) / line["timed_seconds"], rel=1e-12)
    assert line["slice_evals_per_sweep"] == pytest.approx(
        float(np.mean(got["nev1"] - got["nev0"])) / 10, rel=1e-12)
    assert line["sweeps_per_sec"] == pytest.approx(
        10 / line["timed_seconds"], rel=1e-12)


def test_timed_section_is_the_engine_protocol(tiny):
    """The same protocol replayed on a fresh engine (init, warmup, one
    untimed chunk, the timed chunks) gives the bench's draws and evaluation
    counts bitwise: the line's numbers come from the timed sweeps only."""
    import torch

    line, got = tiny
    X, y, prior = bench_torch.bench_problem(TINY["n"], TINY["d"])
    eng = bench_torch.bench_engine(X, y, prior, TINY["spec_k"], "cpu")
    st = eng.warmup(eng.init(0, TINY["n_chains"]), TINY["burnin"])[0]
    st = eng.run(st, bench_torch.CHUNK)[0]
    nev0 = st.nev.numpy().copy()
    st, draws, _ = eng.run(st, TINY["timed_sweeps"])
    assert np.array_equal(nev0, got["nev0"])
    assert np.array_equal(st.nev.numpy(), got["nev1"])
    assert torch.equal(draws, torch.from_numpy(got["draws"]))


def test_pass_probe(tiny):
    line, got = tiny
    assert got["probe_passes_ran"] == [TINY["probe_passes"]] * CAPTURES
    caps = line["pass_microseconds_captures"]
    assert len(caps) == CAPTURES and all(c > 0 for c in caps)
    assert line["pass_microseconds"] == statistics.median(caps)
    # the plain battery's streams: 3 + 2K (C, n) float32 operands
    assert line["modeled_streams_per_pass"] == 3 + 2 * TINY["spec_k"]
    assert line["bytes_per_pass"] == (3 + 2 * TINY["spec_k"]) * 4 * 500 * 4
    assert line["hbm_gbps"] == pytest.approx(
        line["bytes_per_pass"] / line["pass_microseconds"] / 1e3, rel=1e-12)


def test_main_prints_the_line_last(monkeypatch, capsys):
    monkeypatch.setitem(bench_torch.CONFIGS, "cpu",
                        {**TINY, "burnin": 2, "timed_sweeps": 4,
                         "probe_passes": 8})
    assert bench_torch.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert line["metric"] == "min_ess_per_sec_p20_logistic_1chip"
    assert line["timed_sweeps"] == 4 and line["value"] > 0


def test_refuses_to_run_without_cuda():
    """Without CUDA and without ``--device cpu`` the bench raises and
    prints no line; it never falls back to the CPU."""
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=_env())
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not proc.stdout.strip()


def test_imports_no_jax():
    code = (
        "import sys\n"
        "import bench_torch, bench, chip_smoke\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', "
        "'jaxlib', 'mcmcglm_tpu'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=_env())
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


def test_smoke_reads_the_bench_configuration():
    """``chip_smoke.py``'s main path runs the bench's configuration: one
    copy of it, in ``bench_torch``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    X, y, prior, kw = smoke.bench_problem()
    cfg = bench_torch.CONFIGS["cuda"]
    assert X.shape == (cfg["n"], cfg["d"]) and prior.d == cfg["d"]
    assert kw["tuning"] == bench_torch.TUNING
    assert kw["slice_kernel"] == bench_torch.SLICE_KERNEL
    assert kw["spec_k"] == cfg["spec_k"] and kw["device"] == "cuda"
