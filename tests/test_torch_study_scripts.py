"""The port's engine study scripts (``scripts/torch_*.py`` of the pass
budget, chain and K scaling, the quantile and latent A/Bs, the Laplace
diagnosis and the obs-sharded capacity) on the CPU: each imports no JAX,
JAX package, pandas, matplotlib or triton module, refuses to run without
CUDA unless asked for the CPU, and at ``--small --device cpu`` emits JSON
rows with its documented keys; the capacity rows halve exactly at obs =
2.  The graph-capture study (``torch_capture_modes.py``) runs on the card
only: here, its imports."""

import concurrent.futures as cf
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ["torch_pass_budget.py", "torch_chain_scaling.py",
           "torch_spec_probe.py", "torch_quantile_adapt_probe.py",
           "torch_latent_ab_probe.py", "torch_laplace_diag.py",
           "torch_obs_sharded_capacity.py", "torch_capture_modes.py"]
FREERUN_KEYS = {"chains", "warmup", "timed_sweeps", "window_seconds",
                "sweeps_per_s", "chain_sweeps_per_s", "evals_per_coord",
                "passes_per_sweep", "ms_per_pass", "min_ess", "median_ess",
                "min_ess_per_s", "min_ess_per_draw", "battery", "spec_k",
                "device", "card"}
# run name -> (script, extra arguments, keys every row must carry, rows)
RUNS = {
    "pass_budget": ("torch_pass_budget.py", [],
                    {"us_per_pass", "remainder_of", "profile", "timing",
                     "A_rounds", "battery", "chains", "device", "card"}, 1),
    "chain_scaling_freerun": (
        "torch_chain_scaling.py", ["--engine", "freerun"],
        {"engine", "chains", "ms_per_sweep", "chain_sweeps_per_s",
         "scaling_efficiency", "evals_per_coord", "min_ess",
         "min_ess_per_s", "window_seconds", "passes_per_sweep",
         "ms_per_pass", "battery", "device", "card"}, 3),
    "chain_scaling_fused": (
        "torch_chain_scaling.py", ["--engine", "fused"],
        {"engine", "chains", "ms_per_sweep", "chain_sweeps_per_s",
         "scaling_efficiency", "evals_per_coord", "min_ess",
         "min_ess_per_s", "window_seconds", "device", "card"}, 2),
    "chain_scaling_xla": (
        "torch_chain_scaling.py", ["--engine", "xla"],
        {"engine", "chains", "ms_per_sweep", "chain_sweeps_per_s",
         "scaling_efficiency", "evals_per_coord", "min_ess",
         "min_ess_per_s", "device", "card"}, 2),
    "spec_probe": ("torch_spec_probe.py", ["1", "4:plain"],
                   FREERUN_KEYS | {"variant", "adapt_c"}, 2),
    "quantile_adapt": (
        "torch_quantile_adapt_probe.py",
        ["--problems", "logistic_p100,poisson_laplace_p100", "--ladder", "3",
         "--anchors", "stepping_out"],
        FREERUN_KEYS | {"problem", "kernel"}, 4),
    "latent_ab": ("torch_latent_ab_probe.py", [],
                  FREERUN_KEYS | {"kernel", "rate"}, 2),
    "laplace_diag": ("torch_laplace_diag.py", [],
                     {"window", "worst_j", "min_ess", "median_ess", "w_j",
                      "post_mean_j", "post_sd_j", "lag1_j", "device",
                      "card"}, 1),
    "obs_sharded_capacity": (
        "torch_obs_sharded_capacity.py", [],
        {"part", "obs", "n_local", "obs_axis_bytes_per_rank", "vs_obs1",
         "obs_axis_operands", "other_tensors", "device", "card"}, 3),
}


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def test_scripts_import_nothing_forbidden():
    files = [f"scripts/{f}" for f in SCRIPTS + ["torch_study.py"]]
    code = (
        "import runpy, sys\n"
        f"for f in {files!r}:\n"
        "    runpy.run_path(f, run_name='not_main')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', "
        "'jaxlib', 'mcmcglm_tpu', 'pandas', 'matplotlib', 'triton'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=_env())
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


def test_scripts_default_to_the_card():
    """Without CUDA a script's default ``--device cuda`` raises, naming
    ``--device cpu``; it does not fall back to the CPU."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_spec_probe.py")],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=_env())
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not proc.stdout.strip()


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Every run of RUNS at ``--small --device cpu``, all at once; the rows
    each wrote to its ``--out`` file."""
    out = tmp_path_factory.mktemp("study")

    def one(name):
        script, extra, _, _ = RUNS[name]
        path = out / f"{name}.jsonl"
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / script), "--small",
             "--device", "cpu", "--out", str(path), *extra],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env=_env())
        assert proc.returncode == 0, proc.stderr[-3000:]
        return [json.loads(ln) for ln in path.read_text().splitlines()]

    with cf.ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {name: pool.submit(one, name) for name in RUNS}
        return {name: fut.result() for name, fut in futures.items()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_script_rows_carry_their_keys(rows, name):
    _, _, keys, count = RUNS[name]
    got = rows[name]
    assert len(got) == count
    for row in got:
        assert keys <= set(row), sorted(keys - set(row))
        assert row["device"] == "cpu" and row["card"] == "cpu"


def test_pass_budget_names_every_part(rows):
    parts = rows["pass_budget"][0]["us_per_pass"]
    for key in ("A_full_pass_f32", "A_full_pass_bf16",
                "B_battery_gather_commit", "B_battery_gather_commit_bf16",
                "B_battery_commit", "B_battery_sums", "C_3stream_floor",
                "D_scatters", "E_prior_battery", "F_proposal_gen",
                "G_philox", "remainder"):
        assert parts[key] == parts[key]  # present and not NaN
    named = rows["pass_budget"][0]["remainder_of"]
    assert parts["remainder"] == pytest.approx(
        parts[named[0]] - sum(parts[k] for k in named[1:]))
    # the in-pass split: every part's range caught some of the pass's work
    for part in ("B_battery", "D_scatters", "E_prior_battery",
                 "F_proposal_gen", "G_philox", "H_automaton"):
        assert parts[f"in_pass_{part}"] > 0, part
    assert parts["in_pass_busy"] == pytest.approx(sum(
        parts[f"in_pass_{k}"] for k in ("B_battery", "D_scatters",
                                        "E_prior_battery", "F_proposal_gen",
                                        "G_philox", "H_automaton", "other")))


def test_obs_capacity_halves_exactly(rows):
    """The obs-axis operands of a rank at obs = 2 are exactly half those at
    obs = 1, and at obs = 4 a quarter."""
    by_obs = {r["obs"]: r for r in rows["obs_sharded_capacity"]}
    one = by_obs[1]["obs_axis_bytes_per_rank"][0]
    assert set(by_obs[1]["obs_axis_operands"]) >= {"Xt", "y", "mask",
                                                   "state.eta"}
    for obs in (2, 4):
        per_rank = by_obs[obs]["obs_axis_bytes_per_rank"]
        assert len(per_rank) == obs
        assert all(b * obs == one for b in per_rank)
        assert by_obs[obs]["other_tensors"] == by_obs[1]["other_tensors"]
