"""The harness end to end on the CPU at tiny sizes: a well-formed result
line for every engine in both trace modes, cells, configurations and
metrics found as new files, no forbidden module loaded, and the check
failing each fault the cells can have.

    python -m pytest benchmark/tests -q
"""

import json
import subprocess
import sys

import pytest

from benchtools import (BENCH, REPO, TINY_CELLS, TINY_LIMITS, run_harness,
                        tiny_root)

FORBIDDEN = {"jax", "jaxlib", "flax", "mcmcglm_tpu", "bench", "bench_torch"}
NUMBERS = ("eta_gap", "pit_ks", "ess_gap", "stuck_draws", "last_draw_gap",
           "short_sweeps")


# a response law, likelihood and prior that no configuration of the
# benchmark uses, added as files of the reference's kinds
PROBIT = """
import math

import numpy as np
import torch
from scipy.special import ndtr


def sample(rng, eta):
    return rng.binomial(1, ndtr(eta)).astype(np.float64)


def loglik(y, eta):
    return (y * torch.special.log_ndtr(eta)
            + (1.0 - y) * torch.special.log_ndtr(-eta))


def _logphi(eta):
    return -0.5 * eta * eta - 0.5 * math.log(2.0 * math.pi)


def dloglik(y, eta):
    lp = _logphi(eta)
    return (y * torch.exp(lp - torch.special.log_ndtr(eta))
            - (1.0 - y) * torch.exp(lp - torch.special.log_ndtr(-eta)))


def weight(eta):  # the Fisher information: Newton only finds the mode
    return torch.exp(2.0 * _logphi(eta) - torch.special.log_ndtr(eta)
                     - torch.special.log_ndtr(-eta))
"""
STUDENTT = """
import torch


def logp(b, df, loc, scale):
    z = (b - loc) / scale
    return -0.5 * (df + 1.0) * torch.log1p(z * z / df)


def dlogp(b, df, loc, scale):
    z = (b - loc) / scale
    return -(df + 1.0) * z / (scale * (df + z * z))


def d2logp(b, df, loc, scale):
    z = (b - loc) / scale
    return -(df + 1.0) * (df - z * z) / (scale ** 2 * (df + z * z) ** 2)
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("bench"))
    # a configuration with a link and a prior no other one uses, and its
    # cell, added as files of their own and entries, nothing edited
    (root / "reference" / "binomial_probit.py").write_text(PROBIT)
    (root / "reference" / "prior_studentt.py").write_text(STUDENTT)
    cfg = json.loads((root / "configs" / "tiny_logit.json").read_text())
    cfg.update(name="tiny_probit", link="probit",
               prior={"dist": "studentt", "df": 3.0, "loc": 0.0,
                      "scale": 1.0})
    (root / "configs" / "tiny_probit.json").write_text(json.dumps(cfg))
    work = json.loads((root / "workloads" / "tiny_pois.freerun.json")
                      .read_text())
    work.update(config="tiny_probit")
    (root / "workloads" / "tiny_probit.freerun.json").write_text(
        json.dumps(work))
    # a metric added as a file of its own and an entry, nothing edited
    (root / "metrics" / "tiny_extra.py").write_text(
        "def read(rec):\n    return float(rec['window']['sweeps'])\n")
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_probit", "source": "a CPU test",
                            "file": "benchmark/configs/tiny_probit.json",
                            "reduced": ["n", "d"], "why": "a CPU test"})
    spec["workloads"].append({"name": "tiny_probit.freerun",
                              "config": "tiny_probit",
                              "traffic": "freerun", "chips": 1,
                              "why": "a CPU test"})
    spec["per_layer"].append({
        "name": "tiny_extra", "unit": "sweeps", "better": "higher",
        "source": "program_counter", "layer": "engine", "moves":
        "draws_per_s", "workloads": ["tiny_logit.fused"]})
    (root.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", TINY_CELLS)
def test_cell_prints_a_well_formed_line(root, cell, trace):
    line, mods, _, proc = run_harness(root, cell, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    group = spec["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want  # every end-to-end metric
    else:
        assert {"min_ess_per_draw", "evals_per_coord", "sweep_mfu"} \
            <= set(line["metrics"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert tuple(line["checks"]) == NUMBERS
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN
    # each number compared, beside its limit, as standard error's last lines
    tail = proc.stderr.strip().splitlines()[-len(NUMBERS):]
    assert [t.split()[1] for t in tail] == list(NUMBERS)


def test_new_files_are_found_without_edits(root):
    line, _, _, _ = run_harness(root, "tiny_logit.fused", trace=True)
    assert line["metrics"]["tiny_extra"]["value"] > 0


def test_new_link_and_prior_are_found_without_edits(root):
    """binomial/probit under a Student-t prior: the data, the program's
    family and prior, and the reference's check all follow the new files;
    the roofline has no count for the pair, so its readers say nothing."""
    line, _, _, _ = run_harness(root, "tiny_probit.freerun")
    assert line["correct"] is True, line["checks"]
    assert {"min_ess_per_s", "draws_per_s", "setup_s"} \
        == set(line["metrics"])
    line, _, _, _ = run_harness(root, "tiny_probit.freerun", trace=True)
    assert line["correct"] is True, line["checks"]
    assert "sweep_mfu" not in line["metrics"]
    assert "min_ess_per_draw" not in line["metrics"]  # not listed for it


@pytest.mark.parametrize("where,module", [("reference", "jax"),
                                          ("metric", "mcmcglm_tpu")])
def test_forbidden_module_loaded_after_the_window_stops_the_run(
        tmp_path, where, module):
    """A reference file or a metric reader that imports JAX or the JAX
    package (a stub here) loads after the window; the run exits 3 and
    prints no result line."""
    root = tiny_root(tmp_path)
    (tmp_path / module).mkdir()
    (tmp_path / module / "__init__.py").write_text("")
    target = (root / "reference" / "prior_normal.py" if where == "reference"
              else root / "metrics" / "draws_per_s.py")
    target.write_text(f"import {module}  # noqa: F401\n"
                      + target.read_text())
    line, mods, _, proc = run_harness(root, "tiny_logit.fused", rc=3)
    assert line is None
    assert module in mods
    assert f"forbidden modules loaded: {module}" in proc.stderr


def test_reference_loads_nothing_of_the_program(tmp_path):
    """The check and the reference on draws made here: no module of the
    port, and nothing forbidden, is loaded."""
    code = """
import json, sys
import numpy as np, torch
from benchmark import check, datagen, ess, spec
config = json.load(open("benchmark/configs/poisson_laplace_p100.json"))
config.update(n=200, d=4)
X, y, _ = datagen.glm_data(spec.Model(config).sample, 200, 4, 5)
rng = np.random.default_rng(0)
draws = torch.as_tensor(rng.normal(size=(4, 12, 4)) * 0.1)
eta = draws[:, -1] @ torch.as_tensor(X).T
out = {"draws": draws, "nev": None, "nev_sweep": torch.full((12,), 99),
       "beta": draws[:, -1], "eta": eta, "ess": ess.ess_torch(draws)}
nums, ctl = check.run_checks(spec.Model(config), torch.as_tensor(X),
                             torch.as_tensor(y), out, 3,
                             {"check": {"pit_updates": 16, "ess_coords": 2}},
                             controls=True)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "mcmcglm_tpu_torch" not in tops
    assert not tops & FORBIDDEN


def test_run_refuses_without_cuda():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "logistic_p1000.freerun.c256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


# each fault planted under the timed path, in the engine the cell drives:
# a run that returns its state unchanged; half of the chains left out; a
# draw, or the committed predictor, altered where it is produced
FAULTS = {
    "state_unchanged": """
def run(self, state, n):
    st, draws, nev = ORIG(self, state, n)
    if FUSED:
        return state, state.beta[None].expand_as(draws).clone(), 0 * nev
    return (state, state.beta[:, None].expand_as(draws).clone(),
            state.nev[:, None].expand_as(nev).clone())
""",
    "half_left_out": """
def run(self, state, n):
    st, draws, nev = ORIG(self, state, n)
    h = state.beta.shape[0] // 2

    def mix(a, b):
        if torch.is_tensor(a) and a.dim() and a.shape[0] == 2 * h:
            return torch.cat([a[:h], b[h:]])
        return a

    st = type(st)(*[mix(a, b) for a, b in zip(st, state)])
    draws = draws.clone()
    if FUSED:
        draws[:, h:] = state.beta[None, h:]
    else:
        draws[h:] = state.beta[h:, None]
        nev = nev.clone()
        nev[h:] = state.nev[h:, None]
    return st, draws, nev
""",
    "draw_altered": """
def run(self, state, n):
    st, draws, nev = ORIG(self, state, n)
    draws = draws.clone()
    if FUSED:
        draws[:-1] += 0.5
    else:
        draws[:, :-1] += 0.5
    return st, draws, nev
""",
    "eta_altered": """
def run(self, state, n):
    st, draws, nev = ORIG(self, state, n)
    return st._replace(eta=st.eta + 1e-3), draws, nev
""",
}

PLANT = """
import torch
import mcmcglm_tpu_torch as mt
CLS = mt.{cls}
FUSED = CLS is mt.FusedCGGibbs
ORIG = CLS.run
{fault}
CLS.run = run
"""


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ["tiny_logit.freerun", "tiny_logit.fused"])
def test_check_fails_each_fault(root, cell, fault):
    cls = "FusedCGGibbs" if cell.endswith("fused") else "FreeRunCGGibbs"
    prelude = PLANT.format(cls=cls, fault=FAULTS[fault])
    line, _, _, _ = run_harness(root, cell, prelude=prelude)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["tiny_logit.freerun", "tiny_pois.freerun"])
def test_program_control_is_not_correct(root, cell):
    """The program's own lower precision (x_storage="bf16") in the
    free-running engine's place comes out not correct."""
    line, _, _, _ = run_harness(root, cell, opts={"x_storage": "bf16"})
    assert line["correct"] is False
    eta = line["checks"]["eta_gap"]
    assert eta["value"] > eta["limit"]


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_reference_controls_read_past_the_limits(root, cell):
    """The reference's bfloat16 control, read beside a sound run and held
    to the cell's limits by the same ``check.verdict``, comes out not
    correct where the sound run is: its eta falls outside the limit.  (At
    this size the bfloat16 conditional's transforms are not yet far from
    uniform, at n=10,000 they read 0.26-0.32; and a tiny run's ESS can sit
    on the estimator's clamp, where float32 and float64 agree.)  The fused
    cell has no lower-precision path of its own, so this is its control."""
    line, _, ctl, _ = run_harness(root, cell, controls=True)
    assert line["correct"] is True
    assert ctl["correct"] is False
    assert ctl["numbers"]["eta_gap"] > TINY_LIMITS["eta_gap"]
