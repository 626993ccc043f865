"""The port's example walkthroughs (``examples/torch_0*.py``) and their
renderer (``scripts/torch_render_docs.py``) on the CPU: each imports no
JAX, JAX package, pandas, matplotlib or triton module, runs end to end at
``--small --device cpu`` within the tolerance it states, and renders; plus
the two package repairs the examples turned up (a formula on a dict of
arrays and a fit's printout, both without pandas), each held against the
JAX package."""

import ast
import concurrent.futures as cf
import importlib.util
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mcmcglm_tpu as mg  # noqa: E402
import mcmcglm_tpu_torch as mt  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("torch_0*.py"))
# a recovery line: "... = <value> (the example's tolerance: <tol>)"
RECOVERY = re.compile(r"= (\S+) \(the example's tolerance: (\S+)\)")


def _renderer():
    spec = importlib.util.spec_from_file_location(
        "torch_render_docs", REPO / "scripts" / "torch_render_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_six_examples_exist():
    assert EXAMPLES == [f for f, _, _ in _renderer().EXAMPLES]
    assert len(EXAMPLES) == 6


def test_examples_and_renderer_import_nothing_forbidden():
    """Importing every example and the renderer (their modules, not their
    runs) loads no JAX, JAX package, pandas, matplotlib or triton."""
    files = [f"examples/{f}" for f in EXAMPLES] + [
        "scripts/torch_render_docs.py"]
    code = (
        "import runpy, sys\n"
        f"for f in {files!r}:\n"
        "    runpy.run_path(f, run_name='not_main')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', "
        "'jaxlib', 'mcmcglm_tpu', 'pandas', 'matplotlib', 'triton'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


@pytest.fixture(scope="module")
def runs():
    """Every example at ``--small --device cpu`` (two gloo processes for the
    multi-process ones), all at once, each through the renderer's wrapper."""
    render = _renderer()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    with cf.ThreadPoolExecutor(len(EXAMPLES)) as pool:
        futures = {f: pool.submit(
            render.run_example, REPO / "examples" / f,
            render.example_args(f, "cpu", small=True, procs=2), env=env,
            timeout=300) for f in EXAMPLES}
        return render, {f: fut.result() for f, fut in futures.items()}


@pytest.mark.parametrize("fname", EXAMPLES)
def test_example_runs_within_its_tolerance(runs, fname):
    render, results = runs
    res = results[fname]
    assert render.check(fname, res) == [], res["stderr"][-3000:]
    found = RECOVERY.findall(res["stdout"])
    if fname == "torch_03_performance.py":  # a timing table, no recovery
        assert not found
        for calc in ("update", "naive"):
            assert f"log-log slope of time against width, {calc}:" in res[
                "stdout"]
        assert len(re.findall(r"^\s+\d+\s+(update|naive)\s", res["stdout"],
                              re.M)) == 6
        return
    assert found, res["stdout"]
    for value, tol in found:
        assert float(value) <= float(tol), res["stdout"]


def test_examples_render(runs, tmp_path):
    """The renderer's documents: one per example with its source and
    output under a header naming the device, and the index."""
    render, results = runs
    render.write_docs(tmp_path, results, render.where_line("cpu", True))
    docs = sorted(p.name for p in tmp_path.glob("*.md"))
    assert docs == sorted(["README.md"] + [f.replace(".py", ".md")
                                           for f in EXAMPLES])
    for fname in EXAMPLES:
        text = (tmp_path / fname.replace(".py", ".md")).read_text()
        assert "Executed on the CPU (`--device cpu`, `--small`)" in text
        assert results[fname]["stdout"].strip().splitlines()[-1] in text
        assert f"examples/{fname}" in text
    index = (tmp_path / "README.md").read_text()
    assert all(f.replace(".py", ".md") in index for f in EXAMPLES)


def test_rank_processes_are_reported(runs):
    """The multi-process examples' ranks (two gloo processes here) each
    send their own modules and launch counts back through the runner's
    wrapper; the other examples spawn none."""
    render, results = runs
    for fname, res in results.items():
        ranks = res["report"]["ranks"]
        if fname in render.MULTI_PROCESS:
            assert len(ranks) == 2, fname
            for rep in ranks:
                assert "mcmcglm_tpu_torch" in rep["modules"]
                assert set(rep["launches"]) >= {"battery_sums"}
        else:
            assert ranks == [], fname


def test_a_forbidden_import_in_a_rank_fails_the_run(tmp_path, monkeypatch):
    """A module that only a spawned rank imports reaches the report, so
    ``check`` fails the run for it."""
    script = tmp_path / "ranks.py"
    script.write_text(
        "from mcmcglm_tpu_torch.parallel.launch import run_local\n\n\n"
        "def rank_fn(rank):\n"
        "    import wave  # noqa: F401\n"
        "    return rank\n\n\n"
        "if __name__ == '__main__':\n"
        "    print(run_local(rank_fn, 2, device_type='cpu', timeout=120.0))\n")
    render = _renderer()
    res = render.run_example(script, env={**os.environ,
                                          "OMP_NUM_THREADS": "1"},
                             timeout=180)
    assert res["returncode"] == 0, res["stderr"][-3000:]
    assert res["stdout"].strip() == "[0, 1]"
    assert [("wave" in r["modules"]) for r in res["report"]["ranks"]] == [
        True, True]
    monkeypatch.setattr(render, "FORBIDDEN", ("wave",))
    assert render.check("ranks.py", res) == ["imported ['wave']"]


def test_check_flags_a_foreign_plain_battery_warning():
    """The runner's check allows example 02's documented warning only."""
    render = _renderer()
    warn = ("x.py:1: RuntimeWarning: auto battery selection: {} is not in "
            "KERNEL_FAMILIES (...); running the plain torch battery")
    ok = {"returncode": 0, "report": {"modules": ["torch"]},
          "stderr": warn.format("my.inverse.gaussian/log")}
    assert render.check("torch_02_customising.py", ok) == []
    assert render.check("torch_05_speculative_batteries.py", ok)
    other = dict(ok, stderr=warn.format("gaussian/identity"))
    assert render.check("torch_02_customising.py", other)
    assert render.check("torch_01_families_and_priors.py", dict(
        ok, stderr="", report={"modules": ["torch", "pandas"]}))


def _jax_invgauss_logpdf():
    """``my_invgauss_logpdf`` of the JAX example, taken from its source
    (running the example module would fit a model)."""
    src = (REPO / "examples" / "02_customising.py").read_text()
    fn = next(node for node in ast.parse(src).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "my_invgauss_logpdf")
    ns = {"jnp": jnp}
    exec(compile(ast.Module([fn], []), "02_customising.py", "exec"), ns)
    return ns["my_invgauss_logpdf"]


@pytest.mark.parametrize("extra", [{}, {"shape": 1.0}, {"shape": 2.5}])
def test_example02_density_matches_the_jax_example(extra):
    """Example 02's torch log density against the JAX example's, on the
    same float32 inputs from a numpy seed."""
    ns = runpy.run_path(
        str(REPO / "examples" / "torch_02_customising.py"),
        run_name="not_main")
    rng = np.random.default_rng(0)
    mu = rng.uniform(0.2, 4.0, size=500).astype(np.float32)
    y = rng.wald(1.0, 1.0, size=500).astype(np.float32)
    want = np.asarray(_jax_invgauss_logpdf()(jnp.asarray(mu), jnp.asarray(y),
                                             extra))
    got = ns["my_invgauss_logpdf"](torch.from_numpy(mu), torch.from_numpy(y),
                                   extra).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    # rtol 1e-6 of the sum of the density's terms' magnitudes: where the
    # terms cancel, one float32 rounding of a term (one ulp apart between
    # the two libraries' log) is a larger share of their sum
    lam = extra.get("shape", 1.0)
    m, yy = mu.astype(np.float64), y.astype(np.float64)
    scale = 0.5 * (abs(np.log(lam)) + np.log(2 * np.pi)
                   + 3 * np.abs(np.log(yy))) + lam * (yy - m) ** 2 / (
                       2 * m * m * yy)
    assert np.all(np.abs(got - want) <= 1e-6 * scale)


def _data(n=40):
    rng = np.random.default_rng(3)
    return {"Y": rng.normal(size=n), "X1": rng.normal(size=n),
            "X2": rng.binomial(1, 0.5, n).astype(float)}


def test_formula_on_a_dict_imports_no_pandas():
    """Repair: the formula parser imported pandas to test whether ``data``
    was a DataFrame, even for a dict of arrays (the GPU machine has no
    pandas, and example 01 passes a dict).  It now never imports pandas
    itself, and builds the JAX package's design from the dict."""
    code = (
        "import sys, numpy as np\n"
        "from mcmcglm_tpu_torch.formula import build_design\n"
        "rng = np.random.default_rng(3)\n"
        "d = build_design('Y ~ .', {'Y': rng.normal(size=9), "
        "'X1': rng.normal(size=9), 'g': np.array(list('abcabcabc'))})\n"
        "print(d.columns); sys.exit('pandas' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    from mcmcglm_tpu.formula import build_design as jax_design
    from mcmcglm_tpu_torch.formula import build_design

    for formula in ("Y ~ .", "Y ~ X1 * X2", "Y ~ X1 - 1"):
        got, want = build_design(formula, _data()), jax_design(formula,
                                                                _data())
        assert got.columns == want.columns
        np.testing.assert_array_equal(got.X, want.X)
        np.testing.assert_array_equal(got.y, want.y)


def test_fit_prints_without_pandas_as_the_jax_package_does():
    """Repair: ``print(fit)`` went through ``coef()``, which needs pandas,
    so a fit could not print on the GPU machine (example 02 prints one).
    The printout is now numpy's, line for line the JAX package's."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, mcmcglm_tpu_torch as mt\n"
        "rng = np.random.default_rng(0)\n"
        "fit = mt.mcmcglm('Y ~ .', 'gaussian', {'Y': rng.normal(size=30), "
        "'X1': rng.normal(size=30)}, w=0.5, n_samples=6, burnin=2, "
        "device='cpu')\n"
        "print(fit)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert "Average of parameter samples:" in proc.stdout
    fit = mt.mcmcglm("Y ~ .", "gaussian", _data(), w=0.5, n_samples=12,
                     burnin=4, n_chains=2, device="cpu")
    ref = mg.results.MCMCGLM(
        beta=fit.beta, columns=fit.columns, family_name=fit.family_name,
        burnin=fit.burnin, sample_method=fit.sample_method,
        slice_kernel=fit.slice_kernel, tuning=fit.tuning, call=fit.call)
    assert repr(fit) == repr(ref)
