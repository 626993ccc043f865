"""Where the benchmark finds its data and code, by the names that
``BENCHMARK.json`` gives: ``workloads/<cell>.json``, ``configs/<config>.json``,
``drivers/<engine>.py``, ``metrics/<metric>.py`` and the reference's
``reference/<family>_<link>.py`` and ``reference/prior_<dist>.py``.  A
later change adds a cell, a configuration, an engine or a metric by adding
such files and entries, and edits none."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["ROOT", "Model", "benchmark_json", "cell", "load_file",
           "metric_entries"]

ROOT = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """The Python file ``path`` as a module of its own."""
    tag = re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(f"_benchmark_{tag}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root.parent / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT):
    """(workload, config) of the cell ``name``."""
    work = load_json(root / "workloads" / f"{_name(name)}.json")
    config = load_json(root / "configs" / f"{_name(work['config'])}.json")
    return work, config


def metric_entries(name: str, trace: bool, root: Path = ROOT):
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    (trace off) or its per-layer metrics (trace on), as entries of
    ``BENCHMARK.json``."""
    spec = benchmark_json(root)
    entries = spec["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


class Model:
    """The reference's view of a configuration: its response law and log
    likelihood by (family, link) and its prior, each from a file of its
    own."""

    def __init__(self, config: dict, root: Path = ROOT):
        ref = root / "reference"
        self.density = load_file(
            ref / f"{_name(config['family'] + '_' + config['link'])}.py")
        self.extra = dict(config.get("extra") or {})
        prior = dict(config["prior"])
        self.prior = load_file(ref / f"prior_{_name(prior.pop('dist'))}.py")
        self.prior_args = prior

    def sample(self, rng, eta):
        """Responses (n,) at the predictors eta, drawn with the NumPy
        generator rng."""
        return self.density.sample(rng, eta, **self.extra)

    def logp(self, b):
        return self.prior.logp(b, **self.prior_args)

    def dlogp(self, b):
        return self.prior.dlogp(b, **self.prior_args)

    def d2logp(self, b):
        return self.prior.d2logp(b, **self.prior_args)
