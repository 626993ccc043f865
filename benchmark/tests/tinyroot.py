"""``benchtools.tiny_root`` over ``BENCHMARK.json`` with each per-layer
metric's cells cut to those of the engines it has tiny cells for.

``tiny_root`` gives each per-layer metric the tiny cells of the engines
its cells name (a cell name's second field) and has tiny cells for
"freerun" and "fused" only: a cell of another engine, such as
``logistic_p1000.chainmesh.c4096x4`` ("chainmesh"), stops it with a
KeyError.  :func:`tiny_root` reads the same specification less those
cells and hands it to ``benchtools.tiny_root`` as the repository's; the
copy is otherwise the same.  ``conftest.py`` puts it in ``benchtools``'
place for the benchmark's tests, and tests/test_torch_tracing.py calls
it.  Once ``benchtools.tiny_root`` skips the engines it has no tiny cells
for, this module and ``conftest.py`` go.
"""

from __future__ import annotations

import json
from pathlib import Path

try:  # the benchmark's tests, with this directory on the path
    import benchtools
except ImportError:  # the program's tests
    from benchmark.tests import benchtools

KNOWN = ("freerun", "fused")
_tiny_root = benchtools.tiny_root


def tiny_root(tmp: Path) -> Path:
    """``benchtools.tiny_root(tmp)`` with the per-layer metrics' cells of
    other engines left out; returns the copy's ``benchmark/``."""
    spec = json.loads((benchtools.REPO / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        m["workloads"] = [w for w in m["workloads"]
                          if w.split(".")[1] in KNOWN]
    src = Path(tmp) / "_spec"
    src.mkdir()
    (src / "BENCHMARK.json").write_text(json.dumps(spec, indent=1) + "\n")
    repo, benchtools.REPO = benchtools.REPO, src
    try:
        return _tiny_root(Path(tmp))
    finally:
        benchtools.REPO = repo
