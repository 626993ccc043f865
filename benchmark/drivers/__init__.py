"""Engine drivers: ``drivers/<engine>.py`` builds, burns in and runs one
engine of ``mcmcglm_tpu_torch`` for the harness (``harness.py``).

Each module defines ``Driver(config, work, X, y, seed, device, **opts)``
with ``unit`` ("pass" or "sweep": what one profiled unit is),
``burn_in()``, ``chunk(keep)`` (one call of the cell's chunk length, its
draws kept on the device when ``keep``), ``counts()`` (the program's
counters, read on the host), ``outputs()`` (the window's draws and
counters and the final state, for the metrics and the check),
``profile(trace)`` (a short profiled segment after the window) and
``describe()``.  A new engine is a new file.

A cell whose ``chips`` is N > 1 runs one ``Driver`` in each of N
processes, one per card (``ranks.py``).  Such a driver may assume that
the default process group of the N ranks exists (NCCL on the cards, gloo
in the CPU tests) and that ``device`` is its rank's own card.  It drives
its own shard: ``chains`` is the cell's, and the driver keeps its rank's
share; ``counts()``, ``outputs()`` and ``profile()`` are its rank's, and
the harness sums the counts and gathers the chain-leading outputs to rank
0 along the chain axis (``chainmesh.py``).  It runs no collective that
the other ranks do not run in the same order.
"""

from __future__ import annotations

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.models.families import FAMILIES
from mcmcglm_tpu_torch.models.priors import Distribution

__all__ = ["load_kernels", "program_family", "program_prior"]


def program_family(config: dict):
    """The configuration's family with its link, as the program's object."""
    return FAMILIES[config["family"]](link=config["link"])


def program_prior(config: dict):
    """The configuration's IID prior as the program's object: its ``dist``
    names one of the program's distributions, by the class's name in lower
    case (normal, laplace, studentt, ...), and the rest are its
    arguments."""
    args = dict(config["prior"])
    dists = {c.__name__.lower(): c for c in Distribution.__subclasses__()}
    return mt.IIDPrior(dists[args.pop("dist")](**args), config["d"])


def load_kernels(device) -> dict:
    """Build (or find in the checkout's fixed cache) and load the port's
    kernel library on CUDA; what the build reports."""
    if device.type != "cuda":
        return {"cached": None, "seconds": 0.0}
    from mcmcglm_tpu_torch.ops import _build

    _build.load_library()
    return {"cached": _build.BUILD_INFO["cached"],
            "seconds": _build.BUILD_INFO["seconds"]}
