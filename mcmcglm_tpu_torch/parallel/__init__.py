"""Multi-card sampling of the port: the (chain, obs) mesh over
``torch.distributed`` (``mesh``, ``distributed``), the chain-sharded and
obs-sharded free-running engines, the sharded lockstep engine, and the
on-device collection diagnostics (``pooled``).

The engine classes load on first use: they import the single-card
engines, which import ``pooled`` from here."""

import importlib

from . import distributed, pooled
from .mesh import CHAIN_AXIS, OBS_AXIS, make_mesh

_ENGINES = {
    "ShardedFreeRunCGGibbs": "freerun_sharded",
    "ObsShardedFreeRunCGGibbs": "freerun_obs_sharded",
    "ShardedCGGibbs": "sharded_engine",
}


def __getattr__(name):
    if name in _ENGINES:
        module = importlib.import_module(f".{_ENGINES[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
