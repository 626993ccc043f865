"""The (chain, obs) device mesh of the sharded engines.

Counterpart of ``mcmcglm_tpu/parallel/mesh.py``.  The workload has two
parallel axes:

  * ``chain``: thousands of i.i.d. chains, the data-parallel axis;
  * ``obs``: the observation axis n of the design matrix, whose
    per-shard log-density sums are combined by one all-reduce over this
    axis per evaluation.

The JAX package builds one ``jax.sharding.Mesh`` over every device under
one controller per host.  The port runs one process per card (``torchrun``
or any launcher that calls :func:`.distributed.initialize`) and builds a
``torch.distributed.device_mesh.DeviceMesh`` with the same two named
dimensions over the world: rank r sits at chain index r // O and obs index
r % O.  Each rank then holds the process groups of its own chain row (the
ranks with its chain index: the ``obs`` group) and of its own obs column
(the ``chain`` group).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "CHAIN_AXIS",
    "OBS_AXIS",
    "chain_group",
    "chain_index",
    "gather_chains",
    "make_mesh",
    "mesh_shape",
    "obs_group",
    "obs_index",
]

CHAIN_AXIS = "chain"
OBS_AXIS = "obs"


def make_mesh(n_chain_shards: Optional[int] = None, n_obs_shards: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (chain, obs) mesh over the world of :func:`.distributed.initialize`.
    Every rank goes on the chain axis by default, the right layout when
    chains are plentiful and the data fit one card; raise ``n_obs_shards``
    for tall data.  ``device_type`` is "cuda" (the default) or "cpu"."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "mcmcglm_tpu_torch.parallel.distributed.initialize() first"
        )
    total = dist.get_world_size()
    if n_chain_shards is None:
        if total % n_obs_shards:
            raise ValueError(
                f"{total} devices not divisible by n_obs_shards={n_obs_shards}"
            )
        n_chain_shards = total // n_obs_shards
    if n_chain_shards * n_obs_shards != total:
        raise ValueError(
            f"mesh {n_chain_shards}x{n_obs_shards} != {total} devices"
        )
    return init_device_mesh(device_type, (n_chain_shards, n_obs_shards),
                            mesh_dim_names=(CHAIN_AXIS, OBS_AXIS))


def mesh_shape(mesh: DeviceMesh) -> tuple:
    """(chain shards, obs shards)."""
    return mesh.size(0), mesh.size(1)


def chain_index(mesh: DeviceMesh) -> int:
    """This rank's index on the chain axis."""
    return mesh.get_local_rank(CHAIN_AXIS)


def obs_index(mesh: DeviceMesh) -> int:
    """This rank's index on the obs axis."""
    return mesh.get_local_rank(OBS_AXIS)


def chain_group(mesh: DeviceMesh):
    """The process group of the ranks that share this rank's obs index
    (one per chain shard): what a gather over chains runs on."""
    return mesh.get_group(CHAIN_AXIS)


def obs_group(mesh: DeviceMesh):
    """The process group of this rank's chain row (one rank per obs
    shard): what the per-pass all-reduce runs on."""
    return mesh.get_group(OBS_AXIS)


def gather_chains(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated on the leading (chain)
    axis in rank order, on ``t``'s device.  "gloo" gathers host tensors:
    a CUDA tensor goes through the host there, explicitly."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def pad_obs(X, y, n_obs_shards: int, *, weights=None, offset=None,
            extra: Optional[Mapping] = None):
    """The whole problem with n padded to a multiple of ``n_obs_shards``:
    zero rows of X, y = 1.0 and weight 0 (masked by selection), offset 0.
    Returns (X, y, weights, offset) as numpy arrays (``weights`` ones
    where none are given; ``offset`` stays None).  A weight or offset
    vector not of length n, or a per-observation ``extra``, raises."""
    X = np.asarray(X)
    y = np.asarray(y).reshape(-1)
    n = X.shape[0]
    pad = (-n) % n_obs_shards
    for k, v in dict(extra or {}).items():
        if np.ndim(v) != 0:
            raise ValueError(
                f"extra[{k!r}] is per-observation shaped; the obs-sharded "
                "engines support scalar extra args only"
            )
    w = (np.ones(n) if weights is None
         else np.asarray(weights, np.float64).reshape(-1))
    if w.shape[0] != n:
        raise ValueError(f"obs_weights length {w.shape[0]} != n "
                         f"observations {n}")
    if offset is not None:
        offset = np.asarray(offset).reshape(-1)
        if offset.shape[0] != n:
            raise ValueError(
                f"offset length {offset.shape[0]} != n observations {n}"
            )
        offset = np.concatenate([offset, np.zeros(pad, offset.dtype)])
    # padded y = 1.0, not 0: log(y) terms (Gamma, inverse-gaussian) are
    # infinite at 0, and the weight-0 rows drop out by selection
    return (np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)]),
            np.concatenate([y, np.ones(pad, y.dtype)]),
            np.concatenate([w, np.zeros(pad)]), offset)


def take_obs_slab(eng, names: Sequence[str], mesh: DeviceMesh) -> slice:
    """Cut an engine built on the whole (padded) problem down to this
    rank's slab of the observation axis: each named attribute, a tensor
    whose last axis is n (or None), keeps its n / O columns, and
    ``eng.n`` follows.  Returns the slab's slice."""
    O, i = mesh.size(1), obs_index(mesh)
    n_loc = eng.n // O
    sl = slice(i * n_loc, (i + 1) * n_loc)
    for name in names:
        t = getattr(eng, name)
        if t is not None:
            setattr(eng, name, t[..., sl].contiguous())
    eng.n = n_loc
    return sl
