"""The multi-process runtime: one process per card over ``torch.distributed``.

Counterpart of ``mcmcglm_tpu/parallel/distributed.py``.  The JAX package
runs one controller per host under ``jax.distributed``; the port runs one
process per card, as ``torchrun`` launches it:

    torchrun --nproc-per-node 4 my_fit.py

    # my_fit.py
    from mcmcglm_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()          # reads torchrun's environment
    mesh = make_mesh(n_chain_shards=2, n_obs_shards=2)
    fit = mcmcglm(..., mesh=mesh)     # every rank calls it alike

A checkpoint (``mcmcglm_tpu_torch.checkpoint``) writes one file per rank;
a restart calls :func:`initialize` again and restores the last committed
step.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["backend", "initialize", "is_distributed", "sync_global_devices"]

# how long a collective or a barrier waits for a peer before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: Optional[str] = None,
               device_type: str = "cuda",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Initialise the default process group (once per process).

    * Explicit ``init_method`` ("tcp://host:port", "file:///path"),
      ``world_size`` and ``rank``: a failure raises.
    * Otherwise ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``) when it is set.
    * Otherwise a world of one, the counterpart of the JAX package's
      single-process case.

    ``backend`` defaults to "nccl" for ``device_type`` "cuda" and "gloo"
    for "cpu"; a caller may ask for "gloo" on CUDA.  On CUDA the process
    takes card ``LOCAL_RANK`` (else its rank modulo the card count).
    ``timeout`` bounds every collective, so a rank whose peer died raises
    instead of hanging."""
    if dist.is_initialized():
        return
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize(device_type='cuda') needs a CUDA "
                           "device; pass device_type='cpu' to run on the CPU")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    kw = dict(backend=backend, timeout=timeout)
    explicit = (init_method, world_size, rank) != (None, None, None)
    if explicit:
        if None in (init_method, world_size, rank):
            raise ValueError("explicit initialize() needs init_method, "
                             "world_size and rank")
        kw.update(init_method=init_method, world_size=int(world_size),
                  rank=int(rank))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw.update(init_method="env://")
    else:
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    if device_type == "cuda":
        r = int(os.environ.get("LOCAL_RANK",
                               kw.get("rank", os.environ.get("RANK", 0))))
        torch.cuda.set_device(r % torch.cuda.device_count())
    dist.init_process_group(**kw)


def is_distributed() -> bool:
    """True in a process group of more than one rank."""
    return dist.is_initialized() and dist.get_world_size() > 1


def backend(group=None) -> str:
    """The backend of ``group`` (the default group when None)."""
    return str(dist.get_backend(group))


def sync_global_devices(tag: str = "barrier",
                        timeout: Optional[datetime.timedelta] = None) -> None:
    """A barrier of every rank (before and after checkpoint writes).  On
    "gloo" it is ``monitored_barrier``, which names a rank that did not
    arrive within ``timeout``; a dead peer raises, it never hangs."""
    if not is_distributed():
        return
    try:
        if backend() == "gloo":
            dist.monitored_barrier(timeout=timeout, wait_all_ranks=True)
        else:
            dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {tag!r} failed: {exc}") from exc
