"""Obs-sharded FreeRunCGGibbs: the tall-data path over a (chain, obs) mesh.

Counterpart of ``mcmcglm_tpu/parallel/freerun_obs_sharded.py``.  The
chain-sharded engine replicates X (d, n) and carries a (C, n) predictor
per card; for an n where either outgrows the card, this engine splits the
observation axis over the mesh's ``obs`` ranks:

  * X^T (d, n)  -> each obs rank holds its (d, n / O) column slab
  * y, weights  -> each obs rank holds its slice
  * eta (C, n)  -> each rank holds (C / S, n / O); its update stays local
  * beta, logw, draws, automaton registers -> replicated over ``obs``

Per pass each obs rank evaluates its slice of the relative target: the
battery kernel ``battery_sums`` on its n / O observations (the plain
battery on the CPU), and ONE ``all_reduce`` over the rank's obs group
turns the (C, K) partial sums into the global sums.  Everything
downstream (slice tests, interval updates, commits, Philox draws) is a
deterministic function of (the all-reduced sums, the replicated
registers, the chain shard's seed), so the obs ranks of one chain row
advance their registers in bitwise lockstep with no other communication.
Chain shards never communicate.

The commit batteries (``"cuda2"``/``"cuda3"``) replay the accept decision
inside the kernel against the sums they just formed, which on an obs
shard are partial: the decision needs the all-reduce first, so they are
refused here (the JAX package refuses its Pallas batteries for the same
reason and pins its XLA battery; the port runs ``battery_sums``).

Setup is global: every rank builds the setup-time quantities (the
``eval_cache="auto"`` roundoff estimate, the conjugate pass's sum_i w
x^2) from the whole problem and then keeps its slab; the prior draw and
the Philox stream come from the chain shard's seed, alike on every obs
rank of the row.  n is padded to a multiple of O with zero rows of X, y =
1.0 and weight 0, masked by selection.

The pass loop: on "nccl" each block of passes is one captured CUDA graph
with the all-reduce inside it; "gloo" collectives cannot be captured, so
on "gloo" the block runs eagerly.  ``loop_reason`` records which and why.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..freerun import FreeRunCGGibbs
from ..ops.freerun_batteries import masked_sum
from .distributed import backend
from .freerun_sharded import ShardedFreeRunCGGibbs
from .mesh import (chain_group, chain_index, make_mesh, mesh_shape,
                   obs_group, obs_index, pad_obs, take_obs_slab)

__all__ = ["ObsShardedFreeRunCGGibbs"]


def _all_reduce_over(group):
    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over ``group``, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return all_reduce


class ObsShardedFreeRunCGGibbs(ShardedFreeRunCGGibbs):
    """FreeRunCGGibbs over a (chain, obs) mesh.

    The surface of :class:`ShardedFreeRunCGGibbs` (``init`` under the
    chain shard's seed, alike on its obs ranks; ``run`` and friends on
    this rank's shard; ``gather`` and ``sample`` over the chain axis) with
    the observation axis split as well (``device`` required).
    ``n_chains`` must be divisible by the chain-axis size.
    ``battery_impl`` is "auto", "torch" or "cuda"; ``graph`` (default:
    True on "nccl") selects the CUDA-graph pass loop, which "gloo" cannot
    run.
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior,
        mesh=None,
        extra: Optional[Mapping] = None,
        tuning: Optional[Mapping] = None,
        obs_weights=None,
        offset=None,
        reduce_fn=None,
        battery_impl: str = "auto",
        dtype=torch.float32,
        graph: Optional[bool] = None,
        *,
        device,
        **kwargs,
    ):
        if reduce_fn is not None:
            raise ValueError(
                "ObsShardedFreeRunCGGibbs owns the observation reduction "
                "(shard-local masked sum + all-reduce over the obs group); "
                "a custom reduce_fn cannot be assumed all-reduce-compatible "
                "— use obs_weights for weighted likelihoods"
            )
        if battery_impl in ("cuda2", "cuda3"):
            raise ValueError(
                f"battery_impl={battery_impl!r}: the commit batteries replay "
                "the accept decision in-kernel against shard-LOCAL sums, "
                "which obs-sharding cannot do (the decision needs the "
                "all-reduce over the obs group first); only 'auto', 'torch' "
                "and 'cuda' are supported here"
            )
        if battery_impl not in ("auto", "torch", "cuda"):
            raise ValueError(
                f"battery_impl must be 'auto', 'torch' or 'cuda', got "
                f"{battery_impl!r}"
            )
        device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            device_type=device.type)
        self.n_chain_shards, self.n_obs_shards = mesh_shape(self.mesh)
        self.shard = chain_index(self.mesh)
        self.obs_shard = obs_index(self.mesh)
        self.chain_group = chain_group(self.mesh)
        self.obs_group = obs_group(self.mesh)

        self._n_real = np.asarray(X).shape[0]
        X, y, mask, offset = pad_obs(X, y, self.n_obs_shards,
                                     weights=obs_weights, offset=offset,
                                     extra=extra)
        # the whole problem first: every setup-time quantity is global
        inner = FreeRunCGGibbs(
            X, y, family, prior, extra=extra, tuning=tuning,
            obs_weights=mask, offset=offset, battery_impl=battery_impl,
            dtype=dtype, device=device, **kwargs,
        )
        if inner.battery_impl == "cuda3":  # what "auto" picks unsharded
            inner.battery_impl = "cuda"
            inner.battery_reason += ("; obs-sharded: battery_sums, then the "
                                     "all-reduce (the commit kernels decide "
                                     "on local sums)")
        # then this rank's slab of the observation axis
        take_obs_slab(inner, ("Xt", "y", "_mask", "offset"), self.mesh)
        inner._Xt_rows = inner.Xt
        mask_loc = inner._mask
        # the hooks hold the group, not this object: the engine and its
        # cached CUDA graphs must form no reference cycle
        all_reduce = _all_reduce_over(self.obs_group)
        inner.reduce_fn = lambda t: all_reduce(masked_sum(t, mask_loc))
        inner.combine_sums = all_reduce
        be = backend(self.obs_group)
        if device.type != "cuda":
            if graph:
                raise ValueError("graph=True needs a CUDA device")
            graph, why = False, "eager: CPU tensors"
        elif be == "nccl":
            graph = True if graph is None else bool(graph)
            why = ("nccl: the all-reduce is captured in each block's CUDA "
                   "graph" if graph else "eager: graph=False requested")
        else:
            if graph:
                raise ValueError(
                    f"graph=True on {be!r}: its collectives cannot be "
                    "captured in a CUDA graph (use 'nccl')"
                )
            graph, why = False, f"eager: {be!r} collectives cannot be captured"
        inner._graph_loop = graph
        self.loop_reason = why
        self.inner = inner
