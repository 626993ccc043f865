"""The lockstep CGGibbs engine over a (chain, obs) mesh.

Counterpart of ``mcmcglm_tpu/parallel/sharded_engine.py``.  The JAX
package places the single-chip engine's operands on a mesh and lets GSPMD
partition it; the port runs one process per card and splits the work by
hand, with the single-card engine's code unchanged:

  * X^T (d, n)   -> each obs rank holds its (d, n / O) column slab
  * y (n,)       -> each obs rank holds its slice
  * eta, ld_cur (C, n) -> (C / S, n / O) on each rank
  * beta, kernel_state (C, d), per-chain tuning (C,) -> the chain shard's
    C / S rows, replicated over obs

Each evaluation's observation reduction is a shard-local masked sum plus
one ``all_reduce`` over the rank's obs group; the eta update stays local
(each rank updates its slab with its X slab); chain shards never
communicate.  n is padded to a multiple of O with zero rows of X, y = 1.0
and weight 0, masked by selection.

Randomness: the JAX package splits one key per global chain.  Here every
rank keys its Philox stream by the seed and draws chain c's slots at the
counter of its global index (``SliceRNG``'s ``chain0``), and the prior
draw is the rows of the draw for all C chains, so a (S, 1) mesh is
bitwise the single-card ``CGGibbs``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine import CGGibbs, EngineConfig
from ..freerun import _tensor
from ..models.potential import make_coord_target
from ..ops.freerun_batteries import masked_sum
from .mesh import (chain_group, chain_index, gather_chains, make_mesh,
                   mesh_shape, obs_group, obs_index, pad_obs, take_obs_slab)

__all__ = ["ShardedCGGibbs"]


def _masked_all_reduce(mask, group):
    def reduce(t: torch.Tensor) -> torch.Tensor:
        """The masked sum over the shard's observations, summed over the
        obs group."""
        out = masked_sum(t, mask)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return reduce


class ShardedCGGibbs(CGGibbs):
    """CGGibbs with state and data split over a (chain, obs) mesh.

    Same ``init`` / ``run`` / ``warmup`` / ``run_thinned`` / ``sample``
    surface as :class:`~..engine.CGGibbs` (``device`` required);
    ``n_chains`` must be divisible by the mesh's chain-axis size.  ``run``
    and friends take and return this rank's shard; :meth:`sample` gathers
    all chains at the end.
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior,
        extra: Optional[Mapping] = None,
        config: EngineConfig = EngineConfig(),
        tuning: Optional[Mapping] = None,
        mesh=None,
        chain_tuning_names: tuple = (),
        offset=None,
        *,
        device,
    ):
        device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            device_type=device.type)
        self.n_chain_shards, self.n_obs_shards = mesh_shape(self.mesh)
        self.shard = chain_index(self.mesh)
        self.obs_shard = obs_index(self.mesh)
        self.chain_group = chain_group(self.mesh)
        self.obs_group = obs_group(self.mesh)
        self._n_real = np.asarray(X).shape[0]
        X, y, weights, offset = pad_obs(X, y, self.n_obs_shards,
                                        offset=offset, extra=extra)
        # the whole problem first (the conjugate path factors it here)
        super().__init__(X, y, family, prior, extra=extra, config=config,
                         tuning=tuning, chain_tuning_names=chain_tuning_names,
                         obs_weights=weights, offset=offset, device=device)
        # then this rank's slab of the observation axis
        take_obs_slab(self, ("Xt", "y", "obs_weights", "offset"), self.mesh)
        self.reduce_fn = _masked_all_reduce(self.obs_weights, self.obs_group)
        if self._naive:
            self._Xt64 = self.Xt.double()
        self._target_factory = make_coord_target(
            self.family, self.prior, self.y, self.extra,
            reduce_fn=self.reduce_fn,
        )

    def _chain0(self, n_chains: int) -> int:
        return self.shard * n_chains

    def init(self, seed: int, n_chains: int,
             chain_tuning: Optional[Mapping] = None, beta0=None):
        """This rank's C / S chains: the rows of the prior draw for all C
        chains under ``seed`` (``beta0`` overrides it), and their rows of
        ``chain_tuning`` ((C,) values)."""
        if n_chains % self.n_chain_shards:
            raise ValueError(
                f"n_chains={n_chains} must be divisible by the mesh chain "
                f"axis ({self.n_chain_shards})"
            )
        c = n_chains // self.n_chain_shards
        rows = slice(self.shard * c, (self.shard + 1) * c)
        dev, dtype = self.device, self.dtype
        if beta0 is None:
            g = torch.Generator(device=dev).manual_seed(int(seed))
            beta0 = self.prior.sample_beta(g, n_chains, dtype=dtype,
                                           device=dev)
        else:
            beta0 = _tensor(beta0, dtype, dev).expand(n_chains, self.d)
        ct = {}
        for k, v in dict(chain_tuning or {}).items():
            v = _tensor(v, dtype, dev).reshape(-1)
            if v.shape != (n_chains,):
                raise ValueError(
                    f"chain_tuning[{k!r}] must have leading dim "
                    f"n_chains={n_chains}"
                )
            ct[k] = v[rows]
        return super().init(seed, c, chain_tuning=ct, beta0=beta0[rows])

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every chain shard's rows of the chain-leading ``t`` (a tensor
        replicated over obs, not eta), in chain order."""
        return gather_chains(t, self.chain_group)

    def sample(self, seed: int, n_samples: int, n_chains: int = 1,
               chunk_size: int = 0, progress=None,
               chain_tuning: Optional[Mapping] = None):
        """``CGGibbs.sample`` with the draws and counts of all C chains,
        gathered once at the end, and this rank's state."""
        betas, n_evals, state = super().sample(
            seed, n_samples, n_chains=n_chains, chunk_size=chunk_size,
            progress=progress, chain_tuning=chain_tuning)
        dev = self.device
        return (self.gather(torch.from_numpy(betas).to(dev)).cpu().numpy(),
                self.gather(torch.from_numpy(n_evals).to(dev)).cpu().numpy(),
                state)
