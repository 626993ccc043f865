"""Chain-sharded FreeRunCGGibbs: one independent automaton per card.

Counterpart of ``mcmcglm_tpu/parallel/freerun_sharded.py``.  Chains are
i.i.d., so nothing in the sampler ever needs to cross cards: each rank of
the mesh's ``chain`` axis runs one :class:`~..freerun.FreeRunCGGibbs` on
its C / S chains, with X and y replicated.  From ``init`` to the last draw
there is no collective: each rank's pass loop ends with its own chains'
tail, never the slowest chain anywhere.

Keys: the JAX package splits one key per shard; here chain shard s runs
under the seed ``ops.philox.fold_seed(seed, s)``, so shard s is bitwise a
standalone ``FreeRunCGGibbs`` given that seed and C / S chains (its prior
draw and its Philox stream both come from it).

``run``, ``warmup``, ``run_passes``, ``warmup_passes`` and ``run_thinned``
take and return this rank's shard (the carry of a resumable run); only
:meth:`sample` and the pooled summaries gather over the chain axis, at the
end (:meth:`gather`, ``pooled.pooled_summary(..., group=)``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..freerun import FreeRunCGGibbs
from ..ops.philox import fold_seed
from .mesh import (chain_group, chain_index, gather_chains, make_mesh,
                   mesh_shape)

__all__ = ["ShardedFreeRunCGGibbs"]


class ShardedFreeRunCGGibbs:
    """FreeRunCGGibbs over the ``chain`` axis of a (chain, 1) mesh.

    Same problem signature as ``FreeRunCGGibbs`` (``device`` required)
    plus ``mesh`` (default: every rank on the chain axis).  ``n_chains``
    must be divisible by the number of chain shards.  ``battery_impl``
    resolves per shard; the port's "auto" does not depend on the chain
    count, so it is "cuda3" on the card at any C / S.
    """

    def __init__(self, X, y, family, prior, mesh=None, *, device, **kwargs):
        device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            device_type=device.type)
        S, O = mesh_shape(self.mesh)
        if O != 1:
            raise ValueError(
                "ShardedFreeRunCGGibbs shards chains only (X is replicated "
                "per card); use ObsShardedFreeRunCGGibbs to shard the "
                "observation axis"
            )
        self.n_chain_shards, self.n_obs_shards = S, 1
        self.shard = chain_index(self.mesh)
        self.chain_group = chain_group(self.mesh)
        self.inner = FreeRunCGGibbs(X, y, family, prior, device=device,
                                    **kwargs)

    def _check_chains(self, n_chains: int) -> int:
        if n_chains % self.n_chain_shards:
            raise ValueError(
                f"n_chains={n_chains} not divisible by "
                f"{self.n_chain_shards} chain shards"
            )
        return n_chains // self.n_chain_shards

    def shard_seed(self, seed: int) -> int:
        """The seed this rank's shard runs under."""
        return fold_seed(seed, self.shard)

    def init(self, seed: int, n_chains: int, beta0=None):
        """This rank's C / S chains: a prior draw and the Philox stream of
        :meth:`shard_seed`."""
        c_local = self._check_chains(n_chains)
        return self.inner.init(self.shard_seed(seed), c_local, beta0=beta0)

    def run(self, state, n_sweeps: int):
        """``FreeRunCGGibbs.run`` on this rank's chains."""
        return self.inner.run(state, n_sweeps)

    def warmup(self, state, n_sweeps: int, stepout_sweeps=None):
        return self.inner.warmup(state, n_sweeps, stepout_sweeps)

    def warmup_passes(self, state, sweep_count, n_sweeps: int,
                      n_passes: int, stepout_sweeps=None):
        """Pass-bounded warmup of this rank's chains; ``sweep_count=None``
        starts from zero."""
        if sweep_count is None:
            sweep_count = torch.zeros(state.beta.shape[0], dtype=torch.int32,
                                      device=state.beta.device)
        return self.inner.warmup_passes(state, sweep_count, n_sweeps,
                                        n_passes, stepout_sweeps)

    def run_passes(self, state, sweep_count, draws, nevbuf, n_sweeps: int,
                   n_passes: int):
        return self.inner.run_passes(state, sweep_count, draws, nevbuf,
                                     n_sweeps, n_passes)

    def run_thinned(self, state, n_outer: int, thin: int, moments=None,
                    ess: bool = False, ess_max_lag: int = 64):
        """``FreeRunCGGibbs.run_thinned`` on this rank's chains: the
        moments and ESS state are this shard's; ``pooled.pooled_summary``
        and ``pooled.ess_from_state`` with ``group=self.chain_group`` merge
        them over the chain axis."""
        return self.inner.run_thinned(state, n_outer, thin, moments=moments,
                                      ess=ess, ess_max_lag=ess_max_lag)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's rows of the chain-leading ``t``, in chain order."""
        return gather_chains(t, self.chain_group)

    def sample(self, seed: int, n_samples: int, n_chains: int,
               chunk_size: int = 0, progress=None):
        """Init from the prior, then ``n_samples`` sweeps per chain.  Returns
        (betas (C, n_samples + 1, d), n_evals (C,)) as numpy arrays of all
        C chains, gathered once at the end, and this rank's state."""
        state = self.init(seed, n_chains)
        parts = [state.beta[:, None, :]]
        if chunk_size <= 0:
            chunk_size = n_samples
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, draws, _ = self.run(state, step)
            parts.append(draws)
            done += step
            if progress is not None:
                progress(done, n_samples)
        betas = self.gather(torch.cat(parts, 1)).cpu().numpy()
        return betas, self.gather(state.nev).cpu().numpy(), state
