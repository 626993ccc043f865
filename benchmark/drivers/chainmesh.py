"""Driver of the chain-sharded free-running engine,
``ShardedFreeRunCGGibbs``, for a cell on several cards.

Each rank drives its own shard: the engine takes the default process
group that the harness's ranks joined, puts every rank on the mesh's
chain axis, and gives rank r the cell's C / N chains under the seed
``fold_seed(seed, r)``.  Burn-in is the shard's adaptive ``warmup`` and a
chunk one ``run`` of ``chunk_sweeps`` sweeps, as in ``drivers/freerun.py``;
no collective runs until the harness gathers the outputs.  The counters,
the outputs, the profiled segment and the description are this rank's
``FreeRunCGGibbs``'s, so the pass's per-layer readers read it as on one
card.
"""

from __future__ import annotations

import mcmcglm_tpu_torch as mt

from . import freerun, program_family, program_prior

__all__ = ["Driver"]


class Driver(freerun.Driver):

    def __init__(self, config, work, X, y, seed, device, x_storage="f32"):
        self.work, self.seed, self.device = work, int(seed), device
        self.C = int(work["chains"])  # the cell's; init keeps this shard's
        self.mesh_eng = mt.ShardedFreeRunCGGibbs(
            X, y, program_family(config), program_prior(config),
            extra=config.get("extra") or None, tuning=work["tuning"],
            slice_kernel=work["slice_kernel"], spec_k=work["spec_k"],
            battery_impl=work["battery"], x_storage=x_storage,
            device=device)
        self.eng = self.mesh_eng.inner
        self.state = None
        self.draws, self.nev = [], []

    def burn_in(self):
        self.state = self.mesh_eng.init(self.seed, self.C)
        self.state, _, _ = self.mesh_eng.warmup(self.state,
                                                self.work["burnin_sweeps"])

    def chunk(self, keep: bool):
        self.state, draws, nev = self.mesh_eng.run(self.state,
                                                   self.work["chunk_sweeps"])
        if keep:
            self.draws.append(draws)
            self.nev.append(nev)

    def describe(self) -> dict:
        return dict(super().describe(), mesh="ShardedFreeRunCGGibbs",
                    chain_shards=self.mesh_eng.n_chain_shards,
                    shard=self.mesh_eng.shard)
