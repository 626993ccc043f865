"""Driver of the chain-sharded free-running engine with the pooled
monitor, BASELINE config 5's workflow: thousands of chains over the
cards, the pooled R-hat and ESS read after every chunk until they pass
the user's stopping rule.

As ``drivers/chainmesh.py`` (each rank its C / N chains under
``fold_seed(seed, rank)``, X and y replicated), but a chunk is one
monitor step:

* ``run_thinned(chunk_sweeps, thin=1, moments=<carried>, ess=True)``: one
  ``run`` of ``chunk_sweeps`` sweeps, every draw kept, folded into the
  moments carried since burn-in and into a fresh ESS state (lag window
  ``monitor.ess_max_lag``, clamped to half the chunk);
* ``pooled_summary`` and ``ess_from_state`` merged over the engine's
  chain group (NCCL on the cards);
* one host read of (the largest R-hat, the least ESS), held against the
  rule (R-hat below ``monitor.rhat_below``, ESS above
  ``monitor.ess_above``) and logged on standard error by rank 0.  The rule
  never ends the window.

Every rank makes the same merges in the same order.  The draws and the
cumulative evaluation counter at each draw are handed to the harness as
``drivers/freerun.py`` hands a ``run``'s, so the check reads every sweep.
A program whose ``run_thinned`` cannot return the counter at each kept
draw cannot run the cell, and this module raises on import.
"""

from __future__ import annotations

import inspect

import torch
import torch.distributed as dist

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.parallel import pooled

from .. import harness
from . import chainmesh

__all__ = ["Driver"]

if "nev_at_draws" not in inspect.signature(
        mt.FreeRunCGGibbs.run_thinned).parameters:
    raise ImportError("this program's run_thinned returns no evaluation "
                      "counter at each kept draw (nev_at_draws)")


class Driver(chainmesh.Driver):

    def __init__(self, config, work, X, y, seed, device, x_storage="f32"):
        super().__init__(config, work, X, y, seed, device,
                         x_storage=x_storage)
        self.monitor = dict(work["monitor"])
        self.moments = None
        self.steps = 0
        self.last = None

    def chunk(self, keep: bool):
        eng, mon = self.mesh_eng, self.monitor
        (self.state, self.moments, kept, _, es,
         nev) = eng.run_thinned(self.state, int(self.work["chunk_sweeps"]),
                                1, moments=self.moments, ess=True,
                                ess_max_lag=int(mon["ess_max_lag"]),
                                nev_at_draws=True)
        summ = pooled.pooled_summary(self.moments, group=eng.chain_group)
        ess = pooled.ess_from_state(es, group=eng.chain_group)
        rhat, least, per_chain = torch.stack([
            summ["rhat"].max(), ess.min(),
            summ["draws_per_chain"].to(ess.dtype)]).tolist()
        self.steps += 1
        met = rhat < mon["rhat_below"] and least > mon["ess_above"]
        self.last = {"steps": self.steps, "rhat_max": rhat,
                     "ess_min": least, "met": met}
        if not dist.get_rank():
            harness.say(f"monitor step {self.steps}: max R-hat {rhat:.6f},"
                        f" min ESS {least:.1f} over "
                        f"{per_chain:.0f} draws a chain; "
                        f"rule {'met' if met else 'not met'}")
        if keep:
            self.draws.append(kept)
            self.nev.append(nev)

    def describe(self) -> dict:
        return dict(super().describe(), monitor=dict(
            self.monitor, last=self.last,
            merge_counts=dict(pooled.merge_counts)))
