"""Driver of the fused engine, ``FusedCGGibbs``.

Burn-in is ``burnin_sweeps`` sweeps of ``run`` (the engine does not
adapt); a chunk is one ``run`` of ``chunk_sweeps`` sweeps, one
``fused_sweep`` launch each at ``granularity="sweep"``, followed by a
synchronise so that the host never queues work past the window.  At
``block_chains=1`` the evaluation count is each chain's own, which the
roofline and ``sweep_mfu`` need.  The profiled segment is
``profile_sweeps`` sweeps after the window.
"""

from __future__ import annotations

import torch

import mcmcglm_tpu_torch as mt

from . import program_family, program_prior

__all__ = ["Driver"]


class Driver:
    unit = "sweep"

    def __init__(self, config, work, X, y, seed, device):
        self.work, self.seed, self.device = work, int(seed), device
        self.C = int(work["chains"])
        self.eng = mt.FusedCGGibbs(
            X, y, program_family(config), program_prior(config),
            extra=config.get("extra") or None, tuning=work["tuning"],
            block_chains=work["block_chains"],
            granularity=work["granularity"], device=device)
        self.state = None
        self.draws, self.nev = [], []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def burn_in(self):
        self.state = self.eng.init(self.seed, self.C)
        self.state, _, _ = self.eng.run(self.state,
                                        self.work["burnin_sweeps"])
        self._sync()

    def chunk(self, keep: bool):
        self.state, betas, nevs = self.eng.run(self.state,
                                               self.work["chunk_sweeps"])
        self._sync()
        if keep:
            self.draws.append(betas)
            self.nev.append(nevs)

    def counts(self) -> dict:
        return {"evals": int(sum(int(n.sum()) for n in self.nev))}

    def outputs(self) -> dict:
        return {"draws": torch.cat(self.draws, 0).transpose(0, 1)
                .contiguous(),
                "nev": None, "nev_sweep": torch.cat(self.nev),
                "beta": self.state.beta, "eta": self.state.eta}

    def profile(self, trace):
        """(the segment's reduction), with each profiled sweep's
        evaluations over all chains under ``nev``."""
        k = int(self.work["profile_sweeps"])
        (_, _, nevs), red = trace.profile_call(
            lambda: self.eng.run(self.state, k), self.device)
        red["units"] = k
        red["nev"] = [int(v) for v in nevs.cpu()]
        return red

    def describe(self) -> dict:
        return {"engine": "FusedCGGibbs", "impl": self.eng.impl,
                "block_chains": self.eng.block_chains,
                "granularity": self.eng.granularity}
