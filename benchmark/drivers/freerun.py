"""Driver of the free-running engine, ``FreeRunCGGibbs``.

Burn-in is the engine's adaptive ``warmup``; a chunk is one ``run`` of
``chunk_sweeps`` sweeps, which on the card replays the captured block of
32 passes until every chain has its sweeps (one host read of the flag per
block).  The profiled segment is ``profile_passes`` passes through
``run_passes`` after the window, its block captured first, so a traced
run profiles replays and never a capture.
"""

from __future__ import annotations

import math

import torch

import mcmcglm_tpu_torch as mt

from . import program_family, program_prior

__all__ = ["Driver"]


class Driver:
    unit = "pass"

    def __init__(self, config, work, X, y, seed, device, x_storage="f32"):
        self.work, self.seed, self.device = work, int(seed), device
        self.C = int(work["chains"])
        self.eng = mt.FreeRunCGGibbs(
            X, y, program_family(config), program_prior(config),
            extra=config.get("extra") or None, tuning=work["tuning"],
            slice_kernel=work["slice_kernel"], spec_k=work["spec_k"],
            battery_impl=work["battery"], x_storage=x_storage,
            device=device)
        self.state = None
        self.draws, self.nev = [], []

    def burn_in(self):
        self.state = self.eng.init(self.seed, self.C)
        self.state, _, _ = self.eng.warmup(self.state,
                                           self.work["burnin_sweeps"])

    def chunk(self, keep: bool):
        self.state, draws, nev = self.eng.run(self.state,
                                              self.work["chunk_sweeps"])
        if keep:
            self.draws.append(draws)
            self.nev.append(nev)

    def counts(self) -> dict:
        return {"passes": int(self.state.ctr),
                "evals": int(self.state.nev.long().sum())}

    def outputs(self) -> dict:
        return {"draws": torch.cat(self.draws, 1),
                "nev": torch.cat(self.nev, 1), "nev_sweep": None,
                "beta": self.state.beta, "eta": self.state.eta}

    def profile(self, trace):
        """(passes profiled, the segment's reduction)."""
        eng, P = self.eng, int(self.work["profile_passes"])
        # enough sweeps of quota that no chain finishes within P passes
        S = math.ceil(P / eng.d) + 1

        def seg():
            return eng.run_passes(self.state, None, None, None, S, P)[0]

        seg()  # captures the segment's block
        ctr0 = int(self.state.ctr)
        st, red = trace.profile_call(seg, self.device)
        red["units"] = int(st.ctr) - ctr0
        return red

    def describe(self) -> dict:
        return {"engine": "FreeRunCGGibbs", "battery": self.eng.battery_impl,
                "spec_k": self.eng.spec_k, "x_storage": self.eng.x_storage,
                "eval_cache": self.eng.eval_cache,
                "loop_stats": dict(self.eng.loop_stats)}
