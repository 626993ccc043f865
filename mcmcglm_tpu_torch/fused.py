"""FusedCGGibbs: the CGGibbs sampler driven by the fused coordinate kernels.

Counterpart of ``mcmcglm_tpu/fused.py``.  Every chain runs the standard
sequential CGGibbs sweep with Neal's stepping-out slice sampler, and each
coordinate update (level, interval, step-out, shrinkage, the O(n) eta
commit) is one fused computation over all chains:
``granularity="sweep"`` runs a whole sweep as one launch of
``fused_sweep``, ``"coord"`` one launch of ``fused_coord_update`` per
coordinate (``ops/fused_cggibbs.py``).

Scope as in the JAX package: an :class:`~.models.priors.IIDPrior`, the
stepping-out kernel, and n within the JAX package's limit
(``MAX_FUSED_N`` = 65,536).  The engine resolves ``impl`` to
``"cuda"`` on a CUDA device for a family/link pair in ``KERNEL_FAMILIES``
(every built-in pair) and a prior in ``KERNEL_PRIORS``, and to
``"torch"`` (the plain PyTorch versions) otherwise; ``impl_reason`` says
why.  On a CUDA device a user-registered family or link, which no hand
kernel can compile, warns.

Random numbers are the Philox stream of ``ops/philox.py``, keyed by the
state's ``seed`` and counted by its ``sweep``: a chain's draws depend on
neither ``block_chains`` nor ``granularity``.  The TPU kernels' per-core
generator has no counterpart, so the two packages agree in law (and draw
for draw when a test hands both the same uniforms).

Each ``run`` records a ``fused.run`` span and in it one ``fused.sweep``
span per sweep, timed on the card by two events around the sweep's
launches (``utils/profiling.py``), at either granularity.
"""

from __future__ import annotations

import warnings
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from .freerun import _resolve_device, _tensor
from .models.families import check_family
from .models.priors import IIDPrior
from .ops.freerun_batteries import _outside_table, kernel_family
from .ops.fused_cggibbs import (
    MAX_FUSED_N,
    fused_coord_update,
    fused_sweep,
    kernel_prior,
    plain_fused_coord_update,
    plain_fused_sweep,
)
from .utils.linalg import matvec
from .utils.profiling import device_span, span

__all__ = ["FusedCGGibbs", "FusedState"]


class FusedState(NamedTuple):
    beta: torch.Tensor  # (C, d)
    eta: torch.Tensor  # (C, n)
    seed: int  # the Philox key of the run
    sweep: int  # sweeps done so far: the first word of the Philox counter


class FusedCGGibbs:
    """Batch-level CGGibbs with the fused coordinate kernels.

    Same problem signature as the JAX package's ``FusedCGGibbs`` (without
    ``interpret``), plus the required keyword ``device``.
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior: IIDPrior,
        extra: Optional[Mapping] = None,
        tuning: Optional[Mapping] = None,
        block_chains: int = 8,
        max_stepouts: int = 128,
        max_shrink: int = 64,
        granularity: str = "sweep",
        *,
        device,
    ):
        if not isinstance(prior, IIDPrior):
            raise ValueError(
                "FusedCGGibbs requires an IIDPrior; use CGGibbs otherwise"
            )
        self.family = check_family(family)
        self.prior = prior
        self.device = _resolve_device(device)
        X = _tensor(X, torch.float32, "cpu")
        self.n, self.d = X.shape
        if prior.d != self.d:
            raise ValueError(
                f"prior dimension {prior.d} != model width {self.d}"
            )
        if self.n > MAX_FUSED_N:
            raise ValueError(
                f"n={self.n} exceeds the fused engine's limit MAX_FUSED_N="
                f"{MAX_FUSED_N} (the JAX package's); use FreeRunCGGibbs"
            )
        self.Xt = X.T.contiguous().to(self.device)  # (d, n)
        self.y = _tensor(y, torch.float32, self.device).reshape(-1)
        self.extra = {k: float(v) for k, v in dict(extra or {}).items()}
        self.tuning = {k: float(v) for k, v in dict(tuning or {}).items()}
        if "w" not in self.tuning:
            raise ValueError(
                "FusedCGGibbs uses stepping_out; tuning must include w"
            )
        self.block_chains = int(block_chains)
        self.max_stepouts = int(max_stepouts)
        self.max_shrink = int(max_shrink)
        if granularity not in ("sweep", "coord"):
            raise ValueError("granularity must be 'sweep' or 'coord'")
        self.granularity = granularity
        self._configure()

    def _configure(self):
        """Resolve ``impl`` against the kernels' static tables: "cuda" when
        nothing blocks the kernels, else "torch"; ``impl_reason`` says
        why."""
        blockers = []
        if kernel_family(self.family, self.extra) is None:
            blockers.append(_outside_table(self.family))
            if self.device.type == "cuda":
                warnings.warn(
                    f"FusedCGGibbs: {_outside_table(self.family)}; running "
                    "the plain torch fused updates",
                    RuntimeWarning,
                    stacklevel=3,
                )
        if kernel_prior(self.prior.dist) is None:
            blockers.append(f"{type(self.prior.dist).__name__} is not in "
                            "KERNEL_PRIORS")
        if self.device.type != "cuda":
            blockers.append(f"device {self.device} is not CUDA")
        self.impl = "torch" if blockers else "cuda"
        self.impl_reason = ("; ".join(blockers) if blockers else
                            "CUDA device, a kernel family/link pair and prior")

    def _kw(self, state):
        return dict(seed=state.seed, sweep=state.sweep, w=self.tuning["w"],
                    block_chains=self.block_chains,
                    max_stepouts=self.max_stepouts,
                    max_shrink=self.max_shrink)

    def _plain_fns(self):
        fam, extra = self.family, self.extra
        return dict(ld_fn=lambda e, y: fam.log_density_eta_rel(e, y, extra),
                    lp_fn=self.prior.dist.log_prob)

    # -- state -------------------------------------------------------------

    def init(self, seed, n_chains: int) -> FusedState:
        """Prior draws for ``n_chains`` chains and eta0 = X beta0 at full
        float32; the run's Philox key comes from the same seed."""
        if n_chains % self.block_chains:
            raise ValueError(
                f"n_chains={n_chains} must be a multiple of block_chains="
                f"{self.block_chains}"
            )
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        beta = self.prior.sample_beta(g, int(n_chains), dtype=torch.float32,
                                      device=self.device)
        eta = matvec(beta, self.Xt)
        key = torch.randint(0, 2**62, (1,), generator=g, device=self.device)
        return FusedState(beta, eta, int(key.item()), 0)

    # -- sweeps ------------------------------------------------------------

    def _sweep(self, state: FusedState):
        kw = self._kw(state)
        cuda = self.impl == "cuda"
        if self.granularity == "sweep":
            if cuda:
                eta, beta, nev = fused_sweep(
                    state.eta, state.beta, self.Xt, self.y, self.family,
                    self.extra, self.prior.dist, **kw)
            else:
                eta, beta, nev, _ = plain_fused_sweep(
                    state.eta, state.beta, self.Xt, self.y,
                    **self._plain_fns(), **kw)
        else:
            eta, beta = state.eta, state.beta.clone()
            nev = torch.zeros(beta.shape[0], dtype=torch.int32,
                              device=self.device)
            for j in range(self.d):
                bj = beta[:, j].contiguous()
                if cuda:
                    eta, bj, nev_j = fused_coord_update(
                        eta, bj, self.Xt[j], self.y, self.family, self.extra,
                        self.prior.dist, j=j, **kw)
                else:
                    eta, bj, nev_j, _ = plain_fused_coord_update(
                        eta, bj, self.Xt[j], self.y, j=j,
                        **self._plain_fns(), **kw)
                beta[:, j] = bj
                nev += nev_j
        return FusedState(beta, eta, state.seed, state.sweep + 1), nev

    def run(self, state: FusedState, n_steps: int):
        """Advance by ``n_steps`` sweeps.  Returns (state, betas
        (n_steps, C, d), nev (n_steps,)), nev[s] the evaluations of sweep s
        summed over chains."""
        C = state.beta.shape[0]
        with span("fused.run", C=int(C), n_sweeps=int(n_steps)):
            betas = torch.empty((n_steps, C, self.d), dtype=torch.float32,
                                device=self.device)
            nevs = torch.empty(n_steps, dtype=torch.int64,
                               device=self.device)
            for s in range(n_steps):
                with device_span("fused.sweep", self.device):
                    state, nev = self._sweep(state)
                betas[s] = state.beta
                nevs[s] = nev.sum()
        return state, betas, nevs

    def sample(self, seed, n_samples: int, n_chains: int, chunk_size: int = 0,
               progress=None):
        """Returns (betas (C, n_samples+1, d), n_evals (n_samples,), state),
        the arrays as numpy; row 0 is the init draw."""
        state = self.init(seed, n_chains)
        parts = [state.beta.cpu().numpy()[:, None, :]]
        if chunk_size <= 0:
            chunk_size = n_samples
        nevs = []
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, betas, nev = self.run(state, step)
            parts.append(betas.cpu().numpy().transpose(1, 0, 2))
            nevs.append(nev.cpu().numpy())
            done += step
            if progress is not None:
                progress(done, n_samples)
        return np.concatenate(parts, axis=1), np.concatenate(nevs), state
