"""Multivariate elliptical slice sampler on the shared GLM posterior.

Counterpart of ``mcmcglm_tpu/baselines/ess_mv.py`` (qslice's
``slice_elliptical_mv``; Murray, Adams & MacKay 2010): for a gaussian
prior beta ~ N(mu0, Sigma0), each update draws nu ~ N(mu0, Sigma0) and
slices the likelihood along the ellipse

    beta(theta) = (beta - mu0) cos(theta) + (nu - mu0) sin(theta) + mu0.

The ellipse is linear in beta, so eta(theta) = X beta(theta) combines the
carried eta, eta_nu = X (nu - mu0) and X mu0: one product per update
(``utils.linalg.matvec``, float64 rounded once) and elementwise (C, n)
work per evaluation.  Valid for any likelihood; the prior must be an IID
Normal or an MVN prior.

C chains update at once.  The shrinkage loop is a
``ops/slice_kernels.masked_loop`` of up to ``max_shrink`` evaluations: a
chain whose point is accepted freezes, and the host reads one flag per
block of ``_block_iters`` iterations (``loop_stats["flag_reads"]``; the
draws do not depend on the block length).

Random streams (``_streams.Streams``; step = the update's index, carried in
the state from 0):

* site 0, slots 0 .. d-1: the standard normals of nu;
* site 1, slot 0: the slice level's exponential; slot 1: theta's uniform;
* site 2, slot i: the uniform of shrink iteration i.

The initial draw is ``_streams.prior_draws``.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..api import entry_device
from ..models.families import check_family
from ..models.priors import IIDPrior, MVNPrior, Normal
from ..ops.philox import key_tensor
from ..ops.slice_kernels import _BLOCK_ITERS, masked_loop
from ..utils.linalg import matvec
from ._streams import Streams, prior_draws
from .logdensity import design, rowwise

__all__ = ["EllipticalSliceGLM", "ESSState"]


class ESSState(NamedTuple):
    beta: torch.Tensor  # (C, d)
    eta: torch.Tensor  # (C, n): X beta, carried
    key: torch.Tensor  # (2,) int64 Philox key
    step: int  # the next update's index


def run_chunks(run, state, n_samples: int, chunk_size: int):
    """``run(state, n)`` in chunks of ``chunk_size`` (all at once when 0):
    (betas (C, n_samples, d), n_evals (C, n_samples)) as numpy arrays and
    the last state."""
    if chunk_size <= 0:
        chunk_size = n_samples
    parts, nevs, done = [], [], 0
    while done < n_samples:
        step = min(chunk_size, n_samples - done)
        state, betas, nev = run(state, step)
        parts.append(betas.cpu().numpy())
        nevs.append(nev.cpu().numpy())
        done += step
    return np.concatenate(parts, 1), np.concatenate(nevs, 1), state


class EllipticalSliceGLM:
    """Whole-vector elliptical slice sampling for GLMs with gaussian
    priors, C chains at once, on ``device`` (default "cuda", which raises
    without CUDA)."""

    def __init__(self, X, y, family, prior, extra: Optional[Mapping] = None,
                 max_shrink: int = 64, dtype=torch.float32, *,
                 device="cuda"):
        self.device = entry_device(device, "EllipticalSliceGLM")
        self.family = check_family(family)
        if isinstance(prior, IIDPrior) and isinstance(prior.dist, Normal):
            mu0 = torch.full((prior.d,), float(prior.dist.loc),
                             dtype=torch.float64)
            chol = torch.eye(prior.d, dtype=torch.float64) * prior.dist.scale
        elif isinstance(prior, MVNPrior):
            mu0, chol = prior.mvn.loc, prior.mvn.chol
        else:
            raise ValueError(
                "EllipticalSliceGLM requires a gaussian prior "
                "(IIDPrior(Normal) or MVNPrior)"
            )
        self.prior = prior
        self.dtype = dtype
        self.Xt, self.y, self.extra = design(X, y, extra, dtype, self.device)
        self.d, self.n = self.Xt.shape
        self._mu0 = mu0.to(self.device, dtype)
        self._chol_t = chol.T.contiguous().to(self.device, dtype)
        self.max_shrink = int(max_shrink)
        self._block_iters = _BLOCK_ITERS  # masked iterations per flag read
        self.loop_stats = {"flag_reads": 0}
        self._eta_mu0 = matvec(self._mu0, self.Xt)
        # the per-chain products and sums, on fixed tiles of chains
        self._matvec = rowwise(lambda b: matvec(b, self.Xt))
        self._nu = rowwise(lambda z: z @ self._chol_t)
        self._loglik = rowwise(lambda eta: torch.sum(
            self.family.log_density_eta(eta, self.y, self.extra), dim=-1))

    @torch.inference_mode()
    def init(self, seed: int, n_chains: int) -> ESSState:
        """A prior draw per chain and the Philox key of ``seed``."""
        beta = prior_draws(self.prior, seed, n_chains, dtype=self.dtype,
                           device=self.device)
        return ESSState(beta, self._matvec(beta),
                        key_tensor(seed, self.device), 0)

    def _update(self, streams, beta, eta, draws):
        nu_u, lv_u, sh_u = draws
        # the auxiliary draw and its linear predictor (the one product)
        nu_c = self._nu(streams.normal(nu_u))  # nu - mu0
        eta_nu = self._matvec(nu_c)
        beta_c = beta - self._mu0
        eta_c = eta - self._eta_mu0
        level = self._loglik(eta) - streams.exponential(lv_u[:, 0])
        two_pi = 2.0 * math.pi
        theta0 = streams.uniform(lv_u[:, 1]) * two_pi
        shrink_u = streams.uniform(sh_u)

        def eta_at(theta):
            c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
            return eta_c * c + eta_nu * s + self._eta_mu0

        def body(it, c):
            lo, hi, theta, _, _, n_ev = c
            ok = self._loglik(eta_at(theta)) >= level
            lo = torch.where(~ok & (theta < 0), theta, lo)
            hi = torch.where(~ok & (theta >= 0), theta, hi)
            theta_new = lo + (hi - lo) * shrink_u[:, it]
            return lo, hi, theta_new, theta, ok, n_ev + 1

        C = beta.shape[0]
        carry = (theta0 - two_pi, theta0, theta0, torch.zeros_like(theta0),
                 torch.zeros(C, dtype=torch.bool, device=self.device),
                 torch.zeros(C, dtype=torch.int32, device=self.device))
        (_, _, _, theta, ok, n_ev), _ = masked_loop(
            streams, lambda c: ~c[4], body, carry, self.max_shrink)
        c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        a = ok[:, None]
        beta = torch.where(a, beta_c * c + nu_c * s + self._mu0, beta)
        eta = torch.where(a, eta_at(theta), eta)
        return beta, eta, n_ev

    @torch.inference_mode()
    def run(self, state: ESSState, n_steps: int):
        """``n_steps`` updates of every chain: (state, betas (C, n_steps,
        d), n_evals (C, n_steps)), computed in inference mode (no
        autograd bookkeeping)."""
        C = state.beta.shape[0]
        streams = Streams(state.key, C, dtype=self.dtype, device=self.device,
                          block=self._block_iters)
        streams.stats = self.loop_stats
        betas, nevs = [], []
        beta, eta = state.beta, state.eta
        for _, draws in streams.steps(state.step, n_steps,
                                      [(0, self.d), (1, 2),
                                       (2, self.max_shrink)]):
            beta, eta, n_ev = self._update(streams, beta, eta, draws)
            betas.append(beta)
            nevs.append(n_ev)
        state = ESSState(beta, eta, state.key, state.step + int(n_steps))
        return state, torch.stack(betas, 1), torch.stack(nevs, 1)

    def sample(self, seed: int, n_samples: int, n_chains: int = 1,
               chunk_size: int = 0):
        """init, then ``n_samples`` updates: (betas (C, n_samples, d),
        n_evals (C, n_samples)) as numpy arrays and the last state."""
        return run_chunks(self.run, self.init(seed, n_chains), n_samples,
                          chunk_size)
