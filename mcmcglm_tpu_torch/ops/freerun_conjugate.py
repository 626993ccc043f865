"""Exact conjugate coordinate draws for the free-running CGGibbs engine.

Counterpart of ``mcmcglm_tpu/ops/freerun_conjugate.py``.  For a gaussian
response with identity link and an independent normal prior the
coordinate conditional is normal, so a coordinate costs ONE pass:

    r_j   = y - eta + x_j * beta_j          (partial residual)
    tau_j = sum_i w_i x_ij^2 / sigma^2 + 1 / s_j^2
    mu_j  = (sum_i w_i x_ij r_ji / sigma^2 + m_j / s_j^2) / tau_j
    beta_j ~ N(mu_j, 1 / tau_j);  eta += x_j * (beta_j' - beta_j)

``conjugate_params`` validates eligibility at engine construction;
``run_pass_conj`` is the per-pass function, with the signature of
``ops.freerun_passes.run_pass`` so every run mode works unchanged.  It is
plain torch, as the JAX package leaves it to XLA (no Pallas kernel there).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.priors import IIDPrior, Normal, StackedPrior
from .freerun_passes import _active, _draws, _gather

__all__ = ["conjugate_params", "run_pass_conj"]


def conjugate_params(eng):
    """Validate conjugate-coordinate eligibility; return (m, s2) prior
    vectors ((d,) mean and variance, float64 numpy).  Raises ValueError
    with the specific obstruction otherwise."""
    fam = eng.family
    if fam.name != "gaussian" or fam.link.name != "identity":
        raise ValueError(
            "coord_sampler='conjugate' requires the gaussian family with "
            f"identity link (got {fam.name!r} with {fam.link.name!r}); "
            "use the slice coordinate sampler for other models"
        )
    sd = eng.extra.get("sd", None)
    if sd is not None and sd.dim() != 0:
        raise ValueError(
            "coord_sampler='conjugate' requires a scalar gaussian sd"
        )
    prior = eng.prior
    if isinstance(prior, IIDPrior) and isinstance(prior.dist, Normal):
        m = np.full((eng.d,), float(prior.dist.loc), np.float64)
        s2 = np.full((eng.d,), float(prior.dist.scale) ** 2, np.float64)
    elif isinstance(prior, StackedPrior) and all(
        isinstance(di, Normal) for di in prior.dists
    ):
        m = np.array([di.loc for di in prior.dists], np.float64)
        s2 = np.array([di.scale ** 2 for di in prior.dists], np.float64)
    else:
        raise ValueError(
            "coord_sampler='conjugate' requires an independent normal "
            "prior (IIDPrior(Normal) or StackedPrior of Normals); got "
            f"{type(prior).__name__}"
        )
    return m, s2


def run_pass_conj(eng, s, sweep_count, draws, nevbuf, n_sweeps,
                  adapt: bool, shrink_only, stepout_sweeps=None, z=None,
                  live=None):
    """One exact conjugate coordinate draw + commit for every chain.

    ``z`` (C,) are the standard normals of the pass (None: ndtri of the
    state's Philox stream).  Every active lane commits on every pass, so
    chains stay j-synchronised and a sweep costs exactly d passes.
    Inactive lanes are frozen outright (beta, eta, j); the slice registers
    are never read and stay untouched."""
    del adapt, shrink_only, stepout_sweeps  # no widths; warmup = burn-in
    active = _active(sweep_count, n_sweeps, live)
    if z is None:
        z = _draws(eng, s)["z"]

    xg = eng.Xt[s.j.long()]  # (C, n) row gather
    b0 = _gather(s.beta, s.j)
    # weighted partial-residual cross product: sum_i w_i x_ij (y - eta)_i
    s1 = eng.reduce_fn(xg * (eng.y[None, :] - s.eta))  # (C,)
    jl = s.j.long()
    sxx_j = eng._conj_sxx[jl]
    m_j = eng._conj_m[jl]
    s2_j = eng._conj_s2[jl]
    inv_sig2 = eng._conj_inv_sigma2
    tau = sxx_j * inv_sig2 + 1.0 / s2_j
    mu = ((s1 + sxx_j * b0) * inv_sig2 + m_j / s2_j) / tau
    b_new = mu + z / torch.sqrt(tau)
    b_star = torch.where(active, b_new, b0)

    eta = torch.where(active[:, None], s.eta + xg * (b_star - b0)[:, None],
                      s.eta)
    beta = eng._commit_row(s.beta, s.j, b_star)

    nev_new = s.nev + active.to(torch.int32)
    j_next = torch.where(active, s.j + 1, s.j)
    sweep_done = active & (j_next >= eng.d)
    draws, nevbuf = eng._sweep_buffers(draws, nevbuf, sweep_count, beta,
                                       nev_new, sweep_done)
    sweep_count = torch.where(sweep_done, sweep_count + 1, sweep_count)
    j_next = torch.where(sweep_done, 0, j_next)
    state = s._replace(beta=beta, eta=eta, j=j_next, nev=nev_new,
                       ctr=s.ctr + active.any().to(torch.int64))
    return state, sweep_count, draws, nevbuf
