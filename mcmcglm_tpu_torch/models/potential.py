"""The log-potential functions: likelihood + prior as a function of one
coordinate, batched over chains.

Counterpart of ``mcmcglm_tpu/models/potential.py``:

  * :func:`update_linear_predictor` -- the O(n) incremental eta update,
    eta' = eta + x_j (b' - b), the CGGibbs trick;
  * :func:`log_density` and :func:`log_likelihood` -- per-observation log
    densities dispatched on the family, and their sum;
  * :func:`log_potential_from_betaj` -- the absolute log potential after
    setting coordinate j, by the "update" or the "naive" linear predictor;
  * :func:`make_coord_target` -- the lockstep engine's relative target
        g(b) = sum_i [ld_i(eta_i + x_ij (b - beta_j)) - ld_cur_i]
               + prior_j(b) - prior_j(beta_j),
    with g(beta_j) = 0 by construction, so every compared quantity is O(1)
    and float32 keeps about 1e-6 of absolute precision.

Where the JAX functions take one chain, these take ``beta`` (C, d), ``eta``
(C, n) and a (C,) coordinate index per chain; a (d,) ``beta`` is one chain.
The naive product goes through :func:`~..utils.linalg.matvec` (float64,
rounded once), never a bare float32 matmul that TF32 may round.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from ..utils.linalg import matvec
from .families import Family, check_family
from .priors import BetaPrior

__all__ = [
    "log_density",
    "update_linear_predictor",
    "log_likelihood",
    "log_potential_from_betaj",
    "make_coord_target",
]


def log_density(family, mu, y, **extra):
    """Per-observation log density dispatched on the family."""
    return check_family(family).log_density_mu(mu, y, extra)


def update_linear_predictor(new_beta_j, current_beta_j, current_eta, x_j):
    """eta' = eta + x_j * (new_beta_j - current_beta_j): n operations per
    chain instead of the n*d of a full product.  Per-chain (C,) coefficients
    scale the rows of a (C, n) ``current_eta``."""
    delta = new_beta_j - current_beta_j
    if torch.is_tensor(delta) and 0 < delta.dim() == current_eta.dim() - 1:
        delta = delta.unsqueeze(-1)
    return current_eta + x_j * delta


def log_likelihood(family, mu, y, extra=None):
    """Sum of the per-observation log densities over the last axis."""
    return check_family(family).log_likelihood(mu, y, extra)


def _lanes(j, C, device) -> torch.Tensor:
    """A coordinate index (int or (C,) tensor) as a (C,) int64 tensor."""
    j = torch.as_tensor(j, device=device).long()
    return j.expand(C) if j.dim() == 0 else j


def log_potential_from_betaj(
    new_beta_j,
    j,
    current_beta,
    current_eta,
    y,
    X,
    family,
    beta_prior: BetaPrior,
    linear_predictor_calc: str = "update",
    extra: Optional[Mapping] = None,
):
    """Absolute log potential after setting coordinate ``j`` of each chain
    to ``new_beta_j``: the incremental ("update") or full-product ("naive")
    linear predictor, then the log likelihood plus the full log prior.
    ``X`` is the (n, d) design; returns (C,) for a (C, d) ``current_beta``
    and a scalar for a (d,) one."""
    family = check_family(family)
    one = current_beta.dim() == 1
    if one:
        current_beta, current_eta = current_beta[None], current_eta[None]
    C = current_beta.shape[0]
    jl = _lanes(j, C, current_beta.device)
    rows = torch.arange(C, device=current_beta.device)
    new_beta = current_beta.clone()
    new_beta[rows, jl] = torch.as_tensor(new_beta_j, dtype=new_beta.dtype,
                                         device=new_beta.device)
    if linear_predictor_calc == "update":
        new_eta = update_linear_predictor(
            new_beta[rows, jl], current_beta[rows, jl], current_eta,
            X[:, jl].T,
        )
    elif linear_predictor_calc == "naive":
        new_eta = matvec(new_beta, X.T)
    else:
        raise ValueError("linear_predictor_calc must be 'update' or 'naive'")
    ll = torch.sum(family.log_density_eta(new_eta, y, extra), dim=-1)
    out = ll + beta_prior.log_prob_beta(new_beta)
    return out[0] if one else out


def make_coord_target(
    family: Family,
    beta_prior: BetaPrior,
    y,
    extra: Optional[Mapping] = None,
    reduce_fn: Callable = lambda t: torch.sum(t, dim=-1),
):
    """Build the relative coordinate target factory of the lockstep engine.

    Returns ``target_factory(beta (C, d), eta (C, n), ld_cur (C, n), x_j,
    j (C,))``, where ``x_j`` is the coordinate's (n,) design row or a (C,
    n) row per chain; it yields ``g(b)`` for proposals ``b`` (C,) -> (C,),
    or (C, K) -> (C, K) (``g.batched`` is True), with ``g(beta[:, j]) ==
    0``.  ``ld_cur`` caches the per-observation log densities at the
    current eta; ``reduce_fn`` is the observation-axis reduction.
    """
    family = check_family(family)
    extra = dict(extra or {})

    def target_factory(beta, eta, ld_cur, x_j, j):
        beta_j = torch.gather(beta, 1, j.long()[:, None])[:, 0]
        lp_cur = beta_prior.coord_log_prob(beta, j, beta_j)

        def g(b):
            delta = b - (beta_j if b.dim() == 1 else beta_j[:, None])
            if b.dim() == 1:
                eta_new = eta + x_j * delta[:, None]
                ld = ld_cur
            else:  # (C, K) proposals against (C, 1, n) rows
                xj = x_j if x_j.dim() == 1 else x_j[:, None, :]
                eta_new = eta[:, None, :] + xj * delta[..., None]
                ld = ld_cur[:, None, :]
            dll = reduce_fn(family.log_density_eta(eta_new, y, extra) - ld)
            lp = lp_cur if b.dim() == 1 else lp_cur[:, None]
            return dll + (beta_prior.coord_log_prob(beta, j, b) - lp)

        g.batched = True
        return g

    return target_factory
