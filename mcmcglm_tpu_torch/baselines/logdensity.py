"""The shared full-vector log posterior of the baseline samplers.

Counterpart of ``mcmcglm_tpu/baselines/logdensity.py``: log p(beta) =
sum_i log f(y_i | linkinv(x_i beta)) + log prior(beta), the CGGibbs
engines' posterior as one differentiable function, batched over chains:
``logpost`` maps beta (..., d) to (...).  Each evaluation is one full
product beta @ X^T, the family's per-observation density in eta and a sum.

The product runs through ``utils.linalg.matvec``: float64 from the
dtype-rounded operands, rounded once to the working dtype.  The JAX package
pins ``Precision.HIGHEST`` (``mcmcglm_tpu/utils/linalg.py``) so that no
TF32 pass truncates it; here a float32 product may run in TF32 whenever
``torch.backends.cuda.matmul.allow_tf32`` is set, and switching that off
inside the call would not reach the gradient's product, which autograd
runs later, outside it.  The float64 product is TF32-free in both
directions (autograd differentiates through the casts, so the gradient's
product X^T g is float64 too), and at the baselines' widths it costs
little.

A library product or sum may take its rows in an order that depends on
how many rows there are (the CPU's GEMM picks its kernel by shape; a CUDA
sum splits each row over a number of warps set by the row count), so a
chain's value could depend on how many chains run beside it.
:func:`rowwise` runs such an operation on fixed tiles of ``TILE`` rows
(the last tile padded with copies of its first row), one tile at a time:
every tile has the same shape, so chain c's bits depend on c alone.  The
log posterior and the samplers' own per-chain sums go through it.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..api import entry_device
from ..models.families import check_family
from ..models.priors import BetaPrior
from ..utils.linalg import matvec

__all__ = ["make_log_posterior", "rowwise", "value_and_grad"]

TILE = 8  # rows (chains) per tile of :func:`rowwise`


def rowwise(fn):
    """``fn`` applied to tiles of ``TILE`` rows of its arguments' leading
    axis (the last tile padded with copies of the first row) and
    concatenated: for a row-independent ``fn`` the same function, whose
    row c does not depend on the number of rows."""
    def call(*xs):
        C = xs[0].shape[0]
        if C == TILE:
            return fn(*xs)
        pad = -C % TILE
        if pad:
            xs = [torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                  for x in xs]
        outs = [fn(*(x[g:g + TILE] for x in xs))
                for g in range(0, C + pad, TILE)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out[:C] if pad else out

    return call


def design(X, y, extra, dtype, device):
    """(X^T as float64 of the dtype-rounded X, y, extra) on ``device``."""
    Xt = torch.tensor(np.asarray(X, np.float64), dtype=dtype).T
    Xt = Xt.to(device=device, dtype=torch.float64).contiguous()
    y = torch.tensor(np.asarray(y, np.float64).reshape(-1), dtype=dtype,
                     device=device)
    extra = {k: torch.tensor(np.asarray(v, np.float64), dtype=dtype,
                             device=device)
             for k, v in dict(extra or {}).items()}
    return Xt, y, extra


def make_log_posterior(X, y, family, prior: BetaPrior,
                       extra: Optional[Mapping] = None, dtype=torch.float32,
                       device="cuda"):
    """Returns ``logpost(beta)`` for beta (..., d) on ``device``, with the
    result of shape (...): the likelihood through the family's eta path
    plus the prior's full log density, on :func:`rowwise` tiles.
    ``device`` defaults to "cuda" and raises without it."""
    device = entry_device(device, "make_log_posterior")
    family = check_family(family)
    Xt, y, extra = design(X, y, extra, dtype, device)

    @rowwise
    def rows(beta):
        eta = matvec(beta.to(dtype), Xt)
        ll = torch.sum(family.log_density_eta(eta, y, extra), dim=-1)
        return ll + prior.log_prob_beta(beta)

    def logpost(beta):
        d = beta.shape[-1]
        return rows(beta.reshape(-1, d)).reshape(beta.shape[:-1])

    return logpost


def value_and_grad(logpost, beta):
    """(logpost(beta), its gradient) for beta (C, d): ``torch.autograd.grad``
    of the summed batch, whose row c is chain c's gradient (the chains are
    independent).  Both come back detached."""
    with torch.enable_grad():
        b = beta.detach().requires_grad_(True)
        lp = logpost(b)
        (g,) = torch.autograd.grad(lp.sum(), b)
    return lp.detach(), g
