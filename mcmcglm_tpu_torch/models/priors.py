"""Prior distributions over GLM coefficient vectors, on torch tensors.

Counterpart of ``mcmcglm_tpu/models/priors.py`` for the priors the main
path uses: :class:`Normal` and :class:`IIDPrior`.  The port's prior API is
batched over chains (the JAX package's is per chain and vmapped):
``coord_log_prob(beta, j, b)`` takes ``beta`` (C, d), ``j`` (C,) and
proposals ``b`` of shape (C,) or (C, K).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Distribution",
    "Normal",
    "BetaPrior",
    "IIDPrior",
    "make_beta_prior",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _f(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


class Distribution:
    """Minimal univariate distribution interface (log_prob/sample/moments)."""

    def log_prob(self, x):
        raise NotImplementedError

    def sample(self, generator, shape, *, dtype, device):
        raise NotImplementedError

    def mean(self):
        raise NotImplementedError

    def variance(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    """Normal(loc, scale)."""

    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        scale = _f(self.scale, x)
        z = (x - _f(self.loc, x)) / scale
        return -0.5 * z * z - torch.log(scale) - _f(0.5 * _LOG_2PI, x)

    def sample(self, generator, shape, *, dtype, device):
        z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return self.loc + self.scale * z

    def mean(self):
        return self.loc

    def variance(self):
        return self.scale**2


class BetaPrior:
    """Prior over beta in R^d with the coordinate-delta operation the
    CGGibbs engines need, batched over chains."""

    d: int

    def sample_beta(self, generator, n_chains, *, dtype, device):
        """(C, d) initial draws."""
        raise NotImplementedError

    def log_prob_beta(self, beta):
        """Full log prior density of each row of ``beta`` (..., d)."""
        raise NotImplementedError

    def coord_log_prob(self, beta, j, b):
        """Log prior as a function of proposal ``b`` at coordinate ``j``,
        up to a constant in ``b``."""
        raise NotImplementedError

    def mean_beta(self):
        raise NotImplementedError

    def cov_beta(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IIDPrior(BetaPrior):
    """Each coordinate iid from one univariate distribution."""

    dist: Distribution
    d: int

    def sample_beta(self, generator, n_chains, *, dtype, device):
        return self.dist.sample(
            generator, (n_chains, self.d), dtype=dtype, device=device
        )

    def log_prob_beta(self, beta):
        return torch.sum(self.dist.log_prob(beta), dim=-1)

    def coord_log_prob(self, beta, j, b):
        del beta, j
        return self.dist.log_prob(b)

    def mean_beta(self):
        return torch.full((self.d,), float(self.dist.mean()),
                          dtype=torch.float64)

    def cov_beta(self):
        return torch.eye(self.d, dtype=torch.float64) * self.dist.variance()


def make_beta_prior(spec, d: int) -> BetaPrior:
    """Normalise a user prior spec into a BetaPrior: a univariate
    :class:`Distribution` (iid over the d coordinates) or a
    :class:`BetaPrior` of dimension d.  Per-coordinate lists and the
    multivariate normal prior are not ported yet (ROADMAP queue 1,
    item 2)."""
    if isinstance(spec, BetaPrior):
        if spec.d != d:
            raise ValueError(
                f"beta_prior dimension {spec.d} does not match number of "
                f"model parameters {d}"
            )
        return spec
    if isinstance(spec, Distribution):
        return IIDPrior(spec, d)
    if isinstance(spec, (list, tuple)):
        raise NotImplementedError(
            "per-coordinate prior lists (StackedPrior) are not ported yet: "
            "ROADMAP queue 1, item 2 (model math)"
        )
    raise TypeError(f"cannot interpret beta_prior spec of type {type(spec)!r}")
