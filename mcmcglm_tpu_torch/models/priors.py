"""Prior distributions over GLM coefficient vectors, on torch tensors.

Counterpart of ``mcmcglm_tpu/models/priors.py`` for the six univariate
distributions, :class:`IIDPrior` and :class:`StackedPrior`.  The port's
prior API is batched over chains (the JAX package's is per chain and
vmapped): ``coord_log_prob(beta, j, b)`` takes ``beta`` (C, d), ``j`` (C,)
and proposals ``b`` of shape (C,) or (C, K).  The support rules are the
JAX package's: Gamma is -inf for x <= 0, Exponential for x < 0, Uniform
outside [low, high].  The log densities make their constants on the
device (``torch.full``, never a host-to-device copy), so a CUDA graph can
capture them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Distribution",
    "Normal",
    "Gamma",
    "Exponential",
    "StudentT",
    "Laplace",
    "Uniform",
    "BetaPrior",
    "IIDPrior",
    "StackedPrior",
    "make_beta_prior",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _f(value, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _neg_inf_outside(inside: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    return torch.where(inside, lp, torch.full_like(lp, -math.inf))


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


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma(shape, rate)."""

    concentration: float = 1.0
    rate: float = 1.0

    def log_prob(self, x):
        a = _f(self.concentration, x)
        r = _f(self.rate, x)
        xin = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
        lp = (a * torch.log(r) - torch.lgamma(a) + (a - 1.0) * torch.log(xin)
              - r * xin)
        return _neg_inf_outside(x > 0, lp)

    def sample(self, generator, shape, *, dtype, device):
        alpha = torch.full(shape, float(self.concentration), dtype=dtype,
                           device=device)
        return torch._standard_gamma(alpha, generator=generator) / self.rate

    def mean(self):
        return self.concentration / self.rate

    def variance(self):
        return self.concentration / self.rate**2


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    """Exponential(rate)."""

    rate: float = 1.0

    def log_prob(self, x):
        r = _f(self.rate, x)
        return _neg_inf_outside(x >= 0, torch.log(r) - r * x)

    def sample(self, generator, shape, *, dtype, device):
        e = torch.empty(shape, dtype=dtype, device=device)
        return e.exponential_(generator=generator) / self.rate

    def mean(self):
        return 1.0 / self.rate

    def variance(self):
        return 1.0 / self.rate**2


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    """Student-t(df, loc, scale)."""

    df: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        v = _f(self.df, x)
        z = (x - _f(self.loc, x)) / _f(self.scale, x)
        return (
            torch.lgamma((v + 1.0) / 2.0)
            - torch.lgamma(v / 2.0)
            - 0.5 * torch.log(v * _f(math.pi, x))
            - torch.log(_f(self.scale, x))
            - (v + 1.0) / 2.0 * torch.log1p(z * z / v)
        )

    def sample(self, generator, shape, *, dtype, device):
        # t = z / sqrt(chi2_df / df), chi2_df = 2 Gamma(df / 2)
        z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        half = torch.full(shape, 0.5 * float(self.df), dtype=dtype,
                          device=device)
        chi2 = 2.0 * torch._standard_gamma(half, generator=generator)
        return self.loc + self.scale * z / torch.sqrt(chi2 / self.df)

    def mean(self):
        return self.loc  # defined for df > 1

    def variance(self):
        return self.scale**2 * self.df / (self.df - 2.0)  # defined for df > 2


@dataclasses.dataclass(frozen=True)
class Laplace(Distribution):
    """Laplace(loc, scale)."""

    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        b = _f(self.scale, x)
        return -torch.abs(x - _f(self.loc, x)) / b - torch.log(2.0 * b)

    def sample(self, generator, shape, *, dtype, device):
        # the difference of two unit exponentials is a unit Laplace
        e = torch.empty((2, *shape), dtype=dtype, device=device)
        e.exponential_(generator=generator)
        return self.loc + self.scale * (e[0] - e[1])

    def mean(self):
        return self.loc

    def variance(self):
        return 2.0 * self.scale**2


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    low: float = 0.0
    high: float = 1.0

    def log_prob(self, x):
        width = _f(self.high - self.low, x)
        inside = (x >= self.low) & (x <= self.high)
        return _neg_inf_outside(inside, (-torch.log(width)).expand_as(x))

    def sample(self, generator, shape, *, dtype, device):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
        return self.low + (self.high - self.low) * u

    def mean(self):
        return 0.5 * (self.low + self.high)

    def variance(self):
        return (self.high - self.low) ** 2 / 12.0


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


class StackedPrior(BetaPrior):
    """Independent per-coordinate marginal priors (the reference's
    list-of-priors form), with the density sum_j log f_j(beta_j)."""

    def __init__(self, dists):
        self.dists = list(dists)
        self.d = len(self.dists)

    def sample_beta(self, generator, n_chains, *, dtype, device):
        return torch.stack([
            dist.sample(generator, (n_chains,), dtype=dtype, device=device)
            for dist in self.dists
        ], 1)

    def log_prob_beta(self, beta):
        return sum(dist.log_prob(beta[..., i])
                   for i, dist in enumerate(self.dists))

    def coord_log_prob(self, beta, j, b):
        # every marginal at b, then each lane's coordinate selected: O(d)
        # small operations, a feature for small d (IIDPrior for large d)
        del beta
        vals = torch.stack([dist.log_prob(b) for dist in self.dists], -1)
        idx = j.long().reshape(-1, *([1] * (b.dim() - 1)), 1)
        return torch.gather(vals, -1, idx.expand(*b.shape, 1))[..., 0]

    def mean_beta(self):
        return torch.tensor([float(dist.mean()) for dist in self.dists],
                            dtype=torch.float64)

    def cov_beta(self):
        return torch.diag(torch.tensor(
            [float(dist.variance()) for dist in self.dists],
            dtype=torch.float64))


def make_beta_prior(spec, d: int) -> BetaPrior:
    """Normalise a user prior spec into a BetaPrior: a univariate
    :class:`Distribution` (iid over the d coordinates), a list of d
    univariate distributions (:class:`StackedPrior`) or a
    :class:`BetaPrior` of dimension d.  The multivariate normal prior is
    not ported yet (ROADMAP queue 1, item 2)."""
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
        if len(spec) != d:
            raise ValueError(
                "The list length of the `beta_prior` specification needs to "
                "match the number of parameters in the model (potentially "
                "including intercept)"
            )
        return StackedPrior(spec)
    raise TypeError(f"cannot interpret beta_prior spec of type {type(spec)!r}")
