"""Prior distributions over GLM coefficient vectors, on torch tensors.

Counterpart of ``mcmcglm_tpu/models/priors.py``: the six univariate
distributions, :class:`MultivariateNormal`, :class:`IIDPrior`,
:class:`StackedPrior` and :class:`MVNPrior`.  The port's prior API is
batched over chains (the JAX package's is per chain and vmapped):
``coord_log_prob(beta, j, b)`` takes ``beta`` (C, d), ``j`` (C,) and
proposals ``b`` of shape (C,) or (C, K).  The support rules are the JAX
package's: Gamma is -inf for x <= 0, Exponential for x < 0, Uniform
outside [low, high].  The univariate log densities make their constants
on the device (``torch.full``, never a host-to-device copy), so a CUDA
graph can capture them; :class:`MVNPrior` copies its precision matrix to
a device once, at its first use there (an engine's ``init``, before any
capture).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "Distribution",
    "Normal",
    "Gamma",
    "Exponential",
    "StudentT",
    "Laplace",
    "Uniform",
    "MultivariateNormal",
    "BetaPrior",
    "IIDPrior",
    "StackedPrior",
    "MVNPrior",
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


def _f64(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to(device="cpu", dtype=torch.float64)
    return torch.tensor(np.asarray(v, dtype=np.float64))


class MultivariateNormal:
    """MVN(loc, cov), held on the host in float64.  ``log_prob`` and
    ``sample`` compute in float64 on the device of their operands (the
    Cholesky factor copied there once) and round once to the caller's
    dtype."""

    def __init__(self, loc, cov):
        self.loc = _f64(loc)
        self.cov = _f64(cov)
        self.chol = torch.linalg.cholesky(self.cov)
        self._dev = {}  # device -> (loc, chol) float64 copies

    def _on(self, device):
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = (self.loc.to(device), self.chol.to(device))
        return self._dev[device]

    def log_prob(self, x):
        """Log density of each row of ``x`` (..., d), in ``x``'s dtype."""
        loc, chol = self._on(x.device)
        diff = x.double() - loc
        z = torch.linalg.solve_triangular(chol, diff.unsqueeze(-1),
                                          upper=False).squeeze(-1)
        logdet = torch.sum(torch.log(torch.diagonal(chol)))
        d = loc.shape[-1]
        lp = -0.5 * torch.sum(z * z, dim=-1) - logdet - 0.5 * d * _LOG_2PI
        return lp.to(x.dtype)

    def sample(self, generator, shape, *, dtype, device):
        """Draws of shape ``shape + (d,)``: loc + eps chol^T in float64."""
        loc, chol = self._on(device)
        eps = torch.randn((*shape, loc.shape[-1]), generator=generator,
                          dtype=torch.float64, device=device)
        return (loc + eps @ chol.T).to(dtype)

    def mean(self):
        return self.loc

    def covariance(self):
        return self.cov


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


class MVNPrior(BetaPrior):
    """Multivariate-normal prior on beta.

    ``coord_log_prob`` uses the identity: with P = cov^{-1} and r = beta -
    mu, the quadratic form as a function of r_j = b - mu_j is
        -(1/2) [P_jj r_j^2 + 2 r_j q_j] + const,
    where q_j = (P r)_j - P_jj r_j uses the current beta: one O(d)
    precision-row gather per chain and coordinate.  The precision is
    inverted once in float64 and rounded to the caller's dtype at its first
    use on a device.
    """

    def __init__(self, loc, cov):
        self.mvn = MultivariateNormal(loc, cov)
        self.loc = self.mvn.loc
        self.cov = self.mvn.cov
        self.d = int(self.loc.shape[-1])
        self.precision = torch.linalg.inv(self.cov)
        self._dev = {}  # (dtype, device) -> (precision, loc)

    def _operands(self, like):
        key = (like.dtype, like.device)
        if key not in self._dev:
            self._dev[key] = (self.precision.to(like.device, like.dtype),
                              self.loc.to(like.device, like.dtype))
        return self._dev[key]

    def sample_beta(self, generator, n_chains, *, dtype, device):
        return self.mvn.sample(generator, (n_chains,), dtype=dtype,
                               device=device)

    def log_prob_beta(self, beta):
        return self.mvn.log_prob(beta)

    def coord_log_prob(self, beta, j, b):
        P, mu = self._operands(beta)
        jl = j.long()
        r = beta - mu  # (C, d)
        p_row = P[jl]  # (C, d): each chain's precision row
        p_jj = torch.gather(p_row, 1, jl[:, None])[:, 0]
        r_j = torch.gather(r, 1, jl[:, None])[:, 0]
        q_j = torch.sum(p_row * r, dim=-1) - p_jj * r_j
        lane = (-1,) + (1,) * (b.dim() - 1)  # (C,) -> against b's shape
        rj = b - mu[jl].reshape(lane)
        return (-0.5 * p_jj.reshape(lane) * rj * rj
                - rj * q_j.reshape(lane))

    def mean_beta(self):
        return self.loc

    def cov_beta(self):
        return self.cov


def make_beta_prior(spec, d: int) -> BetaPrior:
    """Normalise a user prior spec into a BetaPrior: a univariate
    :class:`Distribution` (iid over the d coordinates), a list of d
    univariate distributions (:class:`StackedPrior`), a
    :class:`MultivariateNormal` (:class:`MVNPrior`) or a :class:`BetaPrior`
    of dimension d."""
    if isinstance(spec, BetaPrior):
        if spec.d != d:
            raise ValueError(
                f"beta_prior dimension {spec.d} does not match number of "
                f"model parameters {d}"
            )
        return spec
    if isinstance(spec, MultivariateNormal):
        if spec.loc.shape[-1] != d:
            raise ValueError(
                "The multivariate normal `beta_prior` dimension needs to "
                "match the number of parameters in the model (potentially "
                "including intercept)"
            )
        return MVNPrior(spec.loc, spec.cov)
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
