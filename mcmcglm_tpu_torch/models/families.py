"""Exponential-family response distributions, on torch tensors.

Counterpart of ``mcmcglm_tpu/models/families.py``.  A :class:`Family`
bundles a per-observation log density ``log_density(mu, y, extra)`` in
the GLM mean, a :class:`~.links.Link`, optional fused forms in the linear
predictor eta, and optional RELATIVE forms (equal to the absolute ones up
to an eta-independent constant per observation), which are all a slice
sampler needs: it only ever compares log densities across eta.

Softplus is spelled ``torch.logaddexp(eta, 0)``, the same function as
``jax.nn.softplus``; ``torch.nn.functional.softplus`` switches to the
identity above its ``threshold`` and is a different function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import torch

from .links import Link, get_link

__all__ = [
    "Family",
    "register_family",
    "check_family",
    "gaussian",
    "binomial",
    "poisson",
    "negative_binomial",
    "gamma",
    "inverse_gaussian",
    "FAMILIES",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar extra argument as a 0-d tensor of ``like``'s dtype/device
    (a Python number is filled on the device, never copied from the host,
    so a CUDA graph can capture it)."""
    if torch.is_tensor(value):
        return value.to(dtype=like.dtype, device=like.device)
    return torch.full((), value, dtype=like.dtype, device=like.device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), exactly ``jax.nn.softplus`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


@dataclasses.dataclass(frozen=True)
class Family:
    """A GLM response family bound to a link.

    ``extra`` carries nuisance parameters, e.g. ``{"sd": 1.0}`` for
    gaussian, as the JAX package's ``log_likelihood_extra_args`` does.
    """

    name: str
    link: Link
    log_density: Callable
    _eta_paths: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    _eta_rel_paths: Mapping[str, Callable] = dataclasses.field(
        default_factory=dict
    )
    log_density_rel: Optional[Callable] = None
    # the open interval the mean lives in (the whole line for a family
    # that does not say)
    mean_domain: tuple = (-math.inf, math.inf)

    @property
    def linkinv(self):
        return self.link.linkinv

    def log_density_mu(self, mu, y, extra=None):
        return self.log_density(mu, y, dict(extra or {}))

    def log_density_eta(self, eta, y, extra=None):
        """Per-observation log density in the linear predictor: the fused
        path for this link where one is registered, else
        ``log_density(linkinv(eta))``."""
        extra = dict(extra or {})
        fused = self._eta_paths.get(self.link.name)
        if fused is not None:
            return fused(eta, y, extra)
        return self.log_density(self.link.linkinv(eta), y, extra)

    def log_density_eta_rel(self, eta, y, extra=None):
        """Per-observation log density in eta UP TO an eta-independent
        additive constant per observation (exact for slice comparisons).
        Falls back to the absolute form where no relative one exists."""
        extra = dict(extra or {})
        rel = self._eta_rel_paths.get(self.link.name)
        if rel is not None:
            return rel(eta, y, extra)
        if self.log_density_rel is not None:
            return self.log_density_rel(self.link.linkinv(eta), y, extra)
        return self.log_density_eta(eta, y, extra)

    def log_likelihood(self, mu, y, extra=None):
        return torch.sum(self.log_density_mu(mu, y, extra), dim=-1)

    def with_link(self, link) -> "Family":
        return dataclasses.replace(self, link=get_link(link))


FAMILIES: dict[str, Callable[..., Family]] = {}


def register_family(name: str, factory: Callable[..., Family]) -> None:
    FAMILIES[name] = factory


def check_family(family) -> Family:
    """Normalise a family given as string / factory / Family instance."""
    if isinstance(family, str):
        key = family.strip()
        if key not in FAMILIES:
            raise ValueError(
                f"'family' not recognized: {family!r}; known: {sorted(FAMILIES)}"
            )
        return FAMILIES[key]()
    if isinstance(family, Family):
        return family
    if callable(family):
        out = family()
        if not isinstance(out, Family):
            raise ValueError("'family' not recognized")
        return out
    raise ValueError("'family' not recognized")


# -- gaussian ---------------------------------------------------------------

def _gaussian_logpdf(mu, y, extra):
    sd = _const(extra.get("sd", 1.0), mu)
    z = (y - mu) / sd
    return -0.5 * z * z - torch.log(sd) - _const(0.5 * _LOG_2PI, mu)


def _gaussian_rel(mu, y, extra):
    # drop -log(sd) - 0.5*log(2*pi): eta-independent per observation
    sd = _const(extra.get("sd", 1.0), mu)
    z = (y - mu) / sd
    return -0.5 * z * z


def gaussian(link="identity") -> Family:
    return Family(
        name="gaussian",
        link=get_link(link),
        log_density=_gaussian_logpdf,
        _eta_paths={"identity": _gaussian_logpdf},
        _eta_rel_paths={"identity": _gaussian_rel},
        log_density_rel=_gaussian_rel,
    )


# -- binomial (Bernoulli) ---------------------------------------------------

def _bernoulli_logpdf(mu, y, extra):
    fi = torch.finfo(mu.dtype)
    mu = torch.clamp(mu, fi.tiny, 1.0 - fi.eps)
    return y * torch.log(mu) + (1.0 - y) * torch.log1p(-mu)


def _bernoulli_logit_eta(eta, y, extra):
    # log p = y*eta - log(1 + exp(eta)): a single softplus
    return y * eta - softplus(eta)


def _bernoulli_probit_eta(eta, y, extra):
    logcdf = torch.special.log_ndtr
    return torch.where(y > 0.5, logcdf(eta), logcdf(-eta))


def _bernoulli_cloglog_eta(eta, y, extra):
    # log(1-mu) = -exp(eta); log(mu) = log(1 - exp(-exp(eta))), with the
    # series eta - exp(eta)/2 where the direct f32 form loses precision
    ex = torch.exp(eta)
    tiny = torch.finfo(eta.dtype).tiny
    log_mu = torch.where(
        ex > 1e-3,
        torch.log(torch.clamp(1.0 - torch.exp(-ex), min=tiny)),
        eta - 0.5 * ex,
    )
    return torch.where(y > 0.5, log_mu, -ex)


def binomial(link="logit") -> Family:
    return Family(
        name="binomial",
        link=get_link(link),
        log_density=_bernoulli_logpdf,
        _eta_paths={
            "logit": _bernoulli_logit_eta,
            "probit": _bernoulli_probit_eta,
            "cloglog": _bernoulli_cloglog_eta,
        },
        # Bernoulli log densities have no eta-independent terms to drop
        _eta_rel_paths={
            "logit": _bernoulli_logit_eta,
            "cloglog": _bernoulli_cloglog_eta,
        },
        mean_domain=(0.0, 1.0),
    )


# -- poisson ----------------------------------------------------------------

def _poisson_logpdf(mu, y, extra):
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return y * torch.log(mu) - mu - torch.lgamma(y + 1.0)


def _poisson_log_eta(eta, y, extra):
    return y * eta - torch.exp(eta) - torch.lgamma(y + 1.0)


def _poisson_log_eta_rel(eta, y, extra):
    # drop lgamma(y + 1): eta-independent
    return y * eta - torch.exp(eta)


def _poisson_rel(mu, y, extra):
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return y * torch.log(mu) - mu


def poisson(link="log") -> Family:
    return Family(
        name="poisson",
        link=get_link(link),
        log_density=_poisson_logpdf,
        _eta_paths={"log": _poisson_log_eta},
        _eta_rel_paths={"log": _poisson_log_eta_rel},
        log_density_rel=_poisson_rel,
        mean_domain=(0.0, math.inf),
    )


# -- negative binomial ------------------------------------------------------

def _negbin_logpdf(mu, y, extra):
    r = _const(extra.get("size", 1.0), mu)
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return (
        torch.lgamma(y + r)
        - torch.lgamma(r)
        - torch.lgamma(y + 1.0)
        + r * (torch.log(r) - torch.log(r + mu))
        + y * (torch.log(mu) - torch.log(r + mu))
    )


def _negbin_log_eta(eta, y, extra):
    # mu = exp(eta): log(r + mu) = log(r) + softplus(eta - log r)
    r = _const(extra.get("size", 1.0), eta)
    log_r = torch.log(r)
    log_r_plus_mu = log_r + softplus(eta - log_r)
    return (
        torch.lgamma(y + r)
        - torch.lgamma(r)
        - torch.lgamma(y + 1.0)
        + r * (log_r - log_r_plus_mu)
        + y * (eta - log_r_plus_mu)
    )


def _negbin_log_eta_rel(eta, y, extra):
    # drop lgamma(y+r) - lgamma(r) - lgamma(y+1): all eta-independent
    r = _const(extra.get("size", 1.0), eta)
    log_r = torch.log(r)
    log_r_plus_mu = log_r + softplus(eta - log_r)
    return r * (log_r - log_r_plus_mu) + y * (eta - log_r_plus_mu)


def _negbin_rel(mu, y, extra):
    r = _const(extra.get("size", 1.0), mu)
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return r * (torch.log(r) - torch.log(r + mu)) + y * (
        torch.log(mu) - torch.log(r + mu)
    )


def negative_binomial(link="log") -> Family:
    return Family(
        name="negative.binomial",
        link=get_link(link),
        log_density=_negbin_logpdf,
        _eta_paths={"log": _negbin_log_eta},
        _eta_rel_paths={"log": _negbin_log_eta_rel},
        log_density_rel=_negbin_rel,
        mean_domain=(0.0, math.inf),
    )


# -- gamma --------------------------------------------------------------------

def _gamma_logpdf(mu, y, extra):
    # shape k, mean parametrisation
    k = _const(extra.get("shape", 1.0), mu)
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return (
        k * (torch.log(k) - torch.log(mu))
        + (k - 1.0) * torch.log(y)
        - k * y / mu
        - torch.lgamma(k)
    )


def _gamma_log_eta(eta, y, extra):
    k = _const(extra.get("shape", 1.0), eta)
    return (
        k * (torch.log(k) - eta)
        + (k - 1.0) * torch.log(y)
        - k * y * torch.exp(-eta)
        - torch.lgamma(k)
    )


def _gamma_log_eta_rel(eta, y, extra):
    # drop k*log(k) + (k-1)*log(y) - lgamma(k): eta-independent
    k = _const(extra.get("shape", 1.0), eta)
    return -k * eta - k * y * torch.exp(-eta)


def _gamma_rel(mu, y, extra):
    k = _const(extra.get("shape", 1.0), mu)
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return -k * torch.log(mu) - k * y / mu


def gamma(link="inverse") -> Family:
    return Family(
        name="Gamma",
        link=get_link(link),
        log_density=_gamma_logpdf,
        _eta_paths={"log": _gamma_log_eta},
        _eta_rel_paths={"log": _gamma_log_eta_rel},
        log_density_rel=_gamma_rel,
        mean_domain=(0.0, math.inf),
    )


# -- inverse gaussian ---------------------------------------------------------

def _invgauss_phi(extra, like):
    if "shape" in extra and "dispersion" not in extra:
        return 1.0 / _const(extra["shape"], like)
    return _const(extra.get("dispersion", 1.0), like)


def _invgauss_logpdf(mu, y, extra):
    # statmod parametrisation: dispersion phi (default 1), shape = 1/phi
    phi = _invgauss_phi(extra, mu)
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return (
        -0.5 * (torch.log(phi) + _const(_LOG_2PI, mu) + 3.0 * torch.log(y))
        - (y - mu) ** 2 / (2.0 * y * phi * mu * mu)
    )


def _invgauss_rel(mu, y, extra):
    # drop -0.5*(log(phi) + log(2*pi) + 3*log(y)): eta-independent
    phi = _invgauss_phi(extra, mu)
    mu = torch.clamp(mu, min=torch.finfo(mu.dtype).tiny)
    return -((y - mu) ** 2) / (2.0 * y * phi * mu * mu)


def inverse_gaussian(link="1/mu^2") -> Family:
    return Family(
        name="inverse.gaussian",
        link=get_link(link),
        log_density=_invgauss_logpdf,
        log_density_rel=_invgauss_rel,
        mean_domain=(0.0, math.inf),
    )


register_family("Gamma", gamma)
register_family("gamma", gamma)
register_family("gaussian", gaussian)
register_family("binomial", binomial)
register_family("poisson", poisson)
register_family("negative.binomial", negative_binomial)
register_family("negative_binomial", negative_binomial)
register_family("inverse.gaussian", inverse_gaussian)
register_family("inverse_gaussian", inverse_gaussian)
