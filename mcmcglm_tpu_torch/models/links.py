"""Link functions for GLM families, on torch tensors.

Counterpart of ``mcmcglm_tpu/models/links.py``: each link is a
``(link, linkinv, mu_eta)`` triple of plain tensor functions, written in
the same numerically stable forms (logit inverse via sigmoid, probit via
erfc) so that float32 is sufficient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = ["Link", "get_link", "register_link", "LINKS"]


@dataclasses.dataclass(frozen=True)
class Link:
    """A GLM link function g with its inverse g^{-1}.

    Attributes:
      name: canonical R name of the link ("identity", "logit", ...).
      link: g(mu) -> eta.
      linkinv: g^{-1}(eta) -> mu.
      mu_eta: d mu / d eta, the derivative of the inverse link.
    """

    name: str
    link: Callable[[torch.Tensor], torch.Tensor]
    linkinv: Callable[[torch.Tensor], torch.Tensor]
    mu_eta: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, eta: torch.Tensor) -> torch.Tensor:
        return self.linkinv(eta)


def _logit(mu):
    return torch.log(mu) - torch.log1p(-mu)


def _probit_inv(eta):
    # Phi(eta) via erfc for tail stability in f32
    return 0.5 * torch.special.erfc(-eta / math.sqrt(2.0))


def _probit(mu):
    return math.sqrt(2.0) * torch.erfinv(2.0 * mu - 1.0)


def _cloglog_inv(eta):
    # 1 - exp(-exp(eta)), clamped away from {0, 1} at the dtype's epsilon
    eps = torch.finfo(eta.dtype).eps
    return torch.clamp(-torch.expm1(-torch.exp(eta)), eps, 1.0 - eps)


def _cauchit_inv(eta):
    return 0.5 + torch.atan(eta) / math.pi


LINKS: dict[str, Link] = {}


def register_link(link: Link) -> Link:
    """Register a link under its name (users may add custom links)."""
    LINKS[link.name] = link
    return link


def get_link(name_or_link: "str | Link") -> Link:
    if isinstance(name_or_link, Link):
        return name_or_link
    try:
        return LINKS[name_or_link]
    except KeyError:
        raise ValueError(
            f"unknown link {name_or_link!r}; known: {sorted(LINKS)}"
        ) from None


register_link(
    Link("identity", lambda mu: mu, lambda eta: eta, torch.ones_like)
)
register_link(Link("log", torch.log, torch.exp, torch.exp))
register_link(
    Link(
        "logit",
        _logit,
        torch.sigmoid,
        lambda eta: torch.sigmoid(eta) * (1.0 - torch.sigmoid(eta)),
    )
)
register_link(
    Link(
        "probit",
        _probit,
        _probit_inv,
        lambda eta: torch.exp(-0.5 * eta * eta) / math.sqrt(2.0 * math.pi),
    )
)
register_link(
    Link(
        "cloglog",
        lambda mu: torch.log(-torch.log1p(-mu)),
        _cloglog_inv,
        lambda eta: torch.exp(eta - torch.exp(eta)),
    )
)
register_link(
    Link(
        "inverse",
        lambda mu: 1.0 / mu,
        lambda eta: 1.0 / eta,
        lambda eta: -1.0 / (eta * eta),
    )
)
register_link(
    Link(
        "1/mu^2",
        lambda mu: 1.0 / (mu * mu),
        torch.rsqrt,
        lambda eta: -0.5 * eta ** (-1.5),
    )
)
register_link(
    Link("sqrt", torch.sqrt, lambda eta: eta * eta, lambda eta: 2.0 * eta)
)
register_link(
    Link(
        "cauchit",
        lambda mu: torch.tan(math.pi * (mu - 0.5)),
        _cauchit_inv,
        lambda eta: 1.0 / (math.pi * (1.0 + eta * eta)),
    )
)
