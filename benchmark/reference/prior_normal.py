"""Normal(loc, scale) prior on one coefficient, up to a constant: the log
density, its first derivative and its second derivative."""

import torch


def logp(b, loc, scale):
    return -0.5 * ((b - loc) / scale) ** 2


def dlogp(b, loc, scale):
    return -(b - loc) / scale ** 2


def d2logp(b, loc, scale):
    return torch.full_like(b, -1.0 / scale ** 2)
