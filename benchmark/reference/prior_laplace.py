"""Laplace(loc, scale) prior on one coefficient, up to a constant: the log
density, its first derivative (the sign's, 0 at the kink) and its second
derivative (0 away from the kink)."""

import torch


def logp(b, loc, scale):
    return -torch.abs(b - loc) / scale


def dlogp(b, loc, scale):
    return -torch.sign(b - loc) / scale


def d2logp(b, loc, scale):
    return torch.zeros_like(b)
