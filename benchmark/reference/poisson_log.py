"""poisson with the log link: the response law (the mean's exponent
clipped to [-20, 20]), y eta - exp(eta) (log y! dropped), its first
derivative in eta, and its negative second derivative."""

import numpy as np
import torch


def sample(rng, eta):
    return rng.poisson(np.exp(np.clip(eta, -20, 20))).astype(np.float64)


def loglik(y, eta):
    return y * eta - torch.exp(eta)


def dloglik(y, eta):
    return y - torch.exp(eta)


def weight(eta):
    return torch.exp(eta)
