"""binomial with the logit link: the response law (Bernoulli), the log
likelihood of one observation in the relative form the port samples
(constants in eta dropped), its first derivative in eta, and its negative
second derivative."""

import numpy as np
import torch


def sample(rng, eta):
    return rng.binomial(1, 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)


def loglik(y, eta):
    return y * eta - torch.logaddexp(torch.zeros_like(eta), eta)


def dloglik(y, eta):
    return y - torch.sigmoid(eta)


def weight(eta):
    p = torch.sigmoid(eta)
    return p * (1.0 - p)
