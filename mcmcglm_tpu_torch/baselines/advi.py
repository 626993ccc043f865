"""Mean-field ADVI baseline: variational inference on the same log posterior.

Counterpart of ``mcmcglm_tpu/baselines/advi.py``: q(beta) = N(m,
diag(exp(log_s)^2)) maximises the ELBO with the reparameterisation trick,
``mc_samples`` draws per step, and ``torch.optim.Adam`` in place of
``optax.adam``: the same update (b1 = 0.9, b2 = 0.999, eps = 1e-8 added
outside the square root, bias-corrected), in ``torch.optim``'s own
order of operations.  ``logpost`` is batched, (S, d) -> (S,).

Random streams (``_streams.Streams``, the "chain" being the Monte Carlo
draw s = 0 .. mc_samples - 1; step = the optimiser step, from 0): site 0,
slots 0 .. d-1, the standard normals of draw s.  ``ADVIResult.sample(seed,
n)`` reads site 0 of step 0 under its own seed, draw i as "chain" i.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..api import entry_device
from ._streams import Streams
from .hmc import initial_positions

__all__ = ["advi_fit", "ADVIResult"]


class ADVIResult(NamedTuple):
    mean: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) posterior sd of q
    elbo_trace: torch.Tensor  # (n_steps,)

    def sample(self, seed: int, n: int):
        """(n, d) draws from q under the integer ``seed``."""
        streams = Streams(seed, n, dtype=self.mean.dtype,
                          device=self.mean.device)
        (u,) = streams.uniforms64([0], [(0, self.mean.shape[-1])])
        return self.mean + streams.normal(u[0]) * self.scale


def _neg_elbo(logpost, m, log_s, eps):
    """-ELBO at (m, log_s) with the (S, d) standard normals ``eps``: the
    Monte Carlo mean of logpost plus the gaussian entropy (up to a
    constant)."""
    z = m + eps * torch.exp(log_s)
    energy = torch.mean(logpost(z))
    entropy = torch.sum(log_s)
    return -(energy + entropy)


def _fit(logpost, init_mean, eps_steps, learning_rate: float) -> ADVIResult:
    """Adam on the -ELBO, one step per (S, d) normals of ``eps_steps``."""
    m = init_mean.detach().clone().requires_grad_(True)
    log_s = torch.full_like(m, -1.0).requires_grad_(True)
    opt = torch.optim.Adam([m, log_s], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, fused=True)
    elbo = []
    with torch.enable_grad():
        for eps in eps_steps:
            opt.zero_grad(set_to_none=True)
            loss = _neg_elbo(logpost, m, log_s, eps)
            loss.backward()
            opt.step()
            elbo.append(-loss.detach())
    return ADVIResult(m.detach(), torch.exp(log_s.detach()),
                      torch.stack(elbo))


def advi_fit(
    seed: int,
    logpost: Callable,
    init_mean,
    n_steps: int = 2000,
    mc_samples: int = 8,
    learning_rate: float = 0.02,
    *,
    device="cuda",
) -> ADVIResult:
    """Fit a mean-field gaussian to exp(logpost) from ``init_mean`` (d,)
    under the integer ``seed``, on ``device`` (default "cuda", which
    raises without CUDA)."""
    device = entry_device(device, "advi_fit")
    init = initial_positions(init_mean, device)[0]
    streams = Streams(seed, mc_samples, dtype=init.dtype, device=device)
    eps_steps = (streams.normal(u[0]) for _, u in
                 streams.steps(0, int(n_steps), [(0, init.shape[-1])]))
    return _fit(logpost, init, eps_steps, learning_rate)
