"""Hamiltonian Monte Carlo baseline with windowed warmup adaptation.

Counterpart of ``mcmcglm_tpu/baselines/hmc.py``: HMC on the same log
posterior as the CGGibbs engines, C chains at once.  Adaptation is the
JAX package's three windows: dual averaging of the step size toward the
target accept rate (Hoffman & Gelman 2014); a diagonal metric from a
Welford estimate of the posterior variances over the middle window,
regularised toward unit; the step size re-adapted under that metric.
Every chain adapts its own step size and metric.

``logpost`` is batched: it maps (C, d) to (C,) (``make_log_posterior``
builds one); gradients come from ``torch.autograd`` of the summed batch.
The JAX package takes one chain's function and vmaps it.  The jittered
trajectory length L ~ U{1 .. num_leapfrog} is drawn per chain and
iteration; the leapfrog loop runs ``num_leapfrog`` steps and a chain past
its own L freezes (what vmap does to the JAX ``fori_loop`` with a traced
bound), so the loop reads nothing on the host.  A leapfrog step evaluates
the gradient once: the one at the step's start is the previous step's end
(the JAX loop evaluates it again, to the same value).

Random streams (``_streams.Streams``; step = the iteration's index over
the warmup windows and the sampling phase, from 0):

* site 0, slots 0 .. d-1: the momentum's standard normals;
* site 1, slot 0: the trajectory length, L = 1 + floor(u num_leapfrog);
  slot 1: the accept uniform.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..api import entry_device
from ._streams import Streams
from .logdensity import rowwise, value_and_grad

__all__ = ["hmc_sample", "HMCResult"]


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (C, K, d)
    accept_rate: torch.Tensor  # (C,)
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor  # (C, d)


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def _da_init(eps0):
    return _DAState(
        log_eps=torch.log(eps0),
        log_eps_avg=torch.log(eps0),
        h_avg=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
        t=torch.zeros_like(eps0),
    )


def _da_update(state: _DAState, accept_prob, target=0.8):
    t = state.t + 1.0
    gamma, t0, kappa = 0.05, 10.0, 0.75
    h_avg = ((1.0 - 1.0 / (t + t0)) * state.h_avg
             + (target - accept_prob) / (t + t0))
    log_eps = state.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, state.mu, t)


def _leapfrog(logpost_vg, z, r, eps, inv_mass, n_steps: int, L=None,
              start=None):
    """``n_steps`` leapfrog steps of size ``eps`` (C,) from (z, r) (C, d);
    a chain whose own ``L`` (C,) is smaller freezes after L steps.
    ``start`` is (logp, grad) at z, evaluated when None.  Returns (z, r,
    logp, grad) at the end."""
    lp, g = logpost_vg(z) if start is None else start
    e = eps[:, None]
    half, e_im = 0.5 * e, e * inv_mass
    for s in range(int(n_steps)):
        r1 = torch.addcmul(r, half, g)
        z1 = torch.addcmul(z, e_im, r1)
        lp1, g1 = logpost_vg(z1)
        r1 = torch.addcmul(r1, half, g1)
        if L is None:
            z, r, lp, g = z1, r1, lp1, g1
        else:
            act = s < L
            a = act[:, None]
            z, r = torch.where(a, z1, z), torch.where(a, r1, r)
            lp, g = torch.where(act, lp1, lp), torch.where(a, g1, g)
    return z, r, lp, g


@rowwise
def kinetic(inv_mass, r):
    """0.5 r' M^-1 r per chain."""
    return 0.5 * torch.sum(inv_mass * r * r, -1)


def _windows(n_warmup: int):
    w1 = max(n_warmup // 4, 1)
    w2 = max(n_warmup // 2, 1)
    w3 = max(n_warmup - w1 - w2, 1)
    return w1, w2, w3


def adapt_and_sample(kernel, z, lpg, n_warmup: int, n_samples: int,
                     init_step_size: float, target_accept: float):
    """The three warmup windows and the sampling phase shared by HMC and
    NUTS.  ``kernel(z, (logp, grad), eps (C,), inv_mass (C, d))`` runs
    the next iteration and returns (z, (logp, grad), accept_stat (C,),
    info), info a tuple of (C,) tensors averaged over the sampling phase.
    Returns
    (draws (C, K, d), mean accept_stat (C,), eps (C,), inv_mass (C, d),
    mean info)."""
    if n_samples < 1:
        raise ValueError(f"n_samples must be at least 1, got {n_samples}")
    C, d = z.shape
    dtype, dev = z.dtype, z.device
    zeros = torch.zeros((C, d), dtype=dtype, device=dev)

    def window(n, z, lpg, da, inv_mass):
        count = torch.zeros((), dtype=dtype, device=dev)
        mean, m2 = zeros, zeros
        for _ in range(n):
            z, lpg, acc, _ = kernel(z, lpg, torch.exp(da.log_eps), inv_mass)
            da = _da_update(da, acc, target_accept)
            count = count + 1.0
            delta = z - mean
            mean = mean + delta / count
            m2 = m2 + delta * (z - mean)
        return z, lpg, da, (count, mean, m2)

    w1, w2, w3 = _windows(n_warmup)
    eps0 = torch.full((C,), float(init_step_size), dtype=dtype, device=dev)
    inv_mass = torch.ones((C, d), dtype=dtype, device=dev)
    # window 1: step size only
    z, lpg, da, _ = window(w1, z, lpg, _da_init(eps0), inv_mass)
    # window 2: step size and the variances
    z, lpg, da, (cnt, _, m2) = window(
        w2, z, lpg, _da_init(torch.exp(da.log_eps_avg)), inv_mass)
    var = m2 / torch.clamp(cnt - 1.0, min=1.0)
    # regularised diagonal metric (Stan's shrinkage toward unit)
    var = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
    inv_mass = torch.clamp(var, min=1e-8)
    # window 3: the step size again, under the new metric
    z, lpg, da, _ = window(w3, z, lpg, _da_init(torch.exp(da.log_eps_avg)),
                           inv_mass)
    eps = torch.exp(da.log_eps_avg)

    # sums over the draws run per chain, elementwise
    draws, acc_sum, info_sum = [], 0.0, None
    for _ in range(n_samples):
        z, lpg, acc, info = kernel(z, lpg, eps, inv_mass)
        draws.append(z)
        acc_sum = acc_sum + acc
        info = tuple(v.to(dtype) for v in info)
        info_sum = info if info_sum is None else tuple(
            a + b for a, b in zip(info_sum, info))
    return (torch.stack(draws, 1), acc_sum / n_samples, eps, inv_mass,
            tuple(v / n_samples for v in info_sum))


def initial_positions(init_beta, device):
    """(C, d) initial positions on ``device``: a tensor keeps its floating
    dtype; an array or list becomes a tensor of its own (float64 for
    numpy's default)."""
    init = torch.as_tensor(init_beta, device=device)
    if not init.is_floating_point():
        init = init.to(torch.float32)
    return torch.atleast_2d(init).contiguous()


def hmc_sample(
    seed: int,
    logpost: Callable,
    init_beta,
    n_warmup: int = 500,
    n_samples: int = 500,
    num_leapfrog: int = 16,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    jitter_steps: bool = True,
    *,
    device="cuda",
) -> HMCResult:
    """Run C HMC chains from ``init_beta`` (C, d) under the integer
    ``seed``; ``logpost`` maps (C, d) to (C,).  Returns the post-warmup
    samples (C, n_samples, d) on ``device`` (default "cuda", which raises
    without CUDA)."""
    device = entry_device(device, "hmc_sample")
    z0 = initial_positions(init_beta, device)
    C, d = z0.shape
    streams = Streams(seed, C, dtype=z0.dtype, device=device)
    tables = streams.steps(0, sum(_windows(n_warmup)) + int(n_samples),
                           [(0, d), (1, 2)])

    def vg(z):
        return value_and_grad(logpost, z)

    def kernel(z, lpg, eps, inv_mass):
        _, (mom_u, misc_u) = next(tables)
        r0 = streams.normal(mom_u) * torch.rsqrt(inv_mass)
        L = None
        if jitter_steps:
            L = torch.clamp(1 + torch.floor(misc_u[:, 0] * num_leapfrog),
                            max=num_leapfrog).to(torch.int64)
        lp0, _ = lpg
        ke0 = kinetic(inv_mass, r0)
        z1, r1, lp1, g1 = _leapfrog(vg, z, r0, eps, inv_mass, num_leapfrog,
                                    L, lpg)
        ke1 = kinetic(inv_mass, r1)
        log_accept = (lp1 - ke1) - (lp0 - ke0)
        log_accept = torch.where(torch.isnan(log_accept), -torch.inf,
                                 log_accept)
        accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
        accept = torch.log(streams.uniform(misc_u[:, 1])) < log_accept
        a = accept[:, None]
        lpg = (torch.where(accept, lp1, lp0), torch.where(a, g1, lpg[1]))
        return torch.where(a, z1, z), lpg, accept_prob, ()

    draws, acc, eps, inv_mass, _ = adapt_and_sample(
        kernel, z0, vg(z0), n_warmup, n_samples, init_step_size,
        target_accept)
    return HMCResult(draws, acc, eps, inv_mass)
