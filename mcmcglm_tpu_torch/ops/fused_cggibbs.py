"""Fused CGGibbs coordinate updates: plain PyTorch versions and the CUDA
kernels that replace the Pallas ones.

Counterpart of ``mcmcglm_tpu/ops/pallas_cggibbs.py``.  One coordinate
update is the whole stepping-out and shrinkage slice update of beta_j for
every chain (level, interval, step-out, shrinkage, eta commit, evaluation
count); a sweep is that update for j = 0 .. d - 1 in order.

* :func:`plain_fused_coord_update` and :func:`plain_fused_sweep`, the plain
  PyTorch versions.  They evaluate every chain at every step of the
  longest chain's loop and mask the updates, and they return, beside the
  result, each chain's smallest |g - level| over the evaluations that
  decided something (the margin by which a float difference in g could
  flip a decision).  ``uniform_fn`` defaults to the Philox stream of
  ``ops/philox.py``; tests pass a constant to line up with the JAX
  package's interpret mode.
* The launchers :func:`fused_coord_update` and :func:`fused_sweep` of the
  kernels in ``csrc/fused_cggibbs.cu``.  On a CPU tensor a launcher runs
  the plain version; on a CUDA tensor it launches its kernel or raises.
  Each counts its launches in :data:`launch_counts`.

Semantics are the TPU kernels' (see the header of the CUDA source): the
relative potential differences ld per observation inside the sum, the
level is log(u), step-out continues while g > level (strict), shrinkage
accepts at g >= level, a chain that never accepts keeps b0, and the
evaluation count of a block of ``block_chains`` chains is
max nL + max nR + max nShrink over its chains, given to each.  The
JAX package pads n to a lane multiple; the port does not pad.

Both versions evaluate the families' relative log densities (constants
per observation dropped, ``log_density_eta_rel``), which only differences
see.  Against the JAX package's full ``log_density_eta`` this changes g
by rounding only, at most about n * 2^-24 * max_i |ld_i|, far below the
Exp(1) scale of the slice level.
"""

from __future__ import annotations

import math

import torch

from ..models.priors import (
    Exponential,
    Gamma,
    Laplace,
    Normal,
    StudentT,
    Uniform,
)
from .freerun_batteries import (
    _check,
    _outside_table,
    _raise_on,
    kernel_family,
)
from .philox import philox_uniform, split_seed

__all__ = [
    "KERNEL_PRIORS",
    "MAX_FUSED_N",
    "ON_CHIP_N",
    "fused_coord_update",
    "fused_sweep",
    "kernel_prior",
    "launch_counts",
    "plain_fused_coord_update",
    "plain_fused_sweep",
    "reset_launch_counts",
]

# the JAX package's limit (n padded to 128 within 65,536), so the fused
# engine takes exactly the n that the reference takes
MAX_FUSED_N = 65_536
# the largest n whose eta and density-cache rows (8n bytes) fit one block's
# shared memory, 232,448 bytes on sm_90 less the 128 bytes of the block's
# reduction slots.  Above it the launchers pass the kernels a (C, n) cache
# scratch, and they run the same arithmetic on the global rows.
ON_CHIP_N = (232_448 - 128) // 8

# prior class -> (kernel prior id, parameter names).  Ids match the
# PRIOR_* enum in csrc/priors.cuh (the fused and the automaton kernels').
KERNEL_PRIORS = {
    Normal: (0, ("loc", "scale")),
    Gamma: (1, ("concentration", "rate")),
    Exponential: (2, ("rate",)),
    StudentT: (3, ("df", "loc", "scale")),
    Laplace: (4, ("loc", "scale")),
    Uniform: (5, ("low", "high")),
}

launch_counts = {"fused_coord_update": 0, "fused_sweep": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_prior(dist):
    """(kernel prior id, (p0, p1, p2)) for a distribution in
    :data:`KERNEL_PRIORS`, else None."""
    entry = KERNEL_PRIORS.get(type(dist))
    if entry is None:
        return None
    pid, names = entry
    params = [float(getattr(dist, k)) for k in names]
    return pid, tuple(params + [0.0] * (3 - len(params)))


# -- the plain versions --------------------------------------------------------


def _block_max(counts: torch.Tensor, block_chains: int) -> torch.Tensor:
    """Each chain's block maximum of ``counts`` (C,)."""
    C = counts.shape[0]
    blocks = counts.view(C // block_chains, block_chains)
    return blocks.amax(1).repeat_interleave(block_chains)


def plain_fused_coord_update(eta, beta_j, x_j, y, *, ld_fn, lp_fn, j: int,
                             seed: int, sweep: int, w: float,
                             block_chains: int = 8, max_stepouts: int = 128,
                             max_shrink: int = 64, uniform_fn=None):
    """One coordinate's slice update for every chain, in plain PyTorch.

    eta (C, n), beta_j (C,), x_j (n,), y (n,); ``ld_fn(e, y)`` is the
    per-observation log density, ``lp_fn(b)`` the elementwise log prior.
    ``uniform_fn(seed, sweep, j, t, C, device)`` gives the draws ``t``
    ((T,) indices) of every chain as a (T, C) tensor (default
    :func:`~.philox.philox_uniform`); the update asks once for all
    3 + max_shrink draws of the coordinate.

    Returns (eta', beta_j', nev (C,) int32, margin (C,)).
    """
    C = eta.shape[0]
    if C % block_chains:
        raise ValueError(
            f"n_chains={C} must be divisible by block_chains={block_chains}"
        )
    dev = eta.device
    U = (uniform_fn or philox_uniform)(
        seed, sweep, j, torch.arange(3 + max_shrink, device=dev), C, dev,
    ).to(eta.dtype)
    w = torch.tensor(w, dtype=eta.dtype, device=dev)
    b0 = beta_j
    ld0 = ld_fn(eta, y)
    lp0 = lp_fn(b0)
    margin = torch.full((C,), math.inf, dtype=eta.dtype, device=dev)

    def g(b, deciding):
        e = eta + x_j * (b - b0)[:, None]
        f = (ld_fn(e, y) - ld0).sum(1) + (lp_fn(b) - lp0)
        gap = (f - level).abs()  # a NaN gap decides nothing: skipped
        margin.copy_(torch.where(deciding & (gap < margin), gap, margin))
        return f

    level = torch.log(U[0])
    L = b0 - w * U[1]
    R = L + w
    J = torch.floor(U[2] * max_stepouts).to(torch.int32)
    K = (max_stepouts - 1) - J

    def stepout(end, budget, direction):
        active = torch.ones(C, dtype=torch.bool, device=dev)
        count = torch.zeros(C, dtype=torch.int32, device=dev)
        while bool(active.any()):
            f = g(end, active)
            count += active.to(torch.int32)
            active = active & (f > level) & (budget > 0)
            end = torch.where(active, end + direction * w, end)
            budget = torch.where(active, budget - 1, budget)
        return end, count

    L, nL = stepout(L, J, -1.0)
    R, nR = stepout(R, K, 1.0)

    bnew = b0.clone()
    accepted = torch.zeros(C, dtype=torch.bool, device=dev)
    nS = torch.zeros(C, dtype=torch.int32, device=dev)
    for it in range(max_shrink):
        if bool(accepted.all()):
            break
        pending = ~accepted
        x1 = L + (R - L) * U[3 + it]
        f = g(x1, pending)
        nS += pending.to(torch.int32)
        ok = f >= level
        bnew = torch.where(ok & pending, x1, bnew)
        rej = ~ok & pending
        L = torch.where(rej & (x1 < b0), x1, L)
        R = torch.where(rej & (x1 >= b0), x1, R)
        accepted = accepted | ok
    bnew = torch.where(accepted, bnew, b0)

    eta_new = eta + x_j * (bnew - b0)[:, None]
    nev = (_block_max(nL, block_chains) + _block_max(nR, block_chains)
           + _block_max(nS, block_chains))
    return eta_new, bnew, nev, margin


def plain_fused_sweep(eta, beta, Xt, y, *, ld_fn, lp_fn, seed: int,
                      sweep: int, w: float, block_chains: int = 8,
                      max_stepouts: int = 128, max_shrink: int = 64,
                      uniform_fn=None):
    """One Gibbs sweep (coordinates 0 .. d - 1 in order) for every chain:
    a loop of :func:`plain_fused_coord_update`.  beta (C, d), Xt (d, n).

    Returns (eta', beta', nev (C,) int32 summed over j, margin (C,))."""
    beta = beta.clone()
    nev = torch.zeros(beta.shape[0], dtype=torch.int32, device=beta.device)
    margin = torch.full_like(beta[:, 0], math.inf)
    for j in range(beta.shape[1]):
        eta, bj, nev_j, m_j = plain_fused_coord_update(
            eta, beta[:, j], Xt[j], y, ld_fn=ld_fn, lp_fn=lp_fn, j=j,
            seed=seed, sweep=sweep, w=w, block_chains=block_chains,
            max_stepouts=max_stepouts, max_shrink=max_shrink,
            uniform_fn=uniform_fn)
        beta[:, j] = bj
        nev += nev_j
        margin = torch.minimum(margin, m_j)
    return eta, beta, nev, margin


# -- the kernel launchers ------------------------------------------------------


def _plain_fns(family, extra, dist):
    return (lambda e, y: family.log_density_eta_rel(e, y, extra),
            dist.log_prob)


def _prepare(eta, y, family, extra, dist, block_chains):
    """Common CUDA-side checks; returns (lib, C, n, kf, pid, pp), kf the
    :class:`~.freerun_batteries.KernelFamily`."""
    if eta.device.type != "cuda":
        raise ValueError(
            f"the fused kernels run on CUDA tensors (got {eta.device})"
        )
    if eta.dim() != 2:
        raise ValueError("eta must be (C, n)")
    C, n = eta.shape
    if not 1 <= block_chains <= 32 or C % block_chains:
        raise ValueError(
            f"block_chains={block_chains} must be in [1, 32] and divide "
            f"n_chains={C}"
        )
    if n > MAX_FUSED_N:
        raise ValueError(
            f"n={n} exceeds the fused kernels' MAX_FUSED_N={MAX_FUSED_N}"
        )
    kf = kernel_family(family, extra)
    if kf is None:
        raise ValueError(_outside_table(family))
    kp = kernel_prior(dist)
    if kp is None:
        raise ValueError(f"{type(dist).__name__} is not in KERNEL_PRIORS")
    _check("eta", eta, (C, n), torch.float32, eta.device)
    _check("y", y, (n,), torch.float32, eta.device)
    from ._build import load_library

    return load_library(), C, n, kf, kp[0], kp[1]


def _scratch(eta, block_chains, d):
    """The kernels' scratch: the (C, n) density cache where a row does not
    fit shared memory (else None), the zeroed (C / block_chains, d, 3)
    int32 block maxima, and nev (C,)."""
    C, n = eta.shape
    ld0 = torch.empty_like(eta) if n > ON_CHIP_N else None
    cnt = torch.zeros((C // block_chains, d, 3), dtype=torch.int32,
                      device=eta.device)
    nev = torch.empty(C, dtype=torch.int32, device=eta.device)
    return ld0, cnt, nev


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_coord_update(eta, beta_j, x_j, y, family, extra, dist, *, j: int,
                       seed: int, sweep: int, w: float, block_chains: int = 8,
                       max_stepouts: int = 128, max_shrink: int = 64):
    """(eta', beta_j', nev (C,) int32): one coordinate's update for every
    chain (replaces ``make_fused_coord_update``).  eta (C, n), beta_j (C,),
    x_j (n,), y (n,); ``dist`` is the IID prior's distribution."""
    if eta.device.type == "cpu":
        ld_fn, lp_fn = _plain_fns(family, extra, dist)
        return plain_fused_coord_update(
            eta, beta_j, x_j, y, ld_fn=ld_fn, lp_fn=lp_fn, j=j, seed=seed,
            sweep=sweep, w=w, block_chains=block_chains,
            max_stepouts=max_stepouts, max_shrink=max_shrink)[:3]
    lib, C, n, kf, pid, pp = _prepare(eta, y, family, extra, dist,
                                      block_chains)
    _check("beta_j", beta_j, (C,), torch.float32, eta.device)
    _check("x_j", x_j, (n,), torch.float32, eta.device)
    eta_out = eta.clone()
    bj_out = torch.empty_like(beta_j)
    ld0, cnt, nev = _scratch(eta, block_chains, 1)
    key0, key1 = split_seed(seed)
    with torch.cuda.device(eta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_coord_update(
            eta_out.data_ptr(), _ptr(ld0), beta_j.data_ptr(),
            bj_out.data_ptr(), cnt.data_ptr(), nev.data_ptr(),
            x_j.data_ptr(), y.data_ptr(), C, n, block_chains, j, key0, key1,
            sweep, w, max_stepouts, max_shrink, *kf, pid, *pp, stream,
        )
    _raise_on(err, "fused_coord_update")
    launch_counts["fused_coord_update"] += 1
    return eta_out, bj_out, nev


def fused_sweep(eta, beta, Xt, y, family, extra, dist, *, seed: int,
                sweep: int, w: float, block_chains: int = 8,
                max_stepouts: int = 128, max_shrink: int = 64):
    """(eta', beta', nev (C,) int32): one Gibbs sweep for every chain in
    one launch (replaces ``make_fused_sweep``).  beta (C, d), Xt (d, n)."""
    if eta.device.type == "cpu":
        ld_fn, lp_fn = _plain_fns(family, extra, dist)
        return plain_fused_sweep(
            eta, beta, Xt, y, ld_fn=ld_fn, lp_fn=lp_fn, seed=seed,
            sweep=sweep, w=w, block_chains=block_chains,
            max_stepouts=max_stepouts, max_shrink=max_shrink)[:3]
    lib, C, n, kf, pid, pp = _prepare(eta, y, family, extra, dist,
                                      block_chains)
    if beta.dim() != 2 or Xt.dim() != 2:
        raise ValueError("beta must be (C, d) and Xt (d, n)")
    d = beta.shape[1]
    _check("beta", beta, (C, d), torch.float32, eta.device)
    _check("Xt", Xt, (d, n), torch.float32, eta.device)
    eta_out = eta.clone()
    beta_out = beta.clone()
    ld0, cnt, nev = _scratch(eta, block_chains, d)
    key0, key1 = split_seed(seed)
    with torch.cuda.device(eta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_sweep(
            eta_out.data_ptr(), _ptr(ld0), beta_out.data_ptr(),
            cnt.data_ptr(), nev.data_ptr(), Xt.data_ptr(), y.data_ptr(), C,
            n, d, block_chains, key0, key1, sweep, w, max_stepouts,
            max_shrink, *kf, pid, *pp, stream,
        )
    _raise_on(err, "fused_sweep")
    launch_counts["fused_sweep"] += 1
    return eta_out, beta_out, nev
