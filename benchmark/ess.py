"""Bulk effective sample size, frozen for the yardstick.

The estimator of the port's ``diagnostics.ess`` (Vehtari et al. 2021
rank-normalisation; split chains; FFT autocovariance; Geyer's
initial monotone positive sequence) in two forms:

* :func:`ess_numpy`, float64 on the host, one coordinate at a time: the
  plain reference that the check holds the metric's ESS against;
* :func:`ess_torch`, vectorised over coordinates on the draws' device,
  which ``min_ess_per_s`` reads: the window's draws are too many for the
  host within a run.

Ranks use a stable sort in both, so tied draws rank alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["ess_numpy", "ess_torch"]


def _rank_normalize_numpy(x):
    """(C, K) draws -> normal scores of their pooled fractional ranks."""
    from scipy.special import ndtri

    ranks = x.reshape(-1).argsort(kind="stable").argsort(kind="stable")
    return ndtri((ranks.reshape(x.shape) + 0.625) / (x.size + 0.25))


def ess_numpy(draws) -> float:
    """Rank-normalised ESS of one coordinate's draws (C, S)."""
    x = _rank_normalize_numpy(np.asarray(draws, dtype=np.float64))
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, x.shape[1] - half:]], axis=0)
    C, K = x.shape
    if K < 4:
        return float(C * K)
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * K)))
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :K].real / K
    mean_var = (acov[:, 0] * K / (K - 1.0)).mean()
    var_plus = mean_var * (K - 1.0) / K
    if C > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0 or not np.isfinite(var_plus):
        return float(C * K)
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    tau, prev, used = 0.0, np.inf, 0
    for t in range((K - 1) // 2):
        pair = rho[2 * t] + rho[2 * t + 1]
        if pair <= 0:
            break
        pair = min(pair, prev)
        tau += pair
        prev = pair
        used += 1
    tau = -1.0 + 2.0 * tau if used else 1.0
    tau = max(tau, 1.0 / np.log10(C * K + 10.0))
    return float(min(C * K / tau, C * K * np.log10(C * K + 10.0)))


def _ess_block(x: torch.Tensor) -> torch.Tensor:
    """Rank-normalised ESS of each coordinate of x (C, S, b)."""
    C0, S, b = x.shape
    flat = x.reshape(C0 * S, b)
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(0, order, torch.arange(
        C0 * S, device=x.device)[:, None].expand(-1, b).contiguous())
    x = torch.special.ndtri((ranks.to(x.dtype) + 0.625)
                            / (C0 * S + 0.25)).reshape(C0, S, b)
    half = S // 2
    x = torch.cat([x[:, :half], x[:, S - half:]], 0)
    C, K = x.shape[0], x.shape[1]
    if K < 4:
        return torch.full((b,), float(C * K), dtype=x.dtype, device=x.device)
    xc = x - x.mean(1, keepdim=True)
    nfft = 1 << math.ceil(math.log2(2 * K))
    f = torch.fft.rfft(xc, n=nfft, dim=1)
    acov = torch.fft.irfft(f * f.conj(), n=nfft, dim=1)[:, :K] / K
    mean_var = (acov[:, 0] * K / (K - 1.0)).mean(0)  # (b,)
    var_plus = mean_var * (K - 1.0) / K
    if C > 1:
        var_plus = var_plus + x.mean(1).var(0, unbiased=True)
    rho = 1.0 - (mean_var - acov.mean(0)) / var_plus  # (K, b)
    rho[0] = 1.0
    P = (K - 1) // 2
    pairs = rho[0:2 * P:2] + rho[1:2 * P:2]  # (P, b)
    keep = torch.cumprod((pairs > 0).to(x.dtype), 0)
    mono = torch.cummin(pairs, 0).values
    used = keep.sum(0)
    tau = torch.where(used > 0, -1.0 + 2.0 * (mono * keep).sum(0),
                      torch.ones_like(used))
    n = float(C * K)
    tau = torch.clamp(tau, min=1.0 / math.log10(n + 10.0))
    out = torch.clamp(n / tau, max=n * math.log10(n + 10.0))
    bad = (var_plus <= 0) | ~torch.isfinite(var_plus)
    return torch.where(bad, torch.full_like(out, n), out)


def ess_torch(draws: torch.Tensor, dtype=torch.float64,
              block: int = 128) -> torch.Tensor:
    """Rank-normalised ESS of every coordinate of draws (C, S, d), on
    their device, in ``dtype``, ``block`` coordinates at a time; returns
    (d,)."""
    out = []
    for k in range(0, draws.shape[2], block):
        out.append(_ess_block(draws[:, :, k:k + block].to(dtype)))
    return torch.cat(out)
