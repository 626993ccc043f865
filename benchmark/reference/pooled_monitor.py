"""The plain reference of the pooled monitor (the program's
``parallel/pooled.py``): from every chain's draws (C, K, d), in float64
PyTorch, the pooled mean and variance, the non-split R-hat, and the
split-chain bulk ESS at a fixed lag window; :func:`gaps` holds the
program's merged summaries against them.  It imports nothing of the
program.

* :func:`summary` is ``pooled_summary``'s definition on the draws: W the
  mean of the chains' variances (divisor K - 1), B = K times the variance
  of the chain means (divisor C - 1), var+ = (K - 1) / K W + B / K,
  R-hat = sqrt(var+ / W), the pooled variance var+ plus the chain means'
  spread over C.
* :func:`ess` is ``ess_from_state``'s estimator on the draws: each chain
  split into its first and last K // 2 draws (the middle draw of an odd K
  left out), each half's autocovariance at lags 0 .. L - 1 about its own
  mean over K // 2, L = max(2, min(max_lag, K // 2)); Stan's cross-chain
  combination over the 2C halves; Geyer's initial monotone sequence over
  the first L // 2 pairs of autocorrelations; tau at least
  1 / log10(2C (K // 2) + 10); the ESS capped at 2C (K // 2)
  log10(2C (K // 2) + 10).

Departures from the program, by design: it reads the draws, where the
program streams per-chain moments (Chan's merge of each block) and raw
lagged sums whose centring it recovers from the sums of the first and
last draws of each half; it centres the draws directly, in float64; it
does not clamp W or var+ away from zero (the program divides by at least
1e-30).  ``benchmark/ess.py`` is not reused: its estimator rank-normalises
the draws and reads every lag by FFT, where the monitor's reads raw draws
up to a window of L lags; only the combination is common, and it is
written out here as a loop over the pairs, as ``ess.ess_numpy`` writes it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ess", "gaps", "summary"]


def summary(draws: torch.Tensor) -> dict:
    """Pooled mean, variance and non-split R-hat per coordinate, (d,) each,
    of draws (C, K, d)."""
    x = draws.double()
    C, K, _ = x.shape
    means = x.mean(1)
    W = x.var(1, correction=1).mean(0)
    grand = means.mean(0)
    spread = ((means - grand) ** 2).sum(0)
    B = K * spread / (C - 1) if C > 1 else torch.zeros_like(W)
    var_plus = (K - 1) / K * W + B / K
    return {"mean": grand, "var": var_plus + spread / C,
            "rhat": torch.sqrt(var_plus / W)}


def ess(draws: torch.Tensor, max_lag: int = 64, cap: bool = True):
    """Split-chain bulk ESS per coordinate (d,) of draws (C, K, d) at the
    lag window ``max_lag`` (clamped as the program's ``init_ess`` does)."""
    x = draws.double()
    C, K, d = x.shape
    H = K // 2
    L = max(2, min(int(max_lag), H))
    halves = torch.cat([x[:, :H], x[:, K - H:]], 0)  # (2C, H, d)
    means = halves.mean(1)
    xc = halves - means[:, None, :]
    acov = torch.zeros((2 * C, L, d), dtype=torch.float64, device=x.device)
    for lag in range(min(L, H)):
        acov[:, lag] = (xc[:, lag:] * xc[:, :H - lag]).sum(1) / H
    mean_var = (acov[:, 0] * H / max(H - 1, 1)).mean(0)
    var_plus = mean_var * max(H - 1, 1) / max(H, 1) + means.var(0)
    rho = (1.0 - (mean_var - acov.mean(0)) / var_plus).cpu()  # (L, d)
    rho[0] = 1.0
    var_plus = var_plus.cpu()
    n = 2 * C * H
    out = torch.empty(d, dtype=torch.float64)
    for j in range(d):
        tau, prev, used = 0.0, math.inf, 0
        for p in range(L // 2):
            pair = float(rho[2 * p, j] + rho[2 * p + 1, j])
            if pair <= 0:
                break
            pair = min(pair, prev)
            tau += pair
            prev = pair
            used += 1
        tau = -1.0 + 2.0 * tau if used else 1.0
        tau = max(tau, 1.0 / math.log10(n + 10.0))
        e = n / tau
        if cap:
            e = min(e, n * math.log10(n + 10.0))
        out[j] = e if float(var_plus[j]) > 0 else n
    return out.to(x.device)


def gaps(got: dict, ref: dict) -> dict:
    """The largest gaps of a program's summaries ``got`` (tensors or
    arrays) against the reference's ``ref``: the mean's in the reference's
    posterior sds, the variance's relative, R-hat's absolute, and the
    ESS's relative where ``got`` holds one."""
    g = {k: torch.as_tensor(v).double().cpu() for k, v in got.items()}
    r = {k: torch.as_tensor(v).double().cpu() for k, v in ref.items()}
    out = {"mean": float(((g["mean"] - r["mean"]).abs()
                          / r["var"].sqrt()).max()),
           "var": float(((g["var"] - r["var"]).abs() / r["var"]).max()),
           "rhat": float((g["rhat"] - r["rhat"]).abs().max())}
    if "ess" in g:
        out["ess"] = float(((g["ess"] - r["ess"]).abs() / r["ess"]).max())
    return out
