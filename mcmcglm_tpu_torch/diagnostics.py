"""Convergence diagnostics: ESS, split-R-hat, posterior summaries.

The reference has NO diagnostics beyond posterior means and quantile tables
(R/mcmcglm_methods.R:124-158; no ESS/R-hat anywhere — SURVEY.md §5).  These
are required by the north star (BASELINE.md: pooled R-hat/ESS over
thousands of chains) and follow the standard formulations:

  * split-R-hat and rank-normalised diagnostics follow Vehtari, Gelman,
    Simpson, Carpenter & Bürkner (2021), "Rank-normalization, folding, and
    localization: An improved R-hat".
  * ESS uses per-chain FFT autocovariance combined across chains with
    Geyer's initial monotone positive sequence truncation (Geyer 1992;
    the estimator used by Stan).

Host-side numpy implementations operating on sample arrays of shape
(chains, draws) or (chains, draws, params): a copy of
``mcmcglm_tpu/diagnostics.py``, whose ESS dispatches large inputs to the
port's own copy of the native C++ kernel (``native/hostutils.cpp``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ess", "split_rhat", "summarize", "rank_normalize"]


def rank_normalize(samples):
    """Rank-normalisation (Vehtari et al. 2021): pooled draws -> fractional
    ranks -> normal scores.  Makes ESS/R-hat robust to heavy tails and
    nonlinear scales; apply before ess()/split_rhat() for the 'bulk'
    rank-normalised variants."""
    from scipy.special import ndtri

    samples = np.asarray(samples, dtype=np.float64)
    shp = samples.shape
    if samples.ndim == 2:
        flatshape = (-1,)
        ranks = samples.reshape(-1).argsort().argsort().reshape(shp)
        S = samples.size
        return ndtri((ranks + 0.625) / (S + 0.25))
    out = np.empty_like(samples)
    S = shp[0] * shp[1]
    for p_ in range(shp[2]):
        ranks = samples[:, :, p_].reshape(-1).argsort().argsort().reshape(shp[:2])
        out[:, :, p_] = ndtri((ranks + 0.625) / (S + 0.25))
    return out


def _autocov_fft(x):
    """Per-chain autocovariance via FFT. x: (C, K) -> (C, K)."""
    C, K = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * K)))
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :K].real
    return acov / K


def _split_chains(x):
    """Split each chain in half: (C, K) -> (2C, K//2)."""
    C, K = x.shape
    half = K // 2
    return np.concatenate([x[:, :half], x[:, K - half :]], axis=0)


_NATIVE_THRESHOLD = 2_000_000  # elements; below this numpy wins on startup cost


def ess(samples, use_native: bool = True,
        rank_normalized: bool = False) -> np.ndarray:
    """Bulk effective sample size.

    samples: (chains, draws) or (chains, draws, params).
    Returns a scalar or (params,) array.  ``rank_normalized=True`` computes
    the Vehtari et al. (2021) bulk-ESS on normal scores.

    From ``_NATIVE_THRESHOLD`` elements on this dispatches to the native
    C++ kernel (``mcmcglm_tpu_torch/native/hostutils.cpp``, OpenMP over
    parameters with early lag termination, built with g++ at first use);
    without a compiler it falls back to the numpy FFT version.
    """
    samples = np.asarray(samples, dtype=np.float64)
    if samples.ndim not in (2, 3):
        raise ValueError("samples must be (chains, draws[, params])")
    if rank_normalized:
        samples = rank_normalize(samples)
    if use_native and samples.size >= _NATIVE_THRESHOLD:
        from . import native

        out = native.ess_bulk(samples)
        if out is not None:
            return out if samples.ndim == 3 else float(out[0])
    if samples.ndim == 2:
        return _ess_1d(samples)
    return np.array([_ess_1d(samples[:, :, p]) for p in range(samples.shape[2])])


def _ess_1d(x) -> float:
    x = _split_chains(x)
    C, K = x.shape
    if K < 4:
        return float(C * K)
    acov = _autocov_fft(x)
    chain_var = acov[:, 0] * K / (K - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (K - 1.0) / K
    if C > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0 or not np.isfinite(var_plus):
        return float(C * K)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0

    # Geyer initial positive + monotone sequence on paired sums
    max_pairs = (K - 1) // 2
    tau = 0.0
    prev_pair = np.inf
    used_pairs = 0
    for t in range(max_pairs):
        pair = rho[2 * t] + rho[2 * t + 1]
        if pair <= 0:
            break
        pair = min(pair, prev_pair)  # enforce monotone decrease
        tau += pair
        prev_pair = pair
        used_pairs += 1
    tau = -1.0 + 2.0 * tau if used_pairs else 1.0
    tau = max(tau, 1.0 / np.log10(C * K + 10.0))
    return float(min(C * K / tau, C * K * np.log10(C * K + 10.0)))


def split_rhat(samples, rank_normalized: bool = False) -> np.ndarray:
    """Split-R-hat (potential scale reduction on half-chains).

    samples: (chains, draws) or (chains, draws, params).
    ``rank_normalized=True`` gives the Vehtari et al. (2021) bulk variant."""
    samples = np.asarray(samples, dtype=np.float64)
    if rank_normalized:
        samples = rank_normalize(samples)
    if samples.ndim == 3:
        return np.array(
            [split_rhat(samples[:, :, p]) for p in range(samples.shape[2])]
        )
    x = _split_chains(samples)
    C, K = x.shape
    if K < 2:
        return np.nan
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = K * chain_means.var(ddof=1) if C > 1 else 0.0
    var_plus = (K - 1.0) / K * W + B / K
    if W <= 0:
        return np.float64(1.0)
    return np.sqrt(var_plus / W)


def summarize(samples, columns=None, probs=(0.025, 0.5, 0.975)):
    """Posterior summary per parameter: mean + quantiles.

    samples: (chains, draws, params).  Returns a pandas DataFrame shaped
    like the reference's quantile method output (var × statistic wide
    format, R/mcmcglm_methods.R:124-158) plus ess/rhat columns."""
    import pandas as pd

    samples = np.asarray(samples, dtype=np.float64)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    C, K, d = samples.shape
    flat = samples.reshape(C * K, d)
    if columns is None:
        columns = [f"X{i}" for i in range(1, d + 1)]
    rows = {
        "var": list(columns),
        "mean": flat.mean(axis=0),
    }
    for p in probs:
        rows[f"q_{str(p).replace('0.', '')}"] = np.quantile(flat, p, axis=0)
    rows["ess"] = ess(samples)
    rows["rhat"] = split_rhat(samples)
    return pd.DataFrame(rows)
