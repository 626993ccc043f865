"""The fit-result container and its methods.

Counterpart of ``mcmcglm_tpu/results.py``: ``samples()``, ``coef()``,
``quantile()``, ``summary()``, ``ess()`` and ``rhat()`` over host numpy
draws, ``predict``, the model-criticism tools ``waic`` and ``loo``, and
``trace_plot``.  Row 0 along the draws axis is the init draw, and a row is
burn-in iff ``iteration <= burnin``.

``predict`` and the pointwise log likelihood behind ``waic`` and ``loo``
run on the fit's own ``device``: the (S, n) linear predictor in float64
(as the JAX package forms it with numpy), then the inverse link and the
log densities in float32 (as the JAX package evaluates them without x64),
and the result comes back to the host.  The draw subsample is
``np.random.default_rng(seed).choice``, as in the JAX package, so the same
seed picks the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from .diagnostics import ess as _ess
from .diagnostics import split_rhat as _split_rhat

__all__ = ["MCMCGLM"]


@dataclasses.dataclass
class MCMCGLM:
    """Result of a :func:`mcmcglm_tpu_torch.mcmcglm` fit; ``beta`` holds
    raw samples of shape (chains, n_samples + 1, d)."""

    beta: np.ndarray  # (C, K+1, d)
    columns: list  # d parameter names
    family_name: str
    burnin: int
    sample_method: str
    slice_kernel: Optional[str]
    tuning: Mapping[str, Any]
    n_evals: Optional[np.ndarray] = None  # (C, K) slice evaluations per sweep
    model_matrix: Optional[np.ndarray] = None
    response: Optional[np.ndarray] = None
    formula: Optional[str] = None
    call: Optional[str] = None
    elapsed_seconds: Optional[float] = None
    family: Optional[Any] = None
    extra: Optional[Mapping[str, Any]] = None
    offset: Optional[np.ndarray] = None
    device: Optional[str] = None  # where the chains ran
    # the engine that drew (the free-running and lockstep engines'
    # ``loop_stats`` count their host flag reads) and its last state (its
    # tensors stay on ``device``; None for the fused engine)
    sampler: Optional[Any] = None
    state: Optional[Any] = None

    @property
    def n_chains(self) -> int:
        return self.beta.shape[0]

    @property
    def n_iterations(self) -> int:
        return self.beta.shape[1] - 1

    @property
    def d(self) -> int:
        return self.beta.shape[2]

    def _burnin_mask(self):
        return np.arange(self.beta.shape[1]) <= self.burnin

    def post_burnin(self) -> np.ndarray:
        """Samples after burn-in: (C, K - burnin, d)."""
        return self.beta[:, self.burnin + 1 :, :]

    def samples(self):
        """Long-format DataFrame of all draws: parameter columns plus
        ``iteration``, ``burnin`` and ``chain``."""
        import pandas as pd

        C, K1, _ = self.beta.shape
        burn = self._burnin_mask()
        frames = []
        for c in range(C):
            df = pd.DataFrame(self.beta[c], columns=self.columns)
            df["iteration"] = np.arange(K1)
            df["burnin"] = burn
            df["chain"] = c
            frames.append(df)
        return pd.concat(frames, ignore_index=True)

    def coef(self):
        """Posterior mean over non-burn-in draws pooled across chains."""
        import pandas as pd

        post = self.post_burnin().reshape(-1, self.d)
        return pd.Series(post.mean(axis=0), index=self.columns,
                         name="beta_mean")

    def quantile(self, probs: Sequence[float] = (0.025, 0.5, 0.975)):
        """Per-parameter mean + quantiles over non-burn-in draws."""
        import pandas as pd

        post = self.post_burnin().reshape(-1, self.d)
        out = {"var": list(self.columns), "mean": post.mean(axis=0)}
        for p in probs:
            out[f"q_{str(p).replace('0.', '')}"] = np.quantile(post, p, axis=0)
        return pd.DataFrame(out)

    def summary(self, probs: Sequence[float] = (0.025, 0.5, 0.975)):
        """quantile() plus per-parameter ESS and split-R-hat columns."""
        from .diagnostics import summarize

        return summarize(self.post_burnin(), columns=self.columns,
                         probs=probs)

    def ess(self) -> np.ndarray:
        """Bulk ESS per parameter over non-burn-in draws."""
        return _ess(self.post_burnin())

    def rhat(self) -> np.ndarray:
        """Split-R-hat per parameter over non-burn-in draws."""
        return _split_rhat(self.post_burnin())

    def ess_per_second(self) -> Optional[np.ndarray]:
        if self.elapsed_seconds is None or self.elapsed_seconds <= 0:
            return None
        return self.ess() / self.elapsed_seconds

    # -- posterior prediction ----------------------------------------------

    def _draws(self, n_draws: int, seed: int) -> np.ndarray:
        """Post-burn-in draws pooled over chains, (S, d): all of them, or
        ``n_draws`` > 0 of them picked without replacement by ``seed``."""
        post = self.post_burnin().reshape(-1, self.d)
        if n_draws and n_draws < post.shape[0]:
            idx = np.random.default_rng(seed).choice(post.shape[0], n_draws,
                                                     replace=False)
            post = post[idx]
        return post

    def _eta(self, post, X, offset):
        """The (S, n) linear predictor post @ X^T (+ offset) in float64, on
        the fit's device."""
        import torch

        dev = torch.device(self.device or "cpu")
        X = torch.as_tensor(np.asarray(X, np.float64), device=dev)
        eta = torch.as_tensor(post, dtype=torch.float64, device=dev) @ X.T
        if offset is not None:
            eta = eta + torch.as_tensor(np.asarray(offset, np.float64),
                                        device=dev)[None, :]
        return eta

    def predict(self, X_new=None, kind: str = "mean", n_draws: int = 0,
                seed: int = 0, offset=None):
        """Posterior draws of the GLM mean mu = linkinv(X beta) at new
        design points.

        kind="link" returns draws of eta (float64); "mean" returns
        linkinv(eta), evaluated in float32.  Returns an array of shape
        (n_posterior_draws, n_new) using all post-burn-in draws (or a
        random subsample of ``n_draws`` > 0).  A model fitted with a
        formula ``offset()`` term applies the stored offset when predicting
        on the training matrix; pass ``offset=`` for new design points.
        """
        if X_new is None:
            if self.model_matrix is None:
                raise ValueError("no stored model matrix; pass X_new")
            X_new = self.model_matrix
            if offset is None:
                offset = self.offset
        if kind not in ("mean", "link"):
            raise ValueError("kind must be 'mean' or 'link'")
        eta = self._eta(self._draws(n_draws, seed), X_new, offset)
        if kind == "link":
            return eta.cpu().numpy()
        fam = self.family
        if fam is None:
            from .models.families import check_family

            fam = check_family(self.family_name)  # default link fallback
        import torch

        return fam.linkinv(eta.to(torch.float32)).cpu().numpy()

    # -- model criticism ---------------------------------------------------

    def _pointwise_loglik(self, n_draws: int = 1000, seed: int = 0):
        """(S, n) per-observation log densities over posterior draws."""
        if (self.model_matrix is None or self.response is None
                or self.family is None):
            raise ValueError("fit lacks stored data/family; cannot compute")
        import torch

        eta = self._eta(self._draws(n_draws, seed), self.model_matrix,
                        self.offset).to(torch.float32)
        y = torch.as_tensor(np.asarray(self.response, np.float64),
                            dtype=torch.float32, device=eta.device)
        ld = self.family.log_density_eta(eta, y, dict(self.extra or {}))
        return ld.cpu().numpy().astype(np.float64)

    def waic(self, n_draws: int = 1000, seed: int = 0):
        """Widely Applicable Information Criterion (Watanabe 2010; Gelman
        et al. formulation): elpd_waic = lppd - p_waic with
        p_waic = sum_i Var_s[log p(y_i | theta_s)].

        Returns dict(elpd_waic, p_waic, waic, se)."""
        ld = self._pointwise_loglik(n_draws, seed)  # (S, n)
        m = ld.max(axis=0)
        lppd_i = m + np.log(np.exp(ld - m).mean(axis=0))
        p_i = ld.var(axis=0, ddof=1)
        elpd_i = lppd_i - p_i
        n = ld.shape[1]
        return {
            "elpd_waic": float(elpd_i.sum()),
            "p_waic": float(p_i.sum()),
            "waic": float(-2.0 * elpd_i.sum()),
            "se": float(np.sqrt(n * elpd_i.var(ddof=1))),
        }

    def loo(self, n_draws: int = 1000, seed: int = 0):
        """Importance-sampling leave-one-out expected log predictive
        density with truncated weights (Ionides 2008 truncation at
        S^{3/4} * mean weight; a robust non-Pareto-smoothed PSIS-LOO
        stand-in).  Returns dict(elpd_loo, p_loo, se)."""
        ld = self._pointwise_loglik(n_draws, seed)  # (S, n)
        S = ld.shape[0]
        lw = -ld  # log importance ratios 1/p(y_i | theta_s)
        lw = lw - lw.max(axis=0)
        w = np.exp(lw)
        wbar = w.mean(axis=0)
        w = np.minimum(w, wbar * S ** 0.75)  # truncate extreme weights
        w /= w.sum(axis=0)
        # elpd_loo_i = log( sum_s w_s p(y_i|theta_s) )
        m = ld.max(axis=0)
        elpd_i = m + np.log((w * np.exp(ld - m)).sum(axis=0))
        lppd_i = m + np.log(np.exp(ld - m).mean(axis=0))
        n = ld.shape[1]
        return {
            "elpd_loo": float(elpd_i.sum()),
            "p_loo": float((lppd_i - elpd_i).sum()),
            "se": float(np.sqrt(n * elpd_i.var(ddof=1))),
        }

    # -- plotting ----------------------------------------------------------

    def trace_plot(self, samples_drop: Optional[int] = None, ax=None):
        """Faceted per-parameter trace plot colored by burn-in status (red
        burn-in, blue sampling), one line per chain; ``samples_drop``
        leading rows are left out and default to half the burn-in.  Host
        only: matplotlib is imported here, at the call."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if samples_drop is None:
            samples_drop = int(np.ceil(self.burnin / 2))
        iters = np.arange(self.beta.shape[1])
        keep = iters > samples_drop
        burn = self._burnin_mask()

        d = self.d
        ncols = min(3, d)
        nrows = int(np.ceil(d / ncols))
        fig, axes = plt.subplots(
            nrows, ncols, figsize=(4 * ncols, 2.5 * nrows), squeeze=False
        )
        for p in range(d):
            ax_p = axes[p // ncols][p % ncols]
            for c in range(self.n_chains):
                for is_burn, color in ((True, "tab:red"), (False, "tab:blue")):
                    mask = keep & (burn == is_burn)
                    ax_p.plot(iters[mask], self.beta[c, mask, p], color=color,
                              lw=0.7, alpha=0.8)
            ax_p.set_title(f"Var: {self.columns[p]}", fontsize=9)
            ax_p.set_xlabel("iteration")
        for p in range(d, nrows * ncols):
            axes[p // ncols][p % ncols].set_visible(False)
        fig.tight_layout()
        return fig

    def __repr__(self):
        lines = ["Object of class 'MCMCGLM'", ""]
        if self.call:
            lines += [f"Call:  {self.call}", ""]
        lines += [
            f"family: {self.family_name}  method: {self.sample_method}"
            + (f" ({self.slice_kernel})" if self.slice_kernel else ""),
            f"chains: {self.n_chains}  iterations: {self.n_iterations}  "
            f"burnin: {self.burnin}",
            "",
            "Average of parameter samples:",
        ]
        # the JAX package prints coef() through pandas; the same table in
        # numpy, so a fit prints where pandas is missing (the GPU machine)
        means = self.post_burnin().reshape(-1, self.d).mean(axis=0)
        names = [str(c) for c in self.columns]
        values = [f"{v: .6f}" for v in means]
        wn, wv = max(map(len, names)), max(map(len, values))
        lines += [f"{n:<{wn}}   {v:>{wv}}" for n, v in zip(names, values)]
        return "\n".join(lines)
