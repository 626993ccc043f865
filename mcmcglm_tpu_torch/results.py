"""The fit-result container and its methods.

Counterpart of ``mcmcglm_tpu/results.py``: ``samples()``, ``coef()``,
``quantile()``, ``summary()``, ``ess()`` and ``rhat()`` over host numpy
draws.  Row 0 along the draws axis is the init draw, and a row is burn-in
iff ``iteration <= burnin``.  ``predict``, ``waic``, ``loo`` and
``trace_plot`` are not ported yet (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from .diagnostics import ess as _ess
from .diagnostics import split_rhat as _split_rhat

__all__ = ["MCMCGLM"]

_LATER = "is not ported yet: ROADMAP queue 1, item 6 (the user path)"


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

    def predict(self, *args, **kwargs):
        raise NotImplementedError(f"MCMCGLM.predict {_LATER}")

    def waic(self, *args, **kwargs):
        raise NotImplementedError(f"MCMCGLM.waic {_LATER}")

    def loo(self, *args, **kwargs):
        raise NotImplementedError(f"MCMCGLM.loo {_LATER}")

    def trace_plot(self, *args, **kwargs):
        raise NotImplementedError(f"MCMCGLM.trace_plot {_LATER}")

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
            self.coef().to_string(),
        ]
        return "\n".join(lines)
