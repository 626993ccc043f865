"""Tuning-parameter sweep: ``mcmcglm`` across the values of one tuning
parameter.

Counterpart of ``mcmcglm_tpu/sweep.py``.  ``parallelise=True`` runs the
sweep as ONE batched fit on the lockstep engine: each value gets
``n_chains`` chains of a single run, the swept value riding the chain axis
through ``chain_tuning`` (a (V * n_chains,) tensor the slice kernels read
per lane), so the device works on every value at once.  Options that path
cannot honour fall back to the sequential per-value fits with a warning.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from .api import entry_device, mcmcglm
from .results import MCMCGLM

__all__ = [
    "mcmcglm_across_tuningparams",
    "plot_mcmcglm_across_tuningparams",
]

# mcmcglm options the batched sweep cannot honour, with their defaults
_SEQUENTIAL_ONLY = {
    "engine": "auto", "adapt_w": False, "weights": None, "thin": 1,
    "progress": False, "qslice_fun": None, "mesh": None,
    "sample_method": "slice_sampling", "linear_predictor_calc": "update",
    "engine_opts": None, "chunk_size": 0,
}


class SweepResult(list):
    """A list of MCMCGLM fits tagged with the swept parameter's name."""

    tuning_parameter_name: str = "w"


def mcmcglm_across_tuningparams(
    values: Sequence[float],
    tuning_parameter_name: str = "w",
    *,
    parallelise: bool = False,
    device="cuda",
    **mcmcglm_kwargs,
):
    """Run :func:`mcmcglm` for each value of one tuning parameter; every
    other argument passes through.  Returns a list of fits whose
    ``tuning`` holds the swept value, tagged with
    ``tuning_parameter_name``.  ``parallelise=True`` folds the sweep into
    the chain axis of one lockstep run (module docstring); the options in
    ``_SEQUENTIAL_ONLY`` make it fall back to the sequential path with a
    warning.  ``device`` defaults to "cuda" and raises without CUDA."""
    device = entry_device(device, "mcmcglm_across_tuningparams")
    values = list(values)
    if parallelise:
        bad = sorted(k for k, default in _SEQUENTIAL_ONLY.items()
                     if k in mcmcglm_kwargs and mcmcglm_kwargs[k] != default)
        if bad:
            warnings.warn(
                "parallelise=True (the batched sweep) does not support "
                f"{bad}; falling back to the sequential per-value sweep.",
                stacklevel=2,
            )
            parallelise = False
    if parallelise:
        fits = _batched_sweep(values, tuning_parameter_name, device,
                              **mcmcglm_kwargs)
    else:
        fits = [mcmcglm(**{**mcmcglm_kwargs, tuning_parameter_name: v},
                        device=device) for v in values]
    for fit, v in zip(fits, values):
        fit.tuning = {**fit.tuning, tuning_parameter_name: v}
    out = SweepResult(fits)
    out.tuning_parameter_name = tuning_parameter_name
    return out


def _batched_sweep(values, name, device, **kwargs):
    """One lockstep run of V * n_chains chains, the tuning value of chain
    block i being values[i].  The seed keys one Philox stream whose
    counter carries the chain index, so every (value, chain) pair draws
    independently."""
    from .engine import CGGibbs, EngineConfig
    from .formula import build_design, design_from_arrays
    from .models.families import check_family
    from .models.priors import Normal, make_beta_prior
    from .ops.slice_kernels import get_slice_kernel

    n_samples = kwargs.get("n_samples", 500)
    burnin = kwargs.get("burnin", 100)
    n_chains = kwargs.get("n_chains", 1)
    fam = check_family(kwargs.get("family", "gaussian"))
    formula = kwargs.get("formula")
    if formula is not None:
        design = build_design(formula, kwargs["data"])
    else:
        design = design_from_arrays(
            kwargs["X"], kwargs["y"], columns=kwargs.get("columns"),
            add_intercept=kwargs.get("add_intercept", False),
        )
    prior_spec = kwargs.get("beta_prior")
    prior = make_beta_prior(
        Normal(0.0, 1.0) if prior_spec is None else prior_spec,
        design.X.shape[1])
    extra = dict(kwargs.get("log_likelihood_extra_args") or {})
    if fam.name == "gaussian" and "sd" not in extra:
        extra["sd"] = 1.0
    kernel = get_slice_kernel(kwargs.get("slice_fn", "stepping_out"))
    fixed = {k: v for k, v in kwargs.items()
             if k in kernel.required and k != name}
    tuned = np.repeat(np.asarray(values, dtype=np.float64), n_chains)
    eng = CGGibbs(
        design.X, design.y, fam, prior, extra=extra,
        config=EngineConfig(slice_kernel=kernel,
                            dtype=kwargs.get("dtype", torch.float32)),
        tuning=fixed, chain_tuning_names=(name,), offset=design.offset,
        device=device,
    )
    betas, n_evals, _ = eng.sample(kwargs.get("seed", 0), n_samples,
                                   n_chains=len(values) * n_chains,
                                   chain_tuning={name: tuned})
    fits = []
    for i, v in enumerate(values):
        sl = slice(i * n_chains, (i + 1) * n_chains)
        fits.append(MCMCGLM(
            beta=betas[sl], columns=list(design.columns),
            family_name=fam.name, burnin=burnin,
            sample_method="slice_sampling", slice_kernel=kernel.name,
            tuning={**fixed, name: v}, n_evals=n_evals[sl],
            model_matrix=design.X, response=design.y,
            formula=design.formula, family=fam, extra=extra,
            offset=design.offset, device=str(device), sampler=eng,
        ))
    return fits


def plot_mcmcglm_across_tuningparams(fits, ncols: Optional[int] = None):
    """A grid of trace plots titled by tuning value (matplotlib, imported
    lazily)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    name = getattr(fits, "tuning_parameter_name", "w")
    V = len(fits)
    ncols = ncols or min(2, V)
    nrows = int(np.ceil(V / ncols))
    d = fits[0].d
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 2.2 * nrows),
                             squeeze=False)
    for i, fit in enumerate(fits):
        ax = axes[i // ncols][i % ncols]
        iters = np.arange(fit.beta.shape[1])
        for p in range(d):
            for c in range(fit.n_chains):
                ax.plot(iters, fit.beta[c, :, p], lw=0.6, alpha=0.8)
        ax.set_title(f"{name} = {fit.tuning.get(name)}", fontsize=10)
        ax.set_xlabel("iteration")
    for i in range(V, nrows * ncols):
        axes[i // ncols][i % ncols].set_visible(False)
    fig.tight_layout()
    return fig
