"""Runtime comparison: the CGGibbs "update" against the "naive" linear
predictor.

Counterpart of ``mcmcglm_tpu/perf.py``: time the lockstep engine with
``linear_predictor_calc="update"`` (O(n) per coordinate) against ``"naive"``
(a full product per slice evaluation, O(nd)) across model widths, the
linear-against-quadratic claim.  Each configuration runs one untimed sweep
first (``compile_time``, here the first sweep's own cost) and then times
``n_samples`` sweeps; on a CUDA device every clock read follows
``torch.cuda.synchronize()``.

The timing core (:func:`eta_comptime_rows`,
:func:`eta_comptime_rows_across_nvars`) returns rows as dicts and needs no
pandas, so it runs where pandas is missing; the DataFrame functions import
pandas lazily and keep the JAX package's columns, plus ``device``,
``evals_per_sweep`` (per chain) and ``flag_reads_per_sweep`` (the slice
loops' host reads).  ``parallelise=True`` fans the widths out over spawned
worker processes pinned to the CPU, as the JAX package pins its workers to
the CPU backend (a CUDA context does not cross a fork, and one card is not
time-shared), and so asks for ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .api import entry_device
from .datagen import normal_arrays

__all__ = [
    "compare_eta_comptime",
    "compare_eta_comptime_across_nvars",
    "eta_comptime_rows",
    "eta_comptime_rows_across_nvars",
    "plot_eta_comptime",
]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eta_comptime_rows(X, y, family="gaussian", beta_prior=None,
                      log_likelihood_extra_args=None, slice_fn="stepping_out",
                      n_samples: int = 500, burnin: int = 100,
                      n_chains: int = 1, seed: int = 0, device="cuda",
                      **tuning) -> list:
    """Time "update" against "naive" on the design ``X`` (n, d) and
    response ``y``: one row (a dict) per linear-predictor calculation.
    ``burnin`` is accepted for the JAX package's signature and, as there,
    unused: the timed sweeps follow the one untimed sweep."""
    from .engine import CGGibbs, EngineConfig
    from .models.families import check_family
    from .models.priors import Normal, make_beta_prior

    del burnin
    dev = entry_device(device, "eta_comptime_rows")
    fam = check_family(family)
    X = np.asarray(X, dtype=np.float64)
    d = X.shape[1]
    prior = make_beta_prior(
        Normal(0.0, 1.0) if beta_prior is None else beta_prior, d)
    extra = dict(log_likelihood_extra_args or {})
    if fam.name == "gaussian" and "sd" not in extra:
        extra["sd"] = 1.0
    rows = []
    for calc in ("update", "naive"):
        eng = CGGibbs(X, y, fam, prior, extra=extra,
                      config=EngineConfig(linear_predictor_calc=calc,
                                          slice_kernel=slice_fn),
                      tuning=tuning, device=dev)
        state = eng.init(seed, n_chains)
        _sync(dev)
        t0 = time.perf_counter()
        state, _, _ = eng.run(state, 1)  # the untimed first sweep
        _sync(dev)
        compile_time = time.perf_counter() - t0
        reads0 = eng.loop_stats["flag_reads"]
        t0 = time.perf_counter()
        state, _, nev = eng.run(state, n_samples)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        reads = eng.loop_stats["flag_reads"] - reads0
        rows.append({
            "time": elapsed,
            "compile_time": compile_time,
            "linear_predictor_calc": calc,
            "n_vars": d,
            "n_obs": X.shape[0],
            "n_samples": n_samples,
            "n_chains": n_chains,
            "beta_mean": float(np.mean(np.asarray(prior.mean_beta()))),
            "beta_variance": float(np.mean(np.diag(np.asarray(
                prior.cov_beta())))),
            "family": fam.name,
            "slice_fn": getattr(eng.kernel, "name", None),
            **{k: float(v) for k, v in tuning.items()},
            **{k: float(v) for k, v in extra.items()},
            "device": str(dev),
            "evals_per_sweep": float(nev.double().mean()),
            "flag_reads_per_sweep": reads / max(n_samples, 1),
        })
    return rows


def compare_eta_comptime(formula: str, data, family="gaussian",
                         beta_prior=None, log_likelihood_extra_args=None,
                         slice_fn="stepping_out", n_samples: int = 500,
                         burnin: int = 100, n_chains: int = 1, seed: int = 0,
                         device="cuda", **tuning):
    """Time "update" against "naive" on one dataset; a two-row DataFrame."""
    import pandas as pd

    from .formula import build_design

    design = build_design(formula, data)
    return pd.DataFrame(eta_comptime_rows(
        design.X, design.y, family=family, beta_prior=beta_prior,
        log_likelihood_extra_args=log_likelihood_extra_args,
        slice_fn=slice_fn, n_samples=n_samples, burnin=burnin,
        n_chains=n_chains, seed=seed, device=device, **tuning))


def _pin_cpu():
    """Worker initializer of the parallel comparison: no CUDA device in
    the worker, one thread per worker."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def _comptime_one_nvars(args) -> list:
    """Module-level worker (picklable for spawned processes): the width-d
    gaussian design, then the update-against-naive rows."""
    d, n, beta_prior, extra, slice_fn, n_samples, burnin, n_chains, seed, \
        tuning, device = args
    X, y = normal_arrays(int(d), n=n, seed=seed + int(d))
    return eta_comptime_rows(
        X, y, family="gaussian", beta_prior=beta_prior,
        log_likelihood_extra_args=extra, slice_fn=slice_fn,
        n_samples=n_samples, burnin=burnin, n_chains=n_chains, seed=seed,
        device=device, **tuning)


def eta_comptime_rows_across_nvars(
    n_vars: Sequence[int],
    n: int = 100,
    beta_prior=None,
    log_likelihood_extra_args=None,
    slice_fn="stepping_out",
    n_samples: int = 500,
    burnin: int = 100,
    n_chains: int = 1,
    seed: int = 0,
    parallelise: bool = False,
    n_cores: Optional[int] = None,
    device="cuda",
    **tuning,
) -> list:
    """The rows of :func:`compare_eta_comptime_across_nvars`, as dicts."""
    if parallelise and str(device) != "cpu":
        raise ValueError("parallelise=True runs the widths in CPU worker "
                         "processes: pass device='cpu' with it")
    dev = entry_device(device, "compare_eta_comptime_across_nvars")
    if slice_fn == "stepping_out" and not tuning:
        tuning = {"w": 0.5}
    jobs = [(int(d), n, beta_prior, log_likelihood_extra_args, slice_fn,
             n_samples, burnin, n_chains, seed, tuning, str(dev))
            for d in n_vars]
    if parallelise:
        import concurrent.futures as cf
        import multiprocessing as mp

        if n_cores is None:
            env = os.environ.get("NUMBER_OF_PROCESSORS")
            n_cores = (int(env) if env else (os.cpu_count() or 2)) - 1
        n_cores = max(1, min(int(n_cores), len(jobs)))
        with cf.ProcessPoolExecutor(max_workers=n_cores,
                                    mp_context=mp.get_context("spawn"),
                                    initializer=_pin_cpu) as pool:
            parts = list(pool.map(_comptime_one_nvars, jobs))
    else:
        parts = [_comptime_one_nvars(j) for j in jobs]
    return [{**row, "parallelised": bool(parallelise)}
            for rows in parts for row in rows]


def compare_eta_comptime_across_nvars(
    n_vars: Sequence[int],
    n: int = 100,
    beta_prior=None,
    log_likelihood_extra_args=None,
    slice_fn="stepping_out",
    n_samples: int = 500,
    burnin: int = 100,
    n_chains: int = 1,
    seed: int = 0,
    parallelise: bool = False,
    n_cores: Optional[int] = None,
    device="cuda",
    **tuning,
):
    """Sweep the update-against-naive comparison over model widths with
    simulated gaussian data (``generate_normal_data``'s arrays); a
    DataFrame with a ``parallelised`` column.  Defaults to w=0.5 for the
    stepping-out kernel with no tuning given.  ``parallelise=True`` runs
    the widths in spawned CPU worker processes (``n_cores`` of them,
    default ``NUMBER_OF_PROCESSORS`` or the CPU count, minus one) and needs
    ``device="cpu"``; call it from an importable ``__main__``."""
    import pandas as pd

    return pd.DataFrame(eta_comptime_rows_across_nvars(
        n_vars, n=n, beta_prior=beta_prior,
        log_likelihood_extra_args=log_likelihood_extra_args,
        slice_fn=slice_fn, n_samples=n_samples, burnin=burnin,
        n_chains=n_chains, seed=seed, parallelise=parallelise,
        n_cores=n_cores, device=device, **tuning))


def plot_eta_comptime(eta_comptime_data, facet_by: Optional[str] = None):
    """Time against dimension, one line per linear-predictor calculation
    (matplotlib, imported lazily)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    df = eta_comptime_data
    facets = [None] if facet_by is None else sorted(df[facet_by].unique())
    fig, axes = plt.subplots(1, len(facets), figsize=(6 * len(facets), 4),
                             squeeze=False)
    for ax, facet in zip(axes[0], facets):
        sub = df if facet is None else df[df[facet_by] == facet]
        for calc, color in (("update", "tab:blue"), ("naive", "tab:orange")):
            part = sub[sub.linear_predictor_calc == calc].sort_values("n_vars")
            ax.plot(part.n_vars, part.time, "o-", color=color, label=calc)
        ax.set_xlabel("Dimension of parameter vector")
        ax.set_ylabel("Computation time (seconds)")
        ax.legend(title="linear_predictor_calc")
        if facet is not None:
            ax.set_title(f"{facet_by}: {facet}")
    fig.tight_layout()
    return fig
