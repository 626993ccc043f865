"""The top-level ``mcmcglm`` entry point of the port.

Counterpart of ``mcmcglm_tpu/api.py``: formula + data (or ``X=``/``y=``
arrays) + family + beta_prior + slice tuning, returning an
:class:`~.results.MCMCGLM`.  The port routes every fit to its
:class:`~.freerun.FreeRunCGGibbs` (the JAX package's ``engine="auto"``
choice for these kernels): adaptive burn-in, then frozen-width sampling.

``device`` defaults to ``"cuda"`` and raises when CUDA is missing; the CPU
runs only when the caller passes ``device="cpu"``.  ``spec_k`` (through
``engine_opts``) defaults to 4 on CUDA and 1 on the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .formula import Design, build_design, design_from_arrays
from .freerun import FreeRunCGGibbs
from .models.families import check_family
from .models.priors import Normal, make_beta_prior
from .results import MCMCGLM

__all__ = ["mcmcglm"]

_PORTED_KERNELS = ("stepping_out", "quantile")
_LATER_KERNELS = ("doubling", "latent", "elliptical", "genelliptical")


def mcmcglm(
    formula: Optional[str] = None,
    family="gaussian",
    data=None,
    beta_prior=None,
    log_likelihood_extra_args: Optional[Mapping[str, Any]] = None,
    linear_predictor_calc: str = "update",
    sample_method: str = "slice_sampling",
    slice_fn="stepping_out",
    *,
    n_samples: int = 500,
    burnin: int = 100,
    n_chains: int = 1,
    seed: int = 0,
    X=None,
    y=None,
    columns: Optional[Sequence[str]] = None,
    add_intercept: bool = False,
    dtype=torch.float32,
    chunk_size: int = 0,
    progress: bool = False,
    qslice_fun=None,
    engine: str = "auto",
    adapt_w: bool = False,
    weights=None,
    thin: int = 1,
    mesh=None,
    engine_opts: Optional[Mapping[str, Any]] = None,
    device="cuda",
    **tuning,
) -> MCMCGLM:
    """Draw MCMC samples from a GLM posterior with the CGGibbs sampler.

    The argument surface is the JAX package's ``mcmcglm`` plus ``device``.
    Ported: ``slice_fn`` "stepping_out" and "quantile" with
    ``linear_predictor_calc="update"`` on the free-running engine
    (``engine`` "auto" or "freerun").  The other kernels, the
    "normal-normal" method, the lockstep and fused engines, ``thin > 1``
    and ``mesh`` raise NotImplementedError naming their ROADMAP item.
    ``adapt_w`` is accepted for signature parity: the free-running engine
    always adapts its widths during burn-in.
    """
    call = (
        f"mcmcglm(formula={formula!r}, family=..., n_samples={n_samples}, "
        f"burnin={burnin}, n_chains={n_chains}, sample_method={sample_method!r})"
    )
    if burnin >= n_samples:
        raise ValueError("Need more iterations than burnin")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mcmcglm(device='cuda') needs a CUDA device; pass device='cpu' "
            "to run on the CPU"
        )
    if sample_method != "slice_sampling":
        raise NotImplementedError(
            f"sample_method={sample_method!r} is not ported yet: ROADMAP "
            "queue 1, items 7 and 9 (conjugate pass, lockstep engine)"
        )
    if linear_predictor_calc != "update":
        raise NotImplementedError(
            "linear_predictor_calc='naive' is not ported yet: ROADMAP queue "
            "1, item 9 (the lockstep engine)"
        )
    if engine in ("xla", "fused"):
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: ROADMAP queue 1, items 9 "
            "and 12"
        )
    if engine not in ("auto", "freerun"):
        raise ValueError("engine must be 'auto', 'freerun', 'xla' or 'fused'")
    if mesh is not None:
        raise NotImplementedError(
            "mesh is not ported yet: ROADMAP queue 1, item 10 (multi-GPU)"
        )
    if thin > 1:
        raise NotImplementedError(
            "thin > 1 is not ported yet: ROADMAP queue 1, item 8 "
            "(on-device collection)"
        )
    kernel = qslice_fun if qslice_fun is not None else slice_fn
    if kernel in _LATER_KERNELS:
        raise NotImplementedError(
            f"slice_fn={kernel!r} is not ported yet: ROADMAP queue 1, item 7"
        )
    if kernel not in _PORTED_KERNELS:
        raise ValueError(f"unknown slice kernel {kernel!r}")

    fam = check_family(family)
    if formula is not None:
        if data is None:
            raise ValueError("`data` is required when a formula is given")
        design: Design = build_design(formula, data)
    elif X is not None and y is not None:
        design = design_from_arrays(X, y, columns=columns,
                                    add_intercept=add_intercept)
    else:
        raise ValueError("provide either (formula, data) or (X=, y=)")

    d = design.X.shape[1]
    prior = make_beta_prior(
        Normal(0.0, 1.0) if beta_prior is None else beta_prior, d
    )
    extra = dict(log_likelihood_extra_args or {})
    if fam.name == "gaussian" and "sd" not in extra:
        extra["sd"] = 1.0  # reference default: list(sd = 1)

    engine_opts = dict(engine_opts or {})
    if kernel == "quantile":
        engine_opts.setdefault("slice_kernel", "quantile")
    sampler = FreeRunCGGibbs(
        design.X, design.y, fam, prior, extra=extra, tuning=tuning,
        obs_weights=weights, dtype=dtype, offset=design.offset,
        device=device, **engine_opts,
    )

    progress_cb = None
    if progress and chunk_size <= 0:
        chunk_size = max(1, n_samples // 10)
    if progress:

        def progress_cb(done, total):  # noqa: ANN001
            pct = 100.0 * done / total
            print(f"\rSampling from posterior: {done}/{total} ({pct:.0f}%)",
                  end="" if done < total else "\n", flush=True)

    t0 = time.perf_counter()
    # adaptive burn-in (its draws are kept as the burn-in rows), then
    # frozen-width shrink-only sampling
    state = sampler.init(seed, n_chains)
    parts = [state.beta.cpu().numpy()[:, None, :]]
    if burnin > 0:
        state, warm_betas, _ = sampler.warmup(state, burnin)
        parts.append(warm_betas.cpu().numpy())
    if progress_cb is not None:
        progress_cb(burnin, n_samples)
    # state.nev is cumulative: warmup evaluations are excluded from the
    # reported per-sweep counts
    nev_warm = state.nev.cpu().numpy().copy()
    n_keep = n_samples - burnin
    step_size = chunk_size if chunk_size > 0 else n_keep
    nev_parts = []
    done = 0
    while done < n_keep:
        step = min(step_size, n_keep - done)
        state, sb, nb = sampler.run(state, step)
        parts.append(sb.cpu().numpy())
        nev_parts.append(nb.cpu().numpy())
        done += step
        if progress_cb is not None:
            progress_cb(burnin + done, n_samples)
    betas = np.concatenate(parts, axis=1)
    cum = np.concatenate(nev_parts, axis=1)
    n_evals = np.diff(np.concatenate([nev_warm[:, None], cum], axis=1),
                      axis=1)
    elapsed = time.perf_counter() - t0

    return MCMCGLM(
        beta=betas,
        columns=list(design.columns),
        family_name=fam.name,
        burnin=burnin,
        sample_method=sample_method,
        slice_kernel=kernel,
        tuning=dict(tuning),
        n_evals=n_evals,
        model_matrix=design.X,
        response=design.y,
        formula=design.formula,
        call=call,
        elapsed_seconds=elapsed,
        family=fam,
        extra=extra,
        offset=design.offset,
        device=str(device),
    )
