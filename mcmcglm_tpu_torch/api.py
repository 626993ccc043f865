"""The top-level ``mcmcglm`` entry point of the port.

Counterpart of ``mcmcglm_tpu/api.py``: formula + data (or ``X=``/``y=``
arrays) + family + beta_prior + slice tuning, returning an
:class:`~.results.MCMCGLM`.  ``engine`` "auto" and "freerun" route all six
slice kernels to the port's :class:`~.freerun.FreeRunCGGibbs` (the JAX
package's ``engine="auto"`` choice): adaptive burn-in, then frozen-width
sampling, or with ``thin > 1`` thinned collection (``run_thinned``).
``sample_method="normal-normal"`` with ``engine="freerun"`` runs its exact
conjugate pass.  ``engine="fused"`` routes to
:class:`~.fused.FusedCGGibbs` under the JAX package's eligibility rule,
with the fused kernels' n limit in place of the TPU's VMEM budget.

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
from .fused import FusedCGGibbs
from .models.families import check_family
from .models.priors import IIDPrior, Normal, make_beta_prior
from .ops.fused_cggibbs import MAX_FUSED_N
from .results import MCMCGLM

__all__ = ["mcmcglm"]

_KERNELS = ("stepping_out", "quantile", "doubling", "latent", "elliptical",
            "genelliptical")


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
    Ported: every ``slice_fn`` with ``linear_predictor_calc="update"`` on
    the free-running engine (``engine`` "auto" or "freerun"; doubling
    drops ``spec_k``), ``thin > 1`` there (thinned collection, the kept
    draws after the init row and ``burnin`` 0), the "normal-normal"
    method with ``engine="freerun"`` (the exact conjugate pass), and the
    fused engine (``engine="fused"``: stepping-out, an IID prior, n within
    ``MAX_FUSED_N`` = 65,536 as in the reference, ``n_chains`` a multiple
    of 8; ``n_evals`` is the evaluations of each sweep summed over chains,
    broadcast to (n_chains, n_samples)).  The lockstep engine (``engine="xla"``, the
    "naive" mode, "normal-normal" under "auto") and ``mesh`` raise
    NotImplementedError naming their ROADMAP item.
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
    conjugate = sample_method == "normal-normal" and engine == "freerun"
    if sample_method not in ("slice_sampling", "normal-normal"):
        raise ValueError(f"unknown sample_method {sample_method!r}")
    if sample_method == "normal-normal" and not conjugate:
        raise NotImplementedError(
            f"sample_method='normal-normal' with engine={engine!r} runs the "
            "lockstep engine, which is not ported yet: ROADMAP queue 1, "
            "item 9 (engine='freerun' runs the exact conjugate pass)"
        )
    if engine not in ("auto", "freerun", "xla", "fused"):
        raise ValueError("engine must be 'auto', 'freerun', 'xla' or 'fused'")
    if engine == "xla":
        raise NotImplementedError(
            "engine='xla' is not ported yet: ROADMAP queue 1, item 9 (the "
            "lockstep engine)"
        )
    use_fused = engine == "fused"
    # the fused engine's eligibility (stepping-out, 'update') is checked
    # below with the JAX package's error
    if linear_predictor_calc != "update" and not use_fused:
        raise NotImplementedError(
            "linear_predictor_calc='naive' is not ported yet: ROADMAP queue "
            "1, item 9 (the lockstep engine)"
        )
    if mesh is not None:
        if use_fused:
            raise ValueError("engine='fused' is single-chip; mesh unsupported")
        raise NotImplementedError(
            "mesh is not ported yet: ROADMAP queue 1, item 10 (multi-GPU)"
        )
    kernel = qslice_fun if qslice_fun is not None else slice_fn
    if kernel not in _KERNELS:
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

    if use_fused:
        eligible = (
            isinstance(prior, IIDPrior)
            and kernel == "stepping_out"
            and linear_predictor_calc == "update"
            and design.X.shape[0] <= MAX_FUSED_N
            and n_chains % 8 == 0
        )
        if not eligible:
            raise ValueError(
                "engine='fused' requires stepping_out + iid prior + "
                "linear_predictor_calc='update', n within the fused kernels' "
                f"limit (MAX_FUSED_N={MAX_FUSED_N}), and n_chains a multiple "
                "of 8"
            )
        if design.offset is not None:
            raise ValueError(
                "formula offset() terms are not supported by engine='fused'"
            )
        if weights is not None:
            raise ValueError(
                "observation weights are not supported by engine='fused'"
            )
        sampler = FusedCGGibbs(design.X, design.y, fam, prior, extra=extra,
                               tuning=tuning, device=device)
    else:
        engine_opts = dict(engine_opts or {})
        if conjugate:
            engine_opts["coord_sampler"] = "conjugate"
        elif kernel != "stepping_out":
            engine_opts.setdefault("slice_kernel", kernel)
        if engine_opts.get("slice_kernel") == "doubling":
            # the classic one-evaluation pass only: the speculative
            # battery does not compose with the back-test
            engine_opts.pop("spec_k", None)
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

    kernel_name = None if sample_method == "normal-normal" else kernel
    t0 = time.perf_counter()
    if use_fused:
        betas, nev, _ = sampler.sample(seed, n_samples, n_chains=n_chains,
                                       chunk_size=chunk_size,
                                       progress=progress_cb)
        return _result(design, fam, extra, tuning, betas,
                       np.broadcast_to(nev, (n_chains, n_samples)), burnin,
                       sample_method, kernel, call, time.perf_counter() - t0,
                       device)
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
    if thin > 1:
        # thinned collection with the streaming moments on the device;
        # the draws are thinned, so n_evals is the flat per-sweep average
        n_outer = n_keep // thin
        state, _, kept, _ = sampler.run_thinned(state, n_outer, thin)
        betas = np.concatenate([parts[0], kept.cpu().numpy()], axis=1)
        n_run = max(n_outer * thin, 1)
        nev_per = (state.nev.cpu().numpy() - nev_warm) / n_run
        if progress_cb is not None:
            progress_cb(n_samples, n_samples)
        return _result(design, fam, extra, tuning, betas,
                       np.broadcast_to(nev_per[:, None], (n_chains, n_run)),
                       0, sample_method, kernel_name, call,
                       time.perf_counter() - t0, device, sampler, state)
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
    return _result(design, fam, extra, tuning, betas, n_evals, burnin,
                   sample_method, kernel_name, call, time.perf_counter() - t0,
                   device, sampler, state)


def _result(design, fam, extra, tuning, betas, n_evals, burnin,
            sample_method, kernel, call, elapsed, device, sampler=None,
            state=None) -> MCMCGLM:
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
        sampler=sampler,
        state=state,
    )
