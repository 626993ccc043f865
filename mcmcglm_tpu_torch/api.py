"""The top-level ``mcmcglm`` entry point of the port.

Counterpart of ``mcmcglm_tpu/api.py``: formula + data (or ``X=``/``y=``
arrays) + family + beta_prior + slice tuning, returning an
:class:`~.results.MCMCGLM`.  The routes are the JAX package's:

* ``engine`` "auto" and "freerun" send the six qslice kernels with the
  "update" linear predictor to :class:`~.freerun.FreeRunCGGibbs`:
  adaptive burn-in, then frozen-width sampling, or with ``thin > 1``
  thinned collection (``run_thinned``); ``sample_method="normal-normal"``
  with ``engine="freerun"`` runs its exact conjugate pass;
* ``engine="fused"`` routes to :class:`~.fused.FusedCGGibbs` under the JAX
  package's eligibility rule, with the fused kernels' n limit in place of
  the TPU's VMEM budget;
* everything else runs the lockstep :class:`~.engine.CGGibbs`:
  ``engine="xla"``, ``linear_predictor_calc="naive"``, normal-normal under
  "auto" (the validation oracle) and a registered kernel the free-running
  engine does not serve (``qslice_fun``/``slice_fn``); there ``adapt_w``
  adapts the stepping-out widths in burn-in, ``thin > 1`` collects thinned
  draws with streaming moments, and ``chunk_size`` runs in chunks;
* with a ``mesh`` (``parallel.make_mesh``, every rank calling alike) the
  free-running routes go to ``ObsShardedFreeRunCGGibbs`` when the mesh
  has more than one obs shard, else to ``ShardedFreeRunCGGibbs``; the
  lockstep route goes to ``ShardedCGGibbs``; the fused engine is
  single-card.  The result holds every chain on every rank.

``device`` defaults to ``"cuda"`` and raises when CUDA is missing; the CPU
runs only when the caller passes ``device="cpu"``.  ``spec_k`` (through
``engine_opts``) defaults to 4 on CUDA and 1 on the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .engine import CGGibbs, EngineConfig
from .formula import Design, build_design, design_from_arrays
from .freerun import FreeRunCGGibbs
from .fused import FusedCGGibbs
from .models.families import check_family
from .models.priors import IIDPrior, Normal, make_beta_prior
from .ops.fused_cggibbs import MAX_FUSED_N
from .ops.slice_kernels import get_slice_kernel
from .parallel.freerun_obs_sharded import ObsShardedFreeRunCGGibbs
from .parallel.freerun_sharded import ShardedFreeRunCGGibbs
from .parallel.mesh import mesh_shape
from .parallel.sharded_engine import ShardedCGGibbs
from .results import MCMCGLM

__all__ = ["mcmcglm"]

# the kernels the free-running engine serves
_FREERUN_KERNELS = ("stepping_out", "quantile", "doubling", "latent",
                    "elliptical", "genelliptical")


def entry_device(device, what: str) -> torch.device:
    """The device of an entry point whose ``device`` defaults to "cuda":
    raises when CUDA is asked for and missing (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}(device='cuda') needs a CUDA device; pass device='cpu' "
            "to run on the CPU"
        )
    return device


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

    The argument surface is the JAX package's ``mcmcglm`` plus ``device``;
    the routes are the JAX package's (module docstring).  The fused engine
    takes stepping-out, an IID prior, n within ``MAX_FUSED_N`` = 65,536
    and ``n_chains`` a multiple of 8, and its ``n_evals`` is the
    evaluations of each sweep summed over chains, broadcast to (n_chains,
    n_samples).  With ``thin > 1`` the kept draws follow the init row and
    ``burnin`` is 0.  ``adapt_w`` selects the lockstep engine's width
    adaptation; the free-running engine always adapts in burn-in.
    ``mesh`` (a ``parallel.make_mesh`` mesh whose device type is
    ``device``'s) selects the sharded engines (module docstring).
    """
    call = (
        f"mcmcglm(formula={formula!r}, family=..., n_samples={n_samples}, "
        f"burnin={burnin}, n_chains={n_chains}, sample_method={sample_method!r})"
    )
    if burnin >= n_samples:
        raise ValueError("Need more iterations than burnin")
    device = entry_device(device, "mcmcglm")
    if sample_method not in ("slice_sampling", "normal-normal"):
        raise ValueError(f"unknown sample_method {sample_method!r}")
    if engine not in ("auto", "freerun", "xla", "fused"):
        raise ValueError("engine must be 'auto', 'freerun', 'xla' or 'fused'")
    slicing = sample_method == "slice_sampling"
    kernel = get_slice_kernel(qslice_fun if qslice_fun is not None
                              else slice_fn) if slicing else None
    freerun_eligible = (slicing and kernel.name in _FREERUN_KERNELS
                        and linear_predictor_calc == "update")
    # as in the JAX package, normal-normal under "fused" is the lockstep
    # oracle
    use_fused = engine == "fused" and slicing
    if engine == "freerun" and slicing and not freerun_eligible:
        raise ValueError(
            "engine='freerun' requires a registered qslice-style kernel "
            "(stepping_out, doubling, latent, elliptical, genelliptical or "
            "quantile) + linear_predictor_calc='update'"
        )
    conjugate = not slicing and engine == "freerun"
    use_freerun = conjugate or (freerun_eligible and engine in ("auto",
                                                                "freerun"))
    if mesh is not None:
        if use_fused:
            raise ValueError("engine='fused' is single-chip; mesh unsupported")
        if mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type!r} mesh cannot run on "
                             f"device {str(device)!r}")
        if not use_freerun and weights is not None:
            raise ValueError(
                "observation weights with a mesh are only supported by "
                "the freerun engine"
            )

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
            and kernel is not None and kernel.name == "stepping_out"
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
    elif use_freerun:
        engine_opts = dict(engine_opts or {})
        if conjugate:
            engine_opts["coord_sampler"] = "conjugate"
        elif kernel.name != "stepping_out":
            engine_opts.setdefault("slice_kernel", kernel.name)
        if engine_opts.get("slice_kernel") == "doubling":
            # the classic one-evaluation pass only: the speculative
            # battery does not compose with the back-test
            engine_opts.pop("spec_k", None)
        kw = dict(extra=extra, tuning=tuning, obs_weights=weights,
                  dtype=dtype, offset=design.offset, device=device,
                  **engine_opts)
        if mesh is None:
            sampler = FreeRunCGGibbs(design.X, design.y, fam, prior, **kw)
        elif mesh_shape(mesh)[1] > 1:
            # the tall-data path: per-shard partial sums all-reduced over
            # the obs axis each pass
            sampler = ObsShardedFreeRunCGGibbs(design.X, design.y, fam,
                                               prior, mesh=mesh, **kw)
        else:
            # one independent automaton per card, no collectives
            sampler = ShardedFreeRunCGGibbs(design.X, design.y, fam, prior,
                                            mesh=mesh, **kw)
    else:
        config = EngineConfig(
            sample_method=sample_method,
            linear_predictor_calc=linear_predictor_calc,
            slice_kernel=kernel if kernel is not None else "stepping_out",
            dtype=dtype,
        )
        if mesh is None:
            sampler = CGGibbs(design.X, design.y, fam, prior, extra=extra,
                              config=config, tuning=tuning,
                              obs_weights=weights, offset=design.offset,
                              device=device)
        else:
            sampler = ShardedCGGibbs(design.X, design.y, fam, prior,
                                     extra=extra, config=config,
                                     tuning=tuning, mesh=mesh,
                                     offset=design.offset, device=device)

    progress_cb = None
    if progress and chunk_size <= 0:
        chunk_size = max(1, n_samples // 10)
    if progress:

        def progress_cb(done, total):  # noqa: ANN001
            pct = 100.0 * done / total
            print(f"\rSampling from posterior: {done}/{total} ({pct:.0f}%)",
                  end="" if done < total else "\n", flush=True)

    kernel_name = None if kernel is None else kernel.name
    t0 = time.perf_counter()

    def result(betas, n_evals, burnin_out, state=None):
        return _result(design, fam, extra, tuning, betas, n_evals,
                       burnin_out, sample_method, kernel_name, call,
                       time.perf_counter() - t0, device, sampler, state)

    if use_fused:
        betas, nev, _ = sampler.sample(seed, n_samples, n_chains=n_chains,
                                       chunk_size=chunk_size,
                                       progress=progress_cb)
        return result(betas, np.broadcast_to(nev, (n_chains, n_samples)),
                      burnin)
    if not use_freerun:
        return _lockstep(sampler, seed, n_samples, burnin, n_chains,
                         chunk_size, thin, adapt_w and slicing, progress_cb,
                         result)
    # adaptive burn-in (its draws are kept as the burn-in rows), then
    # frozen-width shrink-only sampling
    state = sampler.init(seed, n_chains)
    parts = [_host(sampler, state.beta)[:, None, :]]
    if burnin > 0:
        state, warm_betas, _ = sampler.warmup(state, burnin)
        parts.append(_host(sampler, warm_betas))
    if progress_cb is not None:
        progress_cb(burnin, n_samples)
    # state.nev is cumulative: warmup evaluations are excluded from the
    # reported per-sweep counts
    nev_warm = _host(sampler, state.nev).copy()
    n_keep = n_samples - burnin
    if thin > 1:
        # thinned collection with the streaming moments on the device;
        # the draws are thinned, so n_evals is the flat per-sweep average
        n_outer = n_keep // thin
        state, _, kept, _ = sampler.run_thinned(state, n_outer, thin)
        betas = np.concatenate([parts[0], _host(sampler, kept)], axis=1)
        n_run = max(n_outer * thin, 1)
        nev_per = (_host(sampler, state.nev) - nev_warm) / n_run
        if progress_cb is not None:
            progress_cb(n_samples, n_samples)
        return result(betas,
                      np.broadcast_to(nev_per[:, None], (n_chains, n_run)),
                      0, state)
    step_size = chunk_size if chunk_size > 0 else n_keep
    nev_parts = []
    done = 0
    while done < n_keep:
        step = min(step_size, n_keep - done)
        state, sb, nb = sampler.run(state, step)
        parts.append(_host(sampler, sb))
        nev_parts.append(_host(sampler, nb))
        done += step
        if progress_cb is not None:
            progress_cb(burnin + done, n_samples)
    betas = np.concatenate(parts, axis=1)
    cum = np.concatenate(nev_parts, axis=1)
    n_evals = np.diff(np.concatenate([nev_warm[:, None], cum], axis=1),
                      axis=1)
    return result(betas, n_evals, burnin, state)


def _host(sampler, t):
    """``t`` (chain-leading) as numpy; under a mesh, every chain shard's
    rows (the sharded engines' ``gather``)."""
    gather = getattr(sampler, "gather", None)
    return (t if gather is None else gather(t)).cpu().numpy()


def _lockstep(sampler, seed, n_samples, burnin, n_chains, chunk_size, thin,
              adapt_w, progress_cb, result):
    """The lockstep engine's run modes: thinned collection after a burn-in
    (``thin > 1``), adaptive burn-in then frozen widths (``adapt_w``), or
    one ``sample`` call."""
    if thin > 1 and sampler.kernel is not None:
        state = sampler.init(seed, n_chains)
        init_beta = _host(sampler, state.beta)[:, None, :]
        burn = sampler.warmup if adapt_w else sampler.run
        state, _, _ = burn(state, burnin)
        if progress_cb is not None:
            progress_cb(burnin, n_samples)
        n_outer = (n_samples - burnin) // thin
        state, _, draws, nev = sampler.run_thinned(state, n_outer, thin)
        if progress_cb is not None:
            progress_cb(n_samples, n_samples)
        return result(np.concatenate([init_beta, _host(sampler, draws)], 1),
                      _host(sampler, nev), 0, state)
    if adapt_w:
        state = sampler.init(seed, n_chains)
        parts = [_host(sampler, state.beta)[:, None, :]]
        state, warm, warm_nev = sampler.warmup(state, burnin)
        parts.append(_host(sampler, warm))
        nevs = [_host(sampler, warm_nev)]
        if progress_cb is not None:
            progress_cb(burnin, n_samples)
        n_keep = n_samples - burnin
        step_size = chunk_size if chunk_size > 0 else n_keep
        done = 0
        while done < n_keep:
            step = min(step_size, n_keep - done)
            state, sb, nb = sampler.run(state, step)
            parts.append(_host(sampler, sb))
            nevs.append(_host(sampler, nb))
            done += step
            if progress_cb is not None:
                progress_cb(burnin + done, n_samples)
        return result(np.concatenate(parts, 1), np.concatenate(nevs, 1),
                      burnin, state)
    betas, n_evals, state = sampler.sample(seed, n_samples, n_chains=n_chains,
                                           chunk_size=chunk_size,
                                           progress=progress_cb)
    return result(betas, n_evals, burnin, state)


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
