"""Free-running CGGibbs: lockstep-free slice-within-Gibbs, in PyTorch.

Counterpart of ``mcmcglm_tpu/freerun.py`` for ``slice_kernel`` in
{"stepping_out", "quantile"}.  Each chain runs the standard sequential
CGGibbs algorithm as an explicit automaton that advances by one target
evaluation (or one K-proposal speculative battery) per device pass; chains
are free-running, so within one pass chain A can be shrinking coordinate
17 while chain B steps out coordinate 901.  The pass itself lives in
``ops/freerun_passes.py``; the K-proposal batteries, and the CUDA kernels
that evaluate them, in ``ops/freerun_batteries.py``.

PyTorch runs eagerly: a run is a Python loop of passes that reads the
termination flag from the device once per pass.  The engine never picks a
device: ``device=`` is a required argument, and every tensor it makes
lives there.  Random numbers come from a ``torch.Generator`` on that
device, carried in the state's ``key`` field; it gives other numbers than
the JAX package's threefry keys, so the two engines agree in law, not
draw for draw (a test hands both the same uniforms to compare one pass).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from .models.families import Family, check_family
from .models.priors import BetaPrior
from .ops.freerun_batteries import configure_battery, masked_sum
from .utils.linalg import matvec

__all__ = ["FreeRunCGGibbs", "FreeRunState", "QuantileState"]

# slice kernels of the JAX engine that the port does not run yet
_NOT_PORTED = ("latent", "elliptical", "genelliptical", "doubling")


class FreeRunState(NamedTuple):
    # problem state, batched over chains
    beta: torch.Tensor  # (C, d)
    eta: torch.Tensor  # (C, n)
    # log-density cache at the committed eta: (C,) reduced log likelihood
    # for eval_cache="scalar", (C, n) per-observation for "per_obs"
    ld0: torch.Tensor
    key: torch.Generator  # each pass draws one (C, width) uniform block
    logw: torch.Tensor  # (C, d) per-coordinate log slice widths
    # automaton registers, all (C,)
    j: torch.Tensor  # current coordinate, int32
    phase: torch.Tensor  # 0 = stepping out, 1 = shrinking
    stepdir: torch.Tensor  # 0 = testing left endpoint, 1 = right
    level: torch.Tensor  # relative slice level (= -Exp(1))
    L: torch.Tensor
    R: torch.Tensor
    budL: torch.Tensor  # remaining left step budget, int32
    budR: torch.Tensor
    b0: torch.Tensor  # current beta[:, j]
    lp0: torch.Tensor  # prior coord log prob at b0
    w: torch.Tensor  # slice width (quantile: the pivot u0 = F(b0))
    xprop: torch.Tensor  # proposal to evaluate next pass
    n_shrink: torch.Tensor  # shrink evals this coordinate, int32
    nev: torch.Tensor  # (C,) total target evaluations, int32


class QuantileState(NamedTuple):
    """FreeRunState plus the adapted quantile pseudo-target's
    per-(chain, coordinate) location buffer (``pseudo_adapt=True``; the log
    pseudo-scale rides in ``logw``)."""

    beta: torch.Tensor
    eta: torch.Tensor
    ld0: torch.Tensor
    key: torch.Generator
    logw: torch.Tensor  # (C, d) log pseudo-target scales
    j: torch.Tensor
    phase: torch.Tensor
    stepdir: torch.Tensor
    level: torch.Tensor
    L: torch.Tensor
    R: torch.Tensor
    budL: torch.Tensor
    budR: torch.Tensor
    b0: torch.Tensor
    lp0: torch.Tensor
    w: torch.Tensor
    xprop: torch.Tensor
    n_shrink: torch.Tensor
    nev: torch.Tensor
    qloc: torch.Tensor  # (C, d) pseudo-target locations


def _tensor(v, dtype, device) -> torch.Tensor:
    """``v`` (array-like or tensor) as a ``dtype`` tensor on ``device``."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available"
        )
    return device


class FreeRunCGGibbs:
    """Lockstep-free CGGibbs sampler (stepping_out and quantile kernels).

    Same problem signature as the JAX package's ``FreeRunCGGibbs``, plus
    the required keyword ``device``.  ``spec_k`` defaults to 4 on CUDA and
    1 on the CPU.  ``battery_impl`` is "auto", "torch", "cuda", "cuda2" or
    "cuda3" (see ``ops/freerun_batteries.configure_battery``).
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior: BetaPrior,
        extra: Optional[Mapping] = None,
        tuning: Optional[Mapping] = None,
        reduce_fn=None,
        obs_weights=None,
        max_stepouts: int = 128,
        max_shrink: int = 64,
        shrink_only: bool = True,
        adapt_c: Optional[float] = None,
        dtype=torch.float32,
        eval_cache: str = "auto",
        offset=None,
        spec_k: Optional[int] = None,
        battery_impl: str = "auto",
        x_storage: str = "f32",
        coord_sampler: str = "slice",
        slice_kernel: str = "stepping_out",
        *,
        device,
    ):
        if slice_kernel in _NOT_PORTED:
            raise NotImplementedError(
                f"slice_kernel={slice_kernel!r} is not ported yet: ROADMAP "
                "queue 1, item 7 (remaining automaton kernels)"
            )
        if slice_kernel not in ("stepping_out", "quantile"):
            raise ValueError(
                "freerun slice_kernel must be one of 'stepping_out', "
                "'doubling', 'latent', 'elliptical', 'genelliptical' or "
                f"'quantile' (got {slice_kernel!r})"
            )
        if coord_sampler == "conjugate":
            raise NotImplementedError(
                "coord_sampler='conjugate' is not ported yet: ROADMAP "
                "queue 1, item 7 (the conjugate pass)"
            )
        if coord_sampler != "slice":
            raise ValueError(
                f"coord_sampler must be 'slice' or 'conjugate', got "
                f"{coord_sampler!r}"
            )
        if x_storage not in ("f32", "bf16"):
            raise ValueError(
                f"x_storage must be 'f32' or 'bf16', got {x_storage!r}"
            )
        self.x_storage = x_storage
        self.device = _resolve_device(device)
        self.slice_kernel = slice_kernel
        self.coord_sampler = coord_sampler
        # uniforms consumed per coordinate begin (level, interval position,
        # stepout split; quantile uses the first two of the same block)
        self._n_begin_u = 3
        self.family: Family = check_family(family)
        # the engine only ever COMPARES log densities across eta, so it
        # evaluates the relative form (eta-independent constants dropped)
        self._ld_eta = self.family.log_density_eta_rel
        self.prior = prior
        self.dtype = dtype
        dev = self.device
        X = _tensor(X, dtype, "cpu")
        if x_storage == "bf16":
            # the design is rounded to bfloat16 ONCE, up front, and every
            # path (the init product, the plain battery's row gathers, the
            # cuda3 kernel's bf16 row stream) computes on the same rounded
            # values: the engine samples the posterior of X' = bf16(X)
            # exactly, and no chain freezes a residual (X - X') beta0
            X = X.to(torch.bfloat16).to(dtype)
        self.n, self.d = X.shape
        if offset is not None:
            offset = _tensor(offset, dtype, dev).reshape(-1)
            if offset.shape[0] != self.n:
                raise ValueError(
                    f"offset length {offset.shape[0]} != n observations {self.n}"
                )
        self.offset = offset
        if prior.d != self.d:
            raise ValueError(
                f"prior dimension {prior.d} != number of model parameters {self.d}"
            )
        self.Xt = X.T.contiguous().to(dev)  # (d, n)
        self.y = _tensor(y, dtype, dev).reshape(-1)
        # extras live on the device for the tensor code, and as host
        # floats for the kernel wrappers (no device read per pass)
        self.extra = {k: _tensor(v, dtype, dev)
                      for k, v in dict(extra or {}).items()}
        self._extra_host = {k: float(v) for k, v in self.extra.items()
                            if v.dim() == 0}
        tuning = dict(tuning or {})
        if "w" not in tuning and slice_kernel == "stepping_out":
            raise ValueError(
                "A tuning parameter for the slice kernel is missing: ['w'] "
                f"required by {slice_kernel!r}"
            )
        self.w0 = float(tuning.get("w", 1.0))
        # quantile pseudo-target (the lockstep slice_quantile defaults)
        self.q_loc = float(tuning.get("pseudo_loc", 0.0))
        self.q_scale = float(tuning.get("pseudo_scale", 1.0))
        self.q_family = str(tuning.get("pseudo_family", "cauchy"))
        if slice_kernel == "quantile" and self.q_family not in (
            "normal", "cauchy"
        ):
            raise ValueError(
                "pseudo_family must be 'normal' or 'cauchy', got "
                f"{self.q_family!r}"
            )
        # pseudo_adapt: per-(chain, coordinate) pseudo-target loc/scale,
        # tuned in warmup by Robbins-Monro and frozen for sampling (any
        # fixed pseudo-target is an exact kernel)
        self.q_adapt = bool(tuning.get("pseudo_adapt", False))
        self.q_c = float(tuning.get("pseudo_c", 5.0))
        if self.q_adapt and slice_kernel != "quantile":
            raise ValueError(
                "pseudo_adapt=True is a quantile-kernel tuning parameter; "
                f"drop it for slice_kernel={slice_kernel!r}"
            )
        user_reduce_fn = reduce_fn is not None
        if obs_weights is not None:
            mask = _tensor(obs_weights, dtype, dev).reshape(-1)
            if mask.shape[0] != self.n:
                raise ValueError(
                    f"obs_weights length {mask.shape[0]} != n observations {self.n}"
                )
        else:
            mask = torch.ones(self.n, dtype=dtype, device=dev)
        # the reduction weights double as the mask; zero-weight terms drop
        # out by selection, as in the battery kernels
        self._mask = mask
        self.reduce_fn = reduce_fn or (lambda t: masked_sum(t, mask))
        self.max_stepouts = int(max_stepouts)
        self.max_shrink = int(max_shrink)
        # sampling runs use the m=1 shrink-only kernel by default; warmup
        # always uses the full stepping-out schedule
        self.shrink_only = bool(shrink_only)
        self._adapt_rate = 0.08
        self.adapt_c = float(adapt_c if adapt_c is not None else 40.0)
        # eval_cache "auto": the scalar cache when its f32 roundoff
        # estimate (from the log density at eta = 0) is far below the
        # Exp(1) slice level, else the exact per-observation cache
        if eval_cache not in ("auto", "scalar", "per_obs"):
            raise ValueError(
                f"eval_cache must be 'auto', 'scalar' or 'per_obs', got {eval_cache!r}"
            )
        if eval_cache == "auto":
            ld_at0 = self._ld_eta(
                torch.zeros(self.n, dtype=dtype, device=dev), self.y,
                self.extra,
            ).cpu().numpy()
            eps = float(torch.finfo(dtype).eps)
            err = (eps * float(np.sqrt(np.log2(max(self.n, 4))))
                   * float(np.sum(np.abs(ld_at0))))
            eval_cache = "scalar" if err < 0.01 else "per_obs"
        self.eval_cache = eval_cache
        if spec_k is None:
            spec_k = 4 if self.device.type == "cuda" else 1
        self.spec_k = int(spec_k)
        if not 1 <= self.spec_k <= 32:
            raise ValueError(f"spec_k must be in [1, 32], got {spec_k}")
        self.state_cls = QuantileState if self.q_adapt else FreeRunState
        configure_battery(self, battery_impl, user_reduce_fn=user_reduce_fn)
        # the rows the cuda3 kernel streams: bfloat16 under x_storage="bf16"
        # (half the row bytes; the values are already rounded, so the
        # kernel's upcast reproduces the float32 rows exactly)
        bf16_rows = x_storage == "bf16" and self.battery_impl == "cuda3"
        self._Xt_rows = self.Xt.to(torch.bfloat16) if bf16_rows else self.Xt

    def _coord_lp(self, beta, j, b):
        return self.prior.coord_log_prob(beta, j, b).to(self.dtype)

    # -- quantile pseudo-target maps ------------------------------------

    def quantile_ppf(self, u, loc=None, scale=None):
        """Pseudo-target quantile function with the eps-clip that keeps
        endpoint proposals finite; ``loc``/``scale`` (per-lane tensors)
        override the global pseudo-target (``pseudo_adapt``)."""
        loc = self.q_loc if loc is None else loc
        scale = self.q_scale if scale is None else scale
        u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
        if self.q_family == "normal":
            return loc + scale * torch.special.ndtri(u)
        return loc + scale * torch.tan(math.pi * (u - 0.5))

    def quantile_cdf(self, x, loc=None, scale=None):
        loc = self.q_loc if loc is None else loc
        scale = self.q_scale if scale is None else scale
        if self.q_family == "normal":
            return torch.special.ndtr((x - loc) / scale)
        return 0.5 + torch.atan((x - loc) / scale) / math.pi

    def quantile_logpdf(self, x, loc=None, scale=None):
        if loc is None and scale is None and self.q_family == "normal":
            z = (x - self.q_loc) / self.q_scale
            return -0.5 * z * z - float(
                np.log(self.q_scale) + 0.5 * np.log(2.0 * np.pi)
            )
        loc = self.q_loc if loc is None else loc
        scale = self.q_scale if scale is None else scale
        z = (x - loc) / scale
        if self.q_family == "normal":
            return (-0.5 * z * z - torch.log(torch.as_tensor(scale))
                    - float(0.5 * np.log(2.0 * np.pi)))
        return -torch.log(math.pi * scale * (1.0 + z * z))

    # -- coordinate initialisation (batched) -----------------------------

    def _begin_coord(self, beta, logw, j, shrink_only, ubatch, qloc=None):
        """Level + initial interval for each lane's coordinate j, from the
        (C, 3) uniform block ``ubatch``; returns a dict of fresh automaton
        registers.

        ``shrink_only=True`` is Neal's procedure with a step-out budget of
        m = 1 (the width-w interval is used directly and the lane starts
        shrinking); ``False`` is the full stepping-out schedule; a (C,)
        bool tensor selects per lane (two-phase warmup)."""
        if self.slice_kernel == "quantile":
            return self._begin_coord_quantile(beta, logw, j, ubatch, qloc)
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])  # -Exp(1), exact for u in [0, 1)
        u = ubatch[:, 1]
        uj = ubatch[:, 2]
        jl = j.long()[:, None]
        w = torch.exp(torch.gather(logw, 1, jl)[:, 0])
        b0 = torch.gather(beta, 1, jl)[:, 0]
        L = b0 - w * u
        R = L + w
        lp0 = self._coord_lp(beta, j, b0)
        zero = torch.zeros(C, dtype=torch.int32, device=beta.device)
        J_full = torch.floor(uj * self.max_stepouts).to(torch.int32)
        if isinstance(shrink_only, bool) and shrink_only:
            J, K = zero, zero
            phase = torch.ones_like(zero)
            xprop = L + (R - L) * uj  # first shrink proposal
        elif isinstance(shrink_only, bool):
            J = J_full
            K = (self.max_stepouts - 1) - J_full
            phase = zero
            xprop = L
        else:  # per-lane (C,) bool: select between the two register sets
            so = shrink_only
            J = torch.where(so, 0, J_full)
            K = torch.where(so, 0, (self.max_stepouts - 1) - J_full)
            phase = so.to(torch.int32)
            xprop = torch.where(so, L + (R - L) * uj, L)
        return dict(level=level, L=L, R=R, budL=J, budR=K, b0=b0, lp0=lp0,
                    w=w, xprop=xprop, phase=phase, stepdir=zero,
                    n_shrink=zero)

    def _begin_coord_quantile(self, beta, logw, j, ubatch, qloc=None):
        """Quantile-slice coordinate begin (Heiner, Johnson & Waller 2024):
        shrinkage on the unit interval (0, 1) with the pivot u0 = F(b0)
        carried in the ``w`` register; with ``pseudo_adapt`` F is the
        (chain, coordinate)'s own adapted pseudo-target."""
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])  # -Exp(1), on the h scale
        jl = j.long()[:, None]
        b0 = torch.gather(beta, 1, jl)[:, 0]
        if self.q_adapt:
            loc = torch.gather(qloc, 1, jl)[:, 0]
            scale = torch.exp(torch.gather(logw, 1, jl)[:, 0])
            u0 = self.quantile_cdf(b0, loc, scale)
        else:
            u0 = self.quantile_cdf(b0)
        u0 = torch.clamp(u0.to(self.dtype), 1e-7, 1.0 - 1e-7)
        lp0 = self._coord_lp(beta, j, b0)
        zero = torch.zeros(C, dtype=torch.int32, device=beta.device)
        return dict(
            level=level, L=torch.zeros_like(b0), R=torch.ones_like(b0),
            budL=zero, budR=zero, b0=b0, lp0=lp0, w=u0, xprop=ubatch[:, 1],
            phase=torch.ones_like(zero), stepdir=zero, n_shrink=zero,
        )

    def _generator(self, seed) -> torch.Generator:
        if isinstance(seed, torch.Generator):
            if seed.device.type != self.device.type:
                raise ValueError(
                    f"generator on {seed.device}, engine on {self.device}"
                )
            return seed
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init(self, seed, n_chains: int, beta0=None):
        """Initial state for ``n_chains`` chains.  ``seed`` is an int or a
        ``torch.Generator`` on the engine's device, which the state then
        carries.  ``beta0`` ((d,) or (C, d)) overrides the prior draw."""
        g = self._generator(seed)
        C = int(n_chains)
        dev, dtype = self.device, self.dtype
        beta = self.prior.sample_beta(g, C, dtype=dtype, device=dev)
        if beta0 is not None:
            beta0 = _tensor(beta0, dtype, dev)
            beta = beta0.expand(C, self.d).contiguous()
        eta = matvec(beta, self.Xt)
        if self.offset is not None:
            eta = eta + self.offset[None, :]
        ld0 = self._ld_eta(eta, self.y, self.extra)
        if self.eval_cache == "scalar":
            ld0 = self.reduce_fn(ld0)
        w_init = self.q_scale if self.q_adapt else self.w0
        logw = torch.full((C, self.d), float(np.log(np.float32(w_init))),
                          dtype=dtype, device=dev)
        qloc = (torch.full((C, self.d), self.q_loc, dtype=dtype, device=dev)
                if self.q_adapt else None)
        j0 = torch.zeros(C, dtype=torch.int32, device=dev)
        ub = torch.rand((C, self._n_begin_u), generator=g, dtype=dtype,
                        device=dev)
        reg = self._begin_coord(beta, logw, j0, False, ub, qloc=qloc)
        if qloc is not None:
            reg["qloc"] = qloc
        return self.state_cls(
            beta=beta, eta=eta, ld0=ld0, key=g, logw=logw, j=j0,
            nev=torch.zeros(C, dtype=torch.int32, device=dev), **reg,
        )

    @staticmethod
    def _commit_row(arr, j, val, gate=None):
        """A copy of ``arr`` with arr[c, j_c] = val_c (for lanes where
        ``gate``)."""
        rows = torch.arange(arr.shape[0], device=arr.device)
        jl = j.long()
        if gate is not None:
            val = torch.where(gate, val, arr[rows, jl])
        out = arr.clone()
        out[rows, jl] = val
        return out

    @staticmethod
    def _sweep_buffers(draws, nevbuf, sweep_count, beta, nev_new,
                       sweep_done):
        """Record completed sweeps into the draws/nevbuf buffers, in place.

        Lane c writes its slot ``sweep_count[c]`` when ``sweep_done[c]``
        and the slot exists (the JAX package's drop-mode scatter).  The
        write is masked, never gated by a host-side test, so the pass
        stays free of device reads.  ``draws=None`` records nothing."""
        if draws is None:
            return draws, nevbuf
        C, S = draws.shape[0], draws.shape[1]
        rows = torch.arange(C, device=draws.device)
        slot = torch.clamp(sweep_count, max=S - 1).long()
        write = sweep_done & (sweep_count < S)
        draws[rows, slot] = torch.where(write[:, None], beta,
                                        draws[rows, slot])
        nevbuf[rows, slot] = torch.where(write, nev_new, nevbuf[rows, slot])
        return draws, nevbuf

    def _step_fn(self):
        """The per-pass function for this engine's configuration."""
        from .ops.freerun_passes import run_pass, run_pass_spec

        fn = run_pass_spec if self.spec_k > 1 else run_pass
        return lambda *args: fn(self, *args)

    # -- runs ---------------------------------------------------------------

    def _run_pass_block(self, state, sweep_count, *, n_sweeps: int,
                        n_passes: Optional[int], adapt: bool, shrink_only,
                        stepout_sweeps=None, draws=None, nevbuf=None):
        """Advance by at most ``n_passes`` passes (no bound when None)
        toward a quota of ``n_sweeps`` completed sweeps per chain; stops
        as soon as every chain has met its quota, so a run split into
        blocks consumes exactly the uniforms of one unsplit run."""
        step = self._step_fn()
        p = 0
        while (n_passes is None or p < n_passes) and bool(
            (sweep_count < n_sweeps).any()
        ):
            state, sweep_count, draws, nevbuf = step(
                state, sweep_count, draws, nevbuf, n_sweeps, adapt,
                shrink_only, stepout_sweeps,
            )
            p += 1
        return state, sweep_count, draws, nevbuf

    def _buffers(self, C, n_sweeps):
        return (
            torch.zeros((C, n_sweeps, self.d), dtype=self.dtype,
                        device=self.device),
            torch.zeros((C, n_sweeps), dtype=torch.int32, device=self.device),
        )

    def _run(self, state, n_sweeps: int, adapt: bool, shrink_only,
             stepout_sweeps=None):
        C = state.beta.shape[0]
        draws, nevbuf = self._buffers(C, n_sweeps)
        sc = torch.zeros(C, dtype=torch.int32, device=self.device)
        state, _, draws, nevbuf = self._run_pass_block(
            state, sc, n_sweeps=n_sweeps, n_passes=None, adapt=adapt,
            shrink_only=shrink_only, stepout_sweeps=stepout_sweeps,
            draws=draws, nevbuf=nevbuf,
        )
        return state, draws, nevbuf

    def run_passes(self, state, sweep_count, draws, nevbuf, n_sweeps: int,
                   n_passes: int):
        """Pass-bounded sampling collection: advances at most ``n_passes``
        passes toward ``n_sweeps`` completed sweeps per chain, recording
        draws into the carried ``draws`` (C, n_sweeps, d) buffer (``None``
        allocates).  Call until ``(sweep_count >= n_sweeps).all()``;
        bitwise the same as one :meth:`run`."""
        C = int(state.beta.shape[0])
        if sweep_count is None:
            sweep_count = torch.zeros(C, dtype=torch.int32, device=self.device)
        if draws is None or nevbuf is None:
            d_new, nb_new = self._buffers(C, n_sweeps)
            draws = d_new if draws is None else draws
            nevbuf = nb_new if nevbuf is None else nevbuf
        return self._run_pass_block(
            state, sweep_count, n_sweeps=n_sweeps, n_passes=n_passes,
            adapt=False, shrink_only=self.shrink_only, draws=draws,
            nevbuf=nevbuf,
        )

    def _auto_stepout(self, n_sweeps: int) -> int:
        """Default stepping-out quota of the two-phase warmup."""
        return min(n_sweeps, max(3, min(10, n_sweeps // 5)))

    def warmup_passes(self, state, sweep_count, n_sweeps: int,
                      n_passes: int, stepout_sweeps: Optional[int] = None):
        """Adaptive warmup by at most ``n_passes`` passes toward
        ``n_sweeps`` warmup sweeps per chain; returns (state, sweep_count)
        and is bitwise the same as one :meth:`warmup` call."""
        if stepout_sweeps is None:
            stepout_sweeps = self._auto_stepout(n_sweeps)
        state, sweep_count, _, _ = self._run_pass_block(
            state, sweep_count, n_sweeps=n_sweeps, n_passes=n_passes,
            adapt=True, shrink_only=False,
            stepout_sweeps=int(stepout_sweeps),
        )
        return state, sweep_count

    def run(self, state, n_sweeps: int):
        """Advance every chain by ``n_sweeps`` completed Gibbs sweeps.

        Returns (state, draws (C, n_sweeps, d), nev_at_sweep (C, n_sweeps))
        where nev_at_sweep[c, s] is chain c's cumulative evaluation count
        at the completion of its s-th sweep."""
        return self._run(state, n_sweeps, adapt=False,
                         shrink_only=self.shrink_only)

    def run_thinned(self, *args, **kwargs):
        raise NotImplementedError(
            "run_thinned is not ported yet: ROADMAP queue 1, item 8 "
            "(on-device collection)"
        )

    def warmup(self, state, n_sweeps: int,
               stepout_sweeps: Optional[int] = None):
        """Adaptive warmup: per-(chain, coordinate) widths (or quantile
        pseudo-targets) pulled toward the accepted moves, frozen after.
        The first ``stepout_sweeps`` sweeps (default :meth:`_auto_stepout`)
        run the full stepping-out kernel, the rest the shrink-only one."""
        if stepout_sweeps is None:
            stepout_sweeps = self._auto_stepout(n_sweeps)
        return self._run(state, n_sweeps, adapt=True, shrink_only=False,
                         stepout_sweeps=int(stepout_sweeps))

    def sample(self, seed, n_samples: int, n_chains: int = 1,
               chunk_size: int = 0, progress=None):
        """Init from the prior then collect n_samples sweeps per chain.
        Returns (betas (C, n_samples + 1, d), n_evals (C,), state) as
        numpy arrays and the state; row 0 is the init draw."""
        state = self.init(seed, n_chains)
        parts = [state.beta.cpu().numpy()[:, None, :]]
        if chunk_size <= 0:
            chunk_size = n_samples
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, draws, _ = self.run(state, step)
            parts.append(draws.cpu().numpy())
            done += step
            if progress is not None:
                progress(done, n_samples)
        return np.concatenate(parts, axis=1), state.nev.cpu().numpy(), state
