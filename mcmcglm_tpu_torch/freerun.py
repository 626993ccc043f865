"""Free-running CGGibbs: lockstep-free slice-within-Gibbs, in PyTorch.

Counterpart of ``mcmcglm_tpu/freerun.py`` for every coordinate sampler
of the JAX engine: the six slice kernels (stepping_out, quantile, latent,
elliptical, genelliptical, doubling) and the exact conjugate draws
(``coord_sampler="conjugate"``).  Each chain runs the standard sequential
CGGibbs algorithm as an explicit automaton that advances by one target
evaluation (or one K-proposal speculative battery) per device pass; chains
are free-running, so within one pass chain A can be shrinking coordinate
17 while chain B steps out coordinate 901.  The passes live in
``ops/freerun_passes.py`` (and ``ops/freerun_doubling.py``,
``ops/freerun_conjugate.py``); the K-proposal batteries, and the CUDA
kernels that evaluate them, in ``ops/freerun_batteries.py``; on the card
the stepping-out and quantile passes run as two kernels around the battery
(``ops/freerun_automaton.py``, ``pass_impl``).

A run is a loop of blocks of 32 passes with one host read of the
termination flag per block (``passloop.py``); on CUDA each block is one
CUDA graph replay.  The engine never picks a device: ``device=`` is a
required argument, and every tensor it makes lives there.  Random numbers
come from a counter-based Philox4x32-10 stream keyed by the seed: the
state carries the key (``key``, int64 (2,)) and the index of the next pass
that consumes randomness (``ctr``, int64 0-d); a pass draws slot t of
chain c from counter (ctr, c, t).  The JAX package's threefry keys give
other numbers, so the two engines agree in law, not draw for draw (a test
hands both the same draws to compare one pass).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from .models.families import Family, check_family
from .models.priors import BetaPrior
from .ops import freerun_automaton
from .ops.freerun_batteries import configure_battery, launch_counts, masked_sum
from .ops.philox import key_tensor, pass_uniforms
from .passloop import BlockLoop, new_stats
from .utils.profiling import part, ranged, span, synced_span
from .utils.linalg import matvec

__all__ = ["FreeRunCGGibbs", "FreeRunState", "QuantileState"]

_KERNELS = ("stepping_out", "latent", "elliptical", "genelliptical",
            "quantile", "doubling")
_UNBOUNDED = 1 << 62  # the pass budget of a run without a pass bound
# passes per block of the pass loop (the pass budget caps it): on an H100
# 32 ran faster per pass than 1, 8 or 128 (PERF.md, section 5)
_BLOCK_PASSES = 32
# captured blocks an engine keeps, least recently used evicted first:
# each holds a static copy of its carry (the draws buffer included)
_MAX_GRAPHS = 8
# Marsaglia-Tsang candidates per genelliptical Gamma draw: each is
# rejected with probability below 0.049 (shape >= 1, after the boost), so
# a draw exhausts all of them with probability below 0.049**12 < 2e-16
_GAMMA_CANDIDATES = 12


class FreeRunState(NamedTuple):
    # problem state, batched over chains
    beta: torch.Tensor  # (C, d)
    eta: torch.Tensor  # (C, n)
    # log-density cache at the committed eta: (C,) reduced log likelihood
    # for eval_cache="scalar", (C, n) per-observation for "per_obs"
    ld0: torch.Tensor
    key: torch.Tensor  # (2,) int64 Philox key
    ctr: torch.Tensor  # () int64 index of the next pass that draws
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
    w: torch.Tensor  # slice width (quantile: u0 = F(b0); angular: nu)
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
    key: torch.Tensor
    ctr: torch.Tensor
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


def _gather(arr, j):
    """arr[c, j_c] for every chain c."""
    return torch.gather(arr, 1, j.long()[:, None])[:, 0]


def standard_gamma(alpha: float, u: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws from uniforms ``u`` (..., 2m + 1) by
    Marsaglia & Tsang (2000): candidate i takes the normal score
    ndtri(u[..., i]) and the acceptance uniform u[..., m + i]; the first
    accepted candidate is the draw.  For alpha < 1 the draw is
    Gamma(alpha + 1) * U^(1/alpha) with U = u[..., 2m].  A draw whose m
    candidates are all rejected is NaN, never an approximation."""
    m = (u.shape[-1] - 1) // 2
    a = alpha + 1.0 if alpha < 1.0 else alpha
    dd = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * dd)
    x = torch.special.ndtri(u[..., :m])
    v = (1.0 + c * x) ** 3
    logv = torch.log(torch.clamp(v, min=torch.finfo(u.dtype).tiny))
    ok = (v > 0) & (torch.log(u[..., m:2 * m])
                    < 0.5 * x * x + dd - dd * v + dd * logv)
    first = torch.argmax(ok.to(torch.uint8), -1, keepdim=True)
    g = dd * torch.gather(v, -1, first)[..., 0]
    if alpha < 1.0:
        g = g * u[..., 2 * m] ** (1.0 / alpha)
    return torch.where(ok.any(-1), g, math.nan)


def _roundoff_eta(family, y) -> float:
    """The predictor at which eval_cache="auto" reads the log densities:
    0, as the JAX package does, unless the mean there lies outside the
    family's ``mean_domain``; then g(mean y), where that is finite."""
    lo, hi = family.mean_domain
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    mu0 = float(family.link.linkinv(zero))
    if lo < mu0 < hi:
        return 0.0
    eta = float(family.link.link(y.mean()))
    return eta if math.isfinite(eta) else 0.0


class FreeRunCGGibbs:
    """Lockstep-free CGGibbs sampler (all six univariate slice kernels and
    the exact conjugate coordinate draws).

    Same problem signature as the JAX package's ``FreeRunCGGibbs``, plus
    the required keyword ``device``.  ``spec_k`` defaults to 4 on CUDA and 1 on the CPU (always 1 for
    doubling).  ``battery_impl`` is "auto", "torch", "cuda", "cuda2" or
    "cuda3" (see ``ops/freerun_batteries.configure_battery``).  The pass
    runs as the automaton kernels around the battery (``pass_impl`` "cuda")
    or as the PyTorch pass ("torch"), chosen at construction and explained
    in ``pass_impl_reason`` (``ops/freerun_automaton.configure_pass``).
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
        if slice_kernel not in _KERNELS:
            raise ValueError(
                "freerun slice_kernel must be one of 'stepping_out', "
                "'doubling', 'latent', 'elliptical', 'genelliptical' or "
                f"'quantile' (got {slice_kernel!r})"
            )
        if coord_sampler not in ("slice", "conjugate"):
            raise ValueError(
                f"coord_sampler must be 'slice' or 'conjugate', got "
                f"{coord_sampler!r}"
            )
        if slice_kernel != "stepping_out" and coord_sampler == "conjugate":
            raise ValueError(
                "coord_sampler='conjugate' draws exact normals — it has "
                f"no slice kernel; drop slice_kernel={slice_kernel!r}"
            )
        if x_storage not in ("f32", "bf16"):
            raise ValueError(
                f"x_storage must be 'f32' or 'bf16', got {x_storage!r}"
            )
        self.x_storage = x_storage
        self.device = _resolve_device(device)
        self.slice_kernel = slice_kernel
        self.coord_sampler = coord_sampler
        self.is_angular = slice_kernel in ("elliptical", "genelliptical")
        # uniforms consumed per coordinate begin: stepping_out (level,
        # interval position, stepout split; quantile uses the first two),
        # latent (level, midpoint, width Exp, first proposal), elliptical
        # (level, nu normal score, theta0), doubling (level, position)
        self._n_begin_u = (4 if slice_kernel == "latent"
                           else 2 if slice_kernel == "doubling" else 3)
        if slice_kernel == "doubling" or coord_sampler == "conjugate":
            what = ("slice_kernel='doubling' runs the classic "
                    "one-evaluation pass" if slice_kernel == "doubling"
                    else "coord_sampler='conjugate' does not use the slice "
                    "proposal batteries")
            if slice_kernel == "doubling" and spec_k not in (None, 1):
                raise ValueError(
                    "slice_kernel='doubling' requires spec_k=1: the "
                    "speculative battery's all-rejections proposal "
                    "recursion does not compose with the Fig. 6 "
                    "back-test (ops/freerun_doubling.py)"
                )
            if battery_impl not in ("auto", "torch"):
                raise ValueError(f"{what}; drop battery_impl={battery_impl!r}")
            battery_impl = "torch"
            spec_k = 1
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
        if ("w" not in tuning and coord_sampler == "slice"
                and slice_kernel in ("stepping_out", "doubling")):
            raise ValueError(
                "A tuning parameter for the slice kernel is missing: ['w'] "
                f"required by {slice_kernel!r}"
            )
        self.w0 = float(tuning.get("w", 1.0))
        # doubling budget (Neal's p), capped at 60: p doublings scale the
        # interval by 2^p, and past ~2^60 w a float32 interval overflows
        self.max_doublings = min(int(tuning.get("max_doublings", 32)), 60)
        # latent's Exp rate of the width refresh
        self.rate = float(tuning.get("rate", 0.3))
        if self.is_angular:
            if "sigma" not in tuning:
                raise ValueError(
                    "A tuning parameter for the slice kernel is missing: "
                    f"['sigma'] required by {slice_kernel!r}"
                )
            if slice_kernel == "genelliptical" and "df" not in tuning:
                raise ValueError(
                    "A tuning parameter for the slice kernel is missing: "
                    "['df'] required by 'genelliptical'"
                )
        self.ell_mu = float(tuning.get("mu", 0.0))
        self.ell_sigma = float(tuning.get("sigma", 1.0))
        self.ell_df = float(tuning.get("df", 1.0))
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
        # what turns the battery kernel's sums over this engine's
        # observations into the sums over all of them: None here; the
        # obs-sharded engine sets an all-reduce over its obs group (its
        # reduce_fn holds the same all-reduce for the plain paths)
        self.combine_sums = None
        self.max_stepouts = int(max_stepouts)
        self.max_shrink = int(max_shrink)
        # sampling runs use the m=1 shrink-only kernel by default; warmup
        # always uses the full stepping-out schedule
        self.shrink_only = bool(shrink_only)
        self._adapt_rate = 0.08
        self.adapt_c = float(adapt_c if adapt_c is not None else 40.0)
        # eval_cache "auto": the scalar cache when its f32 roundoff
        # estimate (from the log density at eta = 0) is far below the
        # Exp(1) slice level, else the exact per-observation cache (which
        # the battery kernels do not serve: configure_battery warns on the
        # card).  Where the mean at eta = 0 is not inside the family's
        # mean_domain (inverse and 1/mu^2 links, and identity or sqrt
        # links of a positive mean) the density there is infinite or a clamp's artefact and says
        # nothing of the roundoff, so the estimate reads it at the
        # intercept-only predictor g(mean y) instead (the JAX package keeps
        # eta = 0, and so the per-observation cache, for these pairs:
        # ROADMAP, deliberate divergences)
        if eval_cache not in ("auto", "scalar", "per_obs"):
            raise ValueError(
                f"eval_cache must be 'auto', 'scalar' or 'per_obs', got {eval_cache!r}"
            )
        if eval_cache == "auto":
            eta0 = torch.zeros(self.n, dtype=dtype, device=dev)
            ld_at0 = self._ld_eta(eta0 + _roundoff_eta(self.family, self.y),
                                  self.y, self.extra)
            ld_at0 = ld_at0.cpu().numpy()
            eps = float(torch.finfo(dtype).eps)
            err = (eps * float(np.sqrt(np.log2(max(self.n, 4))))
                   * float(np.sum(np.abs(ld_at0))))
            eval_cache = "scalar" if err < 0.01 else "per_obs"
            self.eval_cache_reason = (
                f"auto: roundoff estimate {err:.3g} "
                + ("< 0.01" if eval_cache == "scalar" else ">= 0.01"))
        else:
            self.eval_cache_reason = "requested"
        self.eval_cache = eval_cache
        if spec_k is None:
            spec_k = 4 if self.device.type == "cuda" else 1
        self.spec_k = int(spec_k)
        if not 1 <= self.spec_k <= 32:
            raise ValueError(f"spec_k must be in [1, 32], got {spec_k}")
        if slice_kernel == "doubling":
            from .ops.freerun_doubling import DoublingState

            self.state_cls = DoublingState
        elif self.q_adapt:
            self.state_cls = QuantileState
        else:
            self.state_cls = FreeRunState
        configure_battery(self, battery_impl, user_reduce_fn=user_reduce_fn)
        # the rows the cuda3 kernel streams: bfloat16 under x_storage="bf16"
        # (half the row bytes; the values are already rounded, so the
        # kernel's upcast reproduces the float32 rows exactly)
        bf16_rows = x_storage == "bf16" and self.battery_impl == "cuda3"
        self._Xt_rows = self.Xt.to(torch.bfloat16) if bf16_rows else self.Xt
        # the pass's route: the automaton kernels around the battery, or
        # the PyTorch pass (ops/freerun_automaton.py, configure_pass)
        freerun_automaton.configure_pass(self)
        if coord_sampler == "conjugate":
            from .ops.freerun_conjugate import conjugate_params

            m, s2 = conjugate_params(self)
            self._conj_m = _tensor(m, dtype, dev)
            self._conj_s2 = _tensor(s2, dtype, dev)
            # sum_i w_i x_ij^2, the static part of the conditional precision
            self._conj_sxx = self.reduce_fn(self.Xt ** 2)  # (d,)
            sd = self.extra.get("sd", torch.ones((), dtype=dtype, device=dev))
            self._conj_inv_sigma2 = 1.0 / (sd * sd)
        # uniforms per pass: the K-proposal battery (or one proposal) plus
        # the coordinate begin's; the conjugate pass draws one normal
        self._pass_width = (1 if coord_sampler == "conjugate"
                            else self.spec_k + self._n_begin_u)
        self._block_passes = _BLOCK_PASSES
        # CUDA graphs per block on CUDA; the eager loop there is for the
        # tests and the smoke's equality check only
        self._graph_loop = self.device.type == "cuda"
        self._loops: dict = {}
        self.loop_stats = new_stats()

    @ranged("pass.prior")
    def _coord_lp(self, beta, j, b):
        return self.prior.coord_log_prob(beta, j, b).to(self.dtype)

    # -- quantile pseudo-target maps and the ellipse ---------------------

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

    @ranged("pass.prior")
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

    def ellipse_point(self, b0, nu, theta):
        """The elliptical proposal x(theta) on the ellipse through the
        current point b0 and the auxiliary draw nu around mu (Murray,
        Adams & MacKay 2010)."""
        mu = self.ell_mu
        return (b0 - mu) * torch.cos(theta) + (nu - mu) * torch.sin(theta) + mu

    # -- coordinate initialisation (batched) -----------------------------

    def _begin_coord(self, beta, logw, j, shrink_only, ubatch, qloc=None,
                     g=None):
        """Level + initial interval for each lane's coordinate j, from the
        (C, nb) uniform block ``ubatch`` (and, for genelliptical, the (C,)
        standard Gamma draws ``g``); returns a dict of fresh automaton
        registers (latent adds ``logw_j``, the refreshed log width for the
        caller to commit; doubling its back-test registers).

        ``shrink_only=True`` is Neal's procedure with a step-out budget of
        m = 1 (the width-w interval is used directly and the lane starts
        shrinking); ``False`` is the full stepping-out schedule; a (C,)
        bool tensor selects per lane (two-phase warmup).  Only the
        stepping-out kernel reads it."""
        if self.slice_kernel == "latent":
            return self._begin_coord_latent(beta, logw, j, ubatch)
        if self.is_angular:
            return self._begin_coord_elliptical(beta, j, ubatch, g)
        if self.slice_kernel == "quantile":
            return self._begin_coord_quantile(beta, logw, j, ubatch, qloc)
        if self.slice_kernel == "doubling":
            return self._begin_coord_doubling(beta, logw, j, ubatch)
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])  # -Exp(1), exact for u in [0, 1)
        u = ubatch[:, 1]
        uj = ubatch[:, 2]
        w = torch.exp(_gather(logw, j))
        b0 = _gather(beta, j)
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

    def _begin_coord_latent(self, beta, logw, j, ubatch):
        """Latent-slice coordinate begin (Li & Walker 2020): reads the
        carried bracket width s = exp(logw[c, j]) of the last visit, draws
        the latent midpoint l ~ U(b0 - s/2, b0 + s/2), refreshes
        s' = 2|l - b0| + Exp(rate) and opens the shrink-only bracket
        (l - s'/2, l + s'/2).  Four uniforms: level, midpoint, width Exp,
        first proposal."""
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])
        s = torch.exp(_gather(logw, j))
        b0 = _gather(beta, j)
        latent_l = b0 + s * (ubatch[:, 1] - 0.5)
        s_new = (2.0 * torch.abs(latent_l - b0)
                 - torch.log1p(-ubatch[:, 2]) / self.rate)
        L = latent_l - 0.5 * s_new
        R = latent_l + 0.5 * s_new
        zero = torch.zeros(C, dtype=torch.int32, device=beta.device)
        return dict(
            level=level, L=L, R=R, budL=zero, budR=zero, b0=b0,
            lp0=self._coord_lp(beta, j, b0), w=s_new,
            xprop=L + (R - L) * ubatch[:, 3], phase=torch.ones_like(zero),
            stepdir=zero, n_shrink=zero, logw_j=torch.log(s_new),
        )

    def _begin_coord_elliptical(self, beta, j, ubatch, g=None):
        """Elliptical-slice coordinate begin (Murray, Adams & MacKay 2010):
        the auxiliary nu ~ N(mu, sigma_eff^2) in the ``w`` register, the
        angle theta0 ~ U(0, 2 pi) with bracket (theta0 - 2 pi, theta0) and
        THETA in the xprop register (the passes map it through
        :meth:`ellipse_point` and shrink toward theta = 0).

        genelliptical (Nishihara et al. 2014): sigma_eff = sigma /
        sqrt(lambda), lambda | b0 ~ Gamma((df + 1)/2, rate=(df +
        ((b0 - mu)/sigma)^2)/2), from the standard Gamma draw ``g``."""
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])
        b0 = _gather(beta, j)
        sigma_eff = self.ell_sigma
        if self.slice_kernel == "genelliptical":
            z2 = ((b0 - self.ell_mu) / self.ell_sigma) ** 2
            rate = (self.ell_df + z2) / 2.0
            sigma_eff = self.ell_sigma * torch.rsqrt(g / rate)
        u_nu = torch.clamp(ubatch[:, 1], 1e-7, 1.0 - 1e-7)
        nu = self.ell_mu + sigma_eff * torch.special.ndtri(u_nu)
        two_pi = 2.0 * math.pi
        theta0 = ubatch[:, 2] * two_pi
        zero = torch.zeros(C, dtype=torch.int32, device=beta.device)
        return dict(
            level=level, L=theta0 - two_pi, R=theta0, budL=zero, budR=zero,
            b0=b0, lp0=self._coord_lp(beta, j, b0), w=nu, xprop=theta0,
            phase=torch.ones_like(zero), stepdir=zero, n_shrink=zero,
        )

    def _begin_coord_quantile(self, beta, logw, j, ubatch, qloc=None):
        """Quantile-slice coordinate begin (Heiner, Johnson & Waller 2024):
        shrinkage on the unit interval (0, 1) with the pivot u0 = F(b0)
        carried in the ``w`` register; with ``pseudo_adapt`` F is the
        (chain, coordinate)'s own adapted pseudo-target."""
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])  # -Exp(1), on the h scale
        b0 = _gather(beta, j)
        if self.q_adapt:
            u0 = self.quantile_cdf(b0, _gather(qloc, j),
                                   torch.exp(_gather(logw, j)))
        else:
            u0 = self.quantile_cdf(b0)
        u0 = torch.clamp(u0.to(self.dtype), 1e-7, 1.0 - 1e-7)
        zero = torch.zeros(C, dtype=torch.int32, device=beta.device)
        return dict(
            level=level, L=torch.zeros_like(b0), R=torch.ones_like(b0),
            budL=zero, budR=zero, b0=b0, lp0=self._coord_lp(beta, j, b0),
            w=u0, xprop=ubatch[:, 1], phase=torch.ones_like(zero),
            stepdir=zero, n_shrink=zero,
        )

    def _begin_coord_doubling(self, beta, logw, j, ubatch):
        """Doubling-slice coordinate begin (Neal 2003, Fig. 4): the
        width-w interval positioned around b0, its LEFT endpoint the first
        evaluation, ``budL`` the doubling budget p, the back-test registers
        cleared.  Two uniforms: level, position.  Widths stay the user's w
        (no adaptation)."""
        C = beta.shape[0]
        level = torch.log1p(-ubatch[:, 0])
        w = torch.exp(_gather(logw, j))
        b0 = _gather(beta, j)
        L = b0 - w * ubatch[:, 1]
        R = L + w
        zero = torch.zeros(C, dtype=torch.int32, device=beta.device)
        false = torch.zeros(C, dtype=torch.bool, device=beta.device)
        return dict(
            level=level, L=L, R=R, budL=torch.full_like(zero,
                                                       self.max_doublings),
            budR=zero, b0=b0, lp0=self._coord_lp(beta, j, b0), w=w,
            xprop=L, phase=zero, stepdir=zero, n_shrink=zero,
            x1=b0, eL=L, eR=R, e_aL=false, e_aR=false,
            hatL=L, hatR=R, h_aL=false, h_aR=false, dsep=false,
        )

    # -- randomness -------------------------------------------------------

    @ranged("pass.philox")
    def _randoms(self, key, p0, n_passes: int, n_chains: int) -> dict:
        """The random inputs of the passes with indices p0 .. p0 +
        n_passes - 1, as the pass functions take them, each with a leading
        pass axis: ``u`` (uniform block), ``g`` (genelliptical's standard
        Gamma draws, NaN where a draw exhausted its candidates) or ``z``
        (the conjugate pass's standard normals, ndtri of one uniform)."""
        W = self._pass_width
        extra = (2 * _GAMMA_CANDIDATES + 1
                 if self.slice_kernel == "genelliptical" else 0)
        U = pass_uniforms(key, p0, n_passes, n_chains, W + extra)
        if self.coord_sampler == "conjugate":
            return {"z": torch.special.ndtri(U[..., 0])}
        out = {"u": U[..., :W]}
        if extra:
            out["g"] = standard_gamma((self.ell_df + 1.0) / 2.0, U[..., W:])
        return out

    def init(self, seed: int, n_chains: int, beta0=None):
        """Initial state for ``n_chains`` chains under the integer
        ``seed``: the prior draw comes from a ``torch.Generator`` seeded
        with it, the automaton's randomness from the Philox stream keyed by
        it (the first coordinate begin takes pass index 0, and the state's
        first pass index 1).  ``beta0`` ((d,) or (C, d)) overrides the prior
        draw."""
        seed = int(seed)
        C = int(n_chains)
        dev, dtype = self.device, self.dtype
        g = torch.Generator(device=dev).manual_seed(seed)
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
        w_init = (1.0 / self.rate if self.slice_kernel == "latent"
                  else self.q_scale if self.q_adapt else self.w0)
        logw = torch.full((C, self.d), float(np.log(np.float32(w_init))),
                          dtype=dtype, device=dev)
        qloc = (torch.full((C, self.d), self.q_loc, dtype=dtype, device=dev)
                if self.q_adapt else None)
        j0 = torch.zeros(C, dtype=torch.int32, device=dev)
        key = key_tensor(seed, dev)
        nb = self._n_begin_u
        gen = self.slice_kernel == "genelliptical"
        U = pass_uniforms(key, torch.zeros((), dtype=torch.int64, device=dev),
                          1, C, nb + (2 * _GAMMA_CANDIDATES + 1 if gen else 0)
                          )[0]
        gam = (standard_gamma((self.ell_df + 1.0) / 2.0, U[:, nb:])
               if gen else None)
        if gen and bool(torch.isnan(gam).any()):
            raise RuntimeError("a Gamma draw exhausted its Marsaglia-Tsang "
                               "candidates at init")
        reg = self._begin_coord(beta, logw, j0, False, U[:, :nb], qloc=qloc,
                                g=gam)
        logw_j = reg.pop("logw_j", None)
        if logw_j is not None:  # latent: commit the refreshed width
            logw = self._commit_row(logw, j0, logw_j)
        if qloc is not None:
            reg["qloc"] = qloc
        return self.state_cls(
            beta=beta, eta=eta, ld0=ld0, key=key,
            ctr=torch.ones((), dtype=torch.int64, device=dev), logw=logw,
            j=j0, nev=torch.zeros(C, dtype=torch.int32, device=dev), **reg,
        )

    @staticmethod
    @ranged("pass.scatters")
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
    @ranged("pass.scatters")
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
        """The per-pass function for this engine's configuration, called
        as ``fn(eng, state, ...)``."""
        if self.coord_sampler == "conjugate":
            from .ops.freerun_conjugate import run_pass_conj as fn
        elif self.slice_kernel == "doubling":
            from .ops.freerun_doubling import run_pass_doubling as fn
        else:
            from .ops.freerun_passes import run_pass, run_pass_spec

            fn = run_pass_spec if self.spec_k > 1 else run_pass
        return fn

    # -- the block loop -----------------------------------------------------

    def _block_fn(self, B: int, adapt: bool, shrink_only):
        """One block of B passes, ``block(eng, carry) -> (carry, flag)``
        with carry (state, sweep_count, draws, nevbuf, budget, bad, quota,
        stepout).  ``budget`` is the count of passes with an active lane
        still allowed (a pass past it runs with every lane idle); ``bad``
        counts lane-passes that carried an exhausted Gamma draw; ``quota``
        (sweeps per chain) and ``stepout`` (the two-phase warmup's
        stepping-out quota, or None) are 0-d tensors, so one captured block
        serves every run length.  flag = [some lane below its quota and
        budget left, bad].  The block takes the engine per call and holds
        no reference to it, so an engine and its cached loops form no
        cycle."""
        if self.pass_impl == "cuda":
            return freerun_automaton.make_block(B, adapt, shrink_only)
        step = self._step_fn()
        gen = self.slice_kernel == "genelliptical"

        def block(eng, carry):
            s, sc, draws, nevbuf, budget, bad, quota, stepout = carry
            R = eng._randoms(s.key, s.ctr, B, sc.shape[0])
            for i in range(B):
                p = s.ctr
                with part("pass.automaton"):
                    s, sc, draws, nevbuf = step(
                        eng, s, sc, draws, nevbuf, quota, adapt,
                        shrink_only, stepout, live=budget > 0,
                        **{k: v[i] for k, v in R.items()})
                budget = budget - (s.ctr - p)
                if gen:
                    bad = bad + torch.isnan(s.w).sum()
            go = ((sc < quota).any() & (budget > 0)).to(torch.int64)
            return ((s, sc, draws, nevbuf, budget, bad, quota, stepout),
                    torch.stack([go, bad]))

        return block

    def _loop(self, C, B, adapt, shrink_only, two_phase, slots):
        key_ = (C, B, adapt, shrink_only, two_phase, slots)
        # the cache holds graph loops only: with the graph loop switched
        # off, a configuration captured before must run eagerly
        loop = self._loops.pop(key_, None) if self._graph_loop else None
        if loop is None:
            loop = BlockLoop(self._block_fn(B, adapt, shrink_only),
                             passes=B, graph=self._graph_loop,
                             counters=[launch_counts,
                                       freerun_automaton.launch_counts],
                             stats=self.loop_stats)
        if self._graph_loop:  # an eager loop holds nothing to reuse
            self._loops[key_] = loop  # the most recently used last
            while len(self._loops) > _MAX_GRAPHS:
                del self._loops[next(iter(self._loops))]
        return loop

    def _run_pass_block(self, state, sweep_count, *, n_sweeps: int,
                        n_passes: Optional[int], adapt: bool, shrink_only,
                        stepout_sweeps=None, draws=None, nevbuf=None):
        """Advance by at most ``n_passes`` passes that have an active lane
        (no bound when None) toward a quota of ``n_sweeps`` completed
        sweeps per chain, in blocks of ``_block_passes`` passes (fewer when
        ``n_passes`` is smaller).  A split run consumes exactly the
        random numbers of one unsplit run, at any block length."""
        C = int(state.beta.shape[0])
        B = self._block_passes
        if n_passes is not None:
            B = max(1, min(B, int(n_passes)))
        dev = self.device

        def scalar(v):
            return torch.full((), int(v), dtype=torch.int64, device=dev)

        budget = scalar(_UNBOUNDED if n_passes is None else n_passes)
        bad = scalar(0)
        quota = scalar(n_sweeps)
        stepout = None if stepout_sweeps is None else scalar(stepout_sweeps)
        slots = None if draws is None else int(draws.shape[1])
        loop = self._loop(C, B, adapt, shrink_only, stepout is not None,
                          slots)
        state, sweep_count, draws, nevbuf = loop(
            self, (state, sweep_count, draws, nevbuf, budget, bad, quota,
                   stepout))[:4]
        return state, sweep_count, draws, nevbuf

    # -- runs ---------------------------------------------------------------

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
        with span("freerun.run_passes", C=C, n_sweeps=int(n_sweeps)):
            if sweep_count is None:
                sweep_count = torch.zeros(C, dtype=torch.int32,
                                          device=self.device)
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
        with span("freerun.warmup_passes", C=int(state.beta.shape[0]),
                  n_sweeps=int(n_sweeps)):
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
        with span("freerun.run", C=int(state.beta.shape[0]),
                  n_sweeps=int(n_sweeps)):
            return self._run(state, n_sweeps, adapt=False,
                             shrink_only=self.shrink_only)

    def run_thinned(self, state, n_outer: int, thin: int, moments=None,
                    ess: bool = False, ess_max_lag: int = 64, *,
                    nev_at_draws: bool = False):
        """Advance chains by ``n_outer * thin`` sweeps, keeping every
        ``thin``-th draw and streaming per-chain moments of every sweep on
        the device.  At ``thin`` = 1 that is one :meth:`run` of ``n_outer``
        sweeps, its draws all kept and folded into the moments at once
        (``pooled.fold_moments``, Chan's merge) and into the ESS state at
        once (``pooled.update_ess_block``); the draws are those of one
        ``run(state, n_outer)``.  At ``thin`` > 1 each block of ``thin``
        sweeps is one :meth:`run`, folded the same way, its last draw
        kept and streamed into the ESS state (``pooled.update_ess``).
        Each fold is a ``pooled.fold`` span beside the run's call span; at
        thin=1 it closes once the card has finished the fold
        (``profiling.synced_span``, one synchronise a call), at ``thin`` >
        1 it times the host's queueing alone, so the blocks stay
        asynchronous.

        Returns (state, moments, draws (C, n_outer, d), n_evals (C,)):
        ``moments`` a ``parallel.pooled.ChainMoments`` with per-chain
        counts (C,), ``n_evals`` the cumulative evaluation counter.
        ``ess=True`` also streams the split-chain autocovariance
        accumulator (``parallel.pooled.ESSState``, window
        ``ess_max_lag``) and returns it as a fifth element, for
        ``pooled.ess_from_state``.  ``nev_at_draws=True`` appends the
        cumulative evaluation counter at each kept draw (C, n_outer) as
        the last element."""
        from .parallel.pooled import (ChainMoments, fold_moments, init_ess,
                                      update_ess, update_ess_block)

        C = int(state.beta.shape[0])
        dev, dtype = self.device, self.dtype
        if moments is None:
            moments = ChainMoments(
                count=torch.zeros(C, dtype=dtype, device=dev),
                mean=torch.zeros((C, self.d), dtype=dtype, device=dev),
                m2=torch.zeros((C, self.d), dtype=dtype, device=dev),
            )
        es = (init_ess(C, self.d, planned=n_outer, max_lag=ess_max_lag,
                       dtype=dtype, device=dev) if ess else None)
        if thin == 1 and n_outer > 0:
            state, kept, nev = self.run(state, n_outer)
            with synced_span("pooled.fold", dev, C=C, n_draws=int(n_outer)):
                moments = fold_moments(moments, kept)
                if es is not None:
                    es = update_ess_block(es, kept)
        else:
            kept, nev = [], []
            for _ in range(int(n_outer)):
                state, draws, nevbuf = self.run(state, thin)
                with span("pooled.fold", C=C, n_draws=int(thin)):
                    moments = fold_moments(moments, draws)
                    if es is not None:
                        es = update_ess(es, draws[:, -1])
                kept.append(draws[:, -1])
                nev.append(nevbuf[:, -1])
            kept = (torch.stack(kept, 1) if kept else
                    torch.zeros((C, 0, self.d), dtype=dtype, device=dev))
            nev = (torch.stack(nev, 1) if nev else
                   torch.zeros((C, 0), dtype=torch.int32, device=dev))
        out = (state, moments, kept, state.nev)
        if ess:
            out += (es,)
        return out + (nev,) if nev_at_draws else out

    def warmup(self, state, n_sweeps: int,
               stepout_sweeps: Optional[int] = None):
        """Adaptive warmup: per-(chain, coordinate) widths (or quantile
        pseudo-targets) pulled toward the accepted moves, frozen after.
        The first ``stepout_sweeps`` sweeps (default :meth:`_auto_stepout`)
        run the full stepping-out kernel, the rest the shrink-only one.
        Kernels without adaptation (latent, elliptical, genelliptical,
        doubling, conjugate) just burn in."""
        if stepout_sweeps is None:
            stepout_sweeps = self._auto_stepout(n_sweeps)
        with span("freerun.warmup", C=int(state.beta.shape[0]),
                  n_sweeps=int(n_sweeps)):
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
