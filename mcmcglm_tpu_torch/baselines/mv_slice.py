"""Whole-vector (multivariate) slice samplers on the shared GLM posterior.

Counterpart of ``mcmcglm_tpu/baselines/mv_slice.py``, the qslice ``*_mv``
samplers as standalone whole-vector engines on the same log posterior:

* :class:`HyperrectSliceGLM`: Neal (2003) section 5.1, a width-w box
  placed uniformly around the current point, per-coordinate shrinkage
  (``qslice::slice_hyperrect``);
* :class:`LatentSliceGLM`: Li & Walker (2020), multivariate form: the box
  widths s are sampled, s | l, x ~ 2|l - x| + Exp(rate) per coordinate,
  and carried across updates (``qslice::slice_latent_mv``);
* :class:`QuantileSliceGLM`: Heiner, Johnson & Waller (2024),
  multivariate form: per-coordinate normal or cauchy pseudo-targets map
  beta to the unit hypercube, where shrinkage proposals need no width
  (``qslice::slice_quantile_mv``).

Every proposal moves every coordinate, so each evaluation is one full
product (``utils.linalg.matvec``, float64 rounded once) for C chains at
once.  The shared shrinkage loop (:meth:`_MVSliceBase._shrink_box`) is a
``ops/slice_kernels.masked_loop`` of up to ``max_shrink`` evaluations: a
chain whose proposal is accepted freezes, and the host reads one flag per
block of ``_block_iters`` iterations (``loop_stats["flag_reads"]``; the
draws do not depend on the block length).

Random streams (``_streams.Streams``; step = the update's index, carried in
the state from 0):

* site 0, slot 0: the slice level's exponential;
* site 1, slots 0 .. d-1: the box position's uniforms (hyperrect) or the
  latent midpoint's (latent);
* site 2, slots 0 .. d-1: the latent widths' exponentials (latent);
* site 3, slot i d + j: the uniform of coordinate j at shrink iteration i.

The initial draw is ``_streams.prior_draws``.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch

from ..api import entry_device
from ..models.families import check_family
from ..models.priors import BetaPrior
from ..ops.philox import key_tensor
from ..ops.slice_kernels import _BLOCK_ITERS, masked_loop
from ..utils.linalg import matvec
from ._streams import Streams, prior_draws
from .ess_mv import run_chunks
from .logdensity import design, rowwise

__all__ = ["HyperrectSliceGLM", "LatentSliceGLM", "MVSliceState",
           "QuantileSliceGLM"]


class MVSliceState(NamedTuple):
    beta: torch.Tensor  # (C, d)
    lp: torch.Tensor  # (C,) the log posterior at beta, cached
    key: torch.Tensor  # (2,) int64 Philox key
    aux: torch.Tensor  # latent widths s (C, d), else (C,) zeros
    step: int  # the next update's index


class _MVSliceBase:
    """Shared machinery: the log posterior and the init / run / sample
    surface of :class:`~.ess_mv.EllipticalSliceGLM`."""

    def __init__(self, X, y, family, prior: BetaPrior,
                 extra: Optional[Mapping] = None, max_shrink: int = 64,
                 dtype=torch.float32, *, device="cuda"):
        self.device = entry_device(device, type(self).__name__)
        self.family = check_family(family)
        self.prior = prior
        self.dtype = dtype
        self.Xt, self.y, self.extra = design(X, y, extra, dtype, self.device)
        self.d, self.n = self.Xt.shape
        if prior.d != self.d:
            raise ValueError(
                f"prior dimension {prior.d} != number of model parameters "
                f"{self.d}"
            )
        self.max_shrink = int(max_shrink)
        self._block_iters = _BLOCK_ITERS  # masked iterations per flag read
        self.loop_stats = {"flag_reads": 0}
        # the sites each update draws (module docstring)
        self._sites = [(0, 1), (3, self.max_shrink * self.d)]

        # the log posterior of each chain, on fixed tiles of chains
        @rowwise
        def logpost(beta):
            ll = torch.sum(self.family.log_density_eta(
                matvec(beta, self.Xt), self.y, self.extra), dim=-1)
            return ll + self.prior.log_prob_beta(beta)

        self._logpost = logpost

    def _vec(self, v):
        """A scalar or (d,) setting as a (d,) tensor of the dtype."""
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=self.dtype, device=self.device),
            (self.d,)).contiguous()

    def _init_aux(self, C):
        return torch.zeros(C, dtype=self.dtype, device=self.device)

    @torch.inference_mode()
    def init(self, seed: int, n_chains: int) -> MVSliceState:
        """A prior draw per chain, its log posterior, and the Philox key of
        ``seed``."""
        beta = prior_draws(self.prior, seed, n_chains, dtype=self.dtype,
                           device=self.device)
        return MVSliceState(beta, self._logpost(beta),
                            key_tensor(seed, self.device),
                            self._init_aux(int(n_chains)), 0)

    def _update(self, streams, beta, lp, aux, draws):
        raise NotImplementedError

    @torch.inference_mode()
    def run(self, state: MVSliceState, n_steps: int):
        """``n_steps`` updates of every chain: (state, betas (C, n_steps,
        d), n_evals (C, n_steps)), computed in inference mode (no
        autograd bookkeeping)."""
        C = state.beta.shape[0]
        streams = Streams(state.key, C, dtype=self.dtype, device=self.device,
                          block=self._block_iters)
        streams.stats = self.loop_stats
        beta, lp, aux = state.beta, state.lp, state.aux
        betas, nevs = [], []
        for _, draws in streams.steps(state.step, n_steps, self._sites):
            beta, lp, aux, n_it = self._update(
                streams, beta, lp, aux,
                dict(zip((site for site, _ in self._sites), draws)))
            betas.append(beta)
            nevs.append(n_it)
        state = MVSliceState(beta, lp, state.key, aux,
                             state.step + int(n_steps))
        return state, torch.stack(betas, 1), torch.stack(nevs, 1)

    def sample(self, seed: int, n_samples: int, n_chains: int = 1,
               chunk_size: int = 0):
        """init, then ``n_samples`` updates: (betas (C, n_samples, d),
        n_evals (C, n_samples)) as numpy arrays and the last state."""
        return run_chunks(self.run, self.init(seed, n_chains), n_samples,
                          chunk_size)

    # -- the shared shrinkage loop ----------------------------------------

    def _shrink_box(self, streams, shrink_u, x0, L0, R0, level, to_x=None):
        """Uniform proposals in the (L, R) box with Neal's per-coordinate
        shrinkage toward x0 until the (possibly transformed) log target
        clears ``level``.  ``to_x`` maps a box point to (beta, penalty):
        the identity for hyperrect and latent, the pseudo-targets' quantile
        transform for the quantile sampler (the penalty is its log-density
        correction).  ``shrink_u`` (C, max_shrink d) holds the iterations'
        uniforms.  Returns (box point, beta, lp, accepted, n_evals), (C,)
        or (C, d)."""
        d = self.d
        if to_x is None:
            def to_x(u):
                return u, torch.zeros(u.shape[0], dtype=self.dtype,
                                      device=self.device)

        def body(it, c):
            L, R, _, _, _, _, n_it = c
            u1 = L + (R - L) * shrink_u[:, it * d:(it + 1) * d]
            b1, pen = to_x(u1)
            lp1 = self._logpost(b1)
            ok = (lp1 + pen) >= level
            shrink = ~ok[:, None]
            L = torch.where(shrink & (u1 < x0), u1, L)
            R = torch.where(shrink & (u1 >= x0), u1, R)
            return L, R, u1, b1, ok, lp1, n_it + 1

        C = x0.shape[0]
        carry = (L0, R0, x0, to_x(x0)[0],
                 torch.zeros(C, dtype=torch.bool, device=self.device),
                 torch.zeros(C, dtype=self.dtype, device=self.device),
                 torch.zeros(C, dtype=torch.int32, device=self.device))
        (_, _, u1, b1, ok, lp1, n_it), _ = masked_loop(
            streams, lambda c: ~c[4], body, carry, self.max_shrink)
        return u1, b1, lp1, ok, n_it


_rowsum = rowwise(lambda x: torch.sum(x, dim=-1))
_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def _ndtr(x):
    """The standard normal cdf in the JAX package's form
    (``jax.scipy.special.ndtr``): 1 + erf near 0, erfc in the tails."""
    w = x * _HALF_SQRT_2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _accept(ok, b1, lp1, beta, lp0):
    return torch.where(ok[:, None], b1, beta), torch.where(ok, lp1, lp0)


class HyperrectSliceGLM(_MVSliceBase):
    """Neal (2003) section 5.1 shrinking-hyperrectangle slice sampler
    (``qslice::slice_hyperrect``): a width-``w`` box positioned uniformly
    around the current point, no stepping out, per-coordinate shrinkage.

    ``w`` is a scalar or (d,) vector of box edge lengths."""

    def __init__(self, X, y, family, prior, w=1.0, **kw):
        super().__init__(X, y, family, prior, **kw)
        self.w = self._vec(w)
        self._sites.insert(1, (1, self.d))

    def _update(self, streams, beta, lp0, aux, draws):
        level = lp0 - streams.exponential(draws[0][:, 0])
        L = beta - self.w * streams.uniform(draws[1])
        R = L + self.w
        _, b1, lp1, ok, n_it = self._shrink_box(
            streams, streams.uniform(draws[3]), beta, L, R, level)
        return (*_accept(ok, b1, lp1, beta, lp0), aux, n_it)


class LatentSliceGLM(_MVSliceBase):
    """Li & Walker (2020) latent slice sampler, multivariate form
    (``qslice::slice_latent_mv``): per-coordinate bracket widths s are
    sampled, s_i | l_i, x_i ~ 2|l_i - x_i| + Exp(rate), so the box
    auto-tunes; s is carried in the state across updates."""

    def __init__(self, X, y, family, prior, rate=0.3, **kw):
        super().__init__(X, y, family, prior, **kw)
        self.rate = float(rate)
        self._sites[1:1] = [(1, self.d), (2, self.d)]

    def _init_aux(self, C):
        return torch.full((C, self.d), 1.0 / self.rate, dtype=self.dtype,
                          device=self.device)

    def _update(self, streams, beta, lp0, s, draws):
        level = lp0 - streams.exponential(draws[0][:, 0])
        # latent midpoint l ~ U(x - s/2, x + s/2), coordinate-wise
        l = beta + s * (streams.uniform(draws[1]) - 0.5)
        # refresh s: s' = 2|l - x| + Exp(rate), coordinate-wise
        s_new = 2.0 * torch.abs(l - beta) + (
            streams.exponential(draws[2]) / self.rate)
        L = l - s_new / 2.0
        R = l + s_new / 2.0
        _, b1, lp1, ok, n_it = self._shrink_box(
            streams, streams.uniform(draws[3]), beta, L, R, level)
        return (*_accept(ok, b1, lp1, beta, lp0), s_new, n_it)


class QuantileSliceGLM(_MVSliceBase):
    """Heiner, Johnson & Waller (2024) quantile slice sampler,
    multivariate form (``qslice::slice_quantile_mv``): independent
    per-coordinate pseudo-targets (normal or cauchy, loc/scale scalar or
    (d,)) map beta to u = F(beta) on the unit hypercube; the transformed
    target h(u) = f(Q(u)) / prod_i psi_i(Q_i(u)) is sliced with shrinkage
    proposals on [0, 1]^d, with no width to tune.

    The pseudo-target should roughly cover the posterior bulk; a
    heavy-tailed cauchy is the safe default."""

    def __init__(self, X, y, family, prior, pseudo_loc=0.0, pseudo_scale=1.0,
                 pseudo_family: str = "cauchy", **kw):
        super().__init__(X, y, family, prior, **kw)
        self.loc = self._vec(pseudo_loc)
        self.scale = self._vec(pseudo_scale)
        if pseudo_family not in ("normal", "cauchy"):
            raise ValueError("pseudo_family must be 'normal' or 'cauchy'")
        self.pseudo_family = pseudo_family
        self._eps = torch.tensor(1e-7, dtype=self.dtype, device=self.device)

    def _cdf(self, x):
        z = (x - self.loc) / self.scale
        if self.pseudo_family == "normal":
            return _ndtr(z)
        return 0.5 + torch.atan(z) / math.pi

    def _ppf(self, u):
        if self.pseudo_family == "normal":
            return self.loc + self.scale * torch.special.ndtri(u)
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))

    def _logpdf_sum(self, x):
        z = (x - self.loc) / self.scale
        if self.pseudo_family == "normal":
            per = (-0.5 * z * z - torch.log(self.scale)
                   - 0.5 * math.log(2.0 * math.pi))
        else:
            per = -torch.log(math.pi * self.scale * (1.0 + z * z))
        return _rowsum(per)

    def _clip(self, u):
        return torch.clamp(u, self._eps, 1.0 - self._eps)

    def _update(self, streams, beta, lp0, aux, draws):
        u0 = self._clip(self._cdf(beta))
        # the level on the transformed target h
        level = (lp0 - self._logpdf_sum(beta)
                 - streams.exponential(draws[0][:, 0]))

        def to_x(u):
            b = self._ppf(self._clip(u))
            return b, -self._logpdf_sum(b)

        ones = torch.ones_like(u0)
        _, b1, lp1, ok, n_it = self._shrink_box(
            streams, streams.uniform(draws[3]), u0, torch.zeros_like(u0),
            ones, level, to_x=to_x)
        return (*_accept(ok, b1, lp1, beta, lp0), aux, n_it)
