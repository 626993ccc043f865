"""The lockstep CGGibbs engine: coordinate-wise slice-within-Gibbs, in PyTorch.

Counterpart of ``mcmcglm_tpu/engine.py``.  The JAX engine is a
``lax.scan`` over sweeps of a ``lax.scan`` over coordinates of a bounded
``while_loop`` slice kernel, vmapped over chains.  Here every chain visits
the same coordinate at the same time:

    Python loop over sweeps
      └─ Python loop over the d coordinates
           └─ a batched slice kernel (ops/slice_kernels.py): masked loops
              over the C chains, one host read of the loop flag per block
                └─ one (C, n) elementwise pass + reduction per evaluation

State per chain is (beta, eta, ld_cur, kernel_state): eta is carried and
updated in O(n) per coordinate (the CGGibbs trick) and ld_cur caches the
per-observation log densities, so each evaluation is relative to the
current point (``models/potential.make_coord_target``).  The "naive"
linear predictor recomputes eta = X beta at every evaluation through
``utils/linalg.matvec`` (float64, rounded once), for the update-against-
naive comparison (``perf.py``).  The conjugate "normal-normal" sampler
factors the posterior once, in float64 on the device, and draws each
coordinate from its Schur-complement conditional with one O(d) row
product.  No kernel is hand-written here: the JAX engine's evaluations are
plain XLA too.

Randomness: the prior draw comes from a ``torch.Generator`` seeded with the
integer seed; the slice kernels read a Philox4x32-10 stream keyed by it,
slot t of chain c at coordinate j of sweep s being the counter (s, j, c,
t), drawn ahead for chunks of coordinates.  So a run is the same at any
loop block length and on any device up to the rounding of the arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional

import numpy as np
import torch

from .freerun import _resolve_device, _tensor
from .models.families import Family, check_family
from .models.potential import make_coord_target
from .models.priors import BetaPrior
from .ops.freerun_batteries import masked_sum
from .ops.philox import counter_uniforms, key_tensor
from .ops.slice_kernels import (_BLOCK_ITERS, _LAZY_SLOTS, SliceKernel,
                                SliceRNG, get_slice_kernel)
from .parallel.pooled import ChainMoments, update_moments
from .utils.linalg import matvec

__all__ = ["EngineConfig", "ChainState", "CGGibbs"]

# kernels whose per-coordinate width w may be warmup-adapted (log w carried
# in the kernel-state slot)
_ADAPTIVE_KERNELS = ("stepping_out", "stepping_out_batched")
# uniforms drawn ahead per Philox call: a chunk of coordinates' slots
_TABLE_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static sampler configuration."""

    sample_method: str = "slice_sampling"  # or "normal-normal"
    linear_predictor_calc: str = "update"  # or "naive"
    slice_kernel: Any = "stepping_out"
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.sample_method not in ("slice_sampling", "normal-normal"):
            raise ValueError(
                "sample_method must be 'slice_sampling' or 'normal-normal'"
            )
        if self.linear_predictor_calc not in ("update", "naive"):
            raise ValueError("linear_predictor_calc must be 'update' or 'naive'")


class ChainState(NamedTuple):
    beta: torch.Tensor  # (C, d)
    eta: torch.Tensor  # (C, n) carried linear predictor
    ld_cur: torch.Tensor  # (C, n) per-observation log densities at eta
    kernel_state: torch.Tensor  # (C, d) carried slice-kernel state
    key: torch.Tensor  # (2,) int64 Philox key
    sweep: int  # index of the next sweep (the Philox counter's first word)
    chain_tuning: dict  # name -> (C,) per-chain tuning values
    adapted: bool = False  # kernel_state holds warmup-adapted log widths


def _tuning_value(v, dtype, device):
    """A tuning value: strings pass, scalars become Python numbers, arrays
    tensors on the device."""
    if isinstance(v, str):
        return v
    a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return torch.tensor(a, dtype=dtype, device=device)


class CGGibbs:
    """Lockstep CGGibbs sampler over a fixed (X, y, family, prior) problem.

    Same problem signature as the JAX package's ``CGGibbs`` plus the
    required keyword ``device``: ``X`` (n, d), ``y`` (n,), ``family``,
    ``prior`` (a BetaPrior over the d coefficients), ``extra`` (the
    family's nuisance parameters), ``tuning`` (slice-kernel tuning, e.g.
    ``{"w": 0.5}``), ``reduce_fn`` (the observation-axis reduction),
    ``chain_tuning_names`` (tuning names given per chain at ``init``),
    ``obs_weights`` and ``offset``.
    """

    def __init__(
        self,
        X,
        y,
        family,
        prior: BetaPrior,
        extra: Optional[Mapping] = None,
        config: EngineConfig = EngineConfig(),
        tuning: Optional[Mapping] = None,
        reduce_fn=None,
        chain_tuning_names: tuple = (),
        obs_weights=None,
        offset=None,
        *,
        device,
    ):
        self.config = config
        self.dtype = dtype = config.dtype
        self.device = dev = _resolve_device(device)
        self.family: Family = check_family(family)
        self.prior = prior
        X = _tensor(X, dtype, "cpu")
        self.n, self.d = X.shape
        # a fixed additive eta component: it enters eta's initialisation
        # and the naive path's full products, never the coordinate updates
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
        self.Xt = X.T.contiguous().to(dev)  # (d, n): one row per coordinate
        self.y = _tensor(y, dtype, dev).reshape(-1)
        self.extra = {k: _tensor(v, dtype, dev)
                      for k, v in dict(extra or {}).items()}
        self.tuning = {k: _tuning_value(v, dtype, dev)
                       for k, v in dict(tuning or {}).items()}
        if obs_weights is not None:
            wts = _tensor(obs_weights, dtype, dev).reshape(-1)
            if wts.shape[0] != self.n:
                raise ValueError(
                    f"obs_weights length {wts.shape[0]} != n observations {self.n}"
                )
            self.obs_weights = wts
            if reduce_fn is None:
                reduce_fn = lambda t: masked_sum(t, wts)  # noqa: E731
        else:
            self.obs_weights = None
        self.reduce_fn = reduce_fn or (lambda t: torch.sum(t, dim=-1))

        if config.sample_method == "slice_sampling":
            self.kernel: Optional[SliceKernel] = get_slice_kernel(
                config.slice_kernel)
            missing = [k for k in self.kernel.required
                       if k not in self.tuning and k not in chain_tuning_names]
            if missing:
                raise ValueError(
                    "A tuning parameter for the slice kernel is missing: "
                    f"{missing} required by {self.kernel.name!r}. For the "
                    "default 'stepping_out' a slice width w needs to be "
                    "provided"
                )
        else:
            self.kernel = None
            self._prepare_conjugate()
        self._naive = config.linear_predictor_calc == "naive"
        if self._naive:
            self._Xt64 = self.Xt.double()  # the per-evaluation product's X^T
        self._target_factory = make_coord_target(
            self.family, self.prior, self.y, self.extra,
            reduce_fn=self.reduce_fn,
        )
        self._adaptive = (self.kernel is not None
                          and self.kernel.name in _ADAPTIVE_KERNELS)
        self._w_adapted = False  # set by warmup(): kernel_state carries log w
        self._adapt_rate = 0.08
        self._block_iters = _BLOCK_ITERS
        # sweeps run and host reads of the slice loops' flags
        self.loop_stats = {"sweeps": 0, "flag_reads": 0}

    # -- initialisation ----------------------------------------------------

    def init(self, seed: int, n_chains: int,
             chain_tuning: Optional[Mapping] = None, beta0=None) -> ChainState:
        """Initial state of ``n_chains`` chains under the integer ``seed``:
        a prior draw (``beta0`` (d,) or (C, d) overrides it) and eta0 = X
        beta0, the only full product of an "update" run.
        ``chain_tuning`` maps tuning names to (n_chains,) values (the
        batched sweep of ``sweep.py``)."""
        C, dev, dtype = int(n_chains), self.device, self.dtype
        g = torch.Generator(device=dev).manual_seed(int(seed))
        beta = self.prior.sample_beta(g, C, dtype=dtype, device=dev)
        if beta0 is not None:
            beta = _tensor(beta0, dtype, dev).expand(C, self.d).contiguous()
        ct = {k: _tensor(v, dtype, dev).reshape(-1)
              for k, v in dict(chain_tuning or {}).items()}
        for k, v in ct.items():
            if v.shape != (C,):
                raise ValueError(
                    f"chain_tuning[{k!r}] must have leading dim n_chains={C}"
                )
        eta = matvec(beta, self.Xt)
        if self.offset is not None:
            eta = eta + self.offset
        ld = self.family.log_density_eta(eta, self.y, self.extra)
        s0 = (self.kernel.init_state({**self.tuning, **ct})
              if self.kernel is not None else 0.0)
        s0 = torch.as_tensor(s0, dtype=dtype, device=dev)
        kstate = torch.broadcast_to(s0.reshape(-1, 1) if s0.dim() else s0,
                                    (C, self.d)).clone()
        return ChainState(beta, eta, ld, kstate, key_tensor(int(seed), dev),
                          0, ct, False)

    # -- conjugate normal-normal path -------------------------------------

    def _prepare_conjugate(self):
        """The gaussian posterior's precision Q = X'WX / sigma^2 + S^-1 and
        mean mu = Q^-1 (X'Wy / sigma^2 + S^-1 m) for the prior N(m, S),
        factored once in float64 on the device and rounded once."""
        fam = self.family
        if fam.name != "gaussian" or fam.link.name != "identity":
            raise ValueError(
                "sample_method='normal-normal' requires the gaussian family "
                f"with identity link (got {fam.name!r}, {fam.link.name!r})"
            )
        f64, dev = torch.float64, self.device
        X = self.Xt.to(f64).T
        y = self.y.to(f64)
        if self.offset is not None:
            y = y - self.offset.to(f64)  # identity link: a shifted response
        sigma = self.extra.get("sd", torch.ones((), device=dev)).to(f64)
        cov_prior = torch.as_tensor(self.prior.cov_beta(), dtype=f64).to(dev)
        m_prior = torch.as_tensor(self.prior.mean_beta(), dtype=f64).to(dev)
        Xw = X if self.obs_weights is None else X * self.obs_weights.to(f64)[:, None]
        P_prior = torch.linalg.inv(cov_prior)
        prec = Xw.T @ X / sigma**2 + P_prior
        mu = torch.linalg.solve(prec, Xw.T @ y / sigma**2 + P_prior @ m_prior)
        self._conj_mu = mu.to(self.dtype)
        self._conj_prec = prec.to(self.dtype)

    def _conjugate_draw(self, rng, beta, j):
        """beta_j | beta_-j ~ N(mu_j - Q_j,-j (beta_-j - mu_-j) / Q_jj,
        1 / Q_jj), the standard normal from slot 0."""
        q_row = self._conj_prec[j]
        q_jj = q_row[j]
        r = beta - self._conj_mu
        off = torch.sum(r * q_row, dim=-1) - q_jj * r[:, j]
        mean = self._conj_mu[j] - off / q_jj
        z = torch.special.ndtri(rng.uniform(0).to(self.dtype))
        return mean + torch.rsqrt(q_jj) * z

    # -- the sweep ---------------------------------------------------------

    def _naive_target(self, beta, ld, j, jl, beta_j):
        """g(b) with eta recomputed as X beta' at every evaluation."""
        lp_cur = self.prior.coord_log_prob(beta, jl, beta_j)
        ll_cur = self.reduce_fn(ld)

        def g(b):
            beta_new = beta.clone()
            beta_new[:, j] = b
            eta_new = matvec(beta_new, self._Xt64)
            if self.offset is not None:
                eta_new = eta_new + self.offset
            ll = self.reduce_fn(
                self.family.log_density_eta(eta_new, self.y, self.extra))
            lp = self.prior.coord_log_prob(beta, jl, b)
            return (ll - ll_cur) + (lp - lp_cur)

        return g

    def _n_uniforms(self, tuning) -> int:
        """Slots drawn ahead per coordinate (a slot past them is drawn
        when read): the kernel's own count, or ``_LAZY_SLOTS``."""
        if self.kernel is None:
            return 1
        if self.kernel.n_uniforms is None:
            return _LAZY_SLOTS
        return int(self.kernel.n_uniforms(tuning))

    def _chain0(self, n_chains: int) -> int:
        """The global index of this engine's first chain in the Philox
        counter (a chain shard's offset; 0 here)."""
        return 0

    def _sweep(self, beta, eta, ld, kstate, key, sweep: int, chain_tuning,
               adapt: bool):
        """One Gibbs pass over the d coordinates, every chain at the same
        coordinate; beta, eta and kstate change in place.  Returns (ld_cur,
        evaluations (C,))."""
        C, dev = beta.shape[0], beta.device
        adaptive = self._adaptive and (adapt or self._w_adapted)
        tuning = {**self.tuning, **chain_tuning}
        W = self._n_uniforms(tuning)
        chunk = max(1, min(self.d, _TABLE_ELEMS // max(1, C * W)))
        fx0 = torch.zeros(C, dtype=self.dtype, device=dev)
        nev = torch.zeros(C, dtype=torch.int32, device=dev)
        rate = self._adapt_rate
        table = None
        chain0 = self._chain0(C)
        for j in range(self.d):
            if W and j % chunk == 0:
                coords = torch.arange(j, min(j + chunk, self.d), device=dev)
                table = counter_uniforms(key, sweep, coords, C,
                                         torch.arange(W, device=dev),
                                         chain0=chain0)
            rng = SliceRNG(key, (sweep, j), C,
                           table=table[j % chunk] if W else None,
                           block=self._block_iters, stats=self.loop_stats,
                           chain0=chain0)
            beta_j = beta[:, j].clone()
            x_j = self.Xt[j]
            if self.kernel is None:
                b_new = self._conjugate_draw(rng, beta, j)
            else:
                jl = torch.full((C,), j, dtype=torch.int64, device=dev)
                tun = dict(tuning)
                if adaptive:  # the per-coordinate width, carried as log w
                    tun["w"] = torch.exp(kstate[:, j])
                if self._naive:
                    g = self._naive_target(beta, ld, j, jl, beta_j)
                else:
                    g = self._target_factory(beta, eta, ld, x_j, jl)
                res = self.kernel(rng, beta_j, g, state=kstate[:, j], fx0=fx0,
                                  **tun)
                b_new = res.x
                nev += res.n_evals
                if not adaptive:
                    kstate[:, j] = res.state
                elif adapt:
                    # Robbins-Monro in log space toward ~3x the accepted
                    # move; only in warmup (adapting while sampling would
                    # break detailed balance)
                    target = torch.log(3.0 * torch.abs(b_new - beta_j) + 1e-6)
                    kstate[:, j] = (1.0 - rate) * kstate[:, j] + rate * target
            # commit: the O(n) eta update and the refreshed density cache
            eta += x_j * (b_new - beta_j)[:, None]
            beta[:, j] = b_new
            ld = self.family.log_density_eta(eta, self.y, self.extra)
        return ld, nev

    # -- multi-sweep runs --------------------------------------------------

    def _run(self, state: ChainState, n_outer: int, thin: int, adapt: bool,
             moments: Optional[ChainMoments] = None):
        if self._adaptive and state.adapted != self._w_adapted:
            raise ValueError(
                "the state's kernel_state holds "
                + ("adapted log widths but the engine was reset" if
                   state.adapted else "no adapted widths but the engine "
                   "samples with warmup-adapted widths")
                + "; call init() for a fresh state (or warmup() it)"
            )
        beta = state.beta.clone()
        eta = state.eta.clone()
        kstate = state.kernel_state.clone()
        ld = state.ld_cur
        C = beta.shape[0]
        draws = torch.empty((C, n_outer, self.d), dtype=self.dtype,
                            device=self.device)
        nevs = torch.zeros((C, n_outer), dtype=torch.int32, device=self.device)
        sweep = state.sweep
        for o in range(int(n_outer)):
            for _ in range(int(thin)):
                ld, nev = self._sweep(beta, eta, ld, kstate, state.key, sweep,
                                      state.chain_tuning, adapt)
                sweep += 1
                self.loop_stats["sweeps"] += 1
                nevs[:, o] += nev
                if moments is not None:
                    moments = update_moments(moments, beta)
            draws[:, o] = beta
        new = state._replace(beta=beta, eta=eta, ld_cur=ld,
                             kernel_state=kstate, sweep=sweep)
        return new, draws, nevs, moments

    def run(self, state: ChainState, n_steps: int):
        """Advance every chain by ``n_steps`` sweeps.  Returns (state, betas
        (C, n_steps, d), n_evals (C, n_steps)) on the engine's device."""
        return self._run(state, n_steps, 1, adapt=False)[:3]

    def warmup(self, state: ChainState, n_steps: int):
        """Adaptive warmup: ``n_steps`` sweeps that tune a per-(chain,
        coordinate) stepping-out width toward ~3x the typical accepted move
        (Robbins-Monro in log space, carried in the kernel-state slot).
        Afterwards the engine samples with the tuned widths, frozen.  Other
        kernels just run.  A state that holds no log widths yet starts from
        log of the tuning ``w``."""
        if not self._adaptive:
            return self.run(state, n_steps)
        if not state.adapted:
            w0 = {**self.tuning, **state.chain_tuning}.get("w", 1.0)
            lw = torch.log(torch.as_tensor(w0, dtype=self.dtype,
                                           device=self.device))
            C = state.beta.shape[0]
            kstate = torch.broadcast_to(lw.reshape(-1, 1) if lw.dim() else lw,
                                        (C, self.d)).clone()
            state = state._replace(kernel_state=kstate, adapted=True)
        self._w_adapted = True
        return self._run(state, n_steps, 1, adapt=True)[:3]

    def reset_adaptation(self):
        """Return the engine to the un-adapted sampling mode.  ``run()``
        then refuses states whose kernel-state slot carries log widths, and
        samples fresh ``init()`` states with the static tuning."""
        self._w_adapted = False

    def run_thinned(self, state: ChainState, n_outer: int, thin: int,
                    moments: Optional[ChainMoments] = None):
        """Advance chains by ``n_outer * thin`` sweeps, keeping every
        ``thin``-th draw and accumulating per-chain Welford moments of
        every sweep on the device.  Returns (state, moments (count (C,),
        mean (C, d), m2 (C, d)), draws (C, n_outer, d), n_evals (C, n_outer)
        summed over each block of ``thin`` sweeps)."""
        C = state.beta.shape[0]
        if moments is None:
            zeros = torch.zeros((C, self.d), dtype=self.dtype,
                                device=self.device)
            moments = ChainMoments(
                count=torch.zeros(C, dtype=self.dtype, device=self.device),
                mean=zeros, m2=zeros.clone(),
            )
        state, draws, nevs, moments = self._run(state, n_outer, thin,
                                                adapt=False, moments=moments)
        return state, moments, draws, nevs

    def sample(self, seed: int, n_samples: int, n_chains: int = 1,
               chunk_size: int = 0, progress=None,
               chain_tuning: Optional[Mapping] = None):
        """Init from the prior, then ``n_samples`` sweeps.  Returns (betas
        (C, n_samples + 1, d), n_evals (C, n_samples), state) with numpy
        arrays; row 0 is the init draw.  ``chunk_size`` > 0 runs in chunks
        with a ``progress(done, total)`` call after each."""
        state = self.init(seed, n_chains, chain_tuning=chain_tuning)
        parts = [state.beta.cpu().numpy()[:, None, :]]
        nevs = []
        if chunk_size <= 0:
            chunk_size = n_samples
        done = 0
        while done < n_samples:
            step = min(chunk_size, n_samples - done)
            state, betas, n_evals = self.run(state, step)
            parts.append(betas.cpu().numpy())
            nevs.append(n_evals.cpu().numpy())
            done += step
            if progress is not None:
                progress(done, n_samples)
        n_evals = (np.concatenate(nevs, axis=1) if nevs
                   else np.zeros((n_chains, 0), np.int32))
        return np.concatenate(parts, axis=1), n_evals, state
