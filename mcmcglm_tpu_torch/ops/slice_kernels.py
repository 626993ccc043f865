"""Univariate slice-sampling kernels, batched over chains, in PyTorch.

Counterpart of ``mcmcglm_tpu/ops/slice_kernels.py``: Neal's (2003)
stepping-out and doubling samplers, the K-proposal stepping-out variant,
the elliptical (Murray, Adams & MacKay 2010) and generalized elliptical
(Nishihara, Murray & Adams 2014) samplers, the latent slice sampler (Li &
Walker 2020), the quantile slice sampler (Heiner, Johnson & Waller 2024)
and the registry (``SLICE_KERNELS``, ``register_slice_kernel``,
``get_slice_kernel``), with the JAX package's budgets (``max_stepouts``
128, ``max_shrink`` 64).

The JAX package writes each kernel for one chain and ``jax.vmap`` turns
every bounded ``lax.while_loop`` into a loop that runs until the slowest
lane finishes, finished lanes keeping their carry.  Here each kernel is
written for C chains at once: ``x0``, ``fx0`` and ``state`` are (C,), the
target maps (C,) proposals to (C,) log densities, and every rejection loop
is a :func:`masked_loop` whose idle lanes freeze their carry by selection
(``torch.where``, never by multiplication).  A lane's ``n_evals`` counts
its own evaluations only, as under vmap.

The loops run in blocks of ``rng.block`` masked iterations with one host
read of the loop's flag per block (``rng.stats`` counts them); an
iteration past a lane's end leaves it unchanged.  Randomness comes by
counter (:class:`SliceRNG`): draw slot t of chain c at coordinate j of
sweep s is Philox4x32-10 of (s, j, c, t), and a loop's iteration i reads
slot base + i.  Since a lane is active for iterations 0 .. n-1 of each loop
and idle after, iteration i is the lane's own i-th iteration, so the draws
and results depend neither on the block length nor on the device.

The user contract of a registered kernel is therefore batched:
``fn(rng, x0 (C,), log_target: (C,) -> (C,), state (C,), fx0 (C,),
**tuning) -> SliceResult`` of (C,) tensors, tuning values being numbers or
(C,) tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from .philox import counter_uniforms, key_tensor

__all__ = [
    "SliceResult",
    "SliceKernel",
    "SliceRNG",
    "SLICE_KERNELS",
    "get_slice_kernel",
    "masked_loop",
    "register_slice_kernel",
    "slice_stepping_out",
    "slice_stepping_out_batched",
    "slice_doubling",
    "slice_elliptical",
    "slice_genelliptical",
    "slice_latent",
    "slice_quantile",
]

# masked loop iterations per host read of the loop's flag: a block past a
# loop's end is wasted evaluations, a read is one host-device round trip
_BLOCK_ITERS = 2
# slots a stream draws at once past its drawn-ahead table (one Philox call
# is a few hundred small operations, whatever its width)
_LAZY_SLOTS = 32
# Marsaglia-Tsang candidates of genelliptical's Gamma draw: each is
# rejected with probability below 0.049, so all are with probability below
# 0.049**64 < 1e-83; exhausting them raises, no draw is approximated
_GAMMA_CANDIDATES = 64
# the Gamma draw's slots the engine draws ahead: the alpha < 1 boost and
# the first 8 candidates' two each (a ninth is needed with probability
# below 0.049**8 < 4e-11, and is drawn when read)
_GAMMA_AHEAD = 1 + 2 * 8


class SliceResult(NamedTuple):
    x: torch.Tensor  # (C,) the new points
    n_evals: torch.Tensor  # (C,) int32 target evaluations
    state: torch.Tensor  # (C,) carried kernel state (latent: bracket width)


class SliceRNG:
    """The random numbers and loop settings of one batched coordinate
    update.

    Slot t of chain c is Philox4x32-10 of the counter (w0, w1, c +
    ``chain0``, t) under ``key``: the lockstep engine puts (sweep,
    coordinate) in (w0, w1), and a chain shard whose first chain is the
    global chain ``chain0`` draws the global chains' streams.
    ``table`` (C, W), when given, holds slots 0 .. W-1 drawn ahead (the
    engine draws a chunk of coordinates in one call); a slot past it is
    drawn when read, with the same value, in blocks of ``_LAZY_SLOTS``
    slots kept for the next reads.  ``block`` is the loops' iterations per
    host read of their flag, ``stats`` a dict whose ``flag_reads`` the
    loops add to.
    """

    def __init__(self, key, words, n_chains: int, *, table=None,
                 block: int = _BLOCK_ITERS, stats: Optional[dict] = None,
                 offset: int = 0, chain0: int = 0,
                 _lazy: Optional[dict] = None):
        self.key = key
        self.words = words
        self.n_chains = int(n_chains)
        self.chain0 = int(chain0)
        self.table = table
        self.block = int(block)
        self.stats = stats if stats is not None else {"flag_reads": 0}
        self.offset = offset
        self._lazy = {} if _lazy is None else _lazy  # block index -> (C, 32)

    @classmethod
    def from_seed(cls, seed: int, step: int, n_chains: int, *, device,
                  **kw) -> "SliceRNG":
        """The stream of ``seed`` at step ``step`` (counter words (step,
        0)) on ``device``: for driving a kernel outside an engine."""
        return cls(key_tensor(seed, device), (int(step), 0), n_chains, **kw)

    def uniforms(self, t: int, k: int) -> torch.Tensor:
        """(C, k) float32 uniforms of slots t .. t + k - 1."""
        t = t + self.offset
        if self.table is not None and t + k <= self.table.shape[1]:
            return self.table[:, t:t + k]
        first, last = t // _LAZY_SLOTS, (t + k - 1) // _LAZY_SLOTS
        for b in range(first, last + 1):
            if b not in self._lazy:
                slots = torch.arange(b * _LAZY_SLOTS, (b + 1) * _LAZY_SLOTS,
                                     device=self.key.device)
                self._lazy[b] = counter_uniforms(
                    self.key, self.words[0], self.words[1], self.n_chains,
                    slots, chain0=self.chain0)
        got = torch.cat([self._lazy[b] for b in range(first, last + 1)], 1)
        s = t - first * _LAZY_SLOTS
        return got[:, s:s + k]

    def uniform(self, t: int) -> torch.Tensor:
        """(C,) float32 uniforms of slot t, in [1e-12, 1 - 2^-23]."""
        return self.uniforms(t, 1)[:, 0]

    def shifted(self, k: int) -> "SliceRNG":
        """A view of the same stream whose slot t is this one's t + k."""
        return SliceRNG(self.key, self.words, self.n_chains, table=self.table,
                        block=self.block, stats=self.stats,
                        offset=self.offset + k, chain0=self.chain0,
                        _lazy=self._lazy)


def _freeze(act, new, old):
    out = []
    for n, o in zip(new, old):
        a = act if n.dim() == act.dim() else act.reshape(
            act.shape + (1,) * (n.dim() - act.dim()))
        out.append(torch.where(a, n, o))
    return tuple(out)


def masked_loop(rng: SliceRNG, cond: Callable, body: Callable, carry: tuple,
                max_iters: int):
    """The batched ``while cond: carry = body(it, carry)``.

    Iteration it = 0, 1, ... < ``max_iters`` computes ``body(it, carry)``
    for every lane and keeps it where ``cond(carry)`` held before it (the
    other lanes freeze); ``carry`` is a tuple of tensors with the leading
    axes of ``cond``'s mask ((C,), or (C, 2) for two independent loops
    per chain run side by side).  After each block of ``rng.block``
    iterations one host read of ``cond(carry).any()`` decides whether to
    go on.  Returns ``(carry, active)``, ``active`` True when some lane
    was still active as the iterations ran out."""
    it = 0
    while True:
        stop = min(it + rng.block, max_iters)
        while it < stop:
            carry = _freeze(cond(carry), body(it, carry), carry)
            it += 1
        active = bool(cond(carry).any())  # the block's one host read
        rng.stats["flag_reads"] = rng.stats.get("flag_reads", 0) + 1
        if not active or it >= max_iters:
            return carry, active


def _num(v, like):
    """A tuning value as a Python number or a tensor of ``like``'s dtype
    and device."""
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device)
    return float(v)


def _u(rng, t, like):
    return rng.uniform(t).to(like.dtype)


def _start(x0, log_target, fx0):
    """(fx0, evaluations spent on it) as (C,) tensors."""
    if fx0 is None:
        return log_target(x0), torch.ones_like(x0, dtype=torch.int32)
    return fx0.to(x0.dtype), torch.zeros_like(x0, dtype=torch.int32)


def _level(rng, fx0, slot=0):
    """Slice level on the log scale: f(x0) - Exp(1)."""
    return fx0 + torch.log1p(-_u(rng, slot, fx0))


def _vectorised(log_target):
    """The target on (C, K) proposals: one call when it takes them
    (``batched``), else K calls."""
    if getattr(log_target, "batched", False):
        return log_target
    return lambda xs: torch.stack(
        [log_target(xs[:, k]) for k in range(xs.shape[1])], 1)


def _shrink(rng, x0, log_target, level, L, R, max_shrink, base):
    """Neal's shrinkage toward x0 on (L, R): iteration i draws slot base +
    i.  Returns (x, accepted, evaluations)."""
    def cond(c):
        return ~c[3]

    def body(it, c):
        L, R, _, _, n = c
        x1 = L + (R - L) * _u(rng, base + it, x0)
        ok = log_target(x1) >= level
        return (torch.where(~ok & (x1 < x0), x1, L),
                torch.where(~ok & (x1 >= x0), x1, R), x1, ok, n + 1)

    zero = torch.zeros_like(x0, dtype=torch.int32)
    (_, _, x1, acc, n), _ = masked_loop(
        rng, cond, body, (L, R, x0, torch.zeros_like(x0, dtype=torch.bool),
                          zero), max_shrink)
    return x1, acc, n


# --------------------------------------------------------------------------
# Stepping-out + shrinkage (Neal 2003, Fig. 3 + Fig. 5)
# --------------------------------------------------------------------------

def slice_stepping_out(rng, x0, log_target: Callable, w,
                       max_stepouts: int = 128, max_shrink: int = 64,
                       fx0=None, state=None) -> SliceResult:
    """Neal (2003) stepping-out slice sampler: the width-``w`` interval
    placed at random around x0, a step-out budget m = ``max_stepouts``
    split at random between the two directions (J = floor(m u), K = m - 1
    - J), then shrinkage bounded by ``max_shrink`` (on exhaustion the lane
    keeps x0).  The two directions step out side by side, as one masked
    loop over (C, 2) endpoints (each direction of each lane frozen by its
    own condition, so the ends and counts are the sequential ones).
    Slots: 0 level, 1 position, 2 budget split, 3 + i shrink iteration
    i."""
    del state
    w = _num(w, x0)
    g_vec = _vectorised(log_target)
    fx0, n0 = _start(x0, log_target, fx0)
    level = _level(rng, fx0)
    L0 = x0 - w * _u(rng, 1, x0)
    m = int(max_stepouts)
    J = torch.floor(rng.uniform(2) * m).to(torch.int32)
    ends0 = torch.stack([L0, L0 + w], 1)  # (C, 2): left, right
    budget0 = torch.stack([J, (m - 1) - J], 1)
    wc = w if torch.is_tensor(w) else torch.full_like(x0, w)
    step = torch.stack([-wc, wc], 1)
    lev = level[:, None]

    def cond(c):
        return (c[1] > 0) & (c[2] > lev)

    def body(it, c):
        ends = c[0] + step
        return ends, c[1] - 1, g_vec(ends), c[3] + 1

    (ends, _, _, n), _ = masked_loop(
        rng, cond, body,
        (ends0, budget0, g_vec(ends0), torch.ones_like(budget0)), m)
    x1, acc, nS = _shrink(rng, x0, log_target, level, ends[:, 0],
                          ends[:, 1], max_shrink, 3)
    n_evals = n0 + n.sum(1, dtype=torch.int32) + nS
    return SliceResult(torch.where(acc, x1, x0), n_evals, torch.zeros_like(x0))


# --------------------------------------------------------------------------
# K proposals per round: the same stationary kernel as slice_stepping_out
# --------------------------------------------------------------------------

def slice_stepping_out_batched(rng, x0, log_target: Callable, w, K: int = 8,
                               max_stepouts: int = 128,
                               max_shrink_rounds: int = 16, fx0=None,
                               state=None) -> SliceResult:
    """Neal's stepping-out kernel with K target evaluations per round.
    Stepping out evaluates K/2 candidate endpoints per direction and keeps
    the first at or below the level (capped by the budget split); each
    shrink round draws K points on the round-start interval and folds them
    through Neal's shrink automaton in order, skipping a point outside the
    already-shrunk interval (a uniform draw on [L, R] conditioned on [L',
    R'] is uniform on [L', R']).  ``n_evals`` counts K per round the lane
    was active.  A target with ``batched`` True is called once per round on
    (C, K) proposals.  Slots: 0 level, 1 position, 2 split, 3 + K r + k
    point k of shrink round r."""
    del state
    K = int(K)
    if K < 2:
        raise ValueError(f"slice_stepping_out_batched needs K >= 2, got {K}")
    w = _num(w, x0)
    wc = w[:, None] if torch.is_tensor(w) and w.dim() else w
    KL, KR = K // 2, K - K // 2
    g_vec = _vectorised(log_target)
    fx0, n0 = _start(x0, log_target, fx0)
    level = _level(rng, fx0)
    L0 = x0 - w * _u(rng, 1, x0)
    R0 = L0 + w
    m = int(max_stepouts)
    J = torch.floor(rng.uniform(2) * m).to(torch.int32)
    Kbud = (m - 1) - J
    dev = x0.device
    iotaL = torch.arange(KL, dtype=torch.int32, device=dev)
    iotaR = torch.arange(KR, dtype=torch.int32, device=dev)

    def so_cond(c):
        return ~c[2] | ~c[3]

    def so_body(it, c):
        mL, mR, foundL, foundR, tL, tR, nev = c
        idxL = mL[:, None] + iotaL
        idxR = mR[:, None] + iotaR
        cand = torch.cat([L0[:, None] - idxL.to(x0.dtype) * wc,
                          R0[:, None] + idxR.to(x0.dtype) * wc], 1)
        f = g_vec(cand)
        belowL = f[:, :KL] <= level[:, None]
        anyL = belowL.any(1)
        firstL = mL + torch.argmax(belowL.to(torch.int32), 1).to(torch.int32)
        tL_round = torch.where(anyL, torch.minimum(firstL, J), J)
        doneL = anyL | ((mL + KL) > J)
        belowR = f[:, KL:] <= level[:, None]
        anyR = belowR.any(1)
        firstR = mR + torch.argmax(belowR.to(torch.int32), 1).to(torch.int32)
        tR_round = torch.where(anyR, torch.minimum(firstR, Kbud), Kbud)
        doneR = anyR | ((mR + KR) > Kbud)
        return (mL + KL, mR + KR, foundL | doneL, foundR | doneR,
                torch.where(~foundL & doneL, tL_round, tL),
                torch.where(~foundR & doneR, tR_round, tR), nev + K)

    zi = torch.zeros_like(x0, dtype=torch.int32)
    zb = torch.zeros_like(x0, dtype=torch.bool)
    (_, _, _, _, tL, tR, n_so), _ = masked_loop(
        rng, so_cond, so_body, (zi, zi, zb, zb, zi, zi, zi), m // KL + 2)
    L = L0 - tL.to(x0.dtype) * w
    R = R0 + tR.to(x0.dtype) * w

    def sh_cond(c):
        return ~c[3]

    def sh_body(it, c):
        L, R, bnew, accepted, nev = c
        us = rng.uniforms(3 + K * it, K).to(x0.dtype)
        xs = L[:, None] + (R - L)[:, None] * us
        fs = g_vec(xs)
        for k in range(K):
            xk, fk = xs[:, k], fs[:, k]
            use = (xk >= L) & (xk <= R) & ~accepted
            ok = fk >= level
            bnew = torch.where(use & ok, xk, bnew)
            shrink = use & ~ok
            L = torch.where(shrink & (xk < x0), xk, L)
            R = torch.where(shrink & (xk >= x0), xk, R)
            accepted = accepted | (use & ok)
        return L, R, bnew, accepted, nev + K

    (_, _, bnew, acc, n_sh), _ = masked_loop(
        rng, sh_cond, sh_body, (L, R, x0, zb, zi), int(max_shrink_rounds))
    return SliceResult(torch.where(acc, bnew, x0), n0 + n_so + n_sh,
                       torch.zeros_like(x0))


# --------------------------------------------------------------------------
# Doubling + shrinkage with the acceptability check (Neal 2003, Fig. 4 + 6)
# --------------------------------------------------------------------------

def slice_doubling(rng, x0, log_target: Callable, w, max_doublings: int = 32,
                   max_shrink: int = 64, fx0=None, state=None) -> SliceResult:
    """Neal (2003) doubling: the interval doubles toward a random side
    until both ends are below the level or ``max_doublings`` are spent;
    shrinkage proposals must also pass the Fig. 6 back-test.  Slots: 0
    level, 1 position, 2 + p side of doubling p, 2 + max_doublings + i
    shrink iteration i."""
    del state
    w = _num(w, x0)
    fx0, n0 = _start(x0, log_target, fx0)
    level = _level(rng, fx0)
    L0 = x0 - w * _u(rng, 1, x0)
    R0 = L0 + w
    p_max = int(max_doublings)

    def dbl_cond(c):
        return (c[2] > level) | (c[3] > level)

    def dbl_body(it, c):
        L, R, fL, fR, n = c
        go_left = rng.uniform(2 + it) < 0.5
        width = R - L
        newL = torch.where(go_left, L - width, L)
        newR = torch.where(go_left, R, R + width)
        f_new = log_target(torch.where(go_left, newL, newR))
        return (newL, newR, torch.where(go_left, f_new, fL),
                torch.where(go_left, fR, f_new), n + 1)

    two = torch.full_like(x0, 2, dtype=torch.int32)
    (L, R, _, _, n_dbl), _ = masked_loop(
        rng, dbl_cond, dbl_body,
        (L0, R0, log_target(L0), log_target(R0), two), p_max)
    zi = torch.zeros_like(x0, dtype=torch.int32)
    zb = torch.zeros_like(x0, dtype=torch.bool)

    def acceptable(x1, live):
        """Fig. 6 back-test for the lanes in ``live``; two evaluations per
        halving."""
        def cond(c):
            return live & ~c[3] & ((c[1] - c[0]) > 1.1 * w)

        def body(it, c):
            hatL, hatR, ok, done, n = c
            M = 0.5 * (hatL + hatR)
            D = ((x0 < M) & (x1 >= M)) | ((x0 >= M) & (x1 < M))
            go_left = x1 < M
            newL = torch.where(go_left, hatL, M)
            newR = torch.where(go_left, M, hatR)
            fail = D & (log_target(newL) <= level) & (log_target(newR) <= level)
            return newL, newR, ok & ~fail, done | fail, n + 2

        (_, _, ok, _, n), _ = masked_loop(
            rng, cond, body, (L, R, ~zb, zb, zi), p_max + 2)
        return ok, n

    base = 2 + p_max

    def sh_cond(c):
        return ~c[3]

    def sh_body(it, c):
        Lb, Rb, _, accepted, n = c
        x1 = Lb + (Rb - Lb) * _u(rng, base + it, x0)
        ok_level = log_target(x1) >= level
        ok_accept, n_acc = acceptable(x1, ~accepted)
        ok = ok_level & ok_accept
        return (torch.where(~ok & (x1 < x0), x1, Lb),
                torch.where(~ok & (x1 >= x0), x1, Rb), x1, ok, n + 1 + n_acc)

    (_, _, x1, acc, n_sh), _ = masked_loop(
        rng, sh_cond, sh_body, (L, R, x0, zb, zi), int(max_shrink))
    return SliceResult(torch.where(acc, x1, x0), n0 + n_dbl + n_sh,
                       torch.zeros_like(x0))


# --------------------------------------------------------------------------
# Elliptical slice sampler (Murray, Adams & MacKay 2010), univariate with a
# N(mu, sigma^2) auxiliary
# --------------------------------------------------------------------------

def slice_elliptical(rng, x0, log_target: Callable, mu, sigma,
                     max_shrink: int = 64, fx0=None,
                     state=None) -> SliceResult:
    """Elliptical slice sampling on the ellipse through x0 and nu ~ N(mu,
    sigma^2), shrinking the angle bracket (theta0 - 2 pi, theta0) toward
    0.  Slots: 0 level, 1 nu's normal score, 2 theta0, 3 + i the angle
    after shrink iteration i."""
    del state
    mu = _num(mu, x0)
    sigma = _num(sigma, x0)
    fx0, n0 = _start(x0, log_target, fx0)
    level = _level(rng, fx0)
    nu = mu + sigma * torch.special.ndtri(_u(rng, 1, x0))
    two_pi = 2.0 * math.pi
    theta0 = _u(rng, 2, x0) * two_pi

    def cond(c):
        return ~c[4]

    def body(it, c):
        lo, hi, theta, _, _, n = c
        x1 = (x0 - mu) * torch.cos(theta) + (nu - mu) * torch.sin(theta) + mu
        ok = log_target(x1) >= level
        new_lo = torch.where(~ok & (theta < 0), theta, lo)
        new_hi = torch.where(~ok & (theta >= 0), theta, hi)
        new_theta = new_lo + (new_hi - new_lo) * _u(rng, 3 + it, x0)
        return new_lo, new_hi, new_theta, x1, ok, n + 1

    zi = torch.zeros_like(x0, dtype=torch.int32)
    zb = torch.zeros_like(x0, dtype=torch.bool)
    (_, _, _, x1, acc, n_it), _ = masked_loop(
        rng, cond, body, (theta0 - two_pi, theta0, theta0, x0, zb, zi),
        int(max_shrink))
    return SliceResult(torch.where(acc, x1, x0), n0 + n_it,
                       torch.zeros_like(x0))


def _standard_gamma(rng, alpha, like):
    """Gamma(alpha, 1) draws by Marsaglia & Tsang (2000) as a masked
    rejection loop: candidate i takes the normal score of slot 1 + 2i and
    the acceptance uniform of slot 2 + 2i; for alpha < 1 the draw is
    Gamma(alpha + 1) U^(1/alpha), U from slot 0."""
    alpha = torch.as_tensor(alpha, dtype=like.dtype,
                            device=like.device).expand_as(like)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    dd = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * dd)

    def cond(cr):
        return ~cr[1]

    def body(it, cr):
        x = torch.special.ndtri(_u(rng, 1 + 2 * it, like))
        v = (1.0 + c * x) ** 3
        logv = torch.log(torch.clamp(v, min=torch.finfo(like.dtype).tiny))
        ok = (v > 0) & (torch.log(_u(rng, 2 + 2 * it, like))
                        < 0.5 * x * x + dd - dd * v + dd * logv)
        return dd * v, ok

    (g, _), active = masked_loop(
        rng, cond, body,
        (torch.ones_like(like), torch.zeros_like(like, dtype=torch.bool)),
        _GAMMA_CANDIDATES)
    if active:
        raise RuntimeError(
            f"a Gamma draw rejected all {_GAMMA_CANDIDATES} Marsaglia-Tsang "
            "candidates (genelliptical); no draw was approximated"
        )
    return torch.where(boost, g * _u(rng, 0, like) ** (1.0 / alpha), g)


def slice_genelliptical(rng, x0, log_target: Callable, mu, sigma, df,
                        max_shrink: int = 64, fx0=None,
                        state=None) -> SliceResult:
    """Draws the t auxiliary's mixing scale given x0,
        lambda | x0 ~ Gamma((df + 1)/2, rate=(df + ((x0 - mu)/sigma)^2)/2),
    then one elliptical update with scale sigma / sqrt(lambda).  Slots: the
    elliptical update's 0 .. 2 + max_shrink, then the Gamma draw's."""
    mu = _num(mu, x0)
    sigma = _num(sigma, x0)
    df = _num(df, x0)
    z2 = ((x0 - mu) / sigma) ** 2
    lam = _standard_gamma(rng.shifted(3 + int(max_shrink)),
                          (df + 1.0) / 2.0, x0) / ((df + z2) / 2.0)
    return slice_elliptical(rng, x0, log_target, mu, sigma * torch.rsqrt(lam),
                            max_shrink=max_shrink, fx0=fx0, state=state)


# --------------------------------------------------------------------------
# Latent slice sampler (Li & Walker 2020): a carried bracket width s
# --------------------------------------------------------------------------

def slice_latent(rng, x0, log_target: Callable, rate=0.3,
                 max_shrink: int = 64, fx0=None, state=None) -> SliceResult:
    """The bracket width s is itself sampled: the latent midpoint l ~ U(x0
    - s/2, x0 + s/2), then s' = 2|l - x0| + Exp(rate), then shrinkage on
    (l - s'/2, l + s'/2).  ``state`` carries s (1/rate when None).  Slots:
    0 level, 1 midpoint, 2 the Exp, 3 + i shrink iteration i."""
    rate = _num(rate, x0)
    s = (1.0 / rate) if state is None else state.to(x0.dtype)
    fx0, n0 = _start(x0, log_target, fx0)
    level = _level(rng, fx0)
    lat = x0 + s * (_u(rng, 1, x0) - 0.5)
    s_new = 2.0 * torch.abs(lat - x0) - torch.log1p(-_u(rng, 2, x0)) / rate
    x1, acc, n_it = _shrink(rng, x0, log_target, level, lat - s_new / 2.0,
                            lat + s_new / 2.0, max_shrink, 3)
    return SliceResult(torch.where(acc, x1, x0), n0 + n_it, s_new)


# --------------------------------------------------------------------------
# Quantile slice sampler (Heiner, Johnson & Waller 2024): shrinkage on the
# unit interval through a pseudo-target's CDF
# --------------------------------------------------------------------------

def slice_quantile(rng, x0, log_target: Callable, pseudo_loc=0.0,
                   pseudo_scale=1.0, pseudo_family: str = "cauchy",
                   max_shrink: int = 64, fx0=None,
                   state=None) -> SliceResult:
    """Quantile slice sampling with a normal or cauchy pseudo-target psi
    (CDF F): the transformed target h(u) = f(F^-1(u)) / psi(F^-1(u)) is
    shrunk on (0, 1) around u0 = F(x0).  Slots: 0 level, 1 + i shrink
    iteration i."""
    del state
    loc = _num(pseudo_loc, x0)
    scale = _num(pseudo_scale, x0)
    if pseudo_family == "normal":
        def cdf(x):
            return torch.special.ndtr((x - loc) / scale)

        def ppf(u):
            return loc + scale * torch.special.ndtri(u)

        log_scale = (torch.log(scale) if torch.is_tensor(scale)
                     else math.log(scale))

        def logpdf(x):
            z = (x - loc) / scale
            return -0.5 * z * z - log_scale - 0.5 * math.log(2.0 * math.pi)
    elif pseudo_family == "cauchy":
        def cdf(x):
            return 0.5 + torch.atan((x - loc) / scale) / math.pi

        def ppf(u):
            return loc + scale * torch.tan(math.pi * (u - 0.5))

        def logpdf(x):
            z = (x - loc) / scale
            return -torch.log(math.pi * scale * (1.0 + z * z))
    else:
        raise ValueError("pseudo_family must be 'normal' or 'cauchy'")
    eps = 1e-7
    u0 = torch.clamp(cdf(x0), eps, 1.0 - eps)
    fx0, n0 = _start(x0, log_target, fx0)
    level = _level(rng, fx0 - logpdf(x0))

    def cond(c):
        return ~c[3]

    def body(it, c):
        lo, hi, _, _, n = c
        u1 = lo + (hi - lo) * _u(rng, 1 + it, x0)
        x1 = ppf(torch.clamp(u1, eps, 1.0 - eps))
        ok = (log_target(x1) - logpdf(x1)) >= level
        return (torch.where(~ok & (u1 < u0), u1, lo),
                torch.where(~ok & (u1 >= u0), u1, hi), x1, ok, n + 1)

    zi = torch.zeros_like(x0, dtype=torch.int32)
    zb = torch.zeros_like(x0, dtype=torch.bool)
    (_, _, x1, acc, n_it), _ = masked_loop(
        rng, cond, body,
        (torch.zeros_like(x0), torch.ones_like(x0), x0, zb, zi),
        int(max_shrink))
    return SliceResult(torch.where(acc, x1, x0), n0 + n_it,
                       torch.zeros_like(x0))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SliceKernel:
    """A named kernel, the tuning names it requires, its initial state
    (tuning dict -> number or (C,) tensor) and the uniform slots it can
    read under its budgets (tuning dict -> int; the lockstep engine draws
    them ahead by chunks of coordinates; None: it draws ``_LAZY_SLOTS``
    ahead)."""

    name: str
    fn: Callable
    required: tuple
    state_init: Optional[Callable] = None
    n_uniforms: Optional[Callable] = None

    def __call__(self, rng, x0, log_target, state=None, fx0=None, **tuning):
        return self.fn(rng, x0, log_target, fx0=fx0, state=state, **tuning)

    def init_state(self, tuning):
        if self.state_init is None:
            return 0.0
        return self.state_init(tuning)


SLICE_KERNELS: dict = {}


def register_slice_kernel(kernel: SliceKernel) -> SliceKernel:
    SLICE_KERNELS[kernel.name] = kernel
    return kernel


def get_slice_kernel(name_or_kernel) -> SliceKernel:
    if isinstance(name_or_kernel, SliceKernel):
        return name_or_kernel
    if callable(name_or_kernel) and not isinstance(name_or_kernel, str):
        # a bare function: wrapped with no required-tuning validation
        return SliceKernel(getattr(name_or_kernel, "__name__", "custom"),
                           name_or_kernel, ())
    try:
        return SLICE_KERNELS[name_or_kernel]
    except KeyError:
        raise ValueError(
            f"unknown slice kernel {name_or_kernel!r}; known: "
            f"{sorted(SLICE_KERNELS)}"
        ) from None


def _shrinks(base):
    return lambda t: base + int(t.get("max_shrink", 64))


register_slice_kernel(SliceKernel("stepping_out", slice_stepping_out, ("w",),
                                  n_uniforms=_shrinks(3)))
register_slice_kernel(SliceKernel(
    "stepping_out_batched", slice_stepping_out_batched, ("w",),
    n_uniforms=lambda t: 3 + int(t.get("K", 8)) * int(
        t.get("max_shrink_rounds", 16))))
register_slice_kernel(SliceKernel(
    "doubling", slice_doubling, ("w",),
    n_uniforms=lambda t: 2 + int(t.get("max_doublings", 32)) + int(
        t.get("max_shrink", 64))))
register_slice_kernel(SliceKernel("elliptical", slice_elliptical,
                                  ("mu", "sigma"), n_uniforms=_shrinks(3)))
register_slice_kernel(SliceKernel("genelliptical", slice_genelliptical,
                                  ("mu", "sigma", "df"),
                                  n_uniforms=_shrinks(3 + _GAMMA_AHEAD)))
register_slice_kernel(SliceKernel("quantile", slice_quantile, (),
                                  n_uniforms=_shrinks(1)))
register_slice_kernel(SliceKernel(
    "latent", slice_latent, (),
    state_init=lambda tuning: 1.0 / tuning.get("rate", 0.3),
    n_uniforms=_shrinks(3)))
