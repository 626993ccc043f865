"""Pooled streaming diagnostics: per-chain Welford moments and the
streaming split-chain ESS accumulator, on the device.

Counterpart of ``mcmcglm_tpu/parallel/pooled.py``:

  * per-chain Welford moment accumulators (a (C, d) mean/m2 pair, O(C d)
    state whatever the run length) and the pooled mean, variance and
    (non-split) R-hat computed from them;
  * :class:`ESSState`, which streams the estimator of ``diagnostics.ess``
    (split-chain halves, per-chain autocovariance, Stan's cross-chain
    combination, Geyer's initial monotone positive sequence) up to a
    fixed maximum lag L, one kept draw at a time, so min-ESS needs no
    (C, K, d) draw tensor on the host;
  * :func:`ess_device`, the same estimator from a resident (C, K, d)
    draws buffer;
  * :func:`fold_moments` and :func:`update_ess_block`, a block of K
    consecutive draws folded into either at once (``run_thinned`` at
    thin=1 folds its one call's draws so).

Per (chain, half) the centered autocovariance at lag l needs the raw
lagged cross products S_l, the sums of the first l and last l draws and
the total: three (C, 2, L, d) buffers plus totals.

Across ranks: a sharded engine's moments and ESS state hold its own
chains.  :func:`merge_moments` and :func:`merge_ess` gather them over a
chain group (the JAX package's chain-sharded arrays, whose reductions XLA
turns into psums), and ``pooled_summary`` / ``ess_from_state`` take
``group=`` to summarise all chains of the mesh.

Spans (``utils/profiling.py``): each gather of a merge is a
``pooled.merge`` span (arguments ``bytes``, what this rank sends, and
``ranks``), and the combination that follows in ``pooled_summary`` and
``ess_from_state`` a ``pooled.summary`` span; both close once the card
has finished (:func:`~..utils.profiling.synced_span`).  ``merge_counts``
counts the gathers and the bytes this rank sent and received.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..utils.profiling import synced_span
from .mesh import gather_chains

__all__ = [
    "ChainMoments",
    "init_moments",
    "update_moments",
    "fold_moments",
    "pooled_summary",
    "ESSState",
    "init_ess",
    "update_ess",
    "update_ess_block",
    "ess_from_state",
    "ess_device",
    "merge_ess",
    "merge_moments",
    "merge_counts",
]

# gathers of moments and ESS state, and the bytes this rank sent and
# received in them, since the process started
merge_counts = {"gathers": 0, "bytes_sent": 0, "bytes_received": 0}


class ChainMoments(NamedTuple):
    count: torch.Tensor  # () draws per chain, or (C,) per chain
    mean: torch.Tensor  # (C, d)
    m2: torch.Tensor  # (C, d)


def init_moments(n_chains: int, d: int, dtype=torch.float32, *,
                 device) -> ChainMoments:
    return ChainMoments(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros((n_chains, d), dtype=dtype, device=device),
        m2=torch.zeros((n_chains, d), dtype=dtype, device=device),
    )


def update_moments(m: ChainMoments, beta: torch.Tensor) -> ChainMoments:
    """Welford update with one draw per chain: beta (C, d); ``count`` a
    scalar or per chain (C,)."""
    count = m.count + 1.0
    delta = beta - m.mean
    mean = m.mean + delta / (count[:, None] if count.dim() else count)
    m2 = m.m2 + delta * (beta - mean)
    return ChainMoments(count, mean, m2)


def fold_moments(m: ChainMoments, draws: torch.Tensor) -> ChainMoments:
    """Chan's merge of a block of K draws per chain, draws (C, K, d),
    into the moments: the block's own mean and sum of squared deviations,
    then one pairwise combination (K Welford updates in exact
    arithmetic); ``count`` a scalar or per chain (C,)."""
    K = float(draws.shape[1])
    mu = torch.mean(draws, dim=1)  # (C, d)
    m2_b = torch.sum((draws - mu[:, None, :]) ** 2, dim=1)
    count = m.count + K
    w, wc = K / count, m.count * K / count
    if count.dim():
        w, wc = w[:, None], wc[:, None]
    delta = mu - m.mean
    return ChainMoments(count, m.mean + delta * w,
                        m.m2 + m2_b + delta * delta * wc)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`.mesh.gather_chains` in a ``pooled.merge`` span, counted."""
    ranks = dist.get_world_size(group)
    nbytes = t.numel() * t.element_size()
    with synced_span("pooled.merge", t.device, bytes=nbytes, ranks=ranks):
        out = gather_chains(t, group)
    merge_counts["gathers"] += 1
    merge_counts["bytes_sent"] += nbytes
    merge_counts["bytes_received"] += nbytes * ranks
    return out


def merge_moments(m: ChainMoments, group) -> ChainMoments:
    """The moments of every chain of ``group`` (a sharded engine's
    ``chain_group``), in chain order; a scalar ``count`` stays one."""
    count = m.count if m.count.dim() == 0 else _gather(m.count, group)
    return ChainMoments(count, _gather(m.mean, group), _gather(m.m2, group))


def pooled_summary(m: ChainMoments, group=None):
    """Pooled posterior mean, variance and (non-split) R-hat per
    parameter, (d,) each.  ``count`` may be a scalar (every chain holds
    the same number of draws) or per-chain (C,) (the free-running
    engine's ``run_thinned``).  ``group``: merge a shard's moments over
    the chain group first (:func:`merge_moments`)."""
    if group is not None:
        m = merge_moments(m, group)
    with synced_span("pooled.summary", m.mean.device,
                     C=int(m.mean.shape[0])):
        return _summary(m)


def _summary(m: ChainMoments) -> dict:
    C = m.mean.shape[0]
    if m.count.dim() == 1:
        Kc = m.count[:, None]
        K = torch.mean(m.count)
    else:
        Kc = m.count
        K = m.count
    chain_var = m.m2 / torch.clamp(Kc - 1.0, min=1.0)  # (C, d)
    W = torch.mean(chain_var, dim=0)
    grand_mean = torch.mean(m.mean, dim=0)
    if C > 1:
        B = K * torch.sum((m.mean - grand_mean) ** 2, dim=0) / (C - 1.0)
    else:
        B = torch.zeros_like(W)
    var_plus = (K - 1.0) / K * W + B / K
    rhat = torch.sqrt(var_plus / torch.clamp(W, min=1e-30))
    pooled_var = var_plus + torch.sum((m.mean - grand_mean) ** 2, dim=0) / C
    return {
        "mean": grand_mean,
        "var": pooled_var,
        "rhat": rhat,
        "within_var": W,
        "between_var": B,
        "draws_per_chain": K,
    }


class ESSState(NamedTuple):
    """Streaming split-chain autocovariance state.

    Shapes: s/ring/first (C, 2, L, d); total (C, 2, d); count () int32
    (draws seen so far); planned () int32 (kept draws this collection,
    fixed up front so the split-half boundary is known)."""

    s: torch.Tensor
    ring: torch.Tensor
    first: torch.Tensor
    total: torch.Tensor
    count: torch.Tensor
    planned: torch.Tensor


def init_ess(n_chains: int, d: int, planned: int, max_lag: int = 64,
             dtype=torch.float32, *, device) -> ESSState:
    """Fresh accumulator for ``planned`` kept draws per chain; the window
    ``max_lag`` is clamped to ``planned // 2`` (and at least 2)."""
    L = max(2, min(int(max_lag), int(planned) // 2))
    z = torch.zeros((n_chains, 2, L, d), dtype=dtype, device=device)
    return ESSState(
        s=z, ring=z, first=z,
        total=torch.zeros((n_chains, 2, d), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        planned=torch.full((), int(planned), dtype=torch.int32,
                           device=device),
    )


def update_ess(st: ESSState, x: torch.Tensor) -> ESSState:
    """Accumulate one kept draw x (C, d) into its split half: with
    half = planned // 2, draws t < half feed half 0, draws
    t >= planned - half feed half 1, and the middle draw of an odd-length
    collection feeds neither."""
    C, _, L, d = st.s.shape
    dtype = st.s.dtype
    t = st.count
    half = st.planned // 2
    in0 = t < half
    in1 = t >= st.planned - half
    seg_t = torch.where(in0, t, t - (st.planned - half))
    gate = (in0 | in1).to(dtype)
    seg = torch.where(in0, 0, 1).long()
    seg_mask = (torch.nn.functional.one_hot(seg, 2).to(dtype)
                * gate)[None, :, None, None]  # (1, 2, 1, 1)
    xb = x[:, None, None, :]  # (C, 1, 1, d)
    # lag-ordered ring: after the shift, ring[:, :, l] holds x_{t-l}
    ring_new = torch.cat([xb.expand(C, 2, 1, d), st.ring[:, :, :-1]], dim=2)
    ring = st.ring + seg_mask * (ring_new - st.ring)
    lags = torch.arange(L, device=x.device)[None, None, :, None]
    lag_ok = (lags <= seg_t).to(dtype)
    s = st.s + seg_mask * lag_ok * (xb * ring)
    row_hit = (lags == seg_t).to(dtype) * seg_mask
    first = st.first + row_hit * (xb - st.first)
    total = st.total + seg_mask[:, :, 0, :] * xb[:, :, 0, :]
    return st._replace(s=s, ring=ring, first=first, total=total,
                       count=t + 1)


def update_ess_block(st: ESSState, xs: torch.Tensor) -> ESSState:
    """Accumulate K consecutive kept draws xs (C, K, d) at once: the state
    that K calls of :func:`update_ess` leave, up to the order of the sums.
    Each half's draws of the block are placed after the half's ring (its
    last L draws, oldest first); the lag-l products are summed one lag at
    a time, each draw with its partner l draws back, and the ring, the
    first L draws and the totals follow, all under device-side masks (no
    host read of ``count``)."""
    C, _, L, d = st.s.shape
    K = int(xs.shape[1])
    dtype, dev = st.s.dtype, xs.device
    xs = xs.to(dtype)
    t = st.count + torch.arange(K, dtype=st.count.dtype, device=dev)
    half = st.planned // 2
    start1 = st.planned - half
    seg_t = torch.stack([t, t - start1])  # (2, K): place in its half
    gate = torch.stack([t < half, t >= start1])  # (2, K): feeds the half
    # ext[:, h, e]: the ring of half h oldest first (e < L), then the block
    ext = torch.cat([st.ring.flip(2), xs[:, None].expand(C, 2, K, d)], 2)
    lagged = []
    for lag in range(L):
        w = (gate & (seg_t >= lag)).to(dtype)[None, :, :, None]
        lagged.append((xs[:, None] * w * ext[:, :, L - lag:L - lag + K])
                      .sum(2))
    s = st.s + torch.stack(lagged, 2)
    # the ring: the half's n draws of this block newest first, then its
    # old ring (the draws of a half are consecutive)
    pos = torch.arange(L, device=dev)[None, :]
    k1 = torch.arange(1, K + 1, device=dev)[None, :]
    n = gate.sum(1, keepdim=True)
    end = (gate * k1).amax(1, keepdim=True)  # one past the half's last
    idx = torch.where(pos < n, L + end - 1 - pos, L - 1 - pos + n)
    ring = torch.gather(ext, 2, idx[None, :, :, None].expand(C, 2, L, d))
    hit = gate[:, :, None] & (seg_t[:, :, None] == pos[:, None, :])
    src = hit.to(torch.int32).argmax(1)  # (2, L): the draw at place l
    got = xs.index_select(1, src.reshape(-1)).reshape(C, 2, L, d)
    first = torch.where(hit.any(1)[None, :, :, None], got, st.first)
    total = st.total + (xs[:, None] * gate.to(dtype)[None, :, :, None]).sum(2)
    return st._replace(s=s, ring=ring, first=first, total=total,
                       count=st.count + K)


def merge_ess(st: ESSState, group) -> ESSState:
    """The streamed ESS state of every chain of ``group``, in chain order
    (``count`` and ``planned`` are alike on every rank)."""
    return st._replace(**{k: _gather(getattr(st, k), group)
                          for k in ("s", "ring", "first", "total")})


def ess_from_state(st: ESSState, cap: bool = True, group=None):
    """Combined bulk ESS per parameter from the streamed state: (d,).
    ``group``: merge a shard's state over the chain group first."""
    if group is not None:
        st = merge_ess(st, group)
    with synced_span("pooled.summary", st.s.device, C=int(st.s.shape[0])):
        return _ess_of_state(st, cap)


def _ess_of_state(st: ESSState, cap: bool):
    C, _, L, d = st.s.shape
    Kf = (st.planned // 2).to(st.s.dtype)  # draws per split half
    lags = torch.arange(L, dtype=st.s.dtype, device=st.s.device)[
        None, None, :, None]
    nterm = torch.clamp(Kf - lags, min=1.0)
    mean = st.total / torch.clamp(Kf, min=1.0)  # (C, 2, d)
    zero = torch.zeros_like(st.first[:, :, :1])
    head = torch.cat([zero, torch.cumsum(st.first, dim=2)[:, :, :-1]], 2)
    tail = torch.cat([zero, torch.cumsum(st.ring, dim=2)[:, :, :-1]], 2)
    m4 = mean[:, :, None, :]
    total4 = st.total[:, :, None, :]
    centered = (st.s - m4 * (total4 - head) - m4 * (total4 - tail)
                + nterm * m4 * m4)
    acov = (centered / torch.clamp(Kf, min=1.0)).reshape(C * 2, L, d)
    mean2 = mean.reshape(C * 2, d)
    chain_var = acov[:, 0, :] * Kf / torch.clamp(Kf - 1.0, min=1.0)
    return _ess_combine(torch.mean(acov, dim=0), chain_var, mean2, Kf, cap)


def _ess_combine(mean_acov, chain_var, chain_means, Kf, cap=True):
    """Stan's cross-chain combination + Geyer truncation.  mean_acov
    (L, d): autocovariance averaged over the 2C half-chains; chain_var
    (2C, d): per-half lag-0 variance (unbiased); chain_means (2C, d);
    Kf: draws per half."""
    L = mean_acov.shape[0]
    C2 = chain_var.shape[0]
    mean_var = torch.mean(chain_var, dim=0)  # (d,)
    var_plus = (mean_var * torch.clamp(Kf - 1.0, min=1.0)
                / torch.clamp(Kf, min=1.0))
    var_plus = var_plus + torch.var(chain_means, dim=0, correction=1)
    rho = 1.0 - (mean_var[None, :] - mean_acov) / torch.clamp(
        var_plus[None, :], min=1e-30)
    rho = torch.cat([torch.ones_like(rho[:1]), rho[1:]], 0)
    P = L // 2
    pairs = rho[0:2 * P:2] + rho[1:2 * P:2]  # (P, d)
    pos = torch.cumprod((pairs > 0).to(rho.dtype), dim=0)
    mono = torch.cummin(pairs, dim=0).values
    tau = -1.0 + 2.0 * torch.sum(pos * mono, dim=0)
    tau = torch.where(pos[0] > 0, tau, 1.0)
    CK = C2 * Kf
    tau = torch.maximum(tau, 1.0 / torch.log10(CK + 10.0))
    out = CK / tau
    if cap:
        out = torch.minimum(out, CK * torch.log10(CK + 10.0))
    return torch.where(var_plus > 0, out, CK)


def ess_device(draws: torch.Tensor, max_lag: int = 64, cap: bool = True):
    """Combined bulk ESS per parameter, computed on the device from a
    resident (C, K, d) draws buffer: the estimator of ``diagnostics.ess``
    up to the ``max_lag`` window; only the (d,) result leaves the
    device."""
    C, K, d = draws.shape
    half = K // 2
    L = max(2, min(int(max_lag), half))
    x = torch.stack([draws[:, :half], draws[:, K - half:]], 1)  # (C,2,h,d)
    m = torch.mean(x, dim=2, keepdim=True)
    xc = x - m
    Kf = torch.full((), float(half), dtype=draws.dtype, device=draws.device)
    tidx = torch.arange(half, device=draws.device)[None, None, :, None]
    acovs = []
    for lag in range(L):
        rolled = torch.roll(xc, -lag, dims=2)
        valid = (tidx < half - lag).to(draws.dtype)
        s = torch.sum(xc * rolled * valid, dim=2) / Kf  # (C, 2, d)
        acovs.append(torch.mean(s.reshape(C * 2, d), dim=0))
    mean_acov = torch.stack(acovs, 0)  # (L, d)
    chain_var = torch.var(xc.reshape(C * 2, half, d), dim=1, correction=1)
    return _ess_combine(mean_acov, chain_var, m.reshape(C * 2, d), Kf, cap)
