"""No-U-Turn Sampler baseline: iterative, recursion-free, batched.

Counterpart of ``mcmcglm_tpu/baselines/nuts.py``, with its warmup (the
three windows of ``hmc.py``) and its tree: subtrees are built leaf by
leaf with a checkpoint stack for the dyadic U-turn checks.

* A subtree's even leaf m becomes the left end of the dyadic intervals
  that close at later odd leaves: its momentum and the momentum sum
  before it go to checkpoint slot popcount(m) (the live left ends occupy
  distinct slots).
* At odd leaf n the intervals [n + 1 - 2^k, n] close for k = 1 ..
  tz(n + 1); their left ends sit at the contiguous slots popcount(n + 1)
  - 1 .. popcount(n + 1) + tz(n + 1) - 2, each checked for a U-turn with
  (prefix through n - prefix before the left end) as the interval's
  momentum sum.

Sampling is progressive-multinomial within a subtree and biased (min(1,
W_new / W_old), as Stan) at the top-level merge; a leaf whose energy
error passes 1000 diverges; ``accept_stat`` is the mean of min(1,
exp(dw)) over every leaf built, a rejected subtree's included.

All chains run at once and stand at the same doubling depth and leaf
index, so the slot arithmetic is shared (host integers) and only the
turning and diverging masks differ per chain.  The doubling loop and each
subtree's leaf loop are ``ops/slice_kernels.masked_loop``s: a chain
whose tree or subtree has ended freezes, and the host reads one flag per
block of ``_block_iters`` iterations (``NUTSResult.flag_reads`` counts
them; the draws do not depend on the block length).
A leaf evaluates the gradient once: the one at a leapfrog step's start is
the previous step's end, or the tree edge's, which the tree carries.  The
checkpoint slots live outside the frozen carry: a stopped lane's slots
are never read again.

Random streams (``_streams.Streams``; step = the iteration's index over
the warmup windows and the sampling phase, from 0):

* site 0, slots 0 .. d-1: the momentum's standard normals;
* site 1, slot 2j: the direction of the subtree at depth j; slot 2j + 1:
  the merge's uniform at depth j;
* site 2, slot 2^j - 1 + i: the multinomial uniform of leaf i of the
  subtree at depth j.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..api import entry_device
from ..ops.slice_kernels import _BLOCK_ITERS, masked_loop
from ._streams import Streams
from .hmc import _windows, adapt_and_sample, initial_positions, kinetic
from .logdensity import rowwise, value_and_grad

__all__ = ["nuts_sample", "NUTSResult"]

DIVERGENCE = 1000.0
_block_iters = _BLOCK_ITERS  # masked iterations per flag read


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (C, K, d)
    accept_rate: torch.Tensor  # (C,)
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor  # (C, d)
    mean_depth: torch.Tensor  # (C,)
    mean_leaves: torch.Tensor  # (C,) leapfrog leaves per sampling iteration
    flag_reads: int  # host reads of the loops' flags, warmup included
    n_leapfrog: int  # batched leapfrog steps run, warmup included


def _popcount(n: int) -> int:
    return bin(int(n)).count("1")


def _tz(n: int) -> int:
    """Trailing zero count of an int as a 32-bit word (32 for 0)."""
    n = int(n)
    return _popcount(~n & (n - 1) & 0xFFFFFFFF)


@rowwise
def _uturn(sum_r, r_first, r_last, inv_mass):
    """The U-turn test of a trajectory with momentum sum ``sum_r`` and end
    momenta ``r_first``, ``r_last`` (..., d): (...) bools."""
    return ((torch.sum(sum_r * (inv_mass * r_first), -1) <= 0)
            | (torch.sum(sum_r * (inv_mass * r_last), -1) <= 0))


def _stack(slots):
    """(C, k, d) of k (C, d) checkpoint slots (a view for one)."""
    return slots[0][:, None] if len(slots) == 1 else torch.stack(slots, 1)


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _nuts_kernel(streams, draws, z0, lpg0, logpost_vg, eps, inv_mass,
                 max_depth: int):
    """One NUTS transition of every chain.  ``draws`` = (momentum normals
    (C, d), direction uniforms (C, max_depth), merge uniforms (C,
    max_depth), leaf uniforms (C, 2^max_depth - 1)).  Returns (z, (logp,
    grad) at z, accept_stat, depth, leaves)."""
    mom, dir_u, merge_u, leaf_u = draws
    C = z0.shape[0]
    dtype, dev = z0.dtype, z0.device
    S = max_depth + 1  # checkpoint slots
    lp0, g0 = lpg0

    def ke(r):
        return kinetic(inv_mass, r)

    r0 = mom * torch.rsqrt(inv_mass)
    e0 = lp0 - ke(r0)
    log_merge = torch.log(merge_u)
    log_leaf = torch.log(leaf_u)
    im_slots = inv_mass[:, None, :]
    zero_c = torch.zeros(C, dtype=dtype, device=dev)
    ninf_c = torch.full((C,), -torch.inf, dtype=dtype, device=dev)
    false_c = torch.zeros(C, dtype=torch.bool, device=dev)
    zero_i = torch.zeros(C, dtype=torch.int32, device=dev)

    def build_subtree(j, z, r, g, step, active):
        st = step[:, None]
        half, st_im = 0.5 * st, st * inv_mass
        base = 2 ** j - 1
        # the checkpoint slots, (C, d) each: written for every lane and not
        # frozen (a stopped lane's slots are never read again)
        ck_r, ck_pre = [None] * S, [None] * S

        def body(i, c):
            streams.stats["leapfrog"] += 1
            (z, r, g, prefix, zp, lpp, gp, log_w, sum_acc, n, turning,
             diverging) = c
            r = torch.addcmul(r, half, g)
            z = torch.addcmul(z, st_im, r)
            lp, g = logpost_vg(z)
            r = torch.addcmul(r, half, g)
            dw = torch.nan_to_num((lp - ke(r)) - e0, nan=-math.inf,
                                  posinf=math.inf, neginf=-math.inf)
            diverging = dw < -DIVERGENCE
            sum_acc = sum_acc + torch.clamp(torch.exp(dw), max=1.0)
            new_log_w = torch.logaddexp(log_w, dw)
            take = log_leaf[:, base + i] < dw - new_log_w
            zp, gp = _where(take, z, zp), _where(take, g, gp)
            lpp = torch.where(take, lp, lpp)
            log_w = new_log_w
            if i % 2 == 0:
                slot = _popcount(i)
                ck_r[slot], ck_pre[slot] = r, prefix
            prefix = prefix + r
            if i % 2 == 1:
                # the dyadic intervals [i + 1 - 2^k, i], k = 1 .. tz(i + 1)
                lo = _popcount(i + 1) - 1
                hi = lo + _tz(i + 1)
                seg = prefix[:, None, :] - _stack(ck_pre[lo:hi])
                ut = _uturn(seg, _stack(ck_r[lo:hi]), r[:, None, :],
                            im_slots)
                turning = turning | ut.any(-1)
            return (z, r, g, prefix, zp, lpp, gp, log_w, sum_acc, n + 1,
                    turning, diverging)

        # the proposal starts at the subtree's start, whose logp is never
        # read: the first finite leaf is always taken
        carry = (z, r, g, torch.zeros_like(z), z, zero_c, g, ninf_c, zero_c,
                 zero_i, false_c, false_c)
        carry, _ = masked_loop(
            streams, lambda c: active & ~(c[-2] | c[-1]), body, carry,
            2 ** j)
        return carry

    def outer(j, c):
        (depth, zl, rl, gl, zr, rr, gr, sum_r, zp, lpp, gp, log_w, sum_acc,
         n_tot, done) = c
        go_left = dir_u[:, j] < 0.5
        step = torch.where(go_left, -eps, eps)
        sub = build_subtree(j, _where(go_left, zl, zr),
                            _where(go_left, rl, rr), _where(go_left, gl, gr),
                            step, ~done)
        (s_z, s_r, s_g, s_sum_r, s_zp, s_lpp, s_gp, s_log_w, s_acc, s_n,
         s_turn, s_div) = sub
        sub_ok = ~s_turn & ~s_div
        # biased top-level merge: the new proposal w.p. min(1, W_new/W_old)
        take = (log_merge[:, j] < s_log_w - log_w) & sub_ok
        zp, gp = _where(take, s_zp, zp), _where(take, s_gp, gp)
        lpp = torch.where(take, s_lpp, lpp)
        log_w = torch.where(sub_ok, torch.logaddexp(log_w, s_log_w), log_w)
        sum_acc = sum_acc + s_acc
        n_tot = n_tot + s_n
        left, right = sub_ok & go_left, sub_ok & ~go_left
        zl, rl, gl = (_where(left, s_z, zl), _where(left, s_r, rl),
                      _where(left, s_g, gl))
        zr, rr, gr = (_where(right, s_z, zr), _where(right, s_r, rr),
                      _where(right, s_g, gr))
        # backward-built momenta enter the sum with their simulated sign
        sum_r = _where(sub_ok, sum_r + s_sum_r, sum_r)
        done = ~sub_ok | _uturn(sum_r, rl, rr, inv_mass)
        return (depth + 1, zl, rl, gl, zr, rr, gr, sum_r, zp, lpp, gp,
                log_w, sum_acc, n_tot, done)

    carry = (zero_i, z0, r0, g0, z0, r0, g0, r0, z0, lp0, g0, zero_c,
             zero_c, zero_i, false_c)
    carry, _ = masked_loop(streams, lambda c: ~c[-1], outer, carry,
                           max_depth)
    depth, (zp, lpp, gp) = carry[0], carry[8:11]
    sum_acc, n_tot = carry[12:14]
    accept_stat = sum_acc / torch.clamp(n_tot.to(dtype), min=1.0)
    return zp, (lpp, gp), accept_stat, depth, n_tot


def nuts_sample(
    seed: int,
    logpost: Callable,
    init_beta,
    n_warmup: int = 500,
    n_samples: int = 500,
    max_depth: int = 8,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    *,
    device="cuda",
) -> NUTSResult:
    """Run C NUTS chains from ``init_beta`` (C, d) under the integer
    ``seed``, with the warmup of :func:`~.hmc.hmc_sample`; ``logpost`` maps
    (C, d) to (C,).  Returns the post-warmup samples (C, n_samples, d) on ``device`` (default "cuda",
    which raises without CUDA)."""
    device = entry_device(device, "nuts_sample")
    z0 = initial_positions(init_beta, device)
    C, d = z0.shape
    max_depth = int(max_depth)
    streams = Streams(seed, C, dtype=z0.dtype, device=device,
                      block=_block_iters)
    streams.stats["leapfrog"] = 0
    tables = streams.steps(
        0, sum(_windows(n_warmup)) + int(n_samples),
        [(0, d), (1, 2 * max_depth), (2, 2 ** max_depth - 1)])

    def vg(z):
        return value_and_grad(logpost, z)

    def kernel(z, lpg, eps, inv_mass):
        _, (mom_u, tree_u, leaf_u) = next(tables)
        draws = (streams.normal(mom_u), streams.uniform(tree_u[:, 0::2]),
                 streams.uniform(tree_u[:, 1::2]), streams.uniform(leaf_u))
        z, lpg, acc, depth, leaves = _nuts_kernel(
            streams, draws, z, lpg, vg, eps, inv_mass, max_depth)
        return z, lpg, acc, (depth, leaves)

    draws, acc, eps, inv_mass, (depth, leaves) = adapt_and_sample(
        kernel, z0, vg(z0), n_warmup, n_samples, init_step_size,
        target_accept)
    return NUTSResult(draws, acc, eps, inv_mass, depth, leaves,
                      streams.stats["flag_reads"], streams.stats["leapfrog"])
