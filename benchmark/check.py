"""The comparison that decides ``correct``: what the window produced,
against a plain reference.

The reference is plain PyTorch in float64 on the card (``reference/``,
read through :class:`spec.Model`, and the benchmark's own data); it imports
nothing of the program and takes nothing the program made but the
outputs it judges: the window's draws (C, S, d), each chain's evaluation
counter, and the state at the window's end (beta and the committed
predictor eta).  The numbers, each with its limit from the workload file:

* ``eta_gap``: max |eta - X beta| over every chain and observation, X the
  benchmark's float64 design and beta the program's own final draw: the
  kernel that commits eta (the battery, or the fused kernels).
* ``pit_ks``: the Kolmogorov-Smirnov distance from uniform of the
  probability integral transforms of ``pit_updates`` coordinate updates of
  the window, drawn from the seed.  Update (c, s, j) moved coordinate j of
  chain c from draws[c, s-1, j] to draws[c, s, j] with coordinates < j
  already at sweep s; the chains sweep j = 0 .. d-1 in order, so that is
  the rest it saw.  A sampler that leaves the posterior invariant, at
  stationarity, puts F(new | rest) ~ U(0, 1), F the conditional CDF,
  computed here by Simpson's rule on 2 x 65 points around the conditional
  mode (Newton) out to 12 conditional sds, with the new value a node: the
  slice automaton's draws.
* ``ess_gap``: the largest relative gap between the ESS that
  ``min_ess_per_s`` read (``ess.ess_torch`` on the card) and the host's
  float64 ``ess.ess_numpy``, over ``ess_coords`` coordinates drawn from the
  seed and the one with the least ESS.
* ``stuck_draws``, ``last_draw_gap``, ``short_sweeps`` (exact, limit 0):
  chain-draws equal to the chain's previous draw in every coordinate
  (a step that returned its state, or a chain left out); the largest gap
  between each chain's last draw and its final state; sweeps in which a
  chain's evaluation counter rose by less than d (each coordinate update
  evaluates the target at least once).

The controls (``controls``) read the same numbers in the nearest lower
precision, bfloat16: the reference's eta as a bfloat16 product, each
sampled update redrawn from the conditional computed in bfloat16 at the
same rest, and the ESS in float32; the harness holds them to the cell's
limits by :func:`verdict`, as it does a run's numbers, and a control has to
come out not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ess import ess_numpy, ess_torch

__all__ = ["control_draws", "eta_gap", "ks_uniform", "pit", "run_checks",
           "verdict"]

R_SD = 12.0  # the conditional's grid reaches this many sds past its mode
NODES = 65  # Simpson nodes on each side of the new value (odd)
NEWTON = 30
BLOCK = 16  # updates per block of the grid's (block, 2 x NODES, n) work
CONTROL_NODES = 257


def ks_uniform(u) -> float:
    """Kolmogorov-Smirnov distance of the sample ``u`` from U(0, 1)."""
    u = np.sort(np.asarray(u, dtype=np.float64))
    m = u.size
    i = np.arange(1, m + 1)
    return float(max(np.max(i / m - u), np.max(u - (i - 1) / m)))


def _simpson(f, h):
    """Simpson's rule over the last axis of f (odd count) with steps h."""
    w = torch.ones(f.shape[-1], dtype=f.dtype, device=f.device)
    w[1:-1:2], w[2:-1:2] = 4.0, 2.0
    return (f * w).sum(-1) * h / 3.0


def _rests(X, draws, idx):
    """(eta without coordinate j (M, n), x_j (M, n), old value, new value)
    of the updates idx (M, 3) of (chain, sweep, coordinate)."""
    c, s, j = idx[:, 0], idx[:, 1], idx[:, 2]
    new = draws[c, s].double()
    old = draws[c, s - 1].double()
    col = torch.arange(draws.shape[2], device=draws.device)
    mix = torch.where(col[None, :] < j[:, None], new, old)
    rows = torch.arange(idx.shape[0], device=draws.device)
    b0, b1 = old[rows, j], new[rows, j]
    xj = X[:, j].T.contiguous()
    return mix @ X.T - xj * b0[:, None], xj, b0, b1


def _logcond(model, y, eta_rest, xj, b, dtype=torch.float64):
    """log pi(b | rest) (M, G) at b (M, G), up to a constant, computed in
    ``dtype`` (the sum over observations too)."""
    e = (eta_rest.to(dtype)[:, None, :]
         + xj.to(dtype)[:, None, :] * b.to(dtype)[:, :, None])
    ll = model.density.loglik(y.to(dtype), e).sum(-1)
    return (ll + model.logp(b.to(dtype))).double()


def _mode(model, y, eta_rest, xj, b):
    """The conditional's mode by damped Newton from b, and its sd there."""
    for _ in range(NEWTON):
        e = eta_rest + xj * b[:, None]
        g = (xj * model.density.dloglik(y, e)).sum(1) + model.dlogp(b)
        h = (xj * xj * model.density.weight(e)).sum(1) - model.d2logp(b)
        sd = h.rsqrt()
        b = b + torch.clamp(g / h, -3.0 * sd, 3.0 * sd)
    return b, sd


def pit(model, X, y, draws, idx, new=None):
    """F(new | rest) of each update idx (M, 3): ``new`` (M,) replaces the
    draws' new values when given (a control's draws at the same rests)."""
    out = []
    for k in range(0, idx.shape[0], BLOCK):
        er, xj, b0, b1 = _rests(X, draws, idx[k:k + BLOCK])
        if new is not None:
            b1 = new[k:k + BLOCK]
        m, sd = _mode(model, y, er, xj, b0)
        lo = torch.minimum(m - R_SD * sd, b1)
        hi = torch.maximum(m + R_SD * sd, b1)
        t = torch.linspace(0.0, 1.0, NODES, dtype=torch.float64,
                           device=X.device)
        left = lo[:, None] + (b1 - lo)[:, None] * t
        right = b1[:, None] + (hi - b1)[:, None] * t
        lg = _logcond(model, y, er, xj, torch.cat([left, right], 1))
        f = torch.exp(lg - lg.max(1, keepdim=True).values)
        a = _simpson(f[:, :NODES], (b1 - lo) / (NODES - 1))
        b = _simpson(f[:, NODES:], (hi - b1) / (NODES - 1))
        out.append(a / (a + b))
    return torch.cat(out)


def control_draws(model, X, y, draws, idx, u, dtype=torch.bfloat16):
    """Each update redrawn from its conditional computed in ``dtype`` at the
    same rest, by inverting the CDF on a grid with the uniforms u (M,)."""
    out = []
    for k in range(0, idx.shape[0], BLOCK):
        er, xj, b0, _ = _rests(X, draws, idx[k:k + BLOCK])
        m, sd = _mode(model, y, er, xj, b0)
        t = torch.linspace(-R_SD, R_SD, CONTROL_NODES, dtype=torch.float64,
                           device=X.device)
        grid = m[:, None] + sd[:, None] * t
        lg = _logcond(model, y, er, xj, grid, dtype=dtype)
        f = torch.exp(lg - lg.max(1, keepdim=True).values)
        cdf = torch.cumsum(0.5 * (f[:, 1:] + f[:, :-1]), 1)
        cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], 1)
        cdf = cdf / cdf[:, -1:]
        uk = u[k:k + BLOCK, None]
        i = torch.clamp(torch.searchsorted(cdf, uk), 1, CONTROL_NODES - 1)
        c0, c1 = cdf.gather(1, i - 1), cdf.gather(1, i)
        g0, g1 = grid.gather(1, i - 1), grid.gather(1, i)
        frac = torch.where(c1 > c0, (uk - c0) / (c1 - c0),
                           torch.zeros_like(uk))
        out.append((g0 + frac * (g1 - g0))[:, 0])
    return torch.cat(out)


def eta_gap(X, beta, eta, dtype=torch.float64, block: int = 256) -> float:
    """max |eta - X beta|, X beta computed in ``dtype`` (bfloat16: the
    control's product)."""
    gap = 0.0
    for k in range(0, beta.shape[0], block):
        ref = (beta[k:k + block].to(dtype) @ X.T.to(dtype)).double()
        gap = max(gap, float((eta[k:k + block].double() - ref).abs().max()))
    return gap


def _ess_gap(draws, coords, ess_dev) -> float:
    gaps = []
    for j in coords:
        ref = ess_numpy(draws[:, :, j].cpu().numpy())
        gaps.append(abs(float(ess_dev[j]) - ref) / ref)
    return max(gaps)


def run_checks(model, X, y, out: dict, seed: int, work: dict,
               controls: bool = False):
    """The numbers of the module docstring, as {name: value}, and with
    ``controls`` the controls' readings {name: value}.  ``out`` holds the
    program's outputs: draws (C, S, d), nev (C, S) cumulative evaluations
    at each sweep's end or None, nev_sweep (S,) evaluations per sweep over
    all chains, beta and eta at the end, and the ESS (d,) the metric
    read."""
    draws = out["draws"]
    C, S, d = draws.shape
    cfg = work["check"]
    rng = np.random.default_rng([int(seed), 17])
    idx = np.stack([rng.integers(0, C, cfg["pit_updates"]),
                    rng.integers(1, S, cfg["pit_updates"]),
                    rng.integers(0, d, cfg["pit_updates"])], 1)
    idx = torch.as_tensor(idx, device=draws.device)
    ess_dev = out["ess"]
    coords = sorted(set(rng.choice(d, min(d, cfg["ess_coords"]),
                                   replace=False).tolist())
                    | {int(torch.argmin(ess_dev))})
    nums = {}
    nums["eta_gap"] = eta_gap(X, out["beta"], out["eta"])
    u = pit(model, X, y, draws, idx).cpu().numpy()
    nums["pit_ks"] = ks_uniform(u)
    nums["ess_gap"] = _ess_gap(draws, coords, ess_dev)
    same = (draws[:, 1:] == draws[:, :-1]).all(2)
    nums["stuck_draws"] = int(same.sum())
    nums["last_draw_gap"] = float(
        (draws[:, -1].double() - out["beta"].double()).abs().max())
    if out["nev"] is not None:
        rise = torch.diff(out["nev"].long(), dim=1)
        nums["short_sweeps"] = int((rise < d).sum())
    else:
        nums["short_sweeps"] = int((out["nev_sweep"] < C * d).sum())
    if not controls:
        return nums, None
    ctl = {}
    ctl["eta_gap"] = eta_gap(X, out["beta"], out["beta"].double() @ X.T,
                             torch.bfloat16)
    uu = torch.as_tensor(rng.random(idx.shape[0]), device=draws.device)
    b1 = control_draws(model, X, y, draws, idx, uu)
    ctl["pit_ks"] = ks_uniform(pit(model, X, y, draws, idx, new=b1)
                               .cpu().numpy())
    ess32 = torch.zeros_like(ess_dev)
    cols = torch.as_tensor(coords, device=draws.device)
    ess32[cols] = ess_torch(draws[:, :, cols], dtype=torch.float32).double()
    ctl["ess_gap"] = _ess_gap(draws, coords, ess32)
    return nums, ctl


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def verdict(nums: dict, limits: dict):
    """[(name, value, limit, within)] in order; a number is within its
    limit when it is finite and at most the limit (exact ones: 0)."""
    rows = []
    for name, value in nums.items():
        lim = limits.get(name, 0)
        rows.append((name, value, lim, _finite(value) and value <= lim))
    return rows
