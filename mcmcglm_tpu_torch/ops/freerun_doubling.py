"""Neal's doubling slice kernel on the free-running CGGibbs automaton.

Counterpart of ``mcmcglm_tpu/ops/freerun_doubling.py`` (Neal 2003, Figs.
4-6).  A proposal that passes the level test must also pass the Fig. 6
back-test, a halving walk down the doubling sequence that may need fresh
evaluations; the automaton's rule is one evaluation per pass, so the
back-test becomes two more phases:

  phase 0 — expansion.  ``stepdir`` sequences the endpoint evaluations
      (0 the initial left endpoint, 1 the initial right, 2/3 a
      just-doubled left/right).  After each endpoint but the first the
      lane keeps doubling a coin-chosen side while either endpoint is
      above the level and budget (``budL``, Fig. 4's p) remains, else
      snapshots the interval into (eL, eR) with its endpoint flags and
      enters shrinkage.
  phase 1 — shrink proposal.  Below the level: reject and shrink toward
      b0.  At/above the level with a never-doubled interval (eR - eL <=
      1.1 w): the back-test is vacuous and the lane commits this pass.
      Otherwise stash the candidate in ``x1``, open the back-test interval
      (hatL, hatR) = (eL, eR), halve once (register math) and schedule the
      midpoint.
  phase 2 — back-test halving.  The evaluated midpoint is one of (hatL,
      hatR), so its flag lands on that side; then Fig. 6: reject x1 if a
      halving separated b0 from x1 (``dsep``) and both endpoints are at or
      below the level, halve again while wider than 1.1 w, else accept.
  phase 3 — commit.  The accepted x1 is the pass proposal and commits
      through the standard accept path.

One evaluation per pass stays plain torch, as the JAX package leaves it to
XLA (no Pallas kernel there); ``spec_k`` is 1 and the batteries unused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .freerun_passes import _active, _draws

__all__ = ["DoublingState", "run_pass_doubling"]


class DoublingState(NamedTuple):
    """FreeRunState plus the doubling back-test registers (all (C,)).
    ``budL`` is the remaining doubling budget; ``budR`` is unused."""

    beta: torch.Tensor
    eta: torch.Tensor
    ld0: torch.Tensor
    key: torch.Tensor
    ctr: torch.Tensor
    logw: torch.Tensor
    j: torch.Tensor
    phase: torch.Tensor  # 0 expand, 1 propose, 2 back-test, 3 commit
    stepdir: torch.Tensor  # 0 init-L, 1 init-R, 2/3 doubled-L/R
    level: torch.Tensor
    L: torch.Tensor
    R: torch.Tensor
    budL: torch.Tensor  # remaining doublings (Fig. 4's p)
    budR: torch.Tensor  # unused
    b0: torch.Tensor
    lp0: torch.Tensor
    w: torch.Tensor
    xprop: torch.Tensor
    n_shrink: torch.Tensor
    nev: torch.Tensor
    x1: torch.Tensor  # pending proposal under back-test
    eL: torch.Tensor  # expansion's final interval
    eR: torch.Tensor
    e_aL: torch.Tensor  # f(eL) > level (bool)
    e_aR: torch.Tensor
    hatL: torch.Tensor  # current back-test interval
    hatR: torch.Tensor
    h_aL: torch.Tensor  # f(hatL) > level (bool)
    h_aR: torch.Tensor
    dsep: torch.Tensor  # Fig. 6's D: a halving separated b0 from x1 (bool)


def run_pass_doubling(eng, s, sweep_count, draws, nevbuf, n_sweeps,
                      adapt: bool, shrink_only, stepout_sweeps=None, u=None,
                      live=None):
    """One target evaluation + doubling-automaton advance for every chain;
    returns ``(new_state, sweep_count, draws, nevbuf)``.  ``u`` is the
    (C, 1 + nb) uniform block (None: drawn from the state's stream); its
    first column serves the lane's phase (the expansion side coin or the
    shrink proposal).  ``adapt``/``shrink_only``/``stepout_sweeps`` are
    ignored: doubling runs its full schedule with the user's width."""
    del adapt, shrink_only, stepout_sweeps
    active = _active(sweep_count, n_sweeps, live)
    nb = eng._n_begin_u
    if u is None:
        u = _draws(eng, s)["u"]
    u_pass = u[:, 0]

    xg = eng.Xt[s.j.long()]  # (C, n) row gather
    e = s.eta + xg * (s.xprop - s.b0)[:, None]
    ld_e = eng._ld_eta(e, eng.y, eng.extra)
    if eng.eval_cache == "scalar":
        lsum_e = eng.reduce_fn(ld_e)
        dll = lsum_e - s.ld0
    else:
        dll = eng.reduce_fn(ld_e - s.ld0)
    f = dll + (eng._coord_lp(s.beta, s.j, s.xprop) - s.lp0)
    above = f > s.level  # endpoint-flag sense (Figs. 4/6 use strict >)

    expanding = s.phase == 0
    proposing = s.phase == 1
    backtesting = s.phase == 2
    committing = s.phase == 3

    # -- phase 0: expansion --
    e_aL = torch.where(expanding & ((s.stepdir == 0) | (s.stepdir == 2)),
                       above, s.e_aL)
    e_aR = torch.where(expanding & ((s.stepdir == 1) | (s.stepdir == 3)),
                       above, s.e_aR)
    init_L_done = expanding & (s.stepdir == 0)
    decide = expanding & (s.stepdir != 0)
    keep_doubling = decide & (e_aL | e_aR) & (s.budL > 0)
    go_left = u_pass < 0.5
    width = s.R - s.L
    L = torch.where(keep_doubling & go_left, s.L - width, s.L)
    R = torch.where(keep_doubling & ~go_left, s.R + width, s.R)
    budL = torch.where(keep_doubling, s.budL - 1, s.budL)
    exp_done = decide & ~keep_doubling
    # the back-test restarts from the expansion's interval for EVERY
    # proposal of this coordinate
    eL = torch.where(exp_done, L, s.eL)
    eR = torch.where(exp_done, R, s.eR)

    # -- phase 1: shrink proposal --
    ok_level = f >= s.level
    trivial = (s.eR - s.eL) <= 1.1 * s.w  # never doubled: Fig. 6 vacuous
    accept_now = proposing & ok_level & trivial & active
    need_bt = proposing & ok_level & ~trivial & active
    rej_level = proposing & ~ok_level

    # -- phase 2: back-test midpoint --
    h_aL = torch.where(backtesting & (s.xprop == s.hatL), above, s.h_aL)
    h_aR = torch.where(backtesting & (s.xprop == s.hatR), above, s.h_aR)
    bt_fail = backtesting & s.dsep & ~h_aL & ~h_aR
    bt_cont = backtesting & ~bt_fail & ((s.hatR - s.hatL) > 1.1 * s.w)
    bt_pass = backtesting & ~bt_fail & ~bt_cont & active

    # the next halving: entering lanes start from the expansion snapshot
    x1 = torch.where(need_bt, s.xprop, s.x1)
    bhL = torch.where(need_bt, s.eL, s.hatL)
    bhR = torch.where(need_bt, s.eR, s.hatR)
    bdsep = s.dsep & ~need_bt
    h_aL = torch.where(need_bt, e_aL, h_aL)
    h_aR = torch.where(need_bt, e_aR, h_aR)
    halve = need_bt | bt_cont
    M = 0.5 * (bhL + bhR)
    cross = ((s.b0 < M) & (x1 >= M)) | ((s.b0 >= M) & (x1 < M))
    dsep = torch.where(halve, bdsep | cross, bdsep)
    m_right = x1 < M  # x1 below M: M becomes the new right endpoint
    hatL = torch.where(halve & ~m_right, M, bhL)
    hatR = torch.where(halve & m_right, M, bhR)

    # -- rejection (level or back-test): shrink the main interval --
    rejected = rej_level | bt_fail
    rej_x = torch.where(bt_fail, s.x1, s.xprop)
    L = torch.where(rejected & (rej_x < s.b0), rej_x, L)
    R = torch.where(rejected & (rej_x >= s.b0), rej_x, R)
    n_shrink = torch.where(rejected, s.n_shrink + 1, s.n_shrink)
    exhausted = rejected & (n_shrink >= eng.max_shrink) & active

    # -- commit: this pass's evaluation (committing lanes evaluate x1) --
    accept_move = accept_now | (committing & active)
    commit = accept_move | exhausted
    b_star = torch.where(accept_move, s.xprop, s.b0)
    eta = torch.where(accept_move[:, None], e, s.eta)
    if eng.eval_cache == "scalar":
        ld0 = torch.where(accept_move, lsum_e, s.ld0)
    else:
        ld0 = torch.where(accept_move[:, None], ld_e, s.ld0)
    beta = eng._commit_row(s.beta, s.j, b_star)

    nev_new = s.nev + active.to(torch.int32)
    j_next = torch.where(commit, s.j + 1, s.j)
    sweep_done = commit & (j_next >= eng.d)
    draws, nevbuf = eng._sweep_buffers(draws, nevbuf, sweep_count, beta,
                                       nev_new, sweep_done)
    sweep_count = torch.where(sweep_done, sweep_count + 1, sweep_count)
    j_next = torch.where(sweep_done, 0, j_next)

    reg = eng._begin_coord(beta, s.logw, j_next, False, u[:, 1:1 + nb])

    def pick(name, old):
        return torch.where(commit, reg[name], old)

    # next-pass proposal for non-committing lanes (disjoint cases)
    x_shrink = L + (R - L) * u_pass
    xprop_nc = s.xprop
    xprop_nc = torch.where(init_L_done, s.R, xprop_nc)
    xprop_nc = torch.where(keep_doubling, torch.where(go_left, L, R),
                           xprop_nc)
    xprop_nc = torch.where(exp_done | rejected, x_shrink, xprop_nc)
    xprop_nc = torch.where(halve, M, xprop_nc)
    xprop_nc = torch.where(bt_pass, x1, xprop_nc)

    phase = s.phase
    phase = torch.where(exp_done, 1, phase)
    phase = torch.where(halve, 2, phase)
    phase = torch.where(bt_fail, 1, phase)
    phase = torch.where(bt_pass, 3, phase)
    stepdir = torch.where(init_L_done, 1, s.stepdir)
    # (two Python scalars select an int64 tensor: keep the register int32)
    stepdir = torch.where(keep_doubling,
                          torch.where(go_left, 2, 3).to(stepdir.dtype),
                          stepdir)

    # idle lanes freeze their registers (the boundary-idle hazard)
    def keep(new, old):
        return torch.where(active, new, old)

    new = dict(phase=phase, stepdir=stepdir, L=L, R=R, budL=budL,
               xprop=xprop_nc, n_shrink=n_shrink, x1=x1, eL=eL, eR=eR,
               e_aL=e_aL, e_aR=e_aR, hatL=hatL, hatR=hatR, h_aL=h_aL,
               h_aR=h_aR, dsep=dsep)
    regs = {name: keep(pick(name, v), getattr(s, name))
            for name, v in new.items()}
    state = type(s)(
        beta=beta, eta=eta, ld0=ld0, key=s.key,
        ctr=s.ctr + active.any().to(torch.int64), logw=s.logw, j=j_next,
        level=pick("level", s.level), budR=s.budR, b0=pick("b0", s.b0),
        lp0=pick("lp0", s.lp0), w=pick("w", s.w), nev=nev_new, **regs,
    )
    return state, sweep_count, draws, nevbuf
