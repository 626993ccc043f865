"""The free-running CGGibbs per-pass automaton (classic and K-speculative).

Counterpart of ``mcmcglm_tpu/ops/freerun_passes.py``.  ``run_pass``
advances every chain by ONE target evaluation; ``run_pass_spec`` by a
K-proposal speculative battery.  Both take the engine
(``freerun.FreeRunCGGibbs``) first and return
``(new_state, sweep_count, draws, nevbuf)``.  Every slice kernel but
doubling runs here: the angular kernels (elliptical, genelliptical) map
the angle in ``xprop`` through the ellipse and shrink toward theta = 0,
quantile maps through the pseudo-target and shrinks toward u0 = F(b0),
latent commits its refreshed width into ``logw``.

On the card, where ``ops/freerun_automaton.configure_pass`` allows
(``eng.pass_impl == "cuda"``), the engine runs ``run_pass_spec``'s work
as two hand-written kernels around the battery instead; the passes here
are the plain version those kernels are held against.

Each pass takes its random draws as optional arguments: the uniform block
``u``, (C, 1 + nb) for ``run_pass`` and (C, K + nb) for ``run_pass_spec``
with nb = ``eng._n_begin_u``, and for genelliptical the (C,) standard
Gamma draws ``g`` of the coordinate begin.  When they are None the pass
draws them from the state's Philox stream at its pass index ``s.ctr``; a
test hands in the reference's own draws.  ``live`` (a 0-d bool tensor)
idles every lane when false: the pass loop's pass budget.

A lane is active when it is below its sweep quota (and ``live``).  A pass
in which no lane is active changes nothing: not the state, not the
buffers, not the pass index (``ctr`` advances by one exactly when some
lane is active), which is what lets a block of passes run past the
quota.  (The one exception is the sign of an eta entry that is exactly
zero: the kernels commit eta + x * 0, which turns -0.0 into +0.0, an
equal value that nothing downstream tells apart.)

The state tensors are not modified in place: every pass returns new
tensors for the fields it changes, except the collection buffers
``draws``/``nevbuf``, which the run loops own and which are written in
place.
"""

from __future__ import annotations

import torch

from ..utils.profiling import ranged
from .freerun_batteries import (
    battery_commit,
    battery_gather_commit,
    battery_sums,
    first_acceptor,
    plain_battery,
)

__all__ = ["run_pass", "run_pass_spec", "spec_proposals"]


def _gather(arr, j):
    """arr[c, j_c] for every chain c."""
    return torch.gather(arr, 1, j.long()[:, None])[:, 0]


def _draws(eng, s):
    """This pass's random inputs from the state's stream, at index s.ctr."""
    r = eng._randoms(s.key, s.ctr, 1, s.beta.shape[0])
    return {k: v[0] for k, v in r.items()}


def _active(sweep_count, n_sweeps, live):
    active = sweep_count < n_sweeps
    return active if live is None else active & live


def _pivot(eng, s):
    """The shrink pivot: theta = 0 for the angular kernels, u0 = F(b0)
    (the w register) for quantile, b0 otherwise."""
    if eng.is_angular:
        return torch.zeros_like(s.b0)
    return s.w if eng.slice_kernel == "quantile" else s.b0


def _to_x(eng, s, xs, q_loc=None, q_scale=None):
    """Bracket-space proposals (angle, unit interval or x) in x-space;
    ``xs`` is (C,) or (C, K)."""
    if eng.is_angular:
        if xs.dim() == 2:
            return eng.ellipse_point(s.b0[:, None], s.w[:, None], xs)
        return eng.ellipse_point(s.b0, s.w, xs)
    if eng.slice_kernel == "quantile":
        if xs.dim() == 2:
            q_loc = None if q_loc is None else q_loc[:, None]
            q_scale = None if q_scale is None else q_scale[:, None]
        return eng.quantile_ppf(xs, q_loc, q_scale)
    return xs


@ranged("pass.prior")
def _pseudo_target(eng, s):
    """pseudo_adapt: the current coordinate's pseudo-target loc/scale,
    gathered once per pass (constant across a coordinate episode).  The
    log scale is gathered directly, never rebuilt as log(exp(.))."""
    if eng.slice_kernel == "quantile" and eng.q_adapt:
        lw_j = _gather(s.logw, s.j)
        return _gather(s.qloc, s.j), torch.exp(lw_j), lw_j
    return None, None, None


def _adapt(eng, s, adapt, b_star, accept_move, q_loc_l, lw_j):
    """Warmup-only Robbins-Monro pulls; returns (logw, qloc)."""
    logw = s.logw
    qloc = getattr(s, "qloc", None)
    if adapt and eng.slice_kernel == "stepping_out":
        # pull log w_j toward log(adapt_c * accepted move), on
        # accept-with-move commits only (an exhausted commit has move 0)
        move = torch.abs(b_star - s.b0)
        target = torch.log(eng.adapt_c * move + 1e-6)
        lw = _gather(s.logw, s.j)
        new_lw = (1.0 - eng._adapt_rate) * lw + eng._adapt_rate * target
        logw = eng._commit_row(s.logw, s.j, new_lw, gate=accept_move)
    if adapt and eng.slice_kernel == "quantile" and eng.q_adapt:
        # the coordinate's pseudo-target: loc toward accepted draws, log
        # scale toward log(pseudo_c * |draw - loc|); frozen for sampling
        r = eng._adapt_rate
        new_loc = (1.0 - r) * q_loc_l + r * b_star
        target_q = torch.log(eng.q_c * torch.abs(b_star - q_loc_l) + 1e-6)
        new_lw = (1.0 - r) * lw_j + r * target_q
        logw = eng._commit_row(s.logw, s.j, new_lw, gate=accept_move)
        qloc = eng._commit_row(s.qloc, s.j, new_loc, gate=accept_move)
    return logw, qloc


def _finish(eng, s, sweep_count, draws, nevbuf, n_sweeps, shrink_only,
            stepout_sweeps, active, commit, beta, nev_new, logw, qloc,
            ubatch, regs, g=None):
    """Coordinate/sweep bookkeeping, fresh registers for committing lanes
    and the frozen registers of idle lanes; returns the pass's outputs.

    ``regs`` holds the pass's advanced registers (phase, stepdir, L, R,
    budL, budR, xprop, n_shrink) and ``eta``/``ld0``."""
    j_next = torch.where(commit, s.j + 1, s.j)
    sweep_done = commit & (j_next >= eng.d)
    draws, nevbuf = eng._sweep_buffers(draws, nevbuf, sweep_count, beta,
                                       nev_new, sweep_done)
    sweep_count = torch.where(sweep_done, sweep_count + 1, sweep_count)
    j_next = torch.where(sweep_done, 0, j_next)

    # in two-phase warmup a lane switches to the shrink-only kernel once
    # ITS sweep count crosses the stepout quota
    so_eff = shrink_only
    if stepout_sweeps is not None and not shrink_only:
        so_eff = sweep_count >= stepout_sweeps
    reg = eng._begin_coord(beta, logw, j_next, so_eff, ubatch, qloc=qloc,
                           g=g)
    logw_j = reg.pop("logw_j", None)
    if logw_j is not None:  # latent: commit the refreshed bracket width
        logw = eng._commit_row(logw, j_next, logw_j, gate=commit)

    def pick(name, old):
        return torch.where(commit, reg[name], old)

    # INACTIVE lanes (sweep quota filled, idling while slower chains
    # finish) must not advance their automaton registers: a lane that
    # burned its shrink budget while idle would exhaust-commit b0 at the
    # next run's first pass, freezing the first coordinate after the wrap
    def keep(name, old):
        return torch.where(active, pick(name, regs[name]), old)

    fields = dict(
        beta=beta, eta=regs["eta"], ld0=regs["ld0"], key=s.key,
        ctr=s.ctr + active.any().to(torch.int64), logw=logw, j=j_next,
        phase=keep("phase", s.phase),
        stepdir=keep("stepdir", s.stepdir),
        level=pick("level", s.level),
        L=keep("L", s.L), R=keep("R", s.R),
        budL=keep("budL", s.budL), budR=keep("budR", s.budR),
        b0=pick("b0", s.b0), lp0=pick("lp0", s.lp0), w=pick("w", s.w),
        xprop=keep("xprop", s.xprop),
        n_shrink=keep("n_shrink", s.n_shrink),
        nev=nev_new,
    )
    if qloc is not None:  # QuantileState (pseudo_adapt)
        fields["qloc"] = qloc
    return type(s)(**fields), sweep_count, draws, nevbuf


def run_pass(eng, s, sweep_count, draws, nevbuf, n_sweeps,
             adapt: bool, shrink_only, stepout_sweeps=None, u=None, g=None,
             live=None):
    """One target evaluation + automaton advance for every chain."""
    active = _active(sweep_count, n_sweeps, live)
    nb = eng._n_begin_u
    if u is None:
        r = _draws(eng, s)
        u, g = r["u"], r.get("g")
    u_shrink = u[:, 0]
    q_loc_l, q_scale_l, lw_j = _pseudo_target(eng, s)

    xg = eng.Xt[s.j.long()]  # (C, n) row gather
    quantile = eng.slice_kernel == "quantile"
    xp_x = _to_x(eng, s, s.xprop, q_loc_l, q_scale_l)
    e = s.eta + xg * (xp_x - s.b0)[:, None]
    ld_e = eng._ld_eta(e, eng.y, eng.extra)
    if eng.eval_cache == "scalar":
        lsum_e = eng.reduce_fn(ld_e)
        dll = lsum_e - s.ld0
    else:
        dll = eng.reduce_fn(ld_e - s.ld0)
    f = dll + (eng._coord_lp(s.beta, s.j, xp_x) - s.lp0)
    if quantile:
        # transformed target h = f - log psi, relative to the committed point
        f = f + (eng.quantile_logpdf(s.b0, q_loc_l, q_scale_l)
                 - eng.quantile_logpdf(xp_x, q_loc_l, q_scale_l))
    above = f > s.level

    stepping = s.phase == 0
    left = s.stepdir == 0
    # stepping-out transitions (this pass tested endpoint s.xprop)
    step_more_L = stepping & left & above & (s.budL > 0)
    L = torch.where(step_more_L, s.L - s.w, s.L)
    budL = torch.where(step_more_L, s.budL - 1, s.budL)
    done_L = stepping & left & ~step_more_L
    step_more_R = stepping & ~left & above & (s.budR > 0)
    R = torch.where(step_more_R, s.R + s.w, s.R)
    budR = torch.where(step_more_R, s.budR - 1, s.budR)
    done_R = stepping & ~left & ~step_more_R
    stepdir = torch.where(done_L, 1, s.stepdir)
    phase = torch.where(done_R, 1, s.phase)

    # shrinkage transitions; quantile brackets close toward u0 = F(b0)
    # (the w register), x-space brackets toward b0
    shrinking = s.phase == 1
    accept_move = shrinking & (f >= s.level) & active
    rej = shrinking & (f < s.level)
    exhausted = rej & (s.n_shrink + 1 >= eng.max_shrink) & active
    piv = _pivot(eng, s)
    L = torch.where(rej & (s.xprop < piv), s.xprop, L)
    R = torch.where(rej & (s.xprop >= piv), s.xprop, R)
    n_shrink = torch.where(shrinking, s.n_shrink + 1, s.n_shrink)

    # commit: the evaluated e / ld(e) ARE the new state on acceptance;
    # shrink exhaustion commits b0 (state unchanged)
    commit = accept_move | exhausted
    b_star = torch.where(accept_move, xp_x, s.b0)
    eta = torch.where(accept_move[:, None], e, s.eta)
    if eng.eval_cache == "scalar":
        ld0 = torch.where(accept_move, lsum_e, s.ld0)
    else:
        ld0 = torch.where(accept_move[:, None], ld_e, s.ld0)
    beta = eng._commit_row(s.beta, s.j, b_star)
    logw, qloc = _adapt(eng, s, adapt, b_star, accept_move, q_loc_l, lw_j)
    nev_new = s.nev + active.to(torch.int32)

    # non-commit proposal for the next pass: the (possibly moved)
    # endpoint while stepping, else uniform on the current (L, R)
    in_shrink = (shrinking | done_R) & ~commit
    xprop_nc = torch.where(in_shrink, L + (R - L) * u_shrink,
                           torch.where(stepdir == 0, L, R))
    regs = dict(eta=eta, ld0=ld0, phase=phase, stepdir=stepdir, L=L, R=R,
                budL=budL, budR=budR, xprop=xprop_nc, n_shrink=n_shrink)
    return _finish(eng, s, sweep_count, draws, nevbuf, n_sweeps,
                   shrink_only, stepout_sweeps, active, commit, beta,
                   nev_new, logw, qloc, u[:, 1:1 + nb], regs, g)


@ranged("pass.proposals")
def spec_proposals(eng, s, U):
    """The (C, K) speculative proposal battery of one pass.

    Shrink lanes get the all-rejections chain (the interval recursion is
    deterministic given the uniforms ``U``); stepping lanes the endpoint
    battery in the active direction.  Returns a dict with the bracket-space
    proposals ``xs``, their x-space images ``xs_eval``, the shrink
    brackets ``Ls_sh``/``Rs_sh`` after each rejection, ``deltas``,
    ``fprior`` (prior and pseudo-density terms of f) and the pseudo-target
    ``q_loc_l``/``q_scale_l``/``lw_j`` (None unless pseudo_adapt)."""
    K = U.shape[1]
    quantile = eng.slice_kernel == "quantile"
    piv = _pivot(eng, s)
    xs_sh, Ls_sh, Rs_sh = [], [], []
    Lc, Rc = s.L, s.R
    for k in range(K):
        x = Lc + (Rc - Lc) * U[:, k]
        xs_sh.append(x)
        Lc = torch.where(x < piv, x, Lc)
        Rc = torch.where(x >= piv, x, Rc)
        Ls_sh.append(Lc)
        Rs_sh.append(Rc)
    xs_sh = torch.stack(xs_sh, 1)
    ks = torch.arange(K, dtype=eng.dtype, device=U.device)[None, :]
    x_step = torch.where(
        (s.stepdir == 0)[:, None],
        s.L[:, None] - ks * s.w[:, None],
        s.R[:, None] + ks * s.w[:, None],
    )
    xs = torch.where((s.phase == 0)[:, None], x_step, xs_sh)
    q_loc_l, q_scale_l, lw_j = _pseudo_target(eng, s)
    qloc_k = None if q_loc_l is None else q_loc_l[:, None]
    qscale_k = None if q_scale_l is None else q_scale_l[:, None]
    xs_eval = _to_x(eng, s, xs, q_loc_l, q_scale_l)
    deltas = xs_eval - s.b0[:, None]
    fprior = eng._coord_lp(s.beta, s.j, xs_eval) - s.lp0[:, None]
    if quantile:
        fprior = fprior + (
            eng.quantile_logpdf(s.b0, q_loc_l, q_scale_l)[:, None]
            - eng.quantile_logpdf(xs_eval, qloc_k, qscale_k)
        )
    return dict(xs=xs, xs_eval=xs_eval, Ls_sh=torch.stack(Ls_sh, 1),
                Rs_sh=torch.stack(Rs_sh, 1), deltas=deltas, fprior=fprior,
                q_loc_l=q_loc_l, q_scale_l=q_scale_l, lw_j=lw_j)


def run_pass_spec(eng, s, sweep_count, draws, nevbuf, n_sweeps,
                  adapt: bool, shrink_only, stepout_sweeps=None, u=None,
                  g=None, live=None):
    """K target evaluations + automaton advance per chain per pass.

    In Neal's shrinkage the all-rejections proposal path is deterministic
    given the uniforms, so x_1..x_K are generated up front, all K targets
    evaluated in one battery, and the FIRST acceptor selected: the
    committed draw has exactly the single-proposal kernel's law.  The
    keep-stepping endpoint sequence L, L-w, L-2w, ... is deterministic too,
    so a stepping pass tests a K-endpoint battery.  ``nev`` counts the
    evaluations the single-proposal kernel would have consumed."""
    dtype = eng.dtype
    K = eng.spec_k
    active = _active(sweep_count, n_sweeps, live)
    nb = eng._n_begin_u
    if u is None:
        r = _draws(eng, s)
        u, g = r["u"], r.get("g")
    p = spec_proposals(eng, s, u[:, :K])
    deltas, fprior = p["deltas"], p["fprior"]

    stepping = s.phase == 0
    left = s.stepdir == 0
    shrinking = s.phase == 1
    # >= 1 for active shrink lanes; clamped because inactive lanes keep
    # evaluating past their quota without ever committing
    rem = torch.clamp(eng.max_shrink - s.n_shrink, min=0)

    # -- one battery evaluation of the K proposals --
    impl = eng.battery_impl
    eta_committed = None
    xg = None
    lsum_abs = None  # fresh scalar sums, kept for the cache refresh
    if impl in ("cuda2", "cuda3"):
        scal = torch.stack(
            [s.level, s.ld0, (shrinking & active).to(dtype), rem.to(dtype)],
            1)
        if impl == "cuda3":  # row gather inside the kernel
            lsum_abs, eta_committed = battery_gather_commit(
                s.j, eng._Xt_rows, s.eta, deltas, fprior, scal, eng.y,
                eng._mask, eng.family, eng._extra_host)
        else:
            xg = eng.Xt[s.j.long()]
            lsum_abs, eta_committed = battery_commit(
                s.eta, xg, deltas, fprior, scal, eng.y, eng._mask,
                eng.family, eng._extra_host)
    elif impl == "cuda":
        xg = eng.Xt[s.j.long()]
        lsum_abs = battery_sums(s.eta, xg, deltas, eng.y, eng._mask,
                                eng.family, eng._extra_host)
        if eng.combine_sums is not None:  # an obs shard's partial sums
            lsum_abs = eng.combine_sums(lsum_abs)
    else:
        xg = eng.Xt[s.j.long()]
        if eng.eval_cache == "scalar":
            lsum_abs = plain_battery(
                s.eta, xg, deltas, eng.y,
                lambda e, y: eng._ld_eta(e, y, eng.extra), eng.reduce_fn)
        else:
            e = s.eta[:, None, :] + xg[:, None, :] * deltas[:, :, None]
            ld_e = eng._ld_eta(e, eng.y, eng.extra)
            dll = eng.reduce_fn(ld_e - s.ld0[:, None, :])
    if lsum_abs is not None:
        dll = lsum_abs - s.ld0[:, None]
    f = dll + fprior  # (C, K)

    # -- stepping-out: consume the battery along the keep-stepping path --
    na = ~(f > s.level[:, None])
    m_na = torch.where(na.any(1), torch.argmax(na.to(torch.uint8), 1),
                       K).to(torch.int32)
    bud = torch.where(left, s.budL, s.budR)
    moves = torch.clamp(torch.minimum(m_na, bud), max=K)  # w-steps taken
    done_dir = moves < K
    consumed_step = torch.clamp(moves, max=K - 1) + 1
    movesf = moves.to(dtype)
    L_step = torch.where(left, s.L - movesf * s.w, s.L)
    R_step = torch.where(left, s.R, s.R + movesf * s.w)
    budL = torch.where(left, s.budL - moves, s.budL)
    budR = torch.where(left, s.budR, s.budR - moves)
    stepdir = torch.where(stepping & left & done_dir, 1, s.stepdir)
    phase = torch.where(stepping & ~left & done_dir, 1, s.phase)

    # -- shrinkage: first acceptor in the battery --
    any_acc, idx = first_acceptor(f, s.level, rem)
    idx = idx.to(torch.int32)
    consumed_sh = torch.where(any_acc, idx + 1, torch.clamp(rem, max=K))
    accept_move = shrinking & any_acc & active
    exhausted = shrinking & ~any_acc & (
        s.n_shrink + consumed_sh >= eng.max_shrink) & active
    last = torch.clamp(consumed_sh - 1, 0, K - 1)
    L_sh = _gather(p["Ls_sh"], last)
    R_sh = _gather(p["Rs_sh"], last)
    n_shrink = torch.where(shrinking, s.n_shrink + consumed_sh, s.n_shrink)
    L = torch.where(stepping, L_step, L_sh)
    R = torch.where(stepping, R_step, R_sh)

    # -- commit --
    x_star = _gather(p["xs_eval"], idx)
    commit = accept_move | exhausted
    b_star = torch.where(accept_move, x_star, s.b0)
    if eta_committed is not None:
        # the kernel already applied eta += x * delta* from its own sums
        eta = eta_committed
    else:
        delta_star = torch.where(accept_move, x_star - s.b0, 0.0)
        eta = s.eta + xg * delta_star[:, None]
    if eng.eval_cache == "scalar":
        # refresh the cache with the accepted proposal's FRESH sum; the
        # accumulated ld0 + dll would random-walk its f32 error per chain
        ld0 = torch.where(accept_move, _gather(lsum_abs, idx), s.ld0)
    else:
        ld0 = torch.where(accept_move[:, None],
                          eng._ld_eta(eta, eng.y, eng.extra), s.ld0)
    beta = eng._commit_row(s.beta, s.j, b_star)
    logw, qloc = _adapt(eng, s, adapt, b_star, accept_move, p["q_loc_l"],
                        p["lw_j"])

    consumed = torch.where(stepping, consumed_step, consumed_sh)
    nev_new = s.nev + torch.where(active, consumed, 0)
    regs = dict(eta=eta, ld0=ld0, phase=phase, stepdir=stepdir, L=L, R=R,
                budL=budL, budR=budR, xprop=s.xprop, n_shrink=n_shrink)
    return _finish(eng, s, sweep_count, draws, nevbuf, n_sweeps,
                   shrink_only, stepout_sweeps, active, commit, beta,
                   nev_new, logw, qloc, u[:, K:K + nb], regs, g)
