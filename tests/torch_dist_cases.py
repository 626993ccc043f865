"""What each rank of the port's spawned CPU worlds runs for
tests/test_torch_sharding.py and tests/test_torch_checkpoint.py.

The functions run in processes that ``parallel.launch.run_local`` spawns
(one "gloo" process group each, joined through a FileStore): they import
torch and the port only, run several checks in one world, and return
plain numpy results to the test process, which holds them against the
JAX package and the port's own invariants."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.ops import freerun_batteries as fb
from mcmcglm_tpu_torch.ops import freerun_passes as tp
from mcmcglm_tpu_torch.ops.philox import fold_seed
from mcmcglm_tpu_torch.parallel import make_mesh, pooled

# the collectives a sharded run could issue
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "broadcast", "reduce", "reduce_scatter", "all_to_all",
               "barrier", "monitored_barrier", "send", "recv", "isend",
               "irecv", "gather", "scatter")

QUANTILE = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}
PASS_SWEEPS = 3  # the one-pass comparison's sweep quota


class CountCollectives:
    """Counts calls of every ``torch.distributed`` collective while
    active (the engines call them through the module attribute)."""

    def __init__(self):
        self.calls = {}
        self._saved = {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(dist, name)
            self._saved[name] = fn

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **k)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def gaussian_problem(n=203, d=5, seed=0):
    """n not divisible by 2 or 4: the obs meshes pad."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta = np.array([1.0, 1.5, 2.0, -0.5, 0.3])[:d]
    y = rng.normal(X @ beta, 1.0)
    return X, y


def _np(t):
    return t.detach().cpu().numpy()


def _state_np(st):
    return {k: (_np(v) if torch.is_tensor(v) else v)
            for k, v in st._asdict().items()}


def law_run(eng, seed, C, warm, sweeps):
    """Warmup and a run; every chain's draws and evaluations per
    coordinate of the run, gathered; this rank's state."""
    st = eng.init(seed, C)
    st, _, _ = eng.warmup(st, warm)
    nev0 = st.nev.clone()
    st, draws, _ = eng.run(st, sweeps)
    rate = (st.nev - nev0).double() / (sweeps * eng.inner.d)
    return _np(eng.gather(draws)), _np(eng.gather(rate)), st


def one_pass(eng, rank, steps, n_sweeps):
    """One pass of the port from each converted JAX state with the JAX
    uniforms (quantile kernel, warmup mode): the new fields, the
    all-reduced battery sums with their proposals, and f and the level for
    the lanes' margins."""
    inner = eng.inner
    out = []
    for step in steps:
        st = mt.convert_sharded_state(step["state"], eng, rank)
        u = torch.tensor(step["u"][eng.shard])
        sc, draws, nevbuf = step["sc"], step["draws"], step["nevbuf"]
        p = tp.spec_proposals(inner, st, u[:, :inner.spec_k])
        lsum = fb.plain_battery(
            st.eta, inner.Xt[st.j.long()], p["deltas"], inner.y,
            lambda e, y: inner._ld_eta(e, y, inner.extra), inner.reduce_fn)
        f = (lsum - st.ld0[:, None]) + p["fprior"]
        rows = slice(eng.shard * st.beta.shape[0],
                     (eng.shard + 1) * st.beta.shape[0])
        t2, sc2, dr2, nb2 = tp.run_pass_spec(
            inner, st, torch.tensor(sc[rows]), torch.tensor(draws[rows]),
            torch.tensor(nevbuf[rows]), n_sweeps, True, False, None, u=u)
        out.append(dict(state=_state_np(t2), sc=_np(sc2), draws=_np(dr2),
                        nevbuf=_np(nb2), lsum=_np(lsum),
                        deltas=_np(p["deltas"]), f=_np(f),
                        level=_np(st.level)))
    return out


def world2(rank, jax_inputs):
    """Rank ``rank`` of a world of two: the chain mesh (2, 1) and the obs
    mesh (1, 2)."""
    X, y = gaussian_problem()
    d = X.shape[1]
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), d)
    kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5}, spec_k=4, device="cpu")
    res = {}
    m21 = make_mesh(2, 1, device_type="cpu")
    m12 = make_mesh(1, 2, device_type="cpu")

    # -- the chain mesh: a chain shard is bitwise standalone, with no
    #    collective from init to the last draw
    eng = mt.ShardedFreeRunCGGibbs(X, y, "gaussian", prior, mesh=m21, **kw)
    with CountCollectives() as cc:
        st = eng.init(3, 8)
        st_w, _, _ = eng.warmup(st, 5)
        st_r, draws, nevbuf = eng.run(st_w, 20)
        st_t, mom, kept, _, es = eng.run_thinned(st_r, 6, 2, ess=True)
    res["chain_collectives"] = dict(cc.calls)
    alone = mt.FreeRunCGGibbs(X, y, "gaussian", prior, **kw)
    a = alone.init(fold_seed(3, rank), 4)
    a, _, _ = alone.warmup(a, 5)
    a, d1, n1 = alone.run(a, 20)
    a2, mom1, kept1, _, es1 = alone.run_thinned(a, 6, 2, ess=True)
    res["chain_standalone"] = all(
        torch.equal(x, y_) for x, y_ in
        [(draws, d1), (nevbuf, n1), (kept, kept1), (mom.mean, mom1.mean),
         (mom.m2, mom1.m2), (es.s, es1.s)]
        + list(zip(st_t, a2)))
    # run_passes and warmup_passes are bitwise run and warmup
    sc, buf, nb = None, None, None
    s = st_w
    while sc is None or not bool((sc >= 20).all()):
        s, sc, buf, nb = eng.run_passes(s, sc, buf, nb, 20, 7)
    res["chain_run_passes"] = (torch.equal(buf, draws)
                               and torch.equal(nb, nevbuf)
                               and all(torch.equal(x, y_)
                                       for x, y_ in zip(s, st_r)))
    s, sc = st, None
    while sc is None or not bool((sc >= 5).all()):
        s, sc = eng.warmup_passes(s, sc, 5, 9)
    res["chain_warmup_passes"] = all(torch.equal(x, y_)
                                     for x, y_ in zip(s, st_w))
    # the pooled summary over all chains, merged across the ranks
    summ = pooled.pooled_summary(mom, group=eng.chain_group)
    res["pooled_mean"] = _np(summ["mean"])
    res["all_means"] = _np(eng.gather(mom.mean))
    res["pooled_ess"] = _np(pooled.ess_from_state(es, group=eng.chain_group))
    res["all_kept"] = _np(eng.gather(kept))
    # (S, 1) obs-sharded is bitwise chain-sharded
    eo = mt.ObsShardedFreeRunCGGibbs(X, y, "gaussian", prior, mesh=m21, **kw)
    so, _, _ = eo.warmup(eo.init(3, 8), 5)
    so, d_o, n_o = eo.run(so, 20)
    res["obs21_bitwise"] = (torch.equal(d_o, draws) and torch.equal(n_o,
                                                                    nevbuf)
                            and all(torch.equal(x, y_)
                                    for x, y_ in zip(so, st_r)))
    res["obs21_loop"] = eo.loop_reason
    # ShardedCGGibbs on (S, 1) is bitwise the single-card CGGibbs
    lk = dict(extra={"sd": 1.0}, tuning={"w": 0.5}, device="cpu")
    b, nev, _ = mt.ShardedCGGibbs(X, y, "gaussian", prior, mesh=m21,
                                  **lk).sample(0, 6, 8)
    b1, nev1, _ = mt.CGGibbs(X, y, "gaussian", prior, **lk).sample(0, 6, 8)
    res["lockstep21_bitwise"] = (np.array_equal(b, b1)
                                 and np.array_equal(nev, nev1))

    # -- the chain mesh in law (binomial, the bench's sampler)
    Xb, yb = jax_inputs["binomial"]
    eb = mt.ShardedFreeRunCGGibbs(
        Xb, yb, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), Xb.shape[1]),
        mesh=m21, tuning=QUANTILE, slice_kernel="quantile", spec_k=4,
        device="cpu")
    res["law_chain"] = law_run(eb, 1, 16, 30, 120)[:2]

    # -- the obs mesh: in law, padding, one all-reduce per pass, ranks agree
    e12 = mt.ObsShardedFreeRunCGGibbs(X, y, "gaussian", prior, mesh=m12, **kw)
    res["obs12_n_local"] = int(e12.inner.Xt.shape[1])
    with CountCollectives() as cc:
        blocks0 = e12.inner.loop_stats["blocks"]
        draws12, rate12, st12 = law_run(e12, 1, 8, 30, 120)
        blocks = e12.inner.loop_stats["blocks"] - blocks0
    res["law_obs12"] = (draws12, rate12)
    # every pass the loop ran (idle ones past the quota too) made one
    # all-reduce; init made one more; the gathers are all_gather
    res["obs12_allreduce"] = (cc.calls.get("all_reduce", 0),
                              blocks * e12.inner._block_passes + 1)
    res["obs12_other_collectives"] = {k: v for k, v in cc.calls.items()
                                      if k != "all_reduce"}
    res["obs12_state"] = _state_np(st12)
    ref = st12.beta.double() @ e12.inner.Xt.double()
    res["obs12_eta_drift"] = float((st12.eta.double() - ref).abs().max())
    sc, buf, nb = None, None, None
    s = st12
    s_run, d_run, n_run = e12.run(st12, 10)
    while sc is None or not bool((sc >= 10).all()):
        s, sc, buf, nb = e12.run_passes(s, sc, buf, nb, 10, 5)
    res["obs12_run_passes"] = (torch.equal(buf, d_run)
                               and torch.equal(nb, n_run)
                               and all(torch.equal(x, y_)
                                       for x, y_ in zip(s, s_run)))
    b12, _, _ = mt.ShardedCGGibbs(X, y, "gaussian", prior, mesh=m12,
                                  **lk).sample(0, 60, 8)
    res["lockstep12"] = b12

    # -- one pass from the JAX states (binomial n=300: no padding)
    for name, mesh in (("pass_chain", m21), ("pass_obs", m12)):
        cls = (mt.ObsShardedFreeRunCGGibbs if name == "pass_obs"
               else mt.ShardedFreeRunCGGibbs)
        Xp, yp = jax_inputs["pass_problem"]
        ep = cls(Xp, yp, "binomial",
                 mt.IIDPrior(mt.Normal(0.0, 1.0), Xp.shape[1]), mesh=mesh,
                 tuning=QUANTILE, slice_kernel="quantile", spec_k=4,
                 device="cpu")
        res[name] = one_pass(ep, rank, jax_inputs[name], PASS_SWEEPS)

    # -- the api routes and the validation errors
    res["routes"] = routes(X, y, m21, m12)
    res["errors"] = errors(X, y, prior, m21, m12)
    return res


def routes(X, y, m21, m12):
    kw = dict(X=X, y=y, family="gaussian", w=0.5, n_samples=60, burnin=20,
              n_chains=8, device="cpu", log_likelihood_extra_args={"sd": 1.0})
    out = {}
    for name, extra in (("chain", dict(mesh=m21)),
                        ("obs", dict(mesh=m12, engine="freerun")),
                        ("lockstep", dict(mesh=m12, engine="xla")),
                        ("thinned", dict(mesh=m21, thin=2))):
        fit = mt.mcmcglm(**kw, **extra)
        out[name] = (type(fit.sampler).__name__, fit.beta.shape,
                     fit.post_burnin().reshape(-1, X.shape[1]).mean(0))
    return out


def _raises(fn, match):
    try:
        fn()
    except (ValueError, RuntimeError) as exc:
        return match in str(exc), str(exc)
    return False, "no error"


def errors(X, y, prior, m21, m12):
    kw = dict(extra={"sd": 1.0}, tuning={"w": 0.5}, device="cpu")
    return {
        "chain_obs_mesh": _raises(lambda: mt.ShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m12, **kw), "observation"),
        "chain_divisible": _raises(lambda: mt.ShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m21, **kw).init(0, 7), "divisible"),
        "obs_commit_battery": _raises(lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m12, battery_impl="cuda3", **kw),
            "shard-LOCAL sums"),
        "obs_reduce_fn": _raises(lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m12,
            reduce_fn=lambda t: t.sum(-1), **kw), "reduce_fn"),
        "obs_weights_length": _raises(lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m12, obs_weights=np.ones(3), **kw),
            "obs_weights length"),
        "obs_scalar_extra": _raises(lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m12, tuning={"w": 0.5},
            extra={"sd": np.ones(X.shape[0])}, device="cpu"), "scalar extra"),
        "obs_divisible": _raises(lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m21, **kw).init(0, 7), "divisible"),
        "obs_graph_cpu": _raises(lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "gaussian", prior, mesh=m12, graph=True, **kw), "CUDA"),
        "lockstep_divisible": _raises(lambda: mt.ShardedCGGibbs(
            X, y, "gaussian", prior, mesh=m21, **kw).init(0, 7),
            "divisible"),
        "lockstep_weights": _raises(lambda: mt.mcmcglm(
            X=X, y=y, family="gaussian", w=0.5, engine="xla", mesh=m12,
            weights=np.ones(X.shape[0]), device="cpu"), "weights"),
        "fused_mesh": _raises(lambda: mt.mcmcglm(
            X=X, y=y, family="gaussian", w=0.5, engine="fused", mesh=m21,
            n_chains=8, device="cpu"), "single-chip"),
        "mesh_shape": _raises(lambda: make_mesh(3, 1, device_type="cpu"),
                              "mesh 3x1 != 2 devices"),
        "mesh_obs_divisible": _raises(
            lambda: make_mesh(None, 3, device_type="cpu"), "not divisible"),
    }


def world4(rank):
    """Rank ``rank`` of a world of four: the obs-sharded engine on the
    (2, 2) mesh."""
    X, y = gaussian_problem()
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), X.shape[1])
    mesh = make_mesh(2, 2, device_type="cpu")
    eng = mt.ObsShardedFreeRunCGGibbs(X, y, "gaussian", prior, mesh=mesh,
                                      extra={"sd": 1.0}, tuning={"w": 0.5},
                                      spec_k=4, device="cpu")
    with CountCollectives() as cc:
        blocks0 = eng.inner.loop_stats["blocks"]
        draws, rate, st = law_run(eng, 2, 8, 30, 120)
        blocks = eng.inner.loop_stats["blocks"] - blocks0
    return dict(law=(draws, rate), state=_state_np(st),
                allreduce=(cc.calls.get("all_reduce", 0),
                           blocks * eng.inner._block_passes + 1),
                n_local=int(eng.inner.Xt.shape[1]))
