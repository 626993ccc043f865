"""What each rank of the pooled monitor's spawned CPU world runs for
tests/test_torch_pooled_monitor.py: the chain-sharded engine's thinned
collection at thin=1, its moments and ESS state merged over the chain
group ("gloo"), and what the test process holds against the plain
reference (``benchmark/reference/pooled_monitor.py``) and the program's
own invariants."""

from __future__ import annotations

import torch

import mcmcglm_tpu_torch as mt
from mcmcglm_tpu_torch.parallel import make_mesh, pooled
from mcmcglm_tpu_torch.utils import profiling

N, D, C = 600, 8, 16
STEPS, SWEEPS, LAG = 2, 32, 64
QUANTILE = {"pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}


def problem(seed=11):
    """Seeded logistic data at the test's size."""
    X, y, _ = mt.generate_glm_data("binomial", n=N, d=D, seed=seed)
    return X, y


def _np(t):
    return t.detach().double().cpu().numpy()


def _summaries(summ, ess=None):
    out = {k: _np(summ[k]) for k in ("mean", "var", "rhat")}
    if ess is not None:
        out["ess"] = _np(ess)
    return out


def monitor_world(rank):
    """Rank ``rank`` of a world of two on a (2, 1) chain mesh: burn-in,
    then ``STEPS`` monitor steps of ``run_thinned(SWEEPS, 1, moments=
    <carried>, ess=True)`` and the merged summaries, as the benchmark's
    driver makes them."""
    X, y = problem()
    eng = mt.ShardedFreeRunCGGibbs(
        X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), D),
        mesh=make_mesh(2, 1, device_type="cpu"), tuning=QUANTILE,
        slice_kernel="quantile", spec_k=4, device="cpu")
    st, _, _ = eng.warmup(eng.init(5, C), 10)
    res, mom, kept = {}, None, []
    for step in range(STEPS):
        # one run of SWEEPS sweeps from the same state, for the bitwise
        # comparison
        st_run, d_run, n_run = eng.run(st, SWEEPS)
        profiling.reset_spans()
        st, mom, draws, nev, es, nev_at = eng.run_thinned(
            st, SWEEPS, 1, moments=mom, ess=True, ess_max_lag=LAG,
            nev_at_draws=True)
        kept.append(draws)
        counts0 = dict(pooled.merge_counts)
        summ = pooled.pooled_summary(mom, group=eng.chain_group)
        ess = pooled.ess_from_state(es, group=eng.chain_group)
        if step == 0:
            got = profiling.spans()
            res["spans"] = [(s["name"], s["id"] == s["call"], s["args"],
                             s["t0"], s["t1"]) for s in got]
            res["sizes"] = ([t.numel() * t.element_size() for t in mom]
                            + [getattr(es, k).numel()
                               * getattr(es, k).element_size()
                               for k in ("s", "ring", "first", "total")])
            res["counts"] = {k: pooled.merge_counts[k] - counts0[k]
                             for k in counts0}
            res["as_run"] = (
                torch.equal(draws, d_run) and torch.equal(nev_at, n_run)
                and all(torch.equal(a, b) for a, b in zip(st, st_run)))
            res["last_is_state"] = torch.equal(draws[:, -1], st.beta)
            res["nev_is_state"] = torch.equal(nev, st.nev)
            res["es_count"] = int(es.count)
    res["summ"] = _summaries(summ, ess)
    every = torch.cat(kept, 1)
    bf = torch.bfloat16
    mom_bf = pooled.fold_moments(pooled.ChainMoments(
        torch.zeros(every.shape[0], dtype=bf),
        torch.zeros(every.shape[0], D, dtype=bf),
        torch.zeros(every.shape[0], D, dtype=bf)), every.to(bf))
    res["summ_bf16"] = _summaries(pooled.pooled_summary(
        mom_bf, group=eng.chain_group))
    res["draws"] = _np(eng.gather(every))
    res["count"] = _np(pooled.merge_moments(mom, eng.chain_group).count)
    return res
