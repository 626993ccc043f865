"""Run the baseline config matrix on the port and print one JSON line per
config: the counterpart of ``scripts/baseline_configs.py`` on the card.

Configs (BASELINE.md):
  1. gaussian n=1000 p=3 (README example): the correctness anchor
  2. logistic n=10k p=100, normal prior (+ NUTS cross-check)
  3. poisson/log n=10k p=100, Laplace (sparse) prior (+ NUTS cross-check)
  4. gaussian p=10k linear-runtime stress (prior-mean init, the exact
     conjugate pass, the slice path as its cross-check)
  5. 4096 chains of p=1000 logistic on ``ShardedFreeRunCGGibbs`` over a
     one-rank mesh, pass-bounded collection and pooled R-hat and ESS

``max_err_sd`` / ``med_err_sd`` are |posterior mean - true beta| in units
of the estimated posterior sd of that coordinate (a z-score: below about
3 the truth sits inside the posterior bulk).  Configs 2 and 3 also hold
the CGGibbs posterior mean against NUTS (``baselines.nuts_sample``) on the
same log density, in the same units (``nuts_max_diff_sd``).  Every number
is this run's own, on the card it names.

    python scripts/torch_baseline_configs.py                 # all five, on CUDA
    python scripts/torch_baseline_configs.py --only 2
    python scripts/torch_baseline_configs.py --small --skip-pod --device cpu

It imports numpy and the port only (no JAX, no pandas).
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402


def _log(msg):
    print(time.strftime("%H:%M:%S"), msg, file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _err_in_sd_units(draws, beta_true):
    """z-scores of the posterior-mean error: (C, K, d) draws -> (d,)."""
    flat = draws.reshape(-1, draws.shape[-1])
    post_mean = flat.mean(0)
    post_sd = np.maximum(flat.std(0), 1e-12)
    return np.abs(post_mean - beta_true) / post_sd, post_mean, post_sd


def _nuts_crosscheck(X, y, family, prior, extra, post_mean, post_sd, device,
                     seed=7, n_chains=8, n_warmup=300, n_samples=300):
    """Posterior-mean agreement with NUTS on the identical log density, in
    posterior-sd units."""
    from mcmcglm_tpu_torch.baselines import make_log_posterior, nuts_sample

    d = X.shape[1]
    logpost = make_log_posterior(X, y, family, prior, extra=extra,
                                 device=device)
    init = 0.1 * torch.tensor(
        np.random.default_rng(seed + 1).normal(size=(n_chains, d)),
        dtype=torch.float32)
    t0 = time.perf_counter()
    res = nuts_sample(seed, logpost, init, n_warmup=n_warmup,
                      n_samples=n_samples, device=device)
    _sync(device)
    nuts_s = time.perf_counter() - t0
    nuts_mean = res.samples.cpu().double().numpy().reshape(-1, d).mean(0)
    diff_sd = np.abs(post_mean - nuts_mean) / post_sd
    return {
        "nuts_max_diff_sd": round(float(diff_sd.max()), 3),
        "nuts_med_diff_sd": round(float(np.median(diff_sd)), 3),
        "nuts_accept": round(float(res.accept_rate.mean()), 3),
        "nuts_mean_depth": round(float(res.mean_depth.mean()), 2),
        "nuts_seconds": round(nuts_s, 2),
    }


def _engine_opts(device):
    """The main path's options on the card (the speculative battery on
    "cuda3"); spec_k=1 on the CPU."""
    if torch.device(device).type == "cpu":
        return {}
    return {"spec_k": 4, "battery_impl": "cuda3"}


def _warmup(eng, state, burnin, chunk, name):
    """Adaptive burn-in in chunks, threading the stepping-out quota."""
    stepout_total = eng._auto_stepout(burnin)
    done = 0
    while done < burnin:
        step = min(chunk, burnin - done)
        state, _, _ = eng.warmup(state, step,
                                 stepout_sweeps=max(0, stepout_total - done))
        done += step
        _log(f"{name}: warmup {done}/{burnin}")
    return state


def _collect(eng, state, timed, chunk, device):
    """``timed`` sampling sweeps in chunks: (state, draws (C, timed, d)
    numpy, seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    parts, done = [], 0
    while done < timed:
        step = min(chunk, timed - done)
        state, betas, _ = eng.run(state, step)
        parts.append(betas)  # stays on the device while timed
        done += step
    _sync(device)
    dt = time.perf_counter() - t0
    return state, torch.cat(parts, 1).cpu().numpy(), dt


def run_config(name, family, n, d, prior, w, n_chains, burnin, timed, device,
               extra=None, nuts_check=False, init_at_prior_mean=False,
               engine_opts=None, coord_sampler="slice",
               slice_crosscheck=False):
    """The free-running engine: adaptive-width warmup over the burn-in,
    then frozen-width sampling.  ``coord_sampler="conjugate"`` runs the
    exact normal coordinate draws (config 4), and ``slice_crosscheck``
    also runs the slice path on the same problem and reports the
    posterior-mean agreement in posterior-sd units."""
    X, y, beta_true = generate_glm_data(family, n=n, d=d, seed=0)
    conj = coord_sampler == "conjugate"
    opts = {} if conj else dict(engine_opts or {})
    eng = mt.FreeRunCGGibbs(X, y, family, mt.make_beta_prior(prior, d),
                            extra=extra or {}, tuning={"w": w},
                            coord_sampler=coord_sampler, device=device,
                            **opts)
    beta0 = (eng.prior.mean_beta().numpy() if init_at_prior_mean else None)
    wu_chunk = 20 if d >= 5000 else burnin
    chunk = max(1, min(30, 7680 // n_chains))
    if d >= 5000:
        chunk = min(chunk, 5)
    t0 = time.perf_counter()
    state = eng.init(0, n_chains, beta0=beta0)
    state = _warmup(eng, state, burnin, wu_chunk, name)
    state, _, _ = eng.run(state, chunk)  # capture the sampling graphs
    _sync(device)
    warm_s = time.perf_counter() - t0
    state, draws, dt = _collect(eng, state, timed, chunk, device)
    ess = mt.ess(draws)
    rhat = mt.split_rhat(draws)
    err_sd, post_mean, post_sd = _err_in_sd_units(draws, beta_true)
    out = {
        "config": name,
        "family": family,
        "n": n,
        "d": d,
        "coord_sampler": coord_sampler,
        "spec_k": eng.spec_k,
        "battery": eng.battery_impl,
        "chains": n_chains,
        "warmup_sweeps": burnin,
        "timed_sweeps": timed,
        "seconds": round(dt, 2),
        "warmup_s": round(warm_s, 1),
        "min_ess_per_s": round(float(np.min(ess)) / dt, 2),
        "median_ess_per_s": round(float(np.median(ess)) / dt, 2),
        "max_rhat": round(float(np.max(rhat)), 4),
        "max_err_sd": round(float(err_sd.max()), 3),
        "med_err_sd": round(float(np.median(err_sd)), 3),
    }
    if nuts_check:
        _log(f"{name}: NUTS cross-check")
        out.update(_nuts_crosscheck(X, y, family, eng.prior, extra or {},
                                    post_mean, post_sd, device))
    if slice_crosscheck:
        _log(f"{name}: slice cross-check run")
        eng2 = mt.FreeRunCGGibbs(X, y, family, mt.make_beta_prior(prior, d),
                                 extra=extra or {}, tuning={"w": w},
                                 device=device, **dict(engine_opts or {}))
        st2 = _warmup(eng2, eng2.init(5, n_chains, beta0=beta0), burnin,
                      wu_chunk, name + " slice")
        _, sl, _ = _collect(eng2, st2, timed, chunk, device)
        sl_mean = sl.reshape(-1, d).mean(0)
        diff = np.abs(sl_mean - post_mean) / post_sd
        out["slice_max_diff_sd"] = round(float(diff.max()), 3)
        out["slice_med_diff_sd"] = round(float(np.median(diff)), 3)
        out["slice_min_ess"] = round(float(np.min(mt.ess(sl))), 1)
    out["device"] = _device_name(device)
    print(json.dumps(out), flush=True)
    return out


def run_pooled_4096(n, d, n_chains, burnin, n_outer, device, engine_opts=None,
                    wu_passes=1500, run_block_passes=1500):
    """Config 5: many chains on ``ShardedFreeRunCGGibbs`` over a one-rank
    mesh (one card, no collective), pass-bounded warmup and collection
    (``warmup_passes``, ``run_passes``), the pooled R-hat from per-chain
    moments and the on-device ESS (``parallel/pooled.py``)."""
    from mcmcglm_tpu_torch.parallel import distributed
    from mcmcglm_tpu_torch.parallel.pooled import (
        ChainMoments,
        ess_device,
        pooled_summary,
    )

    dev_type = torch.device(device).type
    distributed.initialize(device_type=dev_type)
    mesh = mt.make_mesh(device_type=dev_type)
    X, y, beta_true = generate_glm_data("binomial", n=n, d=d, seed=0)
    eng = mt.ShardedFreeRunCGGibbs(
        X, y, "binomial", mt.make_beta_prior(mt.Normal(0, 1), d), mesh=mesh,
        tuning={"w": 0.5}, device=device, **dict(engine_opts or {}))
    t0 = time.perf_counter()
    state = eng.init(0, n_chains)
    sc, blk = None, 0
    while True:
        state, sc = eng.warmup_passes(state, sc, burnin, wu_passes)
        scn = sc.cpu().numpy()
        blk += 1
        _log(f"pod: warmup block {blk} (sweeps min {scn.min()} / median "
             f"{int(np.median(scn))} / quota {burnin})")
        if (scn >= burnin).all():
            break
    _sync(device)
    warm_s = time.perf_counter() - t0
    nev0 = state.nev.clone()
    t0 = time.perf_counter()
    sc, drbuf, nb, blk = None, None, None, 0
    while True:
        state, sc, drbuf, nb = eng.run_passes(state, sc, drbuf, nb, n_outer,
                                              run_block_passes)
        scn = sc.cpu().numpy()
        blk += 1
        _log(f"pod: timed block {blk} (sweeps min {scn.min()} / median "
             f"{int(np.median(scn))} / quota {n_outer})")
        if (scn >= n_outer).all():
            break
    _sync(device)
    dt = time.perf_counter() - t0
    mean = drbuf.mean(1)
    mom = ChainMoments(
        torch.full((n_chains,), float(n_outer), dtype=drbuf.dtype,
                   device=drbuf.device),
        mean, ((drbuf - mean[:, None, :]) ** 2).sum(1))
    pooled_rhat = float(pooled_summary(mom)["rhat"].max())
    t_e = time.perf_counter()
    ess_dev = ess_device(drbuf).cpu().numpy()
    dev_ess_s = time.perf_counter() - t_e
    t_g = time.perf_counter()
    draws = drbuf.cpu().numpy()
    gather_s = time.perf_counter() - t_g
    ess = mt.ess(draws)
    err_sd, _, _ = _err_in_sd_units(draws, beta_true)
    evals = float((state.nev - nev0).double().mean()) / n_outer
    out = {
        "config": "pod_%d_chains_p%d_logistic" % (n_chains, d),
        "engine": "ShardedFreeRunCGGibbs+run_passes",
        "spec_k": eng.inner.spec_k,
        "battery": eng.inner.battery_impl,
        "chains": n_chains,
        "n": n,
        "d": d,
        "warmup_sweeps": burnin,
        "sweeps": n_outer,
        "thin": 1,
        "seconds": round(dt, 2),
        "warmup_s": round(warm_s, 1),
        "chain_sweeps_per_s": round(n_chains * n_outer / dt, 1),
        "evals_per_sweep": round(evals, 1),
        "pooled_max_rhat": round(pooled_rhat, 4),
        "min_ess_per_s_thinned": round(float(np.min(ess)) / dt, 2),
        "median_ess_per_s_thinned": round(float(np.median(ess)) / dt, 2),
        "max_err_sd": round(float(err_sd.max()), 3),
        "min_ess_per_s_device": round(float(ess_dev.min()) / dt, 2),
        "device_ess_seconds": round(dev_ess_s, 2),
        "host_gather_seconds": round(gather_s, 2),
        "device_vs_host_min_ess_ratio": round(
            float(ess_dev.min()) / float(np.min(ess)), 4),
        "device": _device_name(device),
    }
    print(json.dumps(out), flush=True)
    return out


def _device_name(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--skip-pod", action="store_true",
                    help="skip the long 4096-chain pooled config")
    ap.add_argument("--only", type=int, default=0,
                    help="run a single config (1-5)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    s, only, dev = args.small, args.only, args.device
    opts = _engine_opts(dev)

    if only in (0, 1):
        run_config("readme_gaussian_n1000_p3", "gaussian", 1000, 3,
                   mt.Normal(0, 1), 0.5, 8 if s else 64, 100, 400, dev,
                   extra={"sd": 1.0}, engine_opts=opts)
    if only in (0, 2):
        run_config("logistic_n10k_p100_normal", "binomial",
                   2000 if s else 10_000, 100, mt.Normal(0, 1), 0.5,
                   8 if s else 64, 60, 100, dev, nuts_check=True,
                   engine_opts=opts)
    if only in (0, 3):
        run_config("poisson_n10k_p100_laplace", "poisson",
                   2000 if s else 10_000, 100, mt.Laplace(0, 1), 0.3,
                   8 if s else 64, 60, 100, dev, nuts_check=True,
                   engine_opts=opts)
    if only in (0, 4):
        # the exact conjugate coordinate draws; 200 + 200 sweeps at C=256
        # (scripts/baseline_configs.py:421-444), the slice path as the
        # cross-check
        run_config("gaussian_p10k_stress", "gaussian",
                   1000 if s else 2000, 1000 if s else 10_000,
                   mt.Normal(0, 1), 0.5, 8 if s else 256,
                   10 if s else 200, 10 if s else 200, dev,
                   extra={"sd": 1.0}, init_at_prior_mean=True,
                   coord_sampler="conjugate", slice_crosscheck=not s,
                   engine_opts=opts)
    if only in (0, 5) and not args.skip_pod:
        run_pooled_4096(2000 if s else 10_000, 100 if s else 1000,
                        64 if s else 4096, 10 if s else 30,
                        20 if s else 150, dev, engine_opts=opts)


if __name__ == "__main__":
    main()
