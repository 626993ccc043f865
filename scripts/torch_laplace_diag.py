"""Diagnose the worst coordinate's ESS on poisson/log with a Laplace(0, 1)
prior (baseline config 3's model) on the free-running engine.

The port's counterpart of ``scripts/laplace_diag.py``.  It runs n=10,000,
d=100 (``generate_glm_data("poisson", seed=0)``), w=0.3, C=64 chains: 60
adaptive warmup sweeps, then 300 sampling sweeps, with the engine's
defaults (spec_k 4 and battery "auto", i.e. "cuda3", on the card).  For
the windows of the first 100, 200 and all sweeps it prints the worst
coordinate by ESS, its ESS against the median, its true coefficient, its
adapted width against the median width, the posterior mean and sd over
the window's last two thirds and the lag-1 autocorrelation (mean over up
to 16 chains): enough to tell a slow-mixing coordinate (the Laplace kink,
coupling to the intercept) from short-window noise of the ESS estimator.
Then the carried eta against X beta per chain (an incremental update keeps
any initial error forever), the five worst coordinates over the whole
run, and the worst and a median coordinate's per-chain structure (spread
of chain means against the expected, drift between halves, width
quantiles).  Each window is also one JSONL row.

    python scripts/torch_laplace_diag.py
    python scripts/torch_laplace_diag.py --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402
from torch_study import Records, resolve_device, sync  # noqa: E402

CHAINS, WARMUP, SWEEPS = 64, 60, 300


def log(m):
    print(time.strftime("%H:%M:%S"), m, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="n=2,000, d=10, C=8, 10 warmup and 30 sweeps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    n, d, C, warm, sweeps = ((2_000, 10, 8, 10, 30) if args.small
                             else (10_000, 100, CHAINS, WARMUP, SWEEPS))
    X, y, beta_true = generate_glm_data("poisson", n=n, d=d, seed=0)
    eng = mt.FreeRunCGGibbs(X, y, "poisson",
                            mt.IIDPrior(mt.Laplace(0.0, 1.0), d),
                            tuning={"w": 0.3}, device=device)
    rec = Records("laplace_diag", device, args.out)
    log(f"n={n} d={d} C={C}: spec_k={eng.spec_k}, battery "
        f"{eng.battery_impl!r}, eval_cache {eng.eval_cache!r}")
    st = eng.init(0, C)
    t0 = time.perf_counter()
    st, _, _ = eng.warmup(st, warm)
    sync(device)
    log(f"warmup {warm} sweeps in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    st, draws, _ = eng.run(st, sweeps)
    sync(device)
    t_run = time.perf_counter() - t0
    draws = draws.cpu().numpy()
    log(f"collected {draws.shape} in {t_run:.2f} s")
    w = np.exp(st.logw.cpu().numpy()).mean(0)
    windows = sorted({min(100, sweeps), min(200, sweeps), sweeps})
    for K in windows:
        e = mt.ess(draws[:, :K, :])
        j = int(np.argmin(e))
        post = draws[:, K // 3:K, j]
        ac = float(np.mean([np.corrcoef(post[c, :-1], post[c, 1:])[0, 1]
                            for c in range(min(C, 16))]))
        log(f"window={K}: min/med ESS {e.min():.0f}/{np.median(e):.0f} "
            f"(ratio {float(np.median(e) / e.min()):.2f}) worst j={j} "
            f"|beta_true[j]|={abs(beta_true[j]):.4f} w[j]={w[j]:.3f} (med w "
            f"{np.median(w):.3f}) post mean/sd {post.mean():.4f}/"
            f"{post.std():.4f} lag1 {ac:.3f}")
        rec.write({"window": K, "chains": C, "n": n, "d": d,
                   "run_seconds": t_run, "worst_j": j,
                   "min_ess": float(e.min()), "median_ess": float(np.median(e)),
                   "abs_beta_true_j": float(abs(beta_true[j])),
                   "w_j": float(w[j]), "median_w": float(np.median(w)),
                   "post_mean_j": float(post.mean()),
                   "post_sd_j": float(post.std()), "lag1_j": ac})
    # the committed eta against X @ beta, per chain: an incremental update
    # keeps any init error forever, and a nonzero per-chain MEAN of the
    # residual acts as a per-chain intercept shift
    eta = st.eta.double().cpu().numpy().reshape(C, -1)[:, :n]
    resid = eta - st.beta.double().cpu().numpy() @ X.T
    m = resid.mean(axis=1)
    log(f"eta - X@beta per-chain mean: sd {m.std():.2e}, max |mean| "
        f"{np.abs(m).max():.2e}, elementwise max {np.abs(resid).max():.2e}")
    e_full = mt.ess(draws)
    order = np.argsort(e_full)
    log(f"full-window worst five: {order[:5]} ESS {np.round(e_full[order[:5]])}")
    wlog = np.exp(st.logw.cpu().numpy())
    for j, tag in ((int(order[0]), "worst"), (int(order[d // 2]), "median")):
        x = draws[:, :, j]
        means, sds = x.mean(1), x.std(1)
        half = x.shape[1] // 2
        drift = x[:, half:].mean(1) - x[:, :half].mean(1)
        wj = wlog[:, j]
        log(f"[{tag} j={j}] chain-mean sd {means.std():.5f} vs expected "
            f"{float(np.median(sds)) / np.sqrt(max(e_full[j] / C, 1)):.5f} "
            f"(within-sd med {np.median(sds):.5f}); half-drift |mean|/max "
            f"{np.abs(drift).mean():.5f}/{np.abs(drift).max():.5f}; w_j "
            f"quantiles {np.round(np.quantile(wj, [0, .25, .5, .75, 1]), 4)}")
        if means.std() > 0 and wj.std() > 0:
            log(f"[{tag} j={j}] corr(|chain mean - grand|, w_j) = "
                f"{np.corrcoef(np.abs(means - means.mean()), wj)[0, 1]:.3f}")


if __name__ == "__main__":
    main()
