"""Same-process A/B of the stepping-out and latent slice kernels on the
free-running engine at the bench's data.

The port's counterpart of ``scripts/latent_ab_probe.py``: both kernels in
one process, in a fixed order, on the same battery ("auto": "cuda3" on the
card) and spec_k (the engine's default: 4 on the card) and the same chain
count, under ``torch_study.measure_freerun``'s protocol (30 adaptive warmup
sweeps, one untimed sweep, 120 timed sweeps in three windows; rates are
the median window's).  Data: binomial/logit, n=10,000, d=1,000
(``generate_glm_data``, seed 0), IID Normal(0, 1), C=256; stepping-out at
w=0.5, latent at rate ``RATE`` (0.3).

    python scripts/torch_latent_ab_probe.py
    python scripts/torch_latent_ab_probe.py --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402
from torch_study import Records, measure_freerun, resolve_device  # noqa: E402

RATE = 0.3  # latent's Exp rate of the width refresh
KERNELS = {
    "stepping_out": {"slice_kernel": "stepping_out", "tuning": {"w": 0.5}},
    "latent": {"slice_kernel": "latent", "tuning": {"rate": RATE}},
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="n=2,000, d=100, C=8, 4 warmup and 6 timed sweeps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    n, d, C, warm, timed = ((2_000, 100, 8, 4, 6) if args.small
                            else (10_000, 1_000, 256, 30, 120))
    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), d)
    rec = Records("latent_ab", device, args.out)
    for name, kw in KERNELS.items():
        eng = mt.FreeRunCGGibbs(X, y, "binomial", prior, device=device, **kw)
        rec.write({"kernel": name, "battery": eng.battery_impl,
                   "spec_k": eng.spec_k,
                   "rate": RATE if name == "latent" else None,
                   "n": n, "d": d,
                   **measure_freerun(eng, C, warm, timed)})


if __name__ == "__main__":
    main()
