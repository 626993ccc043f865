"""Free-running throughput against the speculative battery size K and the
battery implementation, at the bench's data and C=256.

The port's counterpart of ``scripts/spec_probe.py`` (K alone) and
``scripts/spec2_probe.py`` (K, implementation and ``adapt_c``).  A variant
is "K", "K:impl" or "K:impl:adapt_c", impl one of plain, cuda, cuda2,
cuda3 (plain: the battery in plain PyTorch, the engine's
``battery_impl="torch"``; "K" alone takes the engine's "auto", which is
"cuda3" on the card; K = 1 runs the one-evaluation pass).  Per variant: a
fresh engine on binomial/logit, n=10,000, d=1,000 (``generate_glm_data``,
seed 0), IID Normal(0, 1), w=0.5, C=256; 30 adaptive warmup sweeps, one
untimed sweep (graph captures), then 60 timed sweeps in three
windows.  Each row gives the median window's sweeps/s and C x sweeps/s,
the evaluations per coordinate, the device passes per sweep, and the
min-ESS of the timed draws (host, outside the windows) over the timed
seconds.  Variants run one after another in one process, in the order
given.

    python scripts/torch_spec_probe.py                       # the card's default list
    python scripts/torch_spec_probe.py 1 4:cuda3 4:cuda3:80
    python scripts/torch_spec_probe.py --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.datagen import generate_glm_data  # noqa: E402
from torch_study import Records, measure_freerun, resolve_device  # noqa: E402

CARD_VARIANTS = ["1", "2", "4", "6", "8", "4:cuda", "4:cuda2", "4:cuda3"]
CPU_VARIANTS = ["1", "2", "4:plain"]
IMPLS = {"plain": "torch", "cuda": "cuda", "cuda2": "cuda2", "cuda3": "cuda3"}


def parse_variant(spec):
    parts = spec.split(":")
    K = int(parts[0])
    impl = IMPLS[parts[1]] if len(parts) > 1 else "auto"
    adapt_c = float(parts[2]) if len(parts) > 2 else None
    return K, impl, adapt_c


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="n=2,000, d=100, C=8, 4 warmup and 6 timed sweeps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    variants = args.variants or (CARD_VARIANTS if device.type == "cuda"
                                 else CPU_VARIANTS)
    n, d, C, warm, timed = ((2_000, 100, 8, 4, 6) if args.small
                            else (10_000, 1_000, 256, 30, 60))
    X, y, _ = generate_glm_data("binomial", n=n, d=d, seed=0)
    rec = Records("spec_probe", device, args.out)
    for spec in variants:
        K, impl, adapt_c = parse_variant(spec)
        eng = mt.FreeRunCGGibbs(
            X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), d),
            tuning={"w": 0.5}, spec_k=K,
            battery_impl=impl if K > 1 else "auto", adapt_c=adapt_c,
            device=device)
        rec.write({"variant": spec, "spec_k": eng.spec_k,
                   "battery": eng.battery_impl, "adapt_c": eng.adapt_c,
                   "n": n, "d": d,
                   **measure_freerun(eng, C, warm, timed)})


if __name__ == "__main__":
    main()
