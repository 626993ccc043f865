"""Capacity of the obs-sharded free-running engine: each rank's bytes of the
observation-axis operands at obs = 1 against obs = 2 and 4.

The port's counterpart of ``scripts/obs_sharded_capacity.py``, whose
evidence was XLA's compiled memory analysis on a virtual 8-device mesh.
The claim to test: the per-rank footprint of the operands that carry the
observation axis (the X^T slab, y, the mask, the offset, eta, and the
cache when it is per observation) scales as 1/obs, so data too tall for
one card fits a (chain x obs) mesh.  Problem: gaussian/identity, n=400,000,
d=48, C=64 chains on every rank (the mesh is (1, obs)), IID Normal(0, 1),
w=0.5, from numpy seed 0.

1. Tensor bytes: a world of ``obs`` CPU processes over gloo per obs in (1,
   2, 4); each rank builds ``ObsShardedFreeRunCGGibbs`` and its initial
   state and sums ``nbytes`` over its obs-axis operands (and lists the
   rest).  With n a multiple of 4 there is no padding, so obs = 2 holds
   exactly half of obs = 1's bytes and obs = 4 a quarter.
2. Device memory (``--device cuda``): each rank's
   ``torch.cuda.max_memory_allocated`` over the engine's build (the
   engine sets up the whole problem on the device, then keeps its slab),
   the bytes it holds after its init (``memory_allocated``), and the peak
   over 64 passes from there, in a world of one process (obs = 1) and of
   two processes on the card over gloo with CUDA tensors (obs = 2; NCCL
   puts no two ranks on one card).

    python scripts/torch_obs_sharded_capacity.py
    python scripts/torch_obs_sharded_capacity.py --small --device cpu
"""

import os as _os
import sys as _sys

_HERE = _os.path.dirname(_os.path.abspath(__file__))
_sys.path[:0] = [_os.path.dirname(_HERE), _HERE]

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.parallel.launch import run_local  # noqa: E402
from torch_study import Records, resolve_device  # noqa: E402

PASSES = 64  # passes each rank runs before reading its device memory


def problem(small):
    n, d, C = (4_000, 8, 8) if small else (400_000, 48, 64)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    return X, y, C


def build(small, device):
    world = torch.distributed.get_world_size()
    X, y, C = problem(small)
    mesh = mt.make_mesh(1, world, device_type=device.type)
    eng = mt.ObsShardedFreeRunCGGibbs(
        X, y, "gaussian", mt.IIDPrior(mt.Normal(0.0, 1.0), X.shape[1]),
        extra={"sd": 1.0}, tuning={"w": 0.5}, mesh=mesh, device=device)
    return eng, eng.init(0, C)


def operand_bytes(rank, small):
    """Part 1, one rank: bytes of each tensor of the engine and its state,
    split by whether it carries this rank's observation axis."""
    eng, st = build(small, torch.device("cpu"))
    inner = eng.inner
    n_loc = inner.y.shape[0]
    named = {"Xt": inner.Xt, "y": inner.y, "mask": inner._mask,
             "offset": inner.offset}
    named.update({f"state.{k}": v for k, v in st._asdict().items()
                  if torch.is_tensor(v)})
    obs_axis, other = {}, {}
    for k, v in named.items():
        if v is None:
            continue
        (obs_axis if n_loc in v.shape else other)[k] = v.nbytes
    return {"n_local": n_loc, "obs_axis": obs_axis, "other": other,
            "eval_cache": inner.eval_cache}


def device_peak(rank, small):
    """Part 2, one rank on the card: the peak allocated bytes of the
    engine's build and init, the bytes it holds after them, and the peak
    over ``PASSES`` passes from there."""
    device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(device)
    eng, st = build(small, device)
    torch.cuda.synchronize(device)
    build_peak = torch.cuda.max_memory_allocated(device)
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    eng.run_passes(st, None, None, None, 1, PASSES)
    torch.cuda.synchronize(device)
    return {"build_peak_bytes": build_peak, "resident_bytes": resident,
            "run_peak_bytes": torch.cuda.max_memory_allocated(device),
            "loop": eng.loop_reason}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="n=4,000, d=8, C=8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    rec = Records("obs_sharded_capacity", device, args.out)
    X, _, C = problem(args.small)
    n, d = X.shape
    base = None
    for obs in (1, 2, 4):
        ranks = run_local(operand_bytes, obs, args=(args.small,),
                          device_type="cpu", timeout=900.0)
        per_rank = [sum(r["obs_axis"].values()) for r in ranks]
        base = base or per_rank[0]
        rec.write({"part": "tensor_bytes", "obs": obs, "n": n, "d": d,
                   "chains": C, "n_local": ranks[0]["n_local"],
                   "obs_axis_bytes_per_rank": per_rank,
                   "vs_obs1": per_rank[0] / base,
                   "obs_axis_operands": ranks[0]["obs_axis"],
                   "other_tensors": ranks[0]["other"],
                   "eval_cache": ranks[0]["eval_cache"]})
    if device.type != "cuda":
        print("device memory: not measured (no card)", flush=True)
        return
    base = None
    for obs in (1, 2):
        ranks = run_local(device_peak, obs, args=(args.small,),
                          device_type="cuda", backend="gloo", timeout=900.0)
        per_rank = {k: [r[k] for r in ranks] for k in
                    ("build_peak_bytes", "resident_bytes", "run_peak_bytes")}
        base = base or per_rank["run_peak_bytes"][0]
        rec.write({"part": "device_memory", "obs": obs, "n": n, "d": d,
                   "chains": C, "passes": PASSES, **per_rank,
                   "run_peak_vs_obs1": float(np.mean(
                       per_rank["run_peak_bytes"])) / base,
                   "loop": ranks[0]["loop"]})


if __name__ == "__main__":
    main()
