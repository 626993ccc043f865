"""Two-process dryrun of the port's multi-card path on the CPU ("gloo").

    python scripts/torch_multihost_dryrun.py

Spawns two processes joined in one process group
(``mcmcglm_tpu_torch.parallel.launch.run_local``: a FileStore in a
temporary directory, no port) and runs, in each:

  * ``ShardedFreeRunCGGibbs`` on the chain mesh (2, 1),
  * ``ObsShardedFreeRunCGGibbs`` on the obs mesh (1, 2),
  * ``ShardedCGGibbs`` (the lockstep engine) on the obs mesh (1, 2);

for each: warmup, a checkpoint of every rank's shard
(``CheckpointManager``), a first chunk, then a fresh engine restores the
checkpoint and runs the same chunk again, which must equal the first
bitwise; the obs ranks must agree bitwise and the gathered posterior mean
must be finite.  Prints MULTIHOST_DRYRUN_OK and exits 0 on success.
"""

import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CHUNK = 6


def _problem():
    rng = np.random.default_rng(0)  # identical data on every process
    n, d = 203, 5
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ rng.normal(size=d)))).astype(
        float)
    return X, y


def _engines(mt, mesh_chain, mesh_obs):
    X, y = _problem()
    prior = mt.IIDPrior(mt.Normal(0.0, 1.0), X.shape[1])
    kw = dict(tuning={"w": 0.5}, device="cpu")
    return {
        "chain (2, 1)": lambda: mt.ShardedFreeRunCGGibbs(
            X, y, "binomial", prior, mesh=mesh_chain, spec_k=4, **kw),
        "obs (1, 2)": lambda: mt.ObsShardedFreeRunCGGibbs(
            X, y, "binomial", prior, mesh=mesh_obs, spec_k=4, **kw),
        "lockstep obs (1, 2)": lambda: mt.ShardedCGGibbs(
            X, y, "binomial", prior, mesh=mesh_obs, **kw),
    }


def worker(rank, ckpt_root):
    import torch.distributed as dist

    import mcmcglm_tpu_torch as mt
    from mcmcglm_tpu_torch.parallel import make_mesh

    mesh_chain = make_mesh(2, 1, device_type="cpu")
    mesh_obs = make_mesh(1, 2, device_type="cpu")
    lines = []
    for i, (name, make) in enumerate(_engines(mt, mesh_chain,
                                              mesh_obs).items()):
        eng = make()
        st = eng.init(0, 8)
        st, _, _ = eng.warmup(st, 4)
        cm = mt.CheckpointManager(os.path.join(ckpt_root, str(i)))
        cm.save(4, st)
        st1, draws1, nev1 = eng.run(st, CHUNK)
        fresh = make()  # a restarted process builds its engine anew
        step, st_r, _ = cm.restore(fresh.init(0, 8))
        if isinstance(fresh, mt.CGGibbs):
            # the lockstep engine samples with the adapted widths the
            # state carries once warmup has run on it (zero sweeps here)
            st_r, _, _ = fresh.warmup(st_r, 0)
        st2, draws2, nev2 = fresh.run(st_r, CHUNK)
        if step != 4 or not (torch.equal(draws1, draws2)
                             and torch.equal(nev1, nev2)):
            raise AssertionError(f"{name}: the restored run differs")
        got = [torch.empty_like(st2.beta) for _ in range(2)]
        dist.all_gather(got, st2.beta)
        if name != "chain (2, 1)" and not torch.equal(got[0], got[1]):
            raise AssertionError(f"{name}: the obs ranks disagree")
        mean = eng.gather(draws2).mean((0, 1))
        if not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"{name}: non-finite draws")
        lines.append(f"{name}: restored step {step}, {CHUNK} sweeps "
                     f"bitwise; posterior mean {mean.numpy().round(3)}")
    return lines


def main():
    from mcmcglm_tpu_torch.parallel.launch import run_local

    with tempfile.TemporaryDirectory() as ckpt_root:
        results = run_local(worker, 2, (ckpt_root,), device_type="cpu",
                            timeout=300.0)
    for line in results[0]:
        print(line)
    print("MULTIHOST_DRYRUN_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
