"""Fault-injection restart dryrun of the port: kill a worker mid-collection,
restart, restore, and prove bitwise continuation.

    python scripts/torch_fault_injection_dryrun.py        # launcher

The recovery unit is the periodic checkpoint of the chain-sharded
free-running state (``mcmcglm_tpu_torch.checkpoint``): the chains carry
their whole random state (Philox key and pass index), so a restore
replays exactly the draws the crashed run would have produced.

Timeline (two CPU processes, "gloo", one (2, 1) chain mesh):

  phase 1 (faulted run):
    warmup -> CheckpointManager.save(state0)
    chunk1 = run(state0, 4)      both workers record their shard's draws
    chunk2 = run(state1, 3)      worker 1 SIGKILLs ITSELF right before
                                 chunk2 (no cleanup, no atexit); worker 0,
                                 whose chain-sharded path has no
                                 collective, completes chunk2, records it,
                                 then DETECTS the dead peer at the
                                 end-of-run barrier (monitored_barrier
                                 names it, or the connection fails) and
                                 exits with code 3.
  phase 2 (restarted run):
    fresh processes and a fresh process group restore the checkpoint and
    re-run chunk1 and chunk2.  chunk1 must equal EVERY worker's pre-fault
    record bitwise, chunk2 the surviving worker's.

The processes join through a FileStore in a temporary directory (no
port).  Prints FAULT_DRYRUN_OK and exits 0 on success.
"""

import argparse
import datetime
import os
import signal
import subprocess
import sys
import tempfile
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

N_PROC = 2
CHUNK1, CHUNK2 = 4, 3
BARRIER_S = 10  # how long the survivor waits for its dead peer


def _setup(process_id: int, store: str):
    import numpy as np
    import torch

    torch.set_num_threads(1)
    import mcmcglm_tpu_torch as mt
    from mcmcglm_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(f"file://{store}", N_PROC, process_id,
                           device_type="cpu",
                           timeout=datetime.timedelta(seconds=60))
    rng = np.random.default_rng(0)  # identical data on every process
    n, d = 96, 5
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    beta_true = rng.normal(size=d)
    y = rng.binomial(1, 1 / (1 + np.exp(-X @ beta_true))).astype(float)
    fr = mt.ShardedFreeRunCGGibbs(
        X, y, "binomial", mt.IIDPrior(mt.Normal(0.0, 1.0), d),
        tuning={"w": 0.5}, mesh=make_mesh(2, 1, device_type="cpu"),
        device="cpu",
    )
    return np, mt, fr


def worker_faulted(process_id: int, ckpt_dir: str, rec_dir: str,
                   store: str):
    np, mt, fr = _setup(process_id, store)
    st = fr.init(0, 16)
    st, _, _ = fr.warmup(st, 10)
    cm = mt.CheckpointManager(ckpt_dir)
    cm.save(1, st)

    st, draws1, _ = fr.run(st, CHUNK1)
    np.save(os.path.join(rec_dir, f"chunk1_p{process_id}.npy"),
            draws1.numpy())

    if process_id == 1:
        # the fault: a real mid-run kill, no cleanup, no flushing, as an
        # OOM killer or a preemption does it
        print("FAULT_INJECTED", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    # the survivor: the chain-sharded path has no collective, so its
    # chunk2 completes against the dead peer
    st, draws2, _ = fr.run(st, CHUNK2)
    np.save(os.path.join(rec_dir, f"chunk2_p{process_id}.npy"),
            draws2.numpy())

    # failure detection: the end-of-run barrier cannot complete with a
    # dead peer; a bounded wait turns a hang into a detected fault too
    from mcmcglm_tpu_torch.parallel import distributed

    outcome = {}

    def barrier():
        try:
            distributed.sync_global_devices(
                "faulted-run-done",
                timeout=datetime.timedelta(seconds=BARRIER_S))
            outcome["clean"] = True
        except RuntimeError as exc:
            outcome["error"] = str(exc).splitlines()[0]

    th = threading.Thread(target=barrier, daemon=True)
    th.start()
    th.join(timeout=3 * BARRIER_S)
    if not outcome.get("clean"):
        print(f"PEER_FAILURE_DETECTED {outcome.get('error', 'timeout')}",
              flush=True)
        os._exit(3)  # the group cannot be torn down with a dead peer
    print("UNEXPECTED_CLEAN_BARRIER", flush=True)
    os._exit(4)


def worker_resume(process_id: int, ckpt_dir: str, rec_dir: str, store: str):
    np, mt, fr = _setup(process_id, store)
    cm = mt.CheckpointManager(ckpt_dir)
    restored = cm.restore(fr.init(0, 16))
    if restored is None:
        raise AssertionError("checkpoint missing after the fault")
    step, st, _ = restored
    if step != 1:
        raise AssertionError(f"restored step {step}, expected 1")

    st, draws1, _ = fr.run(st, CHUNK1)
    st, draws2, _ = fr.run(st, CHUNK2)

    # bitwise continuation: chunk1 equals both workers' pre-fault
    # records, chunk2 the surviving worker's
    ref1 = np.load(os.path.join(rec_dir, f"chunk1_p{process_id}.npy"))
    np.testing.assert_array_equal(draws1.numpy(), ref1)
    got2 = draws2.numpy()
    if not np.isfinite(got2).all():
        raise AssertionError("non-finite chunk2 draws")
    if process_id == 0:
        ref2 = np.load(os.path.join(rec_dir, "chunk2_p0.npy"))
        np.testing.assert_array_equal(got2, ref2)

    from mcmcglm_tpu_torch.parallel import distributed

    distributed.sync_global_devices("resume-done")
    if process_id == 0:
        print("FAULT_DRYRUN_OK", flush=True)


def _spawn(phase: str, ckpt_dir: str, rec_dir: str, store: str):
    return [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i),
             "--phase", phase, "--ckpt-dir", ckpt_dir, "--rec-dir", rec_dir,
             "--store", store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(N_PROC)
    ]


def _finish(procs, timeout=300):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return outs


def launch():
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        rec_dir = os.path.join(tmp, "rec")
        os.makedirs(rec_dir)
        # phase 1: the faulted run
        procs = _spawn("fault", ckpt_dir, rec_dir, os.path.join(tmp, "s1"))
        outs = _finish(procs)
        ok_fault = (
            procs[0].returncode == 3
            and "PEER_FAILURE_DETECTED" in outs[0]
            and procs[1].returncode == -signal.SIGKILL
            and "FAULT_INJECTED" in outs[1]
        )
        if not ok_fault:
            for i, o in enumerate(outs):
                sys.stderr.write(
                    f"--- fault worker {i} rc={procs[i].returncode} ---\n{o}\n"
                )
            return 1
        detected = [ln for ln in outs[0].splitlines()
                    if ln.startswith("PEER_FAILURE_DETECTED")][0]
        print("fault phase: worker 1 SIGKILLed, worker 0 detected the dead "
              f"peer (rc=3): {detected}", flush=True)

        # phase 2: restart, restore, bitwise continuation
        procs = _spawn("resume", ckpt_dir, rec_dir, os.path.join(tmp, "s2"))
        outs = _finish(procs)
        rc = procs[0].returncode | procs[1].returncode
        if rc != 0 or "FAULT_DRYRUN_OK" not in outs[0]:
            for i, o in enumerate(outs):
                sys.stderr.write(
                    f"--- resume worker {i} rc={procs[i].returncode} ---\n"
                    f"{o}\n"
                )
            return 1
        print("FAULT_DRYRUN_OK (launcher)")
        return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--phase", choices=("fault", "resume"), default=None)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--rec-dir", type=str, default=None)
    ap.add_argument("--store", type=str, default=None)
    args = ap.parse_args()
    if args.worker is None:
        sys.exit(launch())
    elif args.phase == "fault":
        worker_faulted(args.worker, args.ckpt_dir, args.rec_dir, args.store)
    else:
        worker_resume(args.worker, args.ckpt_dir, args.rec_dir, args.store)
