"""Checkpoint and resume of the port (``mcmcglm_tpu_torch.checkpoint``),
the mirror of tests/test_checkpoint.py: a run that is saved, restored in
a fresh engine and continued equals the run that was never interrupted,
bit for bit, for every state class; retention, the empty directory, the
format refusal, template checks; a sharded mid-run resume in two "gloo"
processes (scripts/torch_multihost_dryrun.py) and the fault-injection
restart (scripts/torch_fault_injection_dryrun.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mcmcglm_tpu_torch as mt  # noqa: E402
from mcmcglm_tpu_torch.checkpoint import CHECKPOINT_FORMAT  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT_TIMEOUT = 240


def _problem(n=120, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.normal(size=(n, d - 1))])
    y = rng.normal(X @ np.linspace(1.0, -0.5, d), 1.0)
    return X, y


def _prior(d):
    return mt.IIDPrior(mt.Normal(0.0, 1.0), d)


def _freerun(**kw):
    def make():
        X, y = _problem()
        return mt.FreeRunCGGibbs(X, y, "gaussian", _prior(X.shape[1]),
                                 extra={"sd": 1.0}, device="cpu", **kw)
    return make


def _fused():
    X, y = _problem()
    return mt.FusedCGGibbs(X, y, "gaussian", _prior(X.shape[1]),
                           extra={"sd": 1.0}, tuning={"w": 0.5}, device="cpu")


def _lockstep():
    X, y = _problem()
    return mt.CGGibbs(X, y, "gaussian", _prior(X.shape[1]), extra={"sd": 1.0},
                      tuning={"w": 0.5}, device="cpu")


# state class -> (engine factory, warm-up before the save)
ENGINES = {
    "FreeRunState": (_freerun(tuning={"w": 0.5}, spec_k=4), "warmup"),
    "QuantileState": (_freerun(slice_kernel="quantile", spec_k=4, tuning={
        "pseudo_scale": 2.0, "pseudo_adapt": True, "pseudo_c": 3.0}),
        "warmup"),
    "DoublingState": (_freerun(slice_kernel="doubling", tuning={"w": 0.5}),
                      "warmup"),
    "FusedState": (_fused, "run"),
    "ChainState": (_lockstep, "warmup"),
}


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return type(a) is type(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("cls", list(ENGINES))
def test_resume_is_bitwise(tmp_path, cls):
    make, warm = ENGINES[cls]
    eng = make()
    st = eng.init(7, 8)
    st, _, _ = getattr(eng, warm)(st, 3)
    assert type(st).__name__ == cls
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(3, st, samples=np.arange(6.0))
    st_a, draws_a, nev_a = eng.run(st, 4)  # the uninterrupted run

    fresh = make()  # a restarted process
    step, st_r, samples = cm.restore(fresh.init(0, 8))
    assert step == 3 and _equal(st_r, st)
    np.testing.assert_array_equal(samples, np.arange(6.0))
    if cls == "ChainState":  # take up the adapted widths the state holds
        st_r, _, _ = fresh.warmup(st_r, 0)
    st_b, draws_b, nev_b = fresh.run(st_r, 4)
    assert torch.equal(draws_a, draws_b) and torch.equal(
        torch.as_tensor(nev_a), torch.as_tensor(nev_b))
    assert _equal(st_a, st_b)


def test_retention_and_latest_step(tmp_path):
    eng = _freerun(tuning={"w": 0.5})()
    st = eng.init(0, 4)
    cm = mt.CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in range(1, 6):
        cm.save(step, st)
    assert cm.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    assert cm.restore(st, step=3)[0] == 3
    with pytest.raises(FileNotFoundError):
        cm.restore(st, step=1)
    cm.close()


def test_empty_directory_restores_nothing(tmp_path):
    cm = mt.CheckpointManager(str(tmp_path / "new"))
    assert cm.latest_step() is None
    assert cm.restore(_freerun(tuning={"w": 0.5})().init(0, 2)) is None


def test_uncommitted_step_is_ignored(tmp_path):
    eng = _freerun(tuning={"w": 0.5})()
    st = eng.init(0, 4)
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(2, st)
    os.remove(tmp_path / "2" / "COMMITTED")  # a crash before the commit
    assert cm.latest_step() is None and cm.restore(st) is None


def _rewrite(path, **change):
    payload = torch.load(path, weights_only=True)
    for k, v in change.items():
        if v is None:
            payload.pop(k)
        else:
            payload[k] = v
    torch.save(payload, path)


def test_other_format_is_refused(tmp_path):
    st = _freerun(tuning={"w": 0.5})().init(0, 4)
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(1, st)
    path = tmp_path / "1" / "rank-0-of-1.pt"
    _rewrite(path, format=CHECKPOINT_FORMAT - 1)
    with pytest.raises(ValueError, match="refusing a silently-biased"):
        cm.restore(st)
    _rewrite(path, format=None)
    with pytest.raises(ValueError, match="before format tagging"):
        cm.restore(st)


def test_template_mismatch_raises(tmp_path):
    eng = _freerun(tuning={"w": 0.5})()
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(1, eng.init(0, 4))
    with pytest.raises(ValueError, match="shape|torch.Size|\\(8"):
        cm.restore(eng.init(0, 8))
    q = _freerun(slice_kernel="quantile", tuning={"pseudo_adapt": True})()
    with pytest.raises(ValueError, match="QuantileState"):
        cm.restore(q.init(0, 4))


def test_restore_in_another_world_size_raises(tmp_path):
    """A step two ranks wrote has no file for a world of one."""
    st = _freerun(tuning={"w": 0.5})().init(0, 4)
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(1, st)
    os.rename(tmp_path / "1" / "rank-0-of-1.pt", tmp_path / "1" /
              "rank-0-of-2.pt")
    (tmp_path / "1" / "COMMITTED").write_text("2\n")
    with pytest.raises(FileNotFoundError, match="world of 2 ranks, this "
                       "one has 1"):
        cm.restore(st)


def test_tensor_samples_and_nested_states_round_trip(tmp_path):
    eng = _freerun(tuning={"w": 0.5})()
    st = eng.init(0, 4)
    st, mom, kept, _ = eng.run_thinned(st, 3, 2)
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(1, {"state": st, "moments": mom, "sweeps": 6}, samples=kept)
    step, got, samples = cm.restore({"state": st, "moments": mom,
                                     "sweeps": 0})
    assert got["sweeps"] == 6 and _equal(got["state"], st)
    assert _equal(got["moments"], mom) and torch.equal(samples, kept)


def test_thinned_moments_resume(tmp_path):
    """run_thinned's streaming moments continue across a restore as if
    the collection had never stopped."""
    eng = _freerun(tuning={"w": 0.5}, spec_k=4)()
    st = eng.init(1, 8)
    st, mom, _, _ = eng.run_thinned(st, 4, 2)
    cm = mt.CheckpointManager(str(tmp_path))
    cm.save(8, (st, mom))
    st_a, mom_a, kept_a, _ = eng.run_thinned(st, 5, 2, moments=mom)

    fresh = _freerun(tuning={"w": 0.5}, spec_k=4)()
    st0 = fresh.init(0, 8)
    _, (st_r, mom_r), _ = cm.restore((st0, mom))
    st_b, mom_b, kept_b, _ = fresh.run_thinned(st_r, 5, 2, moments=mom_r)
    assert _equal(mom_a, mom_b) and torch.equal(kept_a, kept_b)
    assert _equal(st_a, st_b)


def _run_script(name):
    out = subprocess.run([sys.executable, os.path.join(_REPO, "scripts",
                                                       name)],
                         capture_output=True, text=True,
                         timeout=SCRIPT_TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_sharded_midrun_resume_in_two_processes():
    """Chain mesh, obs mesh and the sharded lockstep engine: a restored
    shard continues bitwise (scripts/torch_multihost_dryrun.py)."""
    out = _run_script("torch_multihost_dryrun.py")
    assert "MULTIHOST_DRYRUN_OK" in out
    assert out.count("sweeps bitwise") == 3


def test_fault_injection_restart():
    """SIGKILL one worker mid-collection; the survivor names the dead peer
    at the barrier and exits 3; a restarted pair restores the checkpoint
    and reproduces the crashed run's draws bitwise."""
    out = _run_script("torch_fault_injection_dryrun.py")
    assert "FAULT_DRYRUN_OK" in out and "PEER_FAILURE_DETECTED" in out
