"""A cell on N > 1 cards: one process per card.

``run.py`` hands a cell whose ``chips`` is N > 1 to :func:`run_cell`.  It
spawns N processes.  Rank r takes card r (``cuda:r``; on the CPU, where
only the tests run it, the host) and the ranks join one default process
group, NCCL on CUDA and gloo on the CPU, through a ``FileStore`` in a
temporary directory, so no port is fixed.  A second group, over gloo,
carries the host's small messages (the stop decision after each chunk,
the counts, the device report), so that they never queue behind a card's
work.  Each rank runs ``harness.run_cell`` with its :class:`World`.
Rank 0 returns the result line and the numbers compared, and every rank
the forbidden modules it had loaded at its end.

A rank that raises, exits without its result, or outlives the time limit
(``seconds + LIMIT_S``) ends every rank, and :func:`run_cell` raises
:class:`RankFailure`.  A rank also dies with the process that started it,
however that ends.  Nothing here imports the program's own launcher
(``mcmcglm_tpu_torch.parallel``): the yardstick starts its ranks itself.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import multiprocessing as mp
import multiprocessing.connection
import os
import signal
import tempfile
import time

import torch
import torch.distributed as dist

from . import harness

__all__ = ["LIMIT_S", "RankFailure", "World", "run_cell"]

# room beyond the window for the set-up (a cold kernel build included),
# the profiled segment and the check; a first run in a checkout may take
# 1,200 s, so a 51 s window and this stay inside it
LIMIT_S = 1080.0
POLL_S = 0.5


class RankFailure(RuntimeError):
    """A rank raised, died, or outlived the time limit."""


class World:
    """This rank's view of a multi-card run: its rank, the world's size
    and the host group."""

    def __init__(self, rank: int, size: int, host_group):
        self.rank, self.size, self.host = rank, size, host_group

    def barrier(self) -> None:
        dist.barrier(group=self.host)

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop``, broadcast to every rank."""
        flag = torch.tensor([int(stop)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.host)
        return bool(flag.item())

    def all_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every
        rank."""
        got = [None] * self.size
        dist.all_gather_object(got, obj, group=self.host)
        return got

    def gather_chains(self, t: torch.Tensor):
        """Every rank's chain-leading ``t`` (equal shapes), concatenated on
        the chain axis in rank order on rank 0's device; None elsewhere.
        Over the default group: NCCL on the cards, gloo on the CPU."""
        t = t.contiguous()
        if self.rank:
            dist.gather(t, None, dst=0)
            return None
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.gather(t, list(out.split(t.shape[0])), dst=0)
        return out


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent ends (Linux's
    PR_SET_PDEATHSIG), so that no rank outlives a run.py that was killed."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):  # not Linux: the parent's kill only
        return
    prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong,
                      ctypes.c_ulong, ctypes.c_ulong]
    prctl.restype = ctypes.c_int
    prctl(1, int(signal.SIGKILL), 0, 0, 0)
    if os.getppid() != parent:  # the parent ended before the call
        os._exit(1)


def _rank(rank, size, tmp, device_type, parent, limit, cell, kw):
    _die_with_parent(parent)
    harness.TAG = f"[rank {rank}] "
    # each rank the host's cores a one-card machine gives its one process
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmp, "store"), size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=limit))
    world = World(rank, size, dist.new_group(backend="gloo"))
    line, rows, ctl = harness.run_cell(*cell, device, world=world, **kw)
    result = {"forbidden": harness.forbidden_modules()}
    if rank == 0:
        result.update(line=line, rows=rows, controls=ctl)
    path = os.path.join(tmp, f"result-{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)
    dist.destroy_process_group()


def _wait(procs, deadline: float):
    """None once every rank has exited 0; else what went wrong first."""
    while True:
        codes = [p.exitcode for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return ", ".join(f"rank {r} exited with {c}" for r, c in bad)
        if all(c == 0 for c in codes):
            return None
        left = deadline - time.monotonic()
        if left <= 0:
            late = [r for r, c in enumerate(codes) if c is None]
            return f"rank(s) {late} outlived the time limit"
        mp.connection.wait([p.sentinel for p, c in zip(procs, codes)
                            if c is None], timeout=min(left, POLL_S))


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device_type: str, chips: int, *, t_start: float,
             driver_opts=None, controls: bool = False, limit_s=None):
    """Run cell ``name`` once on ``chips`` ranks; returns (rank 0's result
    line, its numbers compared as [(name, value, limit, within)], the
    controls' readings or None, and the forbidden modules that each rank
    had loaded at its end).  ``t_start`` is the caller's
    ``time.perf_counter()`` at its start: on Linux that clock is the
    system's monotonic clock, which the ranks share."""
    limit = float(seconds) + LIMIT_S if limit_s is None else float(limit_s)
    ctx = mp.get_context("spawn")
    cell = (name, seed, seconds, trace_on)
    kw = dict(t_start=t_start, driver_opts=driver_opts, controls=controls)
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        procs = [ctx.Process(target=_rank, args=(
            r, chips, tmp, device_type, os.getpid(), limit, cell, kw))
            for r in range(chips)]
        for p in procs:
            p.start()
        try:
            failure = _wait(procs, time.monotonic() + limit)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(chips):
            path = os.path.join(tmp, f"result-{r}.json")
            if not os.path.exists(path):
                failure = failure or f"rank {r} left no result"
                continue
            with open(path) as f:
                results.append(json.load(f))
    if failure:
        raise RankFailure(failure)
    head = results[0]
    return (head["line"], [tuple(r) for r in head["rows"]],
            head["controls"], [m for res in results for m in res["forbidden"]])
