"""Run a function on a world of local processes.

``torchrun`` launches the processes of a real run (``distributed``).  The
CPU tests, the dryrun scripts and the smoke run need a small world inside
one program, with no fixed port: :func:`run_local` spawns ``nprocs``
processes, joins them into one process group through a ``FileStore`` in a
temporary directory, calls ``fn(rank, *args)`` on each and returns their
results in rank order.  A rank that raises, dies or outlives ``timeout``
fails the call with its traceback or exit code; every process is ended
before it returns.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import distributed

__all__ = ["run_local"]


def _child(fn, rank, world, tmp, device_type, backend, timeout, args):
    torch.set_num_threads(1)
    try:
        distributed.initialize(
            f"file://{os.path.join(tmp, 'store')}", world, rank,
            backend=backend, device_type=device_type,
            timeout=datetime.timedelta(seconds=timeout))
        out = {"ok": True, "value": fn(rank, *args)}
    except Exception:
        out = {"ok": False, "error": traceback.format_exc()}
        raise
    finally:
        torch.save(out, os.path.join(tmp, f"result-{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable, nprocs: int, args: Sequence = (), *,
              device_type: str, backend: Optional[str] = None,
              timeout: float = 300.0) -> list:
    """[fn(rank, *args) for each rank] over a fresh process group of
    ``nprocs`` spawned processes (``distributed.initialize`` with
    ``device_type`` and ``backend``; one thread each).  ``device_type``
    has no default: the caller names "cuda" or "cpu".  ``fn`` must be
    importable (a module-level function) and return picklable values;
    ``timeout`` (seconds) bounds the collectives and the whole call."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_child, args=(
            fn, r, nprocs, tmp, device_type, backend, timeout, tuple(args)))
            for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + 30.0
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in hung:
            procs[r].kill()
            procs[r].join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"result-{r}.pt")
            out = (torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
            if out is not None and out["ok"]:
                results.append(out["value"])
            elif out is not None:
                errors.append(f"rank {r} raised:\n{out['error']}")
            else:
                errors.append(f"rank {r} " + (
                    "timed out" if r in hung else f"exited with {p.exitcode}"))
        if errors:
            raise RuntimeError("\n".join(errors))
        return results
