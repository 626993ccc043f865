"""Profiling helpers: the counterpart of ``mcmcglm_tpu/utils/profiling.py``.

``trace(logdir)`` captures the enclosed block with ``torch.profiler`` (the
host, and the card's kernels where CUDA is present) and writes a Chrome
trace to ``logdir/trace.json``; ``time_block`` is the wall-clock analogue,
which synchronises the CUDA devices of the tensors it is given before the
clock stops, so that asynchronous launches cannot fake a time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["trace", "time_block", "Timer"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile of the enclosed block into ``logdir/trace.json``;
    yields the ``torch.profiler.profile`` (``key_averages()`` and the
    like)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    def __init__(self):
        self.seconds: Optional[float] = None


def _devices(obj):
    if torch.is_tensor(obj):
        yield obj.device
    elif isinstance(obj, (str, torch.device)):
        yield torch.device(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _devices(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _devices(v)


@contextlib.contextmanager
def time_block(sync=None):
    """Wall-clock a block; every CUDA device of ``sync`` (a tensor or a
    device, or lists, tuples and dicts of them) is synchronised before the
    clock stops.  Yields a :class:`Timer` whose
    ``.seconds`` is set on exit."""
    t = Timer()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        for dev in {x for x in _devices(sync) if x.type == "cuda"}:
            torch.cuda.synchronize(dev)
        t.seconds = time.perf_counter() - t0
