"""A short profiled segment, reduced to what the per-layer metrics read.

``torch.profiler`` records the device's operations (kernels, copies,
sets) and the host's calls over one call of the segment.  Busy time is
the union of the device operations' intervals; the gaps between them are
labelled by the host call that began last before the gap ended (a graph
launch, the flag read's synchronise, an operator between chunks).  The
profiler stretches those gaps (811 against 367 us per pass for the same
graph), so an idle share is never taken from its timeline: the metrics
set the busy time against the unprofiled window instead.  Nothing is
written to disk.
"""

from __future__ import annotations

import bisect
import time

import torch

__all__ = ["profile_call", "top"]

TOP = 10
NAME_CHARS = 160  # a kernel's name, cut: template arguments run to pages


def _reduce(events, wall: float) -> dict:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(span)
    dev.sort()
    host.sort()
    by_name: dict = {}
    for s, t, name in dev:
        sec, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + (t - s) / 1e6, cnt + 1)
    busy, gaps = 0.0, {}
    starts = [h[0] for h in host]
    end = None
    for s, t, _ in dev:
        if end is None or s >= end:
            busy += t - s
            if end is not None and s > end:
                i = bisect.bisect_right(starts, s) - 1
                label = host[i][2] if i >= 0 else "(none)"
                gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
            end = t
        elif t > end:
            busy += t - end
            end = t
    return dict(wall_s=wall, busy_s=busy / 1e6, ops=len(dev),
                by_name=by_name, gaps=gaps)


def profile_call(fn, device):
    """(what fn() returned, the segment's reduction) of one profiled call;
    the wall clock runs from the call to the device's last operation."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return out, _reduce(prof.events(), wall)


def top(items: dict, per: float):
    """The ``TOP`` largest of {name: seconds}, each over ``per`` units."""
    rows = sorted(items.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], sec / per] for name, sec in rows]
