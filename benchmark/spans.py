"""The program's own spans (``mcmcglm_tpu_torch.utils.profiling``), read
after a run by the per-layer metrics of the pass loop, the engines' calls
and the fused sweep.

The window's calls are the last K call spans named ``freerun.run`` or
``fused.run`` recorded with no profiler active, K the window's sweeps over
the cell's chunk sweeps (the harness makes one such call per chunk and
none after the window unprofiled).  They count only when their
``n_sweeps`` sum to the window's sweeps.  Each call's device spans are its
``loop.replay`` spans (free-running) or its ``fused.sweep`` spans (fused),
in order; ``dev_us`` is a span's device time and ``gap_us`` the device
time since the device span before it (``prev``), both from CUDA events.
A program without the recorder, or a run without device times (the CPU,
the eager loop), gives None.
"""

from __future__ import annotations

DEVICE_SPAN = {"freerun.run": "loop.replay", "fused.run": "fused.sweep"}


def _recorded():
    """The program's spans, or None where it records none."""
    try:
        from mcmcglm_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def window(rec):
    """[(the window's call span, its device spans)] in order, or None."""
    w = rec["window"]
    chunk = int(rec["work"]["chunk_sweeps"])
    K = w["sweeps"] // chunk
    every = _recorded()
    if every is None or K < 1:
        return None
    calls = [s for s in every if s["name"] in DEVICE_SPAN
             and s["id"] == s["call"] and not s["profiled"]][-K:]
    if (len(calls) != K
            or sum(c["args"].get("n_sweeps", 0) for c in calls)
            != w["sweeps"]):
        return None
    inner = {c["id"]: [] for c in calls}
    for s in every:
        if s["call"] in inner and s["name"] == DEVICE_SPAN.get(
                calls[0]["name"]):
            inner[s["call"]].append(s)
    return [(c, inner[c["id"]]) for c in calls]


def timed(rec, name=None):
    """:func:`window` where every device span of the window has a device
    time and is linked to the one before it within its call (and to the
    previous call's last, from the second call on), and the calls' device
    spans are named ``name`` when given; else None."""
    got = window(rec)
    if got is None:
        return None
    prev = None
    for _, devs in got:
        if not devs:
            return None
        for s in devs:
            if (s["dev_us"] is None or (name and s["name"] != name)
                    or (prev is not None and s["prev"] != prev["id"])):
                return None
            prev = s
    return got


def window_us(rec) -> float:
    return 1e6 * rec["window"]["seconds"]
