"""The pooled monitor's spans in a run's window, for ``monitor_pct`` and
``merge_ms``.

The program records ``pooled.fold``, ``pooled.merge`` and
``pooled.summary`` as call spans of their own beside its engine calls
(``mcmcglm_tpu_torch.utils.profiling``): host intervals that close once
the card has finished.  The window's are those recorded with no profiler
active from the start of the window's first call (``spans.window``) on:
each window call's monitor step follows it, and nothing after the window
runs the monitor.  A program that records none, or a run whose window
calls ``spans.window`` cannot find, gives None.
"""

from __future__ import annotations

from . import spans

NAMES = ("pooled.fold", "pooled.merge", "pooled.summary")


def window_spans(rec, names=NAMES):
    """(the window's call spans, its monitor spans named ``names``), or
    None."""
    got = spans.window(rec)
    if got is None:
        return None
    start = got[0][0]["t0"]
    mine = [s for s in spans._recorded() if s["name"] in names
            and s["id"] == s["call"] and not s["profiled"]
            and s["t0"] >= start]
    return [call for call, _ in got], mine


def host_us(s) -> float:
    return 1e-3 * (s["t1"] - s["t0"])
