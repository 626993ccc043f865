"""device_idle_pct: the share of the window in which the device ran
nothing: one less the profiled segment's busy time per unit (a pass of
the free-running engine, a sweep of the fused engine) over the unprofiled
window's host-clock time per unit.  Never taken from the profiled
timeline's gaps, which the profiler stretches.  On N cards rank 0's card:
its segment over the window's time per pass of its own."""


def read(rec):
    tr, w = rec.get("trace"), rec["window"]
    own = rec.get("ranks", [w])[0]
    if not tr or not tr["ops"]:
        return None
    host = w["seconds"] / (own["passes"] if "passes" in w else w["sweeps"])
    return 100.0 * (1.0 - tr["busy_s"] / tr["units"] / host)
