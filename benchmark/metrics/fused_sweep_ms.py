"""fused_sweep_ms: the device time of the window's fused sweeps
(``fused.sweep`` spans, timed by CUDA events around each sweep's
launches, no profiler) over their count: the unprofiled counterpart of
the profiled ``fused_sweep_kernel`` time."""

from benchmark import spans


def read(rec):
    got = spans.timed(rec, "fused.sweep")
    if got is None:
        return None
    sweeps = [s for _, devs in got for s in devs]
    if len(sweeps) != rec["window"]["sweeps"]:
        return None
    return sum(s["dev_us"] for s in sweeps) / len(sweeps) / 1e3
