"""replay_pass_us: the device time of the window's CUDA-graph replays
(``loop.replay`` spans, timed by CUDA events around each replay, no
profiler) over the passes they replayed (each replay's B): the pass's
device time, unprofiled, with the launch latency between its kernels."""

from benchmark import spans


def read(rec):
    got = spans.timed(rec, "loop.replay")
    if got is None:
        return None
    reps = [s for _, devs in got for s in devs]
    return sum(s["dev_us"] for s in reps) / sum(s["args"]["B"] for s in reps)
