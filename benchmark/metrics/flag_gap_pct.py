"""flag_gap_pct: the device time between consecutive replays of one
window call (from one ``loop.replay`` span's end event to the next one's
start event), over the window's host-clock time, in percent: the flag
read, the host's return and the next graph launch."""

from benchmark import spans


def read(rec):
    got = spans.timed(rec, "loop.replay")
    if got is None:
        return None
    gaps = sum(s["gap_us"] for _, devs in got for s in devs[1:])
    return 100.0 * gaps / spans.window_us(rec)
