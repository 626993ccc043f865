"""call_gap_pct: the device time from the end of one window call's last
replay or sweep to the start of the next call's first (the first device
span's gap in each window call but the first), over the window's
host-clock time, in percent: the host between chunks, the copy-in, the
clone-out and the buffer kernels; an upper bound on the idle time
there."""

from benchmark import spans


def read(rec):
    got = spans.timed(rec)
    if got is None:
        return None
    gaps = sum(devs[0]["gap_us"] for _, devs in got[1:])
    return 100.0 * gaps / spans.window_us(rec)
