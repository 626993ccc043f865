"""monitor_pct: the host-clock time of the window's pooled-monitor spans
(``pooled.fold``, ``pooled.merge``, ``pooled.summary``: the fold of each
chunk's draws into the moments and the ESS state, the gathers over the
chain group, the combination), over the window's host-clock time, in
percent; rank 0's spans.  Each span closes once its card has finished, so
it holds the device work and the collectives' completion."""

from benchmark import monitor_spans, spans


def read(rec):
    got = monitor_spans.window_spans(rec)
    if got is None or not got[1]:
        return None
    used = sum(monitor_spans.host_us(s) for s in got[1])
    return 100.0 * used / spans.window_us(rec)
