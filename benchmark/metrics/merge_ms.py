"""merge_ms: the host-clock time of one monitor step's ``pooled.merge``
spans (each a gather of the moments or of the ESS state over the chain
group, closed once the collective's result is ready), summed over the
window and divided by its monitor steps (its calls, one step each), in
ms; rank 0's spans."""

from benchmark import monitor_spans


def read(rec):
    got = monitor_spans.window_spans(rec, ("pooled.merge",))
    if got is None or not got[1]:
        return None
    calls, merges = got
    return 1e-3 * sum(monitor_spans.host_us(s) for s in merges) / len(calls)
