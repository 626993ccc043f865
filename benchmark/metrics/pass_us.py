"""pass_us: the window's host-clock microseconds per pass, all of its
time (graph replays, flag reads, the host between chunks) over its
passes; on N cards each card's, its passes the mean over the cards."""


def read(rec):
    w = rec["window"]
    if not w.get("passes"):
        return None
    return 1e6 * w["seconds"] * rec["cards"] / w["passes"]
