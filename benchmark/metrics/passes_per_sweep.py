"""passes_per_sweep: device passes of the free-running engine per sweep in
the window, by its pass counter (``state.ctr``)."""


def read(rec):
    w = rec["window"]
    if "passes" not in w:
        return None
    return w["passes"] / w["sweeps"]
