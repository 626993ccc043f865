"""passes_per_sweep: device passes of the free-running engine per sweep in
the window, by its pass counter (``state.ctr``); on N cards the mean over
the cards, each running its own shard of the chains."""


def read(rec):
    w = rec["window"]
    if "passes" not in w:
        return None
    return w["passes"] / (w["sweeps"] * rec["cards"])
