"""evals_per_coord: target evaluations the slice law made per coordinate
update in the window, by the program's counter (the free-running engine's
``state.nev`` counts the law's evaluations, not the speculative ones; the
fused engine's per-sweep count at block_chains=1 is each chain's own)."""


def read(rec):
    w = rec["window"]
    return w["evals"] / (rec["C"] * w["sweeps"] * rec["d"])
