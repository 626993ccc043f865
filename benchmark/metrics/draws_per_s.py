"""draws_per_s: chain-draws completed in the window (chains x sweeps; a
draw is one chain's coefficient vector after a sweep) over the window's
seconds (host clock)."""


def read(rec):
    return rec["C"] * rec["window"]["sweeps"] / rec["window"]["seconds"]
