"""min_ess_per_s: the least ESS over the d coordinates of the window's
draws, pooled over chains, over the window's seconds (host clock)."""


def read(rec):
    return rec["ess"]["min"] / rec["window"]["seconds"]
