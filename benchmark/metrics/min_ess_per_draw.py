"""min_ess_per_draw: the least ESS over coordinates per chain-draw of the
window: how well the slice law mixes, apart from its speed."""


def read(rec):
    return rec["ess"]["min"] / (rec["C"] * rec["window"]["sweeps"])
