"""sweep_mfu: the whole sweep's share of the card's float32 peak: the
instructions the window's work needed (``roofline.sweep_instructions``:
each evaluation the program's counter records, n densities at a moved
predictor and their sum, plus each sweep's d commits of eta), over the
float32 issue rate (67 TFLOP/s, an FMA counted as two) times the window's
seconds (host clock), times the cards.  It bounds a claim after a change
that takes a kernel off the path."""

from benchmark import roofline


def read(rec):
    w = rec["window"]
    instr = roofline.sweep_instructions(
        w["evals"], rec["C"] * w["sweeps"], rec["n"], rec["d"],
        roofline.pair(rec["config"]))
    if instr is None:
        return None
    return 100.0 * instr / (roofline.F32_INSTR_PER_S * w["seconds"]
                            * rec["cards"])
