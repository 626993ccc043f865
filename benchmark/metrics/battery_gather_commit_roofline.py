"""battery_gather_commit_roofline: the least time one launch of the
free-running engine's gather battery (``battery_kernel`` on the card,
``battery_impl="cuda3"``) could take at the cell's C, n and K, by
``roofline.battery_bound``, over its profiled time per launch.  Each
launch reads the rows of at most min(C, d) distinct coordinates; at these
shapes the instructions bound it, so the row count does not move it.  On
N cards rank 0's launches, at its C / N chains."""

from benchmark import roofline

DEVICE_NAME = "battery_kernel"


def read(rec):
    tr, eng = rec.get("trace"), rec["engine"]
    if not tr or eng.get("battery") != "cuda3":
        return None
    hits = [v for k, v in tr["by_name"].items() if DEVICE_NAME in k]
    if not hits:
        return None
    sec = sum(h[0] for h in hits) / sum(h[1] for h in hits)
    row_bytes = 2 if eng.get("x_storage") == "bf16" else 4
    C = rec["C"] // rec["cards"]
    bound_s, _ = roofline.battery_bound(
        C, rec["n"], eng["spec_k"], roofline.pair(rec["config"]),
        "battery_gather_commit", rows=min(C, rec["d"]),
        row_bytes=row_bytes)
    if bound_s is None:
        return None
    return 100.0 * bound_s / sec
