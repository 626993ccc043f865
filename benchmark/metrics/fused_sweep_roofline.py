"""fused_sweep_roofline: the least time the profiled ``fused_sweep``
launches could take, by ``roofline.fused_bound`` on each sweep's own
evaluations (a block_chains=1 launch counts each chain's own), over their
profiled time (``fused_sweep_kernel`` on the card)."""

from benchmark import roofline

DEVICE_NAME = "fused_sweep_kernel"


def read(rec):
    tr, eng = rec.get("trace"), rec["engine"]
    if not tr or "nev" not in tr or eng.get("block_chains") != 1:
        return None
    hits = [v for k, v in tr["by_name"].items() if DEVICE_NAME in k]
    if not hits:
        return None
    bound_s = 0.0
    for nev in tr["nev"]:
        b, _ = roofline.fused_bound(nev, rec["C"], rec["n"], rec["d"],
                                    roofline.pair(rec["config"]))
        if b is None:
            return None
        bound_s += b
    return 100.0 * bound_s / sum(h[0] for h in hits)
