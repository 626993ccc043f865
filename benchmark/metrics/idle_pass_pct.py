"""idle_pass_pct: passes the window's CUDA-graph replays ran with every
lane idle, in percent of the passes replayed (each ``loop.replay``
span's B): the replayed passes less the window's passes by the engine's
pass counter (``state.ctr``, which counts passes with an active lane).
They fall in each call's last block, past the quota.  On N cards rank 0's
card: its spans against its own pass count."""

from benchmark import spans


def read(rec):
    got = spans.timed(rec, "loop.replay")
    passes = rec.get("ranks", [rec["window"]])[0].get("passes")
    if got is None or passes is None:
        return None
    replayed = sum(s["args"]["B"] for _, devs in got for s in devs)
    return 100.0 * (replayed - passes) / replayed
