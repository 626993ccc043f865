"""pass_busy_us: device-busy microseconds per pass in the profiled segment
(the union of its device operations' intervals, over its passes)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or rec["engine"]["engine"] != "FreeRunCGGibbs" or not tr["ops"]:
        return None
    return 1e6 * tr["busy_s"] / tr["units"]
