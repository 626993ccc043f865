"""ops_per_pass: device operations (kernels, copies, sets) per pass in the
profiled segment."""


def read(rec):
    tr = rec.get("trace")
    if not tr or rec["engine"]["engine"] != "FreeRunCGGibbs" or not tr["ops"]:
        return None
    return tr["ops"] / tr["units"]
