"""setup_s: seconds from the process's start to the window's: imports,
the kernel library's load (its build on a cold cache), the data, the
engine, burn-in and the untimed chunk that captures the sampling graph."""


def read(rec):
    return rec["setup_s"]
