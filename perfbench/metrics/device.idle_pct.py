"""Share of the traced window in which no operation ran on the device (the
union of the profiler's kernel, copy and fill intervals)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
