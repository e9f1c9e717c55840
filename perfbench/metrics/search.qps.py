"""Queries answered a second in the traced window, over all its requests
and all its time, as ``search_qps`` reads the untraced window; here the
program's stage timings (each ends in a synchronise) and the profiler are
on. It stands per layer in a cell whose host spreads the rate too widely
for any bound (``PERF.md``)."""


def read(r):
    if not r.requests or r.window_s <= 0:
        return None
    return sum(x.queries for x in r.requests) / r.window_s
