"""The 95th percentile of the traced window's requests, each from its call
to its return (linear between the closest ranks). It stands per layer in a
cell whose host spreads the tail too widely for any bound (``PERF.md``)."""


def read(r):
    if not r.requests:
        return None
    v = sorted(x.seconds for x in r.requests)
    at = (len(v) - 1) * 0.95
    lo = int(at)
    hi = min(lo + 1, len(v) - 1)
    return (v[lo] + (v[hi] - v[lo]) * (at - lo)) * 1e3
