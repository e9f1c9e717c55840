"""The store's scan's share of the chip's roof: the least time the
requests' scans need on the tier that serves them
(``store_roofline.least_seconds``: the live rows in the tier's form, the
queries and the hits over the memory bandwidth, or the operations over
their peak, the larger) over the device time of the operations (kernels,
copies, fills) launched inside the harness's span around
``search_with_workspace_batched``. That time also holds the query embed's
few microseconds. Nothing for a tier not counted or without a trace. The
reading gives the bound, the tier and the card's power limit."""

from perfbench import store_roofline


def read(r):
    if r.trace is None or not r.requests:
        return None
    busy = r.trace.seconds("search", corpus=False)
    if busy <= 0:
        return None
    least, bound = 0.0, {}
    for x in r.requests:
        got = store_roofline.least_seconds(r.tier, r.rows, r.dim, x.queries, x.results,
                                           r.device_name)
        if got is None:
            return None
        least += got[0]
        bound[got[1]] = bound.get(got[1], 0.0) + got[0]
    return {"value": 100.0 * least / busy, "bound": max(bound, key=bound.get), "tier": r.tier,
            "power_limit_w": r.power_limit_w}
