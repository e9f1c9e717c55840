"""The scan's share of the chip's roof: the least time the requests' scans
need (``roofline.least_seconds``: the corpus and queries read once and each
hit written once over the memory bandwidth, or the float32 operations over
the float32 rate, the larger) over the device time of the operations
(kernels, copies, fills) launched in the scan: inside the harness's span
around ``search_documents_batched`` once the program's ``scan`` stage has
begun, so not the corpus concatenation's (``search.corpus_ms``). Nothing
where no scan stage was seen. The reading says which bound holds and gives
the card's power limit."""

from perfbench import roofline


def read(r):
    peak = roofline.peaks(r.device_name)
    if r.trace is None or peak is None or not r.requests or not r.trace.staged:
        return None
    busy = r.trace.seconds("search", corpus=False)
    if busy <= 0:
        return None
    least, bound = 0.0, {}
    for x in r.requests:
        s, b = roofline.least_seconds(r.rows, r.dim, x.queries, x.results, peak)
        least += s
        bound[b] = bound.get(b, 0.0) + s
    return {"value": 100.0 * least / busy, "bound": max(bound, key=bound.get),
            "power_limit_w": r.power_limit_w}
