"""Time a request of assembling the ``SearchResult`` lists: the self time
of the program's ``search.results`` span, the collector's passes under it
left out (they are its ``gc`` children, read by ``host.gc_ms``)."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.self_ms("search.results")
