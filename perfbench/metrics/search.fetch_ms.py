"""Time a request of fetching the answers to the host: the self time of
the program's ``search.fetch`` span (the ``.tolist()`` of every query's
distances and rows, inside the ``scan`` stage), which waits for every
device operation queued before it."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.self_ms("search.fetch")
