"""Candidates a request in a quantized tier's pool: the ``candidates``
counter of the program's ``tier_pool`` stage spans, which each pass of the
pool's growth adds its growth to, so a search's passes sum to its final
pool's width a query."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.counter("tier_pool", "candidates")
