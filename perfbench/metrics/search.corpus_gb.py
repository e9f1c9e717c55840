"""Bytes a request that the corpus concatenation writes, in GB: the
``bytes`` counter of the program's ``search.corpus`` span (0 where the
documents' rows are one tensor already)."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    if w is None:
        return None
    n = w.counter("search.corpus", "bytes")
    return None if n is None else n / 1e9
