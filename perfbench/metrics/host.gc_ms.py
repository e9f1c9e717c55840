"""Time a request of Python's garbage collector inside the program: the
program's ``gc`` spans (one a pass of the collector, recorded by a
``gc.callbacks`` hook) that ran under one of its spans."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.gc_ms()
