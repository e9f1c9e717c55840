"""Time a request of tokenizing the query texts on the host: the self time
of the program's ``tokenize`` stage span in ``StaticModel.encode``."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.self_ms("tokenize")
