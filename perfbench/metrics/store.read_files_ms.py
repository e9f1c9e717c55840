"""Time a request of the workspace's change detection: the self time of the
program's ``read_files`` stage span (``Store.analyze_document_states``: a
stat of every file, a read of each new or changed one)."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.self_ms("read_files")
