"""Time a request of opening and closing the workspace and its store: the
self times of the program's ``store.open`` span (``Workspace.open`` and the
``Store`` construction: the workspace's config, the store's database) and
``store.close`` span, added."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    if w is None:
        return None
    parts = [w.self_ms("store.open"), w.self_ms("store.close")]
    return None if None in parts else sum(parts)
