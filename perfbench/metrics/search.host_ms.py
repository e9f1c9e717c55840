"""Host time of the library search a request: the request's wall time less
the program's ``embed_query`` and ``scan`` stages (``SEMTOOLS_TPU_TIMINGS``;
each stage ends in a synchronise). What is left is ``_corpus_of``, the
results' assembly and the harness's call."""


def read(r):
    if not r.requests or "scan" not in r.stages:
        return None
    wall = sum(x.seconds for x in r.requests)
    inner = sum(r.stages[s][0] for s in ("embed_query", "scan") if s in r.stages)
    return (wall - inner) * 1e3 / r.n_requests
