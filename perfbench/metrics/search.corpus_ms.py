"""Device time a request of the operations that concatenate the documents'
rows into one corpus (``_corpus_of``): those launched inside the harness's
span around ``search_documents_batched`` before the program's ``scan``
stage began (``torch.cat``'s kernels, or one device-to-device copy an input
where the inputs are views of one tensor). Read from the profiler's trace;
nothing where no scan stage was seen."""


def read(r):
    if r.trace is None or not r.trace.requests or not r.trace.staged:
        return None
    return r.trace.seconds("search", corpus=True) * 1e3 / r.trace.requests
