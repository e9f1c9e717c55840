"""Host time a request of the corpus concatenation (``_corpus_of``): the
self time of the program's ``search.corpus`` span, which issues the
``torch.cat`` of the documents' rows and waits for none of its copies."""

from perfbench import spans


def read(r):
    w = spans.window(r)
    return None if w is None else w.self_ms("search.corpus")
