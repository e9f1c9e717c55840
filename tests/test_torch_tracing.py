"""``tests/test_tracing.py`` on the port: the stage timings of
``semtools_tpu_torch.utils.tracing``. The recorded stage names and counts
must equal the JAX package's for the same nested stages and for the same
plain search (the times differ and are not compared). Then the port's
request spans, which the JAX package has not: ids and parents across
threads, nothing recorded off, the collector's passes, the span tree of a
search, and the spans in the device trace."""

from __future__ import annotations

import gc
import io
import json
import os
import sys
import threading

import pytest

from semtools_tpu.utils import tracing as jax_tracing
from semtools_tpu_torch.utils import tracing


def _nest(tr):
    tr.reset()
    with tr.stage("outer"):
        with tr.stage("inner"):
            pass
    with tr.stage("inner"):
        pass
    return dict((name, count) for name, _, count in tr.timings())


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("SEMTOOLS_TPU_TIMINGS", raising=False)
    for tr in (tracing, jax_tracing):
        tr.reset()
        with tr.stage("x"):
            pass
        assert tr.timings() == []


def test_records_and_reports(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_TIMINGS", "1")
    rows = _nest(tracing)
    assert rows == {"outer": 1, "inner": 2} == _nest(jax_tracing)
    _nest(tracing)
    buf = io.StringIO()
    tracing.report(file=buf)
    out = buf.getvalue()
    assert "outer" in out and "x2" in out
    tracing.reset()
    jax_tracing.reset()


def test_search_emits_stages(monkeypatch, tmp_path):
    monkeypatch.setenv("SEMTOOLS_TPU_TIMINGS", "1")
    p = tmp_path / "f.txt"
    p.write_text("alpha beta\ngamma delta\n")
    from semtools_tpu.models.static_model import StaticModel as JaxModel
    from semtools_tpu.search import SearchConfig as JaxConfig
    from semtools_tpu.search import search_files as jax_search_files
    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.search import SearchConfig, search_files

    tracing.reset()
    search_files([str(p)], "alpha", StaticModel.fallback(device="cpu"), SearchConfig(top_k=1))
    names = {name for name, _, _ in tracing.timings()}
    assert {"read_files", "embed", "scan"} <= names
    jax_tracing.reset()
    jax_search_files([str(p)], "alpha", JaxModel.fallback(), JaxConfig(top_k=1))
    jax_names = {name for name, _, _ in jax_tracing.timings()}
    assert {"read_files", "embed", "scan"} <= jax_names
    tracing.reset()
    jax_tracing.reset()


# -- the port's request spans (no JAX counterpart) ----------------------------


@pytest.fixture
def quiet():
    """No recorder on when the test starts (none kept for the process), and
    the kept one as it was after."""
    kept = tracing._kept is not None
    tracing.keep(False)
    tracing.reset()
    yield
    tracing.reset()
    tracing.keep(kept)


def _tree(spans):
    return {s.span: s for s in spans}


def test_client_threads_record_requests_apart(quiet):
    """More client threads than cores at once, switching every
    microsecond: every span's parent is a span of its own request and
    thread, and the roots carry the ids the clients gave."""
    clients, requests = max(8, 2 * (os.cpu_count() or 1)), 100
    done = {}

    def client(c):
        for seq in range(requests):
            with tracing.request(c * 1_000_000 + seq):
                with tracing.span("a"):
                    with tracing.span("b"):
                        pass
                    with tracing.stage("c"):
                        pass
        done[c] = threading.get_ident()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.record() as spans:
            threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and len(done) == clients
    spans = [s for s in spans if s.name != "gc"]
    by_id = _tree(spans)
    assert len(spans) == clients * requests * 3 and len(by_id) == len(spans)
    for s in spans:
        c = s.request // 1_000_000
        assert s.thread == done[c]
        if s.name == "a":
            assert s.parent is None
        else:
            up = by_id[s.parent]
            assert up.name == "a" and up.request == s.request and up.thread == s.thread
            assert up.start <= s.start <= s.end <= up.end
    assert {s.request for s in spans} == {c * 1_000_000 + q for c in range(clients)
                                          for q in range(requests)}


def test_a_span_outside_a_request_starts_its_own(quiet):
    with tracing.record() as spans:
        with tracing.span("x"):
            with tracing.span("y") as y:
                y.count("bytes", 3)
                y.count("bytes", 4)
        with tracing.span("z"):
            pass
    x, y, z = sorted((s for s in spans if s.name != "gc"), key=lambda s: s.name)
    assert x.request == x.span and x.parent is None and y.parent == x.span
    assert y.request == x.request and y.attrs == {"bytes": 7}
    assert z.request == z.span != x.request


def test_off_records_nothing_and_keeps_the_stage_totals(quiet, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_TIMINGS", "1")

    def run():
        tracing.reset()
        for _ in range(3):
            with tracing.request(5), tracing.stage("outer"):
                with tracing.span("inner") as sp:
                    sp.count("bytes", 1)
        return {name: count for name, _, count in tracing.timings()}

    off = run()
    assert tracing.span("x") is tracing.request() is tracing._OFF
    assert tracing.records() == [] and not tracing._on
    with tracing.record() as spans:
        on = run()
    assert off == on == {"outer": 3}
    names = [s.name for s in spans if s.name != "gc"]
    assert names.count("outer") == 3 and names.count("inner") == 3
    assert all(s.request == 5 for s in spans if s.name != "gc")


def test_kept_spans_while_keep_is_on(quiet):
    tracing.keep(True)
    with tracing.span("kept"):
        pass
    assert [s.name for s in tracing.records() if s.name != "gc"] == ["kept"]
    tracing.keep(False)
    assert tracing.records() == [] and not tracing._on and tracing._on_gc not in gc.callbacks


def test_kept_spans_leave_the_collector_s_passes_alone(quiet):
    """The kept store holds plain tuples that a pass untracks, counters and
    collections included, so a full pass does not walk them."""
    tracing.keep(True)
    for _ in range(100):
        with tracing.span("outer") as sp:
            sp.count("bytes", 1 << 40)
            with tracing.stage("inner"):
                pass
    gc.collect()
    gc.collect()
    kept = list(tracing._kept)[:-1]  # the last pass's own span: made after it
    assert len(kept) >= 201 and any(r[0] == "gc" for r in kept)
    assert not [r for r in kept if gc.is_tracked(r)]
    outer = [s for s in tracing.records() if s.name == "outer"]
    assert len(outer) == 100 and all(s.attrs == {"bytes": 1 << 40} for s in outer)


def test_a_collection_is_a_gc_child_of_the_open_span(quiet):
    with tracing.record() as spans:
        with tracing.span("outer"):
            gc.collect()
    assert tracing._on_gc not in gc.callbacks
    outer = next(s for s in spans if s.name == "outer")
    passes = [s for s in spans if s.name == "gc"]
    assert passes and all(s.parent == outer.span and s.request == outer.request
                          and s.thread == outer.thread for s in passes)
    assert any(s.attrs["generation"] == 2 for s in passes)
    assert all(outer.start <= s.start <= s.end <= outer.end for s in passes)


def _search_docs():
    import torch

    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.search import SearchConfig, create_documents_from_contents

    model = StaticModel.fallback(device="cpu")
    docs = create_documents_from_contents(
        [("a.txt", "alpha beta\ngamma delta\nepsilon\n"), ("b.txt", "zeta eta\ntheta\n"),
         ("c.txt", "iota kappa lambda\n")], model, False)
    q = model.encode(["alpha", "theta"])
    return docs, torch.as_tensor(q), SearchConfig


@pytest.mark.parametrize("threshold", [None, 1.5])
def test_search_gives_its_span_tree(quiet, threshold):
    from semtools_tpu_torch.search import search_documents_batched

    docs, q, SearchConfig = _search_docs()
    rows = sum(len(d.lines) for d in docs)
    config = SearchConfig(n_lines=1, top_k=2, max_distance=threshold)
    with tracing.record() as spans:
        out = search_documents_batched(docs, q, config)
    assert len(out) == 2 and all(out)
    spans = [s for s in spans if s.name != "gc"]
    by_id = _tree(spans)
    root = next(s for s in spans if s.name == "search")
    assert root.parent is None and all(s.request == root.request for s in spans)
    kids = {s.name: s for s in spans if s.parent == root.span}
    assert list(kids) == ["search.corpus", "scan", "search.results"]
    fetch = next(s for s in spans if s.name == "search.fetch")
    assert by_id[fetch.parent].name == "scan"
    assert kids["search.corpus"].attrs == {"bytes": rows * docs[0].embeddings.shape[1] * 4}
    assert kids["search.corpus"].end <= kids["scan"].start <= kids["scan"].end \
        <= kids["search.results"].start


def test_one_document_writes_no_corpus_bytes(quiet):
    from semtools_tpu_torch.search import search_documents_batched

    docs, q, SearchConfig = _search_docs()
    with tracing.record() as spans:
        search_documents_batched(docs[:1], q, SearchConfig(top_k=1))
    corpus = next(s for s in spans if s.name == "search.corpus")
    assert corpus.attrs is None


def test_encode_gives_tokenize_and_pool_spans(quiet):
    from semtools_tpu_torch.models.static_model import StaticModel

    model = StaticModel.fallback(device="cpu")
    with tracing.record() as spans:
        model.encode(["one text", "two"])
    assert [s.name for s in spans if s.name != "gc"] == ["tokenize", "embed.pool"]


def test_the_device_trace_holds_the_spans(quiet, monkeypatch, tmp_path):
    monkeypatch.setenv("SEMTOOLS_TPU_TRACE", str(tmp_path))
    with tracing.maybe_device_trace():
        with tracing.request(42), tracing.span("traced.outer"):
            with tracing.span("traced.inner"):
                sum(range(10_000))
    assert not tracing._on
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    mine = {e["name"]: e for e in events if e.get("cat") == "semtools_span"}
    outer, inner = mine["traced.outer"], mine["traced.inner"]
    assert outer["ph"] == inner["ph"] == "X" and outer["args"]["request"] == 42
    assert inner["args"]["parent"] == outer["args"]["span"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    anchor = next(e for e in events if e.get("name") == tracing.ANCHOR)
    assert anchor["ts"] <= outer["ts"]
