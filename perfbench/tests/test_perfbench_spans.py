"""The readers of the program's spans (``spans.py``, ``metrics/``): on
made-up records, and in a traced run of the cut-down cells on the CPU."""

import json
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

from perfbench import cells, spans
from conftest import REPO, SEED

from semtools_tpu_torch.utils.tracing import SpanRecord

MS = 1_000_000
NEW = ("search.corpus_host_ms", "search.corpus_gb", "search.fetch_ms", "search.results_ms",
       "embed.tokenize_ms", "host.gc_ms")


def _rec(name, rid, sid, parent, start_ms, end_ms, attrs=None):
    return SpanRecord(name, rid, sid, parent, 7, int(start_ms * MS), int(end_ms * MS), attrs)


def _readings(*windows_ms):
    return SimpleNamespace(requests=[SimpleNamespace(start=a / 1e3, end=b / 1e3)
                                     for a, b in windows_ms])


def _request(rid, at):
    """One request's spans from ``at`` ms: an embed, then a search whose
    results hold a collection of 2 ms."""
    b = rid * 100
    return [
        _rec("tokenize", b + 1, b + 2, b + 1, at + 0.5, at + 1.5),
        _rec("embed_query", b + 1, b + 1, None, at, at + 2),
        _rec("search.corpus", b + 3, b + 4, b + 3, at + 2, at + 5, {"bytes": 2_000_000_000}),
        _rec("search.fetch", b + 3, b + 6, b + 5, at + 5, at + 9),
        _rec("scan", b + 3, b + 5, b + 3, at + 5, at + 10),
        _rec("gc", b + 3, b + 8, b + 7, at + 11, at + 13, {"generation": 2, "collected": 0}),
        _rec("search.results", b + 3, b + 7, b + 3, at + 10, at + 20),
        _rec("search", b + 3, b + 3, None, at + 2, at + 20),
    ]


def _reader(name):
    return cells.load_cell(REPO / "BENCHMARK.json", "arxiv-1k.eval1k").reader(name)


def test_self_times_leave_the_collector_out():
    records = _request(1, 1000) + _request(2, 2000)
    w = spans.window(_readings((999, 1021), (1999, 2021)), records)
    assert w.searches == 2
    assert w.self_ms("search.results") == pytest.approx(8.0)  # 10 ms less the 2 ms pass
    assert w.self_ms("search.corpus") == pytest.approx(3.0)
    assert w.self_ms("search.fetch") == pytest.approx(4.0)
    assert w.self_ms("scan") == pytest.approx(1.0)
    assert w.self_ms("tokenize") == pytest.approx(1.0)
    assert w.gc_ms() == pytest.approx(2.0)
    assert w.counter("search.corpus", "bytes") == 2e9
    assert w.self_ms("no.such") is None


def test_only_the_window_s_requests_count():
    records = _request(1, 1000) + _request(2, 2000) + _request(3, 3000)
    # a collection outside any program span, between requests
    records.append(_rec("gc", 400, 400, None, 1030, 1040, {"generation": 2, "collected": 0}))
    w = spans.window(_readings((1999, 2021)), records)
    assert w.searches == 1 and {s.request for s in w.spans} == {201, 203}
    assert w.gc_ms() == pytest.approx(2.0)


def test_a_window_with_no_search_reads_none(monkeypatch):
    records = [r for r in _request(1, 1000) if r.request == 101]  # the embed alone
    assert spans.window(_readings((999, 1021)), records) is None
    assert spans.window(_readings((999, 1021)), []) is None
    monkeypatch.setattr(spans, "program_records", lambda: records)
    for name in NEW:
        assert _reader(name)(_readings((999, 1021))) is None


def test_the_readers_read_a_request(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: _request(1, 1000))
    got = {name: _reader(name)(_readings((999, 1021))) for name in NEW}
    assert got == pytest.approx({"search.corpus_host_ms": 3.0, "search.corpus_gb": 2.0,
                                 "search.fetch_ms": 4.0, "search.results_ms": 8.0,
                                 "embed.tokenize_ms": 1.0, "host.gc_ms": 2.0})


def test_the_rate_and_the_tail_of_the_traced_window():
    reqs = [SimpleNamespace(queries=1, seconds=ms / 1e3) for ms in range(1, 101)]
    r = SimpleNamespace(requests=reqs, window_s=2.0)
    assert _reader("search.qps")(r) == pytest.approx(50.0)
    assert _reader("search.p95_ms")(r) == pytest.approx(95.05)  # between the 95th and 96th
    empty = SimpleNamespace(requests=[], window_s=2.0)
    assert _reader("search.qps")(empty) is None and _reader("search.p95_ms")(empty) is None


def test_a_reader_under_another_name_reads_the_same(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: _request(1, 1000))
    r = _readings((999, 1021))
    assert _reader("search.corpus_gb.device")(r) == _reader("search.corpus_gb")(r) == 2.0
    untraced = SimpleNamespace(device_name="NVIDIA H100 80GB HBM3", trace=None, requests=[1])
    assert _reader("scan.roof_pct.device")(untraced) is None


def test_a_program_that_keeps_no_spans_reads_none(monkeypatch):
    from semtools_tpu_torch.utils import tracing

    monkeypatch.delattr(tracing, "records")
    assert spans.program_records() is None
    for name in NEW:
        assert _reader(name)(_readings((999, 1021))) is None


def _traced_metrics(root, workloads, copies=False):
    """Each cut-down cell's metrics from a traced run in a fresh process,
    which sets ``SEMTOOLS_TPU_TIMINGS`` before the program is imported; with
    ``copies`` each document's rows are a tensor of their own."""
    code = textwrap.dedent(f'''
        import json, os, sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from perfbench import cells, run
        if {copies!r}:
            os.environ["SEMTOOLS_TPU_TIMINGS"] = "1"  # before the program's import, as run.py
            from semtools_tpu_torch import search

            real = search.create_documents_from_contents

            def separate(*args, **kw):
                docs = real(*args, **kw)
                for d in docs:
                    d.embeddings = d.embeddings.clone()
                return docs

            search.create_documents_from_contents = separate
        root = Path({str(root)!r})
        out = {{}}
        for w in {list(workloads)!r}:
            cell = cells.load_cell(root / "BENCHMARK.json", w, root=root / "perfbench")
            res = run.execute(cell, {SEED}, 0.3, True, device="cpu")
            out[w] = {{k: v["value"] for k, v in res["metrics"].items()}}
        print("METRICS", json.dumps(out))
    ''')
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.split("METRICS", 1)[1])


def _corpus_bytes(root, workload):
    cfg = cells.load_cell(root / "BENCHMARK.json", workload,
                          root=root / "perfbench").config["corpus"]
    return (cfg.get("lines") or cfg["documents"] * cfg["lines_per_document"]) * 256 * 4


def test_a_traced_run_reports_the_span_metrics(tiny_bench):
    """Every cut-down cell reports the metrics its ``workloads`` lists name
    it in. Its documents are views of one tensor, as the real cells build
    them, so the scan reads them as one view and nothing is copied."""
    got = _traced_metrics(tiny_bench, ("arxiv-1k.agent", "arxiv-1k.eval1k-m", "lines10m.single"))
    bench = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    for w, values in got.items():
        listed = {m["name"] for m in bench["per_layer"] if w in m.get("workloads", [w])}
        assert set(NEW) & listed <= set(values), w
        # the copy's bytes, under the name the cell lists them by
        assert [values[n] for n in sorted(listed) if n.startswith("search.corpus_gb")] == [0], w
        if "host.gc_ms" in listed:
            assert values["host.gc_ms"] >= 0 and values["search.results_ms"] > 0
    assert {"search.qps", "search.corpus_gb.device"} <= set(got["lines10m.single"])


def test_documents_of_separate_tensors_count_their_copied_bytes(tiny_bench):
    """Where each document's rows are a tensor of their own, the search
    copies them into one corpus a request, and ``search.corpus_gb`` reads
    the corpus's bytes."""
    got = _traced_metrics(tiny_bench, ("arxiv-1k.agent", "arxiv-1k.eval1k-m"), copies=True)
    for w, values in got.items():
        assert values["search.corpus_gb"] * 1e9 == pytest.approx(_corpus_bytes(tiny_bench, w)), w
