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


def test_a_program_that_keeps_no_spans_reads_none(monkeypatch):
    from semtools_tpu_torch.utils import tracing

    monkeypatch.delattr(tracing, "records")
    assert spans.program_records() is None
    for name in NEW:
        assert _reader(name)(_readings((999, 1021))) is None


def test_a_traced_run_reports_the_span_metrics(tiny_bench):
    """The traced run sets ``SEMTOOLS_TPU_TIMINGS`` before the program is
    imported, so the program keeps its spans: every cut-down cell reports
    the metrics its ``workloads`` lists name it in, the concatenation's
    bytes equal to the corpus's."""
    code = textwrap.dedent(f'''
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from perfbench import cells, run
        root = Path({str(tiny_bench)!r})
        out = {{}}
        for w in ("arxiv-1k.agent", "arxiv-1k.eval1k-m", "lines10m.single"):
            cell = cells.load_cell(root / "BENCHMARK.json", w, root=root / "perfbench")
            res = run.execute(cell, {SEED}, 0.3, True, device="cpu")
            out[w] = {{k: v["value"] for k, v in res["metrics"].items()}}
        print("METRICS", json.dumps(out))
    ''')
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.split("METRICS", 1)[1])
    bench = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    for w, values in got.items():
        listed = {m["name"] for m in bench["per_layer"] if w in m.get("workloads", [w])}
        assert set(NEW) & listed <= set(values), w
        cfg = cells.load_cell(tiny_bench / "BENCHMARK.json", w,
                              root=tiny_bench / "perfbench").config["corpus"]
        rows = cfg.get("lines") or cfg["documents"] * cfg["lines_per_document"]
        assert values["search.corpus_gb"] * 1e9 <= rows * 256 * 4
        assert values["search.corpus_gb"] > 0.5 * rows * 256 * 4 / 1e9
        assert values["host.gc_ms"] >= 0 and values["search.results_ms"] > 0
