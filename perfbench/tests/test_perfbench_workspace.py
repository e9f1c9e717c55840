"""The workspace route (``"serve": "workspace"``): a configuration served
from the workspace store runs as data files alone, is judged as the library
cells are, fails for each planted fault, and leaves nothing behind."""

import dataclasses
import json
import os
import tempfile
import textwrap

import pytest

from perfbench import cells, run
from semtools_tpu_torch import search
from conftest import SEED

CELL = "arxiv-1k-ws.agent"


def _add_workspace_cell(root, settings=None, clients=1, name=CELL):
    """A workspace configuration of the arXiv corpus, a cell of it on
    ``agent``'s mix from ``clients`` clients, its limits (``agent``'s) and a
    reader of the store's scan, as new files and entries."""
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "arxiv-1k.json").read_text())
    cfg.update(name="arxiv-1k-ws", serve="workspace")
    if settings is not None:
        cfg["workspace"] = settings
    (pb / "configs" / "arxiv-1k-ws.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "agent.json").read_text())
    traffic.update(name=f"agent{clients}", clients=clients)
    (pb / "traffic" / f"agent{clients}.json").write_text(json.dumps(traffic))
    (pb / "limits" / f"{name}.json").write_text(
        (pb / "limits" / "arxiv-1k.agent.json").read_text())
    (pb / "metrics" / "store.scan_ms.py").write_text(textwrap.dedent('''
        def read(r):
            ms = r.stage_ms_per_request("store_scan")
            return None if ms is None else {"value": ms, "tier": r.tier}
    '''))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "arxiv-1k-ws", "source": "https://example.org/x",
                             "file": "perfbench/configs/arxiv-1k-ws.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": name, "config": "arxiv-1k-ws", "traffic": f"agent{clients}",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "store.scan_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "workspace store",
                               "moves": "search_qps", "workloads": [name]})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cells.load_cell(root / "BENCHMARK.json", name, root=pb)


@pytest.fixture
def scratch(tmp_path, monkeypatch):
    """A ``HOME`` and a temporary directory of the test's own, both empty.
    ``coalesce.enable()`` lasts the process, which a run ends but the tests
    outlive, so its flag is put back after each test."""
    from semtools_tpu_torch.store import coalesce

    monkeypatch.setattr(coalesce, "_enabled", coalesce._enabled)
    home, tmp = tmp_path / "home", tmp_path / "tmp"
    home.mkdir()
    tmp.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    return home, tmp


def _left_behind(scratch):
    """What the run's files, store and workspace left (torch's own caches in
    the temporary directory, such as the profiler's, are not the run's)."""
    home, tmp = scratch
    return sorted(str(p) for p in [*home.rglob("*"), *tmp.glob("perfbench-*")])


@pytest.mark.parametrize("settings, clients, tier", [
    (None, 1, "exact-mxu-scan"),
    ({"device_cache_bytes": 1 << 20, "coalesce": True}, 4, "int8-mxu-scan"),
])
def test_a_workspace_cell_added_as_files_runs(tiny_bench, scratch, settings, clients, tier):
    before = {p: p.read_bytes() for p in (tiny_bench / "perfbench").rglob("*") if p.is_file()}
    cell = _add_workspace_cell(tiny_bench, settings, clients)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    for traced in (False, True):
        res = run.execute(cell, SEED, 0.3, traced, device="cpu")
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        assert "context" not in res["checks"]
        assert list(res)[-1] == "checks"
        if traced:
            assert res["metrics"]["store.scan_ms"]["tier"] == tier
        else:
            assert set(res["metrics"]) == {"search_qps", "setup_s"}
    assert _left_behind(scratch) == []


def test_the_check_lines_say_context_is_not_checked(tiny_bench, scratch):
    res = run.execute(_add_workspace_cell(tiny_bench), SEED, 0.3, False, device="cpu")
    lines = run.check_lines(res)
    assert lines[0] == run.NO_CONTEXT
    assert not any(line.startswith("check context =") for line in lines)
    library = run.execute(cells.load_cell(tiny_bench / "BENCHMARK.json", "arxiv-1k.agent",
                                          root=tiny_bench / "perfbench"),
                          SEED, 0.3, False, device="cpu")
    assert run.NO_CONTEXT not in run.check_lines(library)
    assert "context" in library["checks"]


def test_the_configuration_alone_sets_the_store(tiny_bench, scratch, monkeypatch):
    """A serving variable in the environment changes nothing and is back
    when the run ends."""
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")
    res = run.execute(_add_workspace_cell(tiny_bench), SEED, 0.3, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["store.scan_ms"]["tier"] == "exact-mxu-scan"
    assert os.environ["SEMTOOLS_TPU_STORE_INT8"] == "1"


def test_unknown_workspace_settings_and_vector_corpora_are_refused(tiny_bench, scratch):
    cell = _add_workspace_cell(tiny_bench, {"device_cache_bytes": 1 << 30, "int8": True})
    with pytest.raises(cells.BenchError, match="int8"):
        run.execute(cell, SEED, 0.3, False, device="cpu")
    cell.config = dict(cell.config, serve="daemon")
    with pytest.raises(cells.BenchError, match="daemon"):
        run.execute(cell, SEED, 0.3, False, device="cpu")
    vectors = cells.load_cell(tiny_bench / "BENCHMARK.json", "lines10m.single",
                              root=tiny_bench / "perfbench")
    vectors.config = dict(vectors.config, serve="workspace")
    with pytest.raises(cells.BenchError, match="text"):
        run.execute(vectors, SEED, 0.3, False, device="cpu")
    assert _left_behind(scratch) == []


def _first_with(out, n):
    return next(per for per in out if len(per) >= n)


def _moved_distance(real):
    def broken(*args, **kw):
        out = real(*args, **kw)
        per = _first_with(out, 1)
        per[0] = dataclasses.replace(per[0], distance=per[0].distance + 1e-4)
        return out
    return broken


def _swapped(real):
    def broken(*args, **kw):
        out = real(*args, **kw)
        per = _first_with(out, 2)
        per[0], per[-1] = per[-1], per[0]
        return out
    return broken


def _dropped(real):
    def broken(*args, **kw):
        out = real(*args, **kw)
        _first_with(out, 1).pop()
        return out
    return broken


def _line_moved(real):
    def broken(*args, **kw):
        out = real(*args, **kw)
        per = _first_with(out, 1)
        per[0] = dataclasses.replace(per[0], line_number=per[0].line_number ^ 1)
        return out
    return broken


@pytest.mark.parametrize("fault", [_moved_distance, _swapped, _dropped, _line_moved])
def test_a_broken_workspace_search_is_not_correct(tiny_bench, scratch, monkeypatch, fault):
    cell = _add_workspace_cell(tiny_bench)
    monkeypatch.setattr(search, "search_with_workspace_batched",
                        fault(search.search_with_workspace_batched))
    res = run.execute(cell, SEED, 0.3, False, device="cpu")
    assert not res["correct"], res["checks"]
    assert _left_behind(scratch) == []


def test_nothing_is_left_after_a_request_raises(tiny_bench, scratch, monkeypatch):
    cell = _add_workspace_cell(tiny_bench)
    real = search.search_with_workspace_batched
    calls = []

    def flaky(*args, **kw):  # the cold build and the warm-up pass, then a failure
        calls.append(1)
        if len(calls) > 1 + int(cell.traffic["warmup_rounds"]) * int(cell.traffic["clients"]):
            raise RuntimeError("planted")
        return real(*args, **kw)

    monkeypatch.setattr(search, "search_with_workspace_batched", flaky)
    res = run.execute(cell, SEED, 0.3, False, device="cpu")
    assert not res["correct"] and res["failed"] > 0
    assert _left_behind(scratch) == []


def test_nothing_is_left_after_set_up_raises(tiny_bench, scratch, monkeypatch):
    cell = _add_workspace_cell(tiny_bench)

    def broken(*args, **kw):
        raise RuntimeError("planted")

    monkeypatch.setattr(search, "search_with_workspace_batched", broken)
    with pytest.raises(RuntimeError, match="planted"):
        run.execute(cell, SEED, 0.3, False, device="cpu")
    assert _left_behind(scratch) == []


@pytest.mark.parametrize("workload, every", [("arxiv-1k.eval1k", False),
                                             ("arxiv-1k.agent", True)])
def test_a_library_answer_without_its_context_is_not_correct(tiny_bench, monkeypatch,
                                                             workload, every):
    """The library route returns context: one query's results that come
    without it beside others' with it, or every result without it, are
    wrong context, not a route without any."""
    cell = cells.load_cell(tiny_bench / "BENCHMARK.json", workload,
                           root=tiny_bench / "perfbench")
    real = search.search_documents_batched

    def bare(*args, **kw):
        out = real(*args, **kw)
        for per in out if every else [_first_with(out, 1)]:
            per[:] = [dataclasses.replace(r, lines=None, start=None, end=None) for r in per]
        return out

    monkeypatch.setattr(search, "search_documents_batched", bare)
    res = run.execute(cell, SEED, 0.3, False, device="cpu")
    assert not res["correct"] and res["checks"]["context"]["value"] > 0, res["checks"]


def test_the_coalescer_serves_only_the_runs_that_ask_for_it(tiny_bench, scratch, monkeypatch):
    """``coalesce.enable()`` lasts the process; a later run in it without
    ``coalesce`` still searches without the funnel."""
    from semtools_tpu_torch.store import coalesce

    funnelled = []
    real = coalesce.search_batched

    def counted(*args, **kw):
        funnelled.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(coalesce, "search_batched", counted)
    on = _add_workspace_cell(tiny_bench, {"coalesce": True}, 4, name="arxiv-1k-ws.on")
    assert run.execute(on, SEED, 0.3, False, device="cpu")["correct"]
    assert funnelled
    funnelled.clear()
    off = _add_workspace_cell(tiny_bench, None, 1, name="arxiv-1k-ws.off")
    assert run.execute(off, SEED, 0.3, False, device="cpu")["correct"]
    assert funnelled == []
