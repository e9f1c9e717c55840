"""A cell is found by its name in files of its own; a run loads no JAX."""

import json
import subprocess
import sys
import textwrap

import pytest

from perfbench import cells, run
from conftest import REPO, SEED


def _add_cell(root):
    """A new configuration, traffic mix, metric and cell, as new files and
    new entries only."""
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "lines10m.json").read_text())
    cfg.update(name="lines-small")
    cfg["corpus"].update(documents=7, lines_per_document=60)
    (pb / "configs" / "lines-small.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "single.json").read_text())
    tr.update(name="pairs", clients=1, queries_per_request=2, top_k=4)
    (pb / "traffic" / "pairs.json").write_text(json.dumps(tr))
    (pb / "metrics" / "search.requests.py").write_text(textwrap.dedent('''
        def read(r):
            return float(r.n_requests) if r.requests else None
    '''))
    (pb / "limits" / "lines-small.pairs.json").write_text(
        (pb / "limits" / "lines10m.single.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lines-small", "source": "https://example.org/x",
                             "file": "perfbench/configs/lines-small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "lines-small.pairs", "config": "lines-small",
                               "traffic": "pairs", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "search.requests", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "library search (search.py)",
                               "moves": "search_qps", "workloads": ["lines-small.pairs"]})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("lines-small.pairs")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_added_as_files_runs(tiny_bench):
    before = {p: p.read_bytes() for p in (tiny_bench / "perfbench").rglob("*") if p.is_file()}
    _add_cell(tiny_bench)
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    cell = cells.load_cell(tiny_bench / "BENCHMARK.json", "lines-small.pairs",
                           root=tiny_bench / "perfbench")
    for traced in (False, True):
        res = run.execute(cell, SEED, 0.3, traced, device="cpu")
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        if traced:
            assert res["metrics"]["search.requests"]["value"] > 0
            assert "search.corpus_ms" not in res["metrics"]  # no trace of a device
        else:
            assert set(res["metrics"]) == {"search_qps", "setup_s"}  # no device time listed
        assert list(res)[-1] == "checks"


def test_every_cell_names_files_that_exist():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load_cell(REPO / "BENCHMARK.json", w["name"])
        assert cell.per_layer and any(m["name"] == "setup_s" for m in cell.end_to_end)
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))


def test_context_lines_come_from_the_mix_where_it_names_them():
    agent = cells.load_cell(REPO / "BENCHMARK.json", "arxiv-1k.agent")
    evals = cells.load_cell(REPO / "BENCHMARK.json", "arxiv-1k.eval1k")
    assert agent.config == evals.config
    assert run.n_lines(agent) == 0 and run.n_lines(evals) == evals.config["n_lines"] == 3


def test_a_missing_cell_is_an_error():
    with pytest.raises(cells.BenchError):
        cells.load_cell(REPO / "BENCHMARK.json", "no.such-cell")


def test_a_run_loads_no_jax(tiny_bench):
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from pathlib import Path
        from perfbench import cells, run
        root = Path({str(tiny_bench)!r})
        for w in ("arxiv-1k.eval1k", "lines10m.single"):
            cell = cells.load_cell(root / "BENCHMARK.json", w, root=root / "perfbench")
            run.execute(cell, {SEED}, 0.2, True, device="cpu")
        print("FOUND", run.forbidden_modules(), sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "semtools_tpu")))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] []" in out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "semtools_tpu_torch_like", sys)
    assert "semtools_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "semtools_tpu.search", sys)
    assert "semtools_tpu" in run.forbidden_modules()


def test_without_a_card_the_run_prints_no_result(tiny_bench):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "lines10m.single",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=tiny_bench, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_to_its_shape():
    import re

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s  # noqa: E731
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and all(line(w) for w in bench["command"])
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert c["file"].startswith(bench["paths"][0] + "/") and line(c["source"])
        spec = json.loads((REPO / c["file"]).read_text())
        assert all(k in spec for k in c["reduced"]) and spec["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells_of = lambda m: set(m.get("workloads", [w["name"] for w in bench["workloads"]]))  # noqa
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])
        assert name.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"]) and cells_of(m) <= cells_of(e2e[m["moves"]])
