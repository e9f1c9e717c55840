"""The committed workspace cell ``arxiv-1k-ws.agent`` (configuration
``arxiv-1k-workspace``): it runs on the CPU cut
to size and is judged ``correct``, its store's readers read the program's
spans and counters, the store's roofline counts each tier's bytes, and the
store's policy serves the committed size on the int8 tier."""

import json
import tempfile
from contextlib import ExitStack
from types import SimpleNamespace

import pytest

from perfbench import cells, run, spans, store_roofline
from conftest import REPO, SEED

CELL = "arxiv-1k-ws.agent"
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("store.read_files_ms", "store.open_ms", "store.scan_ms", "store.rerank_ms",
           "store.candidates", "store.roof_pct")


def _reader(name):
    return cells.load_cell(REPO / "BENCHMARK.json", CELL).reader(name)


@pytest.fixture
def scratch(tmp_path, monkeypatch):
    """A ``HOME`` and a temporary directory of the test's own, and the
    program's spans kept, as a traced run's import of the program keeps
    them; these and the coalescer's flag put back after."""
    from semtools_tpu_torch.store import coalesce
    from semtools_tpu_torch.utils import tracing

    monkeypatch.setattr(coalesce, "_enabled", coalesce._enabled)  # enable() lasts the process
    home, tmp = tmp_path / "home", tmp_path / "tmp"
    home.mkdir()
    tmp.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    kept = tracing._kept is not None
    tracing.keep(True)
    yield home, tmp
    tracing.keep(kept)


@pytest.mark.parametrize("workspace, clients, tier", [
    (None, 1, "exact-mxu-scan"),  # as committed: 3,000 lines are f32 at the 4 GiB budget
    ({"device_cache_bytes": 1 << 20}, 1, "int8-mxu-scan"),  # f32 over 1 MiB, int8 under it
    ({"device_cache_bytes": 1 << 20, "coalesce": True}, 4, "int8-mxu-scan"),  # the daemon's
])
def test_the_committed_workspace_cell_runs(tiny_bench, scratch, workspace, clients, tier):
    pb = tiny_bench / "perfbench"
    path = pb / "configs" / "arxiv-1k-workspace.json"
    cfg = json.loads(path.read_text())
    assert cfg["serve"] == "workspace" and "workspace" not in cfg
    if workspace is not None:
        path.write_text(json.dumps(dict(cfg, workspace=workspace)))
    traffic = pb / "traffic" / "agent.json"
    traffic.write_text(json.dumps(dict(json.loads(traffic.read_text()), clients=clients)))
    cell = cells.load_cell(tiny_bench / "BENCHMARK.json", CELL, root=pb)
    assert {m["name"] for m in cell.per_layer} >= set(READERS)
    for traced in (False, True):
        res = run.execute(cell, SEED, 0.3, traced, device="cpu")
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        metrics = res["metrics"]
        if not traced:
            assert set(metrics) == {"search_qps", "setup_s"}
            continue
        assert metrics["store.scan_ms"]["tier"] == tier
        pooled = tier != "exact-mxu-scan"  # a quantized tier's pool and re-rank
        read = {"store.read_files_ms", "store.open_ms", "store.scan_ms"}
        read |= {"store.rerank_ms", "store.candidates"} if pooled else set()
        assert {n for n in READERS if n in metrics} == read  # no device roof on the CPU
        assert all(metrics[n]["value"] > 0 for n in read)
        if pooled and clients == 1:  # coalesced requests share the leader's pool
            assert metrics["store.candidates"]["value"] >= int(cell.traffic["top_k"])
        assert {"embed.query_ms", "search.p95_ms", "embed.tokenize_ms", "host.gc_ms",
                "kernels.launches"} <= set(metrics)


def test_the_store_readers_read_nothing_without_the_store_s_spans(monkeypatch):
    """A program whose workspace search opens no ``search`` span (the
    parent's) gives the span readers nothing, and none raises."""
    from semtools_tpu_torch.utils.tracing import SpanRecord

    ms = 1_000_000
    records = [SpanRecord("read_files", 1, 1, None, 7, 1000 * ms, 1010 * ms,
                          {"files": 3, "changed": 0, "bytes": 0})]
    monkeypatch.setattr(spans, "program_records", lambda: records)
    r = SimpleNamespace(requests=[SimpleNamespace(start=0.999, end=1.021, queries=1, results=8)],
                        stages={}, trace=None, tier="int8-mxu-scan", rows=10, dim=256,
                        device_name=H100, power_limit_w=700.0,
                        stage_ms_per_request=lambda name: None)
    assert {n: _reader(n)(r) for n in READERS} == dict.fromkeys(READERS)


def test_the_span_readers_read_a_workspace_request(monkeypatch):
    from semtools_tpu_torch.utils.tracing import SpanRecord

    ms = 1_000_000

    def rec(name, sid, parent, a, b, attrs=None):
        return SpanRecord(name, 1, sid, parent, 7, a * ms, b * ms, attrs)

    records = [
        rec("store.open", 2, 1, 1001, 1004),
        rec("gc", 4, 3, 1010, 1012, {"generation": 2, "collected": 0}),
        rec("read_files", 3, 1, 1004, 1030, {"files": 3, "changed": 0, "bytes": 0}),
        rec("tier_pool", 6, 5, 1031, 1032, {"passes": 1, "candidates": 48}),
        rec("tier_pool", 7, 5, 1032, 1033, {"passes": 1, "candidates": 56}),
        rec("tier_rerank", 8, 5, 1033, 1035, {"rows": 100}),
        rec("store_scan", 5, 1, 1030, 1036, {"rows": 10, "queries": 1}),
        rec("store.close", 9, 1, 1036, 1037),
        rec("search", 1, None, 1000, 1038),
    ]
    monkeypatch.setattr(spans, "program_records", lambda: records)
    r = SimpleNamespace(requests=[SimpleNamespace(start=0.999, end=1.039)])
    assert _reader("store.read_files_ms")(r) == pytest.approx(24.0)  # the 2 ms pass left out
    assert _reader("store.open_ms")(r) == pytest.approx(4.0)
    assert _reader("store.candidates")(r) == 104  # the final pool: each pass adds its growth


@pytest.mark.parametrize("tier, per_row", [
    ("exact-mxu-scan", 1024), ("int8-mxu-scan", 256), ("int4-mxu-scan", 128),
    ("int8-mxu-scan-reduced64d", 65), ("int8-mxu-scan-reduced32d", 33),
])
def test_each_tier_s_bytes_a_row(tier, per_row):
    assert store_roofline.row_bytes(tier, 256) == per_row
    b = 1_000_000 * per_row + 1024 + 96
    s, bound = store_roofline.least_seconds(tier, 1_000_000, 256, 1, 8, H100)
    assert bound == "bytes" and s == pytest.approx(b / 3.35e12)


def test_a_thousand_queries_on_the_exact_tier_are_bound_by_float32_operations():
    s, bound = store_roofline.least_seconds("exact-mxu-scan", 1_000_000, 256, 1000, 10_000,
                                            H100)
    assert bound == "flops" and s == pytest.approx(2 * 1000 * 1_000_000 * 256 / 67e12)


@pytest.mark.parametrize("tier", ["ivf-pq", "host-mmap-scan", "sharded-int8-scan[4]",
                                  "sharded-exact-scan[4]", None])
def test_tiers_not_counted_read_none(tier):
    assert store_roofline.row_bytes(tier, 256) is None
    assert store_roofline.least_seconds(tier, 1000, 256, 1, 8, H100) is None
    r = _fake_readings(tier)
    assert _reader("store.roof_pct")(r) is None


def _fake_readings(tier, busy_s=6e-4, requests=4):
    return SimpleNamespace(
        trace=SimpleNamespace(seconds=lambda kind, corpus: busy_s if kind == "search"
                              and not corpus else 0.0),
        requests=[SimpleNamespace(queries=1, results=8)] * requests, tier=tier,
        rows=1_000_000, dim=256, device_name=H100, power_limit_w=700.0)


def test_the_int8_tier_s_share_of_its_roof():
    got = _reader("store.roof_pct")(_fake_readings("int8-mxu-scan"))
    least = 4 * (256_000_000 + 1024 + 96) / 3.35e12
    assert got == {"value": pytest.approx(100 * least / 6e-4), "bound": "bytes",
                   "tier": "int8-mxu-scan", "power_limit_w": 700.0}
    assert 0 < got["value"] < 100


def test_no_trace_or_no_known_card_reads_none():
    r = _fake_readings("int8-mxu-scan")
    r.trace = None
    assert _reader("store.roof_pct")(r) is None
    r = _fake_readings("int8-mxu-scan")
    r.device_name = "cpu"
    assert _reader("store.roof_pct")(r) is None


def test_the_policy_serves_the_committed_size_on_the_int8_tier(tmp_path):
    """With the environment pinned as the harness pins it for the committed
    configuration, an empty store names ``int8-mxu-scan`` at the corpus's
    line count (and without its empty lines), at the default budget."""
    from semtools_tpu_torch.store import Store

    cfg = json.loads((REPO / "perfbench" / "configs" / "arxiv-1k-workspace.json").read_text())
    values = {run.WORKSPACE_SETTINGS[k]: str(int(v))
              for k, v in (cfg.get("workspace") or {}).items()}
    values.setdefault(run.WORKSPACE_SETTINGS["coalesce"], "0")
    lines = cfg["corpus"]["lines"]
    with ExitStack() as pinned:
        run._pin_environment(pinned, values)
        with Store(str(tmp_path / "store"), dim=cfg["model"]["dim"], device="cpu") as store:
            assert store.count_line_embeddings() == 0
            for n in (lines, round(lines * (1 - cfg["corpus"]["empty_line_share"]))):
                assert store.serving_tier(n) == "int8-mxu-scan", n
