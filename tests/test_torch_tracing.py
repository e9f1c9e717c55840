"""``tests/test_tracing.py`` on the port: the stage timings of
``semtools_tpu_torch.utils.tracing``. The recorded stage names and counts
must equal the JAX package's for the same nested stages and for the same
plain search (the times differ and are not compared)."""

from __future__ import annotations

import io

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
