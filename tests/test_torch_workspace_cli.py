"""``semtools workspace`` and ``semtools search -w`` end to end: the port's
CLI against the JAX package's.

Each package runs under its own temporary HOME (so each builds its own
workspace from the same files) with the built-in fallback model and
``SEMTOOLS_TPU_SCAN=device``. ``workspace use|status|prune -j`` print equal
JSON (HOME replaced by a placeholder); ``search -w`` prints equal headers,
context lines and JSON fields, with distances within 1e-6 (f32 scan
summation order); both print the same "Updating workspace" progress lines,
none on a repeat search, and the line-reuse line after a one-line edit.
"""

from __future__ import annotations

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from semtools_tpu import cli as jax_cli
from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu_torch import cli as torch_cli
from semtools_tpu_torch.store import device_cache

from test_torch_search_cli import DOCS, _split_json, _split_text

ATOL = 1e-6


class _Tty(io.StringIO):
    def isatty(self) -> bool:
        return True


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.delenv("SEMTOOLS_WORKSPACE", raising=False)
    device_cache.invalidate()
    jax_device_cache.invalidate()
    homes = {}
    for side in ("jax", "torch"):
        homes[side] = tmp_path / f"home_{side}"
        homes[side].mkdir()
    docs = tmp_path / "docs"
    docs.mkdir()
    files = []
    for name, lines in DOCS.items():
        p = docs / name
        p.write_text("\n".join(lines) + "\n", newline="")
        files.append(str(p))
    big = docs / "big.txt"  # enough lines for the scan to span sub-tiles
    big.write_text("\n".join(f"line {i} about {w}" for i, w in
                             enumerate(["databases", "foxes", "rivers", "queries"] * 100)) + "\n")
    files.append(str(big))
    queries = tmp_path / "queries.txt"
    queries.write_text("fox and dog\n\nslow database query\nINDEX\n")
    yield homes, files, str(queries)
    device_cache.invalidate()
    jax_device_cache.invalidate()


def _run(side, argv, homes, capsys, monkeypatch):
    """(exit code, stdout, stderr) of one in-process CLI call; HOME is
    replaced by '<HOME>' in both outputs."""
    monkeypatch.setenv("HOME", str(homes[side]))
    monkeypatch.setattr(sys, "stdin", _Tty())
    capsys.readouterr()
    if side == "jax":
        rc = jax_cli.main(argv)
    else:
        rc = torch_cli.main([*argv, "--device", "cpu"] if argv[0] == "search" else argv)
    out, err = capsys.readouterr()
    return rc, out.replace(str(homes[side]), "<HOME>"), err.replace(str(homes[side]), "<HOME>")


def _both(argv, homes, capsys, monkeypatch):
    rj, oj, ej = _run("jax", argv, homes, capsys, monkeypatch)
    rt, ot, et = _run("torch", argv, homes, capsys, monkeypatch)
    assert rj == rt == 0, (ej, et)
    return (oj, ej), (ot, et)


def _progress(err):
    return [ln for ln in err.splitlines() if ln.startswith(("Updating workspace", "  (reused"))]


def _assert_search_same(out_j, out_t, as_json):
    if as_json:
        dj, dt = [], []
        docs_j = [json.loads(x) for x in out_j.splitlines() if x.strip()] \
            if out_j.lstrip().startswith('{"query"') else [json.loads(out_j)]
        docs_t = [json.loads(x) for x in out_t.splitlines() if x.strip()] \
            if out_t.lstrip().startswith('{"query"') else [json.loads(out_t)]
        assert _split_json(docs_t, dt) == _split_json(docs_j, dj)
    else:
        sj, dj = _split_text(out_j)
        st, dt = _split_text(out_t)
        assert st == sj
    assert len(dt) == len(dj) and len(dj) > 0
    np.testing.assert_allclose(dt, dj, atol=ATOL, rtol=0)


def test_workspace_commands_match_jax_cli(env, capsys, monkeypatch):
    homes, files, _ = env
    (oj, _), (ot, _) = _both(["workspace", "use", "ws", "-j"], homes, capsys, monkeypatch)
    assert json.loads(ot) == json.loads(oj)
    (oj, _), (ot, _) = _both(["workspace", "use", "ws"], homes, capsys, monkeypatch)
    assert ot == oj
    _both(["search", "lazy dog", *files, "-w", "ws"], homes, capsys, monkeypatch)
    for argv in (["workspace", "status", "ws", "-j"], ["workspace", "-j", "status", "ws"],
                 ["workspace", "status", "ws"]):
        (oj, _), (ot, _) = _both(argv, homes, capsys, monkeypatch)
        assert ot == oj
    assert "Index: Yes (exact-mxu-scan)" in ot
    status = json.loads(_both(["workspace", "status", "ws", "-j"], homes, capsys,
                              monkeypatch)[1][0])
    assert status["total_documents"] == len(files)
    Path(files[0]).unlink()
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "ws")
    (oj, _), (ot, _) = _both(["workspace", "prune", "-j"], homes, capsys, monkeypatch)
    assert json.loads(ot) == json.loads(oj) == {"files_removed": 1,
                                                "files_remaining": len(files) - 1}


@pytest.mark.parametrize("flags", [
    ["--top-k", "4"],
    ["--top-k", "5", "-j"],
    ["-m", "0.8"],
    ["-m", "0.8", "-j", "-n", "1"],
    ["-n", "0", "--top-k", "30"],
    ["-i", "--top-k", "3"],
])
def test_workspace_search_matches_jax_cli(env, capsys, monkeypatch, flags):
    homes, files, _ = env
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "ws")
    argv = ["search", "DATABASES pages disk", *files, *flags]
    (oj, ej), (ot, et) = _both(argv, homes, capsys, monkeypatch)
    _assert_search_same(oj, ot, "-j" in flags)
    assert _progress(et) == _progress(ej) and _progress(et)
    # a repeat over unchanged files embeds nothing and prints the same hits
    (oj2, ej2), (ot2, et2) = _both(argv, homes, capsys, monkeypatch)
    assert _progress(et2) == _progress(ej2) == []
    _assert_search_same(oj2, ot2, "-j" in flags)


@pytest.mark.parametrize("flags", [[], ["-j"], ["-m", "0.9", "-j", "--top-k", "2"]])
def test_workspace_queries_file_matches_jax_cli(env, capsys, monkeypatch, flags):
    homes, files, queries = env
    argv = ["search", "-Q", queries, *files, "-w", "ws", "--top-k", "3", *flags]
    (oj, _), (ot, _) = _both(argv, homes, capsys, monkeypatch)
    _assert_search_same(oj, ot, "-j" in flags)


@pytest.mark.parametrize("flags", [["--top-k", "5"], ["--top-k", "4", "-j"], ["-m", "0.8", "-j"]])
def test_int4_workspace_search_matches_jax_cli(env, capsys, monkeypatch, flags):
    """The int4 tier (``SEMTOOLS_TPU_STORE_INT4=1``) serves both CLIs the
    same hits, and both name it in ``workspace status``."""
    homes, files, _ = env
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "ws")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT4", "1")
    argv = ["search", "DATABASES pages disk", *files, *flags]
    (oj, _), (ot, _) = _both(argv, homes, capsys, monkeypatch)
    _assert_search_same(oj, ot, "-j" in flags)
    (oj, _), (ot, _) = _both(["workspace", "status", "ws"], homes, capsys, monkeypatch)
    assert ot == oj and "Index: Yes (int4-mxu-scan)" in ot


def test_one_line_edit_reuses_cached_lines(env, capsys, monkeypatch):
    homes, files, _ = env
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "ws")
    argv = ["search", "fox and dog", *files, "-j"]
    _both(argv, homes, capsys, monkeypatch)
    path = Path(files[0])
    lines = path.read_text().split("\n")
    lines[1] = "Databases keep their rows in pages on a spinning disk"
    path.write_text("\n".join(lines))
    (oj, ej), (ot, et) = _both(argv, homes, capsys, monkeypatch)
    assert _progress(et) == _progress(ej)
    assert any("embedded 1 unique new lines" in ln for ln in _progress(et))
    _assert_search_same(oj, ot, True)


def test_workspace_errors_match_jax_cli(env, capsys, monkeypatch):
    """Errors match too: no active workspace, and the unported actions."""
    homes, _, _ = env
    rj, _, ej = _run("jax", ["workspace", "status"], homes, capsys, monkeypatch)
    rt, _, et = _run("torch", ["workspace", "status"], homes, capsys, monkeypatch)
    assert rj == rt == 1 and "No active workspace" in et and et == ej
    for action in ("compact", "index"):
        rt, _, et = _run("torch", ["workspace", action, "ws"], homes, capsys, monkeypatch)
        assert rt == 1 and "not ported yet" in et
