"""``semtools search`` end to end: the port's CLI against the JAX package's.

The same files, stdin and queries go through ``semtools_tpu.cli.main`` and
``semtools_tpu_torch.cli.main([..., "--device", "cpu"])`` under an isolated
HOME. Headers (``file:start::end``), context lines and JSON fields must be
equal; distances agree within 1e-5 (f32 matmul summation order; ``repr`` of
a distance may differ in the last digit, so bytes are not compared).
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from semtools_tpu import cli as jax_cli
from semtools_tpu_torch import cli as torch_cli

ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent
_HEADER = re.compile(r"^(.*:\d+::\d+) \((.+)\)$")

DOCS = {
    "notes.txt": [
        "The quick brown fox jumps over the lazy dog",
        "Databases store rows in pages on disk",
        "",
        "A B-tree index speeds up range queries",
        "the quick brown fox jumps over the lazy dog",
        "Query planners choose join orders by cost",
        "Vector search ranks lines by cosine distance",
    ],
    "log.txt": [
        "ERROR disk full while writing page 42",
        "WARN slow query: 1.2 s for SELECT * FROM users",
        "INFO index rebuild finished",
        "Databases store rows in pages on disk",
        "INFO checkpoint complete",
        "café naïve résumé — unicode line",
    ],
    "crlf.txt": ["windows line one\r", "fox and dog again\r", "last line"],
}


class _Tty(io.StringIO):
    def isatty(self) -> bool:
        return True


@pytest.fixture()
def env(tmp_path, monkeypatch):
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("SEMTOOLS_WORKSPACE", raising=False)
    files = []
    for name, lines in DOCS.items():
        p = tmp_path / name
        p.write_text("\n".join(lines) + "\n", newline="")
        files.append(str(p))
    queries = tmp_path / "queries.txt"
    queries.write_text("fox and dog\n\nslow database query\nINDEX\n")
    return files, str(queries)


def _run(main, argv, capsys, monkeypatch, stdin=None):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin) if stdin is not None else _Tty())
    capsys.readouterr()
    rc = main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _split_text(out):
    """(lines with distances blanked, distances)."""
    shape, dists = [], []
    for line in out.splitlines():
        m = _HEADER.match(line)
        if m:
            shape.append(m.group(1))
            dists.append(float(m.group(2)))
        else:
            shape.append(line)
    return shape, dists


def _split_json(obj, dists):
    if isinstance(obj, dict):
        out = {}
        for key, val in obj.items():
            if key == "distance":
                dists.append(val)
            else:
                out[key] = _split_json(val, dists)
        return out
    if isinstance(obj, list):
        return [_split_json(v, dists) for v in obj]
    return obj


def _assert_same(out_jax, out_torch, as_json):
    if as_json:
        dj, dt = [], []
        docs_j = [json.loads(x) for x in out_jax.splitlines() if x.strip()] \
            if out_jax.lstrip().startswith('{"query"') else [json.loads(out_jax)]
        docs_t = [json.loads(x) for x in out_torch.splitlines() if x.strip()] \
            if out_torch.lstrip().startswith('{"query"') else [json.loads(out_torch)]
        assert _split_json(docs_t, dt) == _split_json(docs_j, dj)
    else:
        sj, dj = _split_text(out_jax)
        st, dt = _split_text(out_torch)
        assert st == sj
    assert len(dt) == len(dj) and len(dj) > 0
    np.testing.assert_allclose(dt, dj, atol=ATOL, rtol=0)


@pytest.mark.parametrize("flags", [
    ["--top-k", "4"],
    ["--top-k", "5", "-j"],
    ["-m", "0.8"],
    ["-m", "0.8", "-j"],
    ["-i", "--top-k", "3"],
    ["-n", "1", "--top-k", "6"],
    ["-n", "0", "--top-k", "50"],
])
def test_files_match_jax_cli(env, capsys, monkeypatch, flags):
    files, _ = env
    argv = ["search", "DATABASES pages disk", *files, *flags]
    rc_j, out_j, _ = _run(jax_cli.main, argv, capsys, monkeypatch)
    rc_t, out_t, _ = _run(torch_cli.main, [*argv, "--device", "cpu"], capsys, monkeypatch)
    assert rc_j == rc_t == 0
    _assert_same(out_j, out_t, "-j" in flags)


@pytest.mark.parametrize("flags", [[], ["-j"], ["-n", "1", "--top-k", "2"]])
def test_stdin_matches_jax_cli(env, capsys, monkeypatch, flags):
    text = "\n".join(DOCS["notes.txt"]) + "\n"
    argv = ["search", "lazy dog", *flags]
    rc_j, out_j, _ = _run(jax_cli.main, argv, capsys, monkeypatch, stdin=text)
    rc_t, out_t, _ = _run(torch_cli.main, [*argv, "--device", "cpu"], capsys, monkeypatch,
                          stdin=text)
    assert rc_j == rc_t == 0
    assert "<stdin>" in out_t
    _assert_same(out_j, out_t, "-j" in flags)


@pytest.mark.parametrize("flags,stdin_docs", [
    ([], False), (["-j"], False), (["-m", "0.9", "-j"], False), (["-j"], True),
])
def test_queries_file_matches_jax_cli(env, capsys, monkeypatch, flags, stdin_docs):
    files, queries = env
    if stdin_docs:
        argv, stdin = ["search", "-Q", queries, *flags], "\n".join(DOCS["log.txt"]) + "\n"
    else:
        argv, stdin = ["search", "-Q", queries, *files, "--top-k", "2", *flags], None
    rc_j, out_j, _ = _run(jax_cli.main, argv, capsys, monkeypatch, stdin=stdin)
    rc_t, out_t, _ = _run(torch_cli.main, [*argv, "--device", "cpu"], capsys, monkeypatch,
                          stdin=stdin)
    assert rc_j == rc_t == 0
    _assert_same(out_j, out_t, "-j" in flags)


def test_unported_modes_exit_1(env, capsys, monkeypatch):
    files, _ = env
    for argv in (["parse", *files], ["ask", "q", *files], ["daemon", "status"],
                 ["workspace", "compact", "ws"], ["workspace", "index", "ws"]):
        rc, out, err = _run(torch_cli.main, argv, capsys, monkeypatch)
        assert rc == 1 and out == "" and "not ported yet" in err, argv
    rc, _, err = _run(torch_cli.main, ["search", "q", "--device", "cpu"], capsys, monkeypatch,
                      stdin="")
    assert rc == 1 and "No input provided" in err  # as the JAX CLI


def test_from_jax_model_encodes_identically(fallback_model):
    from semtools_tpu_torch.models.static_model import StaticModel

    ours = StaticModel.from_jax_model(fallback_model, device="cpu")
    assert (ours.name, ours.normalize, ours.dim) == (
        fallback_model.name, fallback_model.normalize, fallback_model.dim)
    texts = [ln for lines in DOCS.values() for ln in lines]
    np.testing.assert_allclose(
        ours.encode(texts).numpy(), np.asarray(fallback_model.encode(texts)),
        atol=1e-6, rtol=0,
    )


def test_device_is_explicit(monkeypatch):
    import torch

    from semtools_tpu_torch.utils.platform import resolve_device

    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.delenv("SEMTOOLS_TORCH_DEVICE")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()


def test_port_search_never_imports_jax(env, tmp_path):
    """A plain search and workspace searches (int8 and int4 tiers), in a
    child process that can see only the port (``semtools_tpu_torch/`` and
    ``cpp/``, without the JAX package or its ``_native/`` build), import
    nothing of jax or of the JAX package."""
    import shutil

    files, _ = env
    root = tmp_path / "port_only"
    shutil.copytree(REPO / "semtools_tpu_torch", root / "semtools_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(REPO / "cpp", root / "cpp")
    assert not (root / "semtools_tpu").exists()
    script = (
        "import sys\n"
        "from semtools_tpu_torch.cli import main\n"
        f"rc = main(['search', 'lazy dog', *{files!r}, '--device', 'cpu', '-j'])\n"
        "assert rc == 0, rc\n"
        "assert main(['workspace', 'use', 'guard']) == 0\n"
        f"rc = main(['search', 'lazy dog', *{files!r}, '-w', 'guard', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "import os\n"
        "os.environ['SEMTOOLS_TPU_STORE_INT4'] = '1'\n"
        f"rc = main(['search', 'lazy dog', *{files!r}, '-w', 'guard', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert main(['workspace', 'status', 'guard']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'semtools_tpu'))\n"
        "assert not bad, bad\n"
        "from semtools_tpu_torch.utils import native\n"
        "assert native.lib_path().is_relative_to(sys.argv[1]), native.lib_path()\n"
        "print('NO_JAX_OK')\n"
    )
    child_env = dict(os.environ, HOME=str(tmp_path / "home"), PYTHONPATH=str(root),
                     SEMTOOLS_TPU_NO_FETCH="1", SEMTOOLS_TPU_ALLOW_FALLBACK="1")
    child_env.pop("SEMTOOLS_WORKSPACE", None)
    proc = subprocess.run([sys.executable, "-c", script, str(root)], cwd=str(tmp_path),
                          env=child_env, capture_output=True, text=True,
                          stdin=subprocess.DEVNULL, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert out.strip().endswith("NO_JAX_OK")
    assert json.loads(out[: out.index("\n}\n") + 2])["results"]
    assert "lazy dog" not in proc.stderr and "Updating workspace" in proc.stderr
    assert "int4-mxu-scan" in out  # the second workspace search served the int4 tier
