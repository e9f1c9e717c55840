"""``semtools search`` end to end: the port's CLI against the JAX package's.

The same files, stdin and queries go through ``semtools_tpu.cli.main`` and
``semtools_tpu_torch.cli.main([..., "--device", "cpu"])`` under an isolated
HOME. Headers (``file:start::end``), context lines and JSON fields must be
equal; distances agree within 1e-5 (f32 matmul summation order; ``repr`` of
a distance may differ in the last digit, so bytes are not compared).
"""

from __future__ import annotations

import contextlib
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
from semtools_tpu_torch.parallel import mesh as torch_mesh

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
    """Every mode runs now. Sharded serving, the last one ported: with
    ``SEMTOOLS_TPU_SHARDED=1`` a workspace search on a one-device mesh serves
    the single-device tier with the JAX CLI's output (the JAX side, which has
    8 virtual devices here, pinned to one by ``SEMTOOLS_TPU_SHARDED=0``), and
    on an 8-shard mesh the sharded tier, as the JAX CLI's 8 devices do
    (``workspace status`` names the same tier). ``parse`` and ``ask`` run (a
    text file passes through ``parse``; ``ask`` without a key fails as the
    JAX CLI does)."""
    files, _ = env
    assert _run(torch_cli.main, ["workspace", "use", "sharded"], capsys, monkeypatch)[0] == 0
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    argv = ["search", "DATABASES pages disk", *files, "-w", "sharded", "--top-k", "4"]
    status = ["workspace", "status", "sharded"]
    for shards, tier in ((1, "exact-mxu-scan"), (8, "sharded-exact-scan[8]")):
        monkeypatch.setattr(torch_mesh, "_VIRTUAL", shards)
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0" if shards == 1 else "1")
        rc_j, out_j, _ = _run(jax_cli.main, argv, capsys, monkeypatch)
        st_j = _run(jax_cli.main, status, capsys, monkeypatch)
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
        rc_t, out_t, err_t = _run(torch_cli.main, argv, capsys, monkeypatch)
        st_t = _run(torch_cli.main, status, capsys, monkeypatch)
        assert rc_j == rc_t == 0 and "not ported" not in err_t
        _assert_same(out_j, out_t, False)
        assert st_t == st_j and f"Index: Yes ({tier})" in st_t[1]
    monkeypatch.delenv("SEMTOOLS_TPU_SHARDED")
    rc, out, err = _run(torch_cli.main, ["parse", *files], capsys, monkeypatch)
    assert rc == 0 and out.split() == files and "not ported" not in err
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    runs = [_run(main, ["ask", "q", *files], capsys, monkeypatch)
            for main in (jax_cli.main, torch_cli.main)]
    assert runs[0] == runs[1] and runs[1][0] == 1 and "OpenAI API key not found" in runs[1][2]
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
    """A plain search, workspace searches (int8 and int4 tiers, and the
    sharded tier on a mesh of 4 CPU shards), a forced
    IVF-PQ build (``workspace index --force``) and a search it serves,
    ``parse -b local`` and ``parse`` against a fake LlamaParse, ``ask`` in
    chat, responses and stdin modes against a fake OpenAI (plain and ``-w``),
    a daemon serving (warm-up included) and a search and an ``ask`` forwarded
    to it (and a search forwarded by the native client), in a child process
    that can see only the port
    (``semtools_tpu_torch/`` and ``cpp/``, without the JAX package or its
    ``_native/`` build), import nothing of jax, of the JAX package or of
    ``httpx``; the grep tool runs the port's native scanner."""
    import shutil

    from tests.fake_servers import (
        FakeLlamaParse,
        FakeOpenAI,
        FakeServer,
        chat_text_response,
        chat_tool_call_response,
        responses_text,
        responses_tool_call,
    )

    files, _ = env
    doc = tmp_path / "page.html"
    doc.write_text("<h1>Guard</h1><p>lazy dog</p>")
    pdf = tmp_path / "scan.pdf"
    pdf.write_bytes(b"%PDF-1.4 fake")
    search = {"query": "lazy dog", "config": {"top_k": 2}}
    servers = {
        "parse": FakeServer(FakeLlamaParse(fail_uploads=1)),
        "chat": FakeServer(FakeOpenAI([
            chat_tool_call_response("search", search),
            chat_tool_call_response("grep", {"pattern": r"lazy \w+", "is_regex": True}),
            chat_text_response("chat answer")])),
        "responses": FakeServer(FakeOpenAI([responses_tool_call("search", search),
                                            responses_text("responses answer")])),
        "stdin": FakeServer(FakeOpenAI([chat_text_response("stdin answer")])),
        "forwarded": FakeServer(FakeOpenAI([chat_tool_call_response("search", search),
                                            chat_text_response("forwarded answer")])),
    }
    urls = {k: srv.url for k, srv in servers.items()}
    cfg = tmp_path / "parse.json"
    cfg.write_text(json.dumps({"parse": {"api_key": "k", "base_url": urls["parse"],
                                         "check_interval": 0.01, "retry_delay_ms": 1}}))
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
        "os.environ.pop('SEMTOOLS_TPU_STORE_INT4')\n"
        "os.environ['SEMTOOLS_TPU_SHARDED'] = '1'\n"
        f"rc = main(['search', 'lazy dog', *{files!r}, '-w', 'guard', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert main(['workspace', 'status', 'guard']) == 0\n"
        "os.environ.pop('SEMTOOLS_TPU_SHARDED')\n"
        "os.environ.update(SEMTOOLS_TPU_FORCE_ANN='1', SEMTOOLS_TORCH_DEVICE='cpu')\n"
        "assert main(['workspace', 'index', 'guard', '--force']) == 0\n"
        f"rc = main(['search', 'lazy dog', *{files!r}, '-w', 'guard', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert main(['workspace', 'status', 'guard']) == 0\n"
        "from semtools_tpu_torch.utils import native\n"
        "assert native.adc_lib() is not None\n"
        "os.environ.pop('SEMTOOLS_TPU_FORCE_ANN')\n"
        "import contextlib, io, json, threading, time\n"
        f"assert main(['parse', '-b', 'local', {str(doc)!r}]) == 0\n"
        f"assert main(['parse', '-c', {str(cfg)!r}, {str(pdf)!r}]) == 0\n"
        f"urls = {urls!r}\n"
        "ask = ['ask', 'where is the dog?', '--api-key', 'k']\n"
        "from semtools_tpu_torch.utils import grepscan\n"
        "greps = []\n"
        "real_match = grepscan.match_lines\n"
        "grepscan.match_lines = lambda *a: greps.append(a) or real_match(*a)\n"
        f"assert main([*ask, *{files!r}, '--api-mode', 'chat', '--base-url', urls['chat'],\n"
        "             '--device', 'cpu']) == 0\n"
        "assert greps, 'the grep tool did not run the native scanner'\n"
        f"assert main([*ask, *{files!r}, '-w', 'guard', '--api-mode', 'responses',\n"
        "             '--base-url', urls['responses'], '--device', 'cpu']) == 0\n"
        "sys.stdin = io.StringIO('piped text')\n"
        "assert main([*ask, '--api-mode', 'chat', '--base-url', urls['stdin']]) == 0\n"
        "sys.stdin = sys.__stdin__\n"
        "from semtools_tpu_torch import daemon\n"
        "os.environ.update(SEMTOOLS_TPU_DAEMON_DIR=sys.argv[2], SEMTOOLS_WORKSPACE='guard',\n"
        "                  SEMTOOLS_TORCH_DEVICE='cpu')\n"
        "th = threading.Thread(target=daemon.serve, daemon=True)\n"
        "th.start()\n"
        "for _ in range(1200):\n"
        "    if daemon.ping():\n"
        "        break\n"
        "    time.sleep(0.05)\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    rc = daemon.forward(['search', 'lazy dog', *{files!r}, '-j'], None)\n"
        "assert rc == 0 and json.loads(buf.getvalue())['results'], (rc, buf.getvalue())\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    rc = daemon.forward([*ask, *{files!r}, '--api-mode', 'chat', '--base-url',\n"
        "                         urls['forwarded']], None)\n"
        "assert rc == 0 and buf.getvalue().endswith('forwarded answer\\n'), buf.getvalue()\n"
        "import subprocess\n"
        f"r = subprocess.run([str(native.build_client()), 'search', 'lazy dog', *{files!r}, '-j'],\n"
        "                   input='', capture_output=True, text=True, timeout=120)\n"
        "assert r.returncode == 0 and json.loads(r.stdout)['results'], r.stderr\n"
        "assert daemon.stop()\n"
        "th.join(timeout=30)\n"
        "assert not th.is_alive()\n"
        "from semtools_tpu_torch.models import HFTokenizer, HashTokenizer, StaticModel, load_model\n"
        "from semtools_tpu_torch.ops import cosine_distances, embed_token_lists, topk_scan\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'semtools_tpu', 'httpx'))\n"
        "assert not bad, bad\n"
        "assert native.lib_path().is_relative_to(sys.argv[1]), native.lib_path()\n"
        "print('NO_JAX_OK')\n"
    )
    child_env = dict(os.environ, HOME=str(tmp_path / "home"), PYTHONPATH=str(root),
                     SEMTOOLS_TPU_NO_FETCH="1", SEMTOOLS_TPU_ALLOW_FALLBACK="1",
                     SEMTOOLS_TORCH_VIRTUAL_DEVICES="4")
    child_env.pop("SEMTOOLS_WORKSPACE", None)
    with contextlib.ExitStack() as stack:
        for srv in servers.values():
            stack.enter_context(srv)
        proc = subprocess.run([sys.executable, "-c", script, str(root), str(tmp_path / "run")],
                              cwd=str(tmp_path),
                              env=child_env, capture_output=True, text=True,
                              stdin=subprocess.DEVNULL, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert out.strip().endswith("NO_JAX_OK")
    assert json.loads(out[: out.index("\n}\n") + 2])["results"]
    assert "lazy dog" not in proc.stderr and "Updating workspace" in proc.stderr
    assert "int4-mxu-scan" in out  # the second workspace search served the int4 tier
    assert "sharded-exact-scan[4]" in out  # SEMTOOLS_TPU_SHARDED=1 on 4 CPU shards
    assert "Index ready: ivf-pq serving" in out and "Index: Yes (ivf-pq)" in out
    assert ".local.md" in out and "Job creation failed (attempt 1/11)" in proc.stderr
    for answer in ("chat answer", "responses answer", "stdin answer"):
        assert f"\n{answer}\n" in out
    assert servers["parse"].app.upload_attempts == 2
    assert all(not srv.app.script for k, srv in servers.items() if k != "parse")


def test_reexports_are_lazy():
    """``semtools_tpu_torch.models`` and ``.ops`` re-export the JAX
    package's names (its ``__all__``) lazily: importing either package, or
    ``ops.kernels`` beside them, loads no torch, numpy or jax; the first
    use of a name imports its module."""
    import semtools_tpu.models as jax_models
    import semtools_tpu.ops as jax_ops
    import semtools_tpu_torch.models as port_models
    import semtools_tpu_torch.ops as port_ops

    assert port_models.__all__ == jax_models.__all__
    assert port_ops.__all__ == jax_ops.__all__
    script = (
        "import sys\n"
        "import semtools_tpu_torch.ops.kernels, semtools_tpu_torch.models, semtools_tpu_torch.ops\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'semtools_tpu'))\n"
        "assert not heavy, heavy\n"
        "from semtools_tpu_torch.models import *\n"
        "from semtools_tpu_torch.ops import *\n"
        "from semtools_tpu_torch.models.static_model import StaticModel as S\n"
        "from semtools_tpu_torch.ops.scan import topk_scan as t\n"
        "assert StaticModel is S and topk_scan is t\n"
        "print('LAZY_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "LAZY_OK", proc.stderr


def test_port_soak_never_imports_jax(tmp_path):
    """The soak (store and crash campaigns, a few steps, ``--device cpu``)
    and a crash-harness child, in child processes that see only the port
    (``semtools_tpu_torch/`` and ``cpp/``): the soak checks its own modules
    (exit 3 on jax, jaxlib or the JAX package), its crash children and the
    direct child theirs before their readiness record."""
    import shutil

    root = tmp_path / "port_only"
    shutil.copytree(REPO / "semtools_tpu_torch", root / "semtools_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    shutil.copytree(REPO / "cpp", root / "cpp")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMTOOLS_")}
    env.update(PYTHONPATH=str(root), HOME=str(tmp_path / "home"), SEMTOOLS_TPU_NO_FETCH="1",
               SEMTOOLS_TPU_ALLOW_FALLBACK="1")
    proc = subprocess.run(
        [sys.executable, "-m", "semtools_tpu_torch.soak", "--device", "cpu", "--steps", "4",
         "--seeds", "1", "--crash-rounds", "2", "--campaigns", "store,crash"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    reports = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert [r["campaign"] for r in reports] == ["store", "crash"]
    assert all(r["checks"] > 0 and r["failures"] == 0 for r in reports), reports
    journal = tmp_path / "journal.jsonl"
    child = subprocess.run(
        [sys.executable, "-m", "semtools_tpu_torch.soak.crash_harness", "child",
         str(tmp_path / "ws"), str(journal), "7", "3", "upsert-pre-commit"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        stdin=subprocess.DEVNULL, timeout=120)
    assert child.returncode == 137, child.stderr[-2000:]  # the trap, not check_no_jax's 3
    assert json.loads(journal.read_text().splitlines()[0]) == {"op": "ready", "phase": "done"}


def test_port_evals_never_import_jax(tmp_path):
    """The three evaluation drivers at a tiny size (three real-text documents
    copied to a temporary ``--corpus``, and 8 papers), the grep fuzz and the
    int4 tier probes (``probes.int4_tier`` and ``probes.int4_check``, 3,000
    rows, ``--device cpu``), in one child that sees only
    ``semtools_tpu_torch/`` and ``cpp/``: no ``jax``, ``jaxlib``,
    ``semtools_tpu*`` or ``httpx`` module loaded; and the local-parse fuzz
    (``parse.fuzz``, 2 cases a format) in a child of its own (it sets an
    address-space limit), which loads neither those nor torch nor numpy."""
    import shutil

    root = tmp_path / "port_only"
    shutil.copytree(REPO / "semtools_tpu_torch", root / "semtools_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    shutil.copytree(REPO / "cpp", root / "cpp")
    realtext = REPO / "benchmarks" / "realtext"
    docs = ("argparse", "json", "socket")
    (tmp_path / "rt" / "corpus").mkdir(parents=True)
    for doc in docs:
        shutil.copy(realtext / "corpus" / f"{doc}.txt", tmp_path / "rt" / "corpus")
    manifest = json.loads((realtext / "MANIFEST.json").read_text())
    manifest["documents"] = {d: manifest["documents"][d] for d in docs}
    (tmp_path / "rt" / "MANIFEST.json").write_text(json.dumps(manifest))
    out = tmp_path / "out"
    script = (
        "import contextlib, io, json, sys\n"
        "from semtools_tpu_torch.evals.__main__ import main\n"
        "runs = [\n"
        f"    ['realtext', '--device', 'cpu', '--corpus', {str(tmp_path / 'rt' / 'corpus')!r},\n"
        f"     '--out', {str(out / 'rt')!r}],\n"
        f"    ['retrieval', '--device', 'cpu', '--papers', '8', '--out', {str(out / 'rr')!r}],\n"
        f"    ['agent', '--device', 'cpu', '--papers', '8', '--out', {str(out / 'ag')!r}],\n"
        "    ['fuzz_grep', '--cases', '200'],\n"
        "]\n"
        "for argv in runs:\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        assert main(argv) == 0, argv\n"
        "from semtools_tpu_torch.probes import int4_check, int4_tier\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert int4_tier.main(['--device', 'cpu', '--rows', '3000', '--out',\n"
        f"                           {str(out / 'tier.json')!r}]) == 0\n"
        "    assert int4_check.main(['--device', 'cpu', '--rows', '3000']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'semtools_tpu', 'httpx'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMTOOLS_")}
    env.update(PYTHONPATH=str(root), HOME=str(tmp_path / "home"), SEMTOOLS_TPU_ALLOW_FALLBACK="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("NO_JAX_OK")
    rt = json.loads((out / "rt" / "RESULTS_REALTEXT.json").read_text())
    assert rt["corpus"]["documents"] == 3 and rt["summary"]["semantic_questions"] == 11
    assert json.loads((out / "rr" / "RESULTS_RETRIEVAL.json").read_text())["corpus"]["papers"] == 8
    agent = json.loads((out / "ag" / "RESULTS_AGENT.json").read_text())
    assert agent["aggregate"]["fault_injection_crashes"] == 0
    assert len(list((out / "ag" / "answers").glob("*/*.txt"))) == 30
    assert {r["probe"] for r in json.loads((out / "tier.json").read_text())} == {
        "int4_deep_recall", "int4_candidate_recall", "int4_throughput", "int8_ref_throughput"}
    fuzz = (
        "import runpy, sys\n"
        f"sys.argv = ['fuzz', '--cases', '2', '--out', {str(out / 'fuzz')!r}]\n"
        "code = 0\n"
        "try:\n"
        "    runpy.run_module('semtools_tpu_torch.parse.fuzz', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'semtools_tpu', 'httpx', 'torch', 'numpy'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
        "sys.exit(code)\n"
    )
    proc = subprocess.run([sys.executable, "-c", fuzz], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("NO_JAX_OK") and " 0 findings" in proc.stdout


def test_port_probes_never_import_jax(tmp_path):
    """Every module of ``semtools_tpu_torch.probes`` (and ``ops.probes``),
    imported and run on the CPU in a child that sees only the port, loads
    nothing of jax or of the JAX package. The store-scale drivers run at
    tiny sizes: the ladder at a 256 KiB budget (60-row docs), the IVF-PQ
    drivers at 3,000 rows and the patch at 1,004 x 50 and a 3,000-line
    document; the measurement drivers too: ``run_bench --small`` (two
    configs), ``workspace_e2e`` and ``daemon_parallel`` at 24 papers (the
    ``potion_mini`` artifacts), the embed drivers at 2^12 tokens, and
    ``gen_corpus`` (which takes no device) at 2 x 5."""
    import shutil

    root = tmp_path / "port_only"
    shutil.copytree(REPO / "semtools_tpu_torch", root / "semtools_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    names = sorted(p.stem for p in (REPO / "semtools_tpu_torch" / "probes").glob("*.py")
                   if p.stem != "__init__")
    out = ["--out", str(tmp_path / "out.json")]
    runs = {name: [["--rows", "3000"]] for name in names}
    runs.update(
        capacity_ladder=[["--budget", "262144", "--queries", "4", "--reps", "1", *out]],
        ann_scale=[["--rows", "3000", "--clusters", "64", "--queries", "5", *out]],
        ann_incremental=[["--rows", "3000", "--docs", "20", *out]],
        patch_scale=[["--docs", "1004", "--lines", "50", *out],
                     ["--single-file", "--lines", "3000", *out]],
        run_bench=[["--small", "--configs", "search_e2e,batched_threshold", *out]],
        workspace_e2e=[["--papers", "24", *out]],
        daemon_parallel=[["--papers", "24", "--parallel", "2", *out]],
        embed_baseline=[["--tokens", "4096", "--lines", "256", *out]],
        embed_variants=[["--tokens", "4096", "--lines", "256", *out]],
        gen_corpus=[[str(tmp_path / "corpus"), "--files", "2", "--lines", "5"]])
    no_device = ["gen_corpus"]
    assert {"stream_sweep", "kernel_variants", "int8_phase1", "int4_sweep", "int4_unpack",
            "capacity_ladder", "ann_scale", "ann_incremental", "patch_scale", "run_bench",
            "workspace_e2e", "daemon_parallel", "embed_baseline", "embed_variants",
            "gen_corpus", "drivers"} <= set(names)
    script = (
        "import contextlib, importlib, io, sys\n"
        "import semtools_tpu_torch.ops.probes\n"
        f"for name in {names!r}:\n"
        "    mod = importlib.import_module('semtools_tpu_torch.probes.' + name)\n"
        "    if hasattr(mod, 'main'):\n"
        f"        for args in {runs!r}[name]:\n"
        "            with contextlib.redirect_stdout(io.StringIO()):\n"
        f"                device = [] if name in {no_device!r} else ['--device', 'cpu']\n"
        "                assert mod.main([*device, *args]) == 0, (name, args)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'semtools_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root),
               SEMTOOLS_TPU_MODEL_DIR=str(REPO / "tests" / "fixtures" / "potion_mini"))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True,
                          text=True, stdin=subprocess.DEVNULL, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("NO_JAX_OK")
