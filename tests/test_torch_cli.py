"""``tests/test_cli.py`` on the port: the CLI end to end — search (files,
JSON, stdin, no input, threshold), the workspace lifecycle and its JSON
shapes, parse passthrough, ask without a key, ``--version``, and the batch
mode ``-Q`` (text, NDJSON, stdin documents, workspace, errors, ``-`` as
stdin).

Each case drives ``semtools_tpu_torch.cli.main`` in this process (the CPU
through ``SEMTOOLS_TORCH_DEVICE=cpu``, no daemon), and the JAX package's
``semtools_tpu.cli.main`` with the same arguments and stdin under its own
HOME. Exit codes must be equal; stdout must be byte-equal once each side's
HOME is written ``<home>``, except that search hits compare their headers
and context lines exactly and their distances within 1e-5 (a distance's
last printed digit may differ: ``test_torch_search_cli.py``'s rule); the
stderr lines the JAX suite checks must appear in both. Left out: the JAX
suite's two wedged-backend cases, which test the TPU-link watchdog's
re-exec (``utils/platform.py``, not ported).
"""

import io
import json
import os
import sys
from pathlib import Path

import pytest

from semtools_tpu import cli as jax_cli
from semtools_tpu_torch import cli as torch_cli
from test_torch_search_cli import _assert_same

REPO = Path(__file__).resolve().parent.parent


class _Tty(io.StringIO):
    def isatty(self) -> bool:
        return True


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.delenv("SEMTOOLS_WORKSPACE", raising=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    (d / "a.txt").write_text(
        "the quick brown fox\njumps over the lazy dog\nan essay about databases\n"
    )
    (d / "b.txt").write_text("neural networks for vision\nconvolutional layers\n")
    return d


class _Result:
    def __init__(self, returncode, stdout, stderr):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def _one(main, args, stdin, home, env_extra, capsys, monkeypatch):
    home.mkdir(parents=True, exist_ok=True)
    with monkeypatch.context() as m:
        m.setenv("HOME", str(home))
        for k, v in (env_extra or {}).items():
            m.setenv(k, v)
        m.setattr(sys, "stdin", io.StringIO(stdin) if stdin is not None else _Tty())
        capsys.readouterr()
        try:
            rc = main(list(args))
        except SystemExit as e:  # argparse errors and --version
            rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        out, err = capsys.readouterr()
    return _Result(rc, out.replace(str(home), "<home>"), err.replace(str(home), "<home>"))


@pytest.fixture()
def run_cli(tmp_path, capsys, monkeypatch):
    """``run_cli(args, stdin, home, env_extra)`` -> the port's result, held
    against the JAX CLI's on the same arguments (its HOME beside the
    port's)."""

    def run(args, stdin=None, home=None, env_extra=None, hits=None):
        home = Path(home) if home else tmp_path / "nohome"
        got = _one(torch_cli.main, args, stdin, home / "port", env_extra, capsys, monkeypatch)
        want = _one(jax_cli.main, args, stdin, home / "jax", env_extra, capsys, monkeypatch)
        assert got.returncode == want.returncode, (got.stderr, want.stderr)
        if hits is None:
            hits = bool(got.stdout.strip()) and "search" in args and got.returncode == 0
        if hits:
            _assert_same(want.stdout, got.stdout, "-j" in args or "--json" in args)
        else:
            assert got.stdout == want.stdout
        return got

    return run


def test_search_files_plain(corpus, tmp_path, run_cli):
    r = run_cli(
        ["search", "databases", str(corpus / "a.txt"), "--top-k", "1"],
        stdin="",
        home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert str(corpus / "a.txt") in r.stdout
    assert "an essay about databases" in r.stdout
    # header format: path:start::end (distance)
    assert "::" in r.stdout.splitlines()[0]


def test_search_json_schema(corpus, tmp_path, run_cli):
    r = run_cli(
        ["search", "fox", str(corpus / "a.txt"), "--top-k", "1", "-j"],
        stdin="",
        home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout)
    assert set(data) == {"results"}
    row = data["results"][0]
    assert set(row) == {
        "filename",
        "start_line_number",
        "end_line_number",
        "match_line_number",
        "distance",
        "content",
    }


def test_search_stdin(tmp_path, run_cli):
    r = run_cli(
        ["search", "beta two", "--top-k", "1", "-n", "0"],
        stdin="alpha one\nbeta two\ngamma three\n",
        home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert "<stdin>" in r.stdout
    assert "beta two" in r.stdout


def test_search_no_input_errors(tmp_path, run_cli):
    r = run_cli(["search", "q"], stdin="", home=tmp_path)
    assert r.returncode == 1
    assert "No input provided" in r.stderr


def test_search_threshold_overrides_topk(corpus, tmp_path, run_cli):
    r = run_cli(
        ["search", "word", str(corpus / "a.txt"), "--top-k", "1", "-m", "10.0", "-j"],
        stdin="",
        home=tmp_path,
    )
    data = json.loads(r.stdout)
    assert len(data["results"]) == 3  # all lines pass a distance-10 threshold


def test_workspace_end_to_end(corpus, tmp_path, run_cli):
    r = run_cli(["workspace", "use", "wtest"], stdin="", home=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "export SEMTOOLS_WORKSPACE=wtest" in r.stdout

    env = {"SEMTOOLS_WORKSPACE": "wtest"}
    r = run_cli(
        ["search", "fox", str(corpus / "a.txt"), "--top-k", "1"],
        stdin="",
        home=tmp_path,
        env_extra=env,
    )
    assert r.returncode == 0, r.stderr
    assert "Updating workspace" in r.stderr

    # second run: no re-embed
    r2 = run_cli(
        ["search", "fox", str(corpus / "a.txt"), "--top-k", "1"],
        stdin="",
        home=tmp_path,
        env_extra=env,
    )
    assert "Updating workspace" not in r2.stderr
    assert r2.stdout == r.stdout

    r = run_cli(["workspace", "status", "-j"], stdin="", home=tmp_path, env_extra=env)
    data = json.loads(r.stdout)
    assert data["name"] == "wtest"
    assert data["total_documents"] == 1

    r = run_cli(["workspace", "prune"], stdin="", home=tmp_path, env_extra=env)
    assert "clean" in r.stdout


def test_workspace_status_without_active_errors(tmp_path, run_cli):
    r = run_cli(["workspace", "status"], stdin="", home=tmp_path)
    assert r.returncode == 1
    assert "No active workspace" in r.stderr


def test_parse_passthrough_and_missing(corpus, tmp_path, run_cli):
    r = run_cli(
        ["parse", str(corpus / "a.txt"), str(corpus / "nope.pdf")],
        stdin="",
        home=tmp_path,
    )
    assert r.returncode == 0
    lines = r.stdout.splitlines()
    assert lines == [str(corpus / "a.txt"), str(corpus / "nope.pdf")]
    assert "Warning: File does not exist" in r.stderr


def test_ask_requires_api_key(corpus, tmp_path, run_cli):
    env = {k: "" for k in ("OPENAI_API_KEY",)}
    r = run_cli(
        ["ask", "what?", str(corpus / "a.txt")], stdin="", home=tmp_path, env_extra=env
    )
    assert r.returncode == 1
    assert "API key not found" in r.stderr


def test_version_flag(run_cli):
    r = run_cli(["--version"])
    assert r.returncode == 0
    assert r.stdout.strip().startswith("semtools ")


def test_version_matches_packaging():
    """``__version__`` must track pyproject's version, in both packages."""
    import re

    import semtools_tpu
    import semtools_tpu_torch

    pyproject = (REPO / "pyproject.toml").read_text()
    m = re.search(r'^version = "([^"]+)"', pyproject, re.M)
    assert m and m.group(1) == semtools_tpu_torch.__version__ == semtools_tpu.__version__


def test_workspace_global_json_flag_position(corpus, tmp_path, run_cli):
    # -j is global on workspace: accepted before the action
    r = run_cli(["workspace", "use", "gjson"], home=tmp_path)
    assert r.returncode == 0
    r = run_cli(["workspace", "-j", "status"], home=tmp_path,
                env_extra={"SEMTOOLS_WORKSPACE": "gjson"})
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout)
    assert set(data) == {
        "name", "root_dir", "total_documents", "slots_live", "slots_allocated"
    }
    assert data["slots_live"] <= data["slots_allocated"]


def test_parse_json_schema(corpus, tmp_path, run_cli):
    r = run_cli(["parse", "--json", str(corpus / "a.txt")], home=tmp_path)
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout)
    assert set(data) == {"results"}
    assert set(data["results"][0]) == {"input_path", "output_path", "was_cached"}


def test_workspace_prune_json_schema(corpus, tmp_path, run_cli):
    env = {"SEMTOOLS_WORKSPACE": "prunejs"}
    run_cli(["workspace", "use", "prunejs"], home=tmp_path)
    run_cli(["search", "fox", str(corpus / "a.txt")], stdin="", home=tmp_path, env_extra=env)
    r = run_cli(["workspace", "prune", "-j"], home=tmp_path, env_extra=env)
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout)
    assert set(data) == {"files_removed", "files_remaining"}


def test_search_queries_file_batch(corpus, tmp_path, run_cli):
    qf = tmp_path / "queries.txt"
    qf.write_text("databases\n\nneural vision\n")  # blank line skipped
    r = run_cli(
        ["search", "--queries-file", str(qf), str(corpus / "a.txt"),
         str(corpus / "b.txt"), "--top-k", "1", "-n", "0"],
        stdin="", home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "# query: databases" in out
    assert "# query: neural vision" in out
    assert out.index("databases") < out.index("neural vision")
    assert "an essay about databases" in out
    assert "neural networks for vision" in out


def test_search_queries_file_ndjson(corpus, tmp_path, run_cli):
    qf = tmp_path / "queries.txt"
    qf.write_text("databases\nneural vision\n")
    r = run_cli(
        ["search", "-Q", str(qf), str(corpus / "a.txt"), str(corpus / "b.txt"),
         "--top-k", "2", "-j"],
        stdin="", home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 2  # one NDJSON object per query
    for ln, q in zip(lines, ["databases", "neural vision"]):
        data = json.loads(ln)
        assert data["query"] == q
        assert len(data["results"]) == 2
        assert set(data["results"][0]) == {
            "filename", "start_line_number", "end_line_number",
            "match_line_number", "distance", "content",
        }


def test_search_queries_file_stdin_docs(corpus, tmp_path, run_cli):
    qf = tmp_path / "queries.txt"
    qf.write_text("beta\nalpha\n")
    r = run_cli(
        ["search", "-Q", str(qf), "-n", "0", "-j"],
        stdin="alpha line\nbeta line\n", home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    first = json.loads(lines[0])
    assert first["query"] == "beta"
    assert first["results"][0]["filename"] == "<stdin>"


def test_search_queries_file_workspace_batch(corpus, tmp_path, run_cli):
    env = {"SEMTOOLS_WORKSPACE": "qbatch"}
    run_cli(["workspace", "use", "qbatch"], home=tmp_path)
    qf = tmp_path / "queries.txt"
    qf.write_text("databases\nneural vision\n")
    r = run_cli(
        ["search", "-Q", str(qf), str(corpus / "a.txt"), str(corpus / "b.txt"),
         "--top-k", "1", "-j"],
        stdin="", home=tmp_path, env_extra=env,
    )
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 2
    d0 = json.loads(lines[0])
    assert d0["query"] == "databases"
    assert d0["results"][0]["filename"].endswith("a.txt")
    # batched results identical to Q single-query invocations
    for ln, q in zip(lines, ["databases", "neural vision"]):
        r1 = run_cli(
            ["search", q, str(corpus / "a.txt"), str(corpus / "b.txt"),
             "--top-k", "1", "-j"],
            stdin="", home=tmp_path, env_extra=env,
        )
        single = json.loads(r1.stdout)["results"]
        got = json.loads(ln)["results"]
        # identical hits; distances agree to f32 matmul-shape tolerance
        assert [
            {k: v for k, v in r.items() if k != "distance"} for r in got
        ] == [{k: v for k, v in r.items() if k != "distance"} for r in single]
        for g, s in zip(got, single):
            assert abs(g["distance"] - s["distance"]) < 1e-5


def test_search_queries_file_errors(corpus, tmp_path, run_cli):
    r = run_cli(["search"], stdin="", home=tmp_path)
    assert r.returncode == 2
    assert "QUERY" in r.stderr
    qf = tmp_path / "empty.txt"
    qf.write_text("\n\n")
    r = run_cli(["search", "-Q", str(qf), str(corpus / "a.txt")],
                stdin="", home=tmp_path)
    assert r.returncode == 1
    assert "no queries" in r.stderr
    # '-' without document files: stdin cannot be both queries and document
    r = run_cli(["search", "-Q", "-"], stdin="q1\n", home=tmp_path)
    assert r.returncode == 1
    assert "stdin" in r.stderr


def test_search_queries_file_dash_reads_stdin(corpus, tmp_path, run_cli):
    r = run_cli(
        ["search", "-Q", "-", str(corpus / "a.txt"), "--top-k", "1", "-j"],
        stdin="databases\n", home=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    data = json.loads(r.stdout.splitlines()[0])
    assert data["query"] == "databases"
    assert "databases" in data["results"][0]["content"]


def test_cli_module_runs_as_a_process(corpus, tmp_path):
    """The process boundary itself, which the in-process cases cannot show:
    ``python -m semtools_tpu_torch.cli`` searches and exits 0."""
    import subprocess

    env = dict(os.environ, HOME=str(tmp_path), SEMTOOLS_TORCH_DEVICE="cpu",
               SEMTOOLS_TPU_DAEMON="off", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("SEMTOOLS_WORKSPACE", None)
    r = subprocess.run(
        [sys.executable, "-m", "semtools_tpu_torch.cli", "search", "databases",
         str(corpus / "a.txt"), "--top-k", "1"],
        input="", capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "an essay about databases" in r.stdout
