"""``ask``: the port's agent, tools and CLI against the JAX package's.

Both packages run against identical ``tests/fake_servers.FakeOpenAI`` scripts
over the same files, each with its own embedder (the JAX fallback model and
the port's copy of it on the CPU). The request bodies the fake server
records must be equal with the distances in ``<chunk ... distance=D>``
blanked, and those distances must agree within 1e-5 (f32 summation order;
``repr`` may differ in the last digit). The agent's stdout, its answer and
``files_searched``, and the CLI's text and ``--json`` output must be equal.
The grep tool's output must be byte-equal on every route: the native
scanner (the port's own build of ``cpp/grepscan.cpp``) and Python ``re``.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

from tests.fake_servers import (
    FakeOpenAI,
    FakeServer,
    chat_text_response,
    chat_tool_call_response,
    responses_text,
    responses_tool_call,
)

PKGS = ("semtools_tpu", "semtools_tpu_torch")
ATOL = 1e-5
_DIST = re.compile(r"distance=([-+0-9.eE]+|nan|inf)>")
WORDS = ("index query vector cosine search token embed kernel shard stream corpus database "
         "table row column page disk cache memory latency river mountain forest ocean city "
         "error warn info request reply server").split()


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture()
def corpus(tmp_path):
    """Three files, ~300 lines: seeded word lines, planted lines, unicode."""
    rng = np.random.default_rng(8)
    files = []
    for i in range(2):
        lines = [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 9))))
                 for _ in range(140)]
        lines[37 + i] = "gamma target line about the quick brown fox"
        lines[90] = f"ERROR disk full while writing page {42 + i}"
        p = tmp_path / f"doc_{i}.txt"
        p.write_text("\n".join(lines) + "\n")
        files.append(str(p))
    u = tmp_path / "unicode.txt"
    u.write_text("plain ascii line\ndigit ٣ arabic-indic\ncafé lower\nCAFÉ UPPER\n"
                 "x€y wildcard line\nplain xzy line\nΣigma\n")
    files.append(str(u))
    return files


@pytest.fixture(scope="module")
def models(fallback_model):
    from semtools_tpu_torch.models.static_model import StaticModel

    return {PKGS[0]: fallback_model,
            PKGS[1]: StaticModel.from_jax_model(fallback_model, device="cpu")}


def _split(obj):
    """(JSON text with distances blanked, distances)."""
    text = json.dumps(obj, sort_keys=True, ensure_ascii=False)
    dists = [float(d) for d in _DIST.findall(text)]
    return _DIST.sub("distance=D>", text), dists


def _assert_same_requests(req_jax, req_torch):
    sj, dj = _split(req_jax)
    st, dt = _split(req_torch)
    assert st == sj
    assert len(dt) == len(dj)
    np.testing.assert_allclose(dt, dj, atol=ATOL, rtol=0)
    return dj


# -- grep: routes and predicates ----------------------------------------------------

GREP_CASES = [
    ("gamma target", {}),
    ("GAMMA", {"case_sensitive": True}),
    ("GAMMA", {"case_sensitive": False}),
    (r"ga.{2}a", {"is_regex": True}),
    (r"page \d+", {"is_regex": True, "context_lines": 1}),
    ("arr[0]", {}),
    ("line", {"file_paths": "doc_1"}),
    (r"\d", {"is_regex": True, "context_lines": 0}),
    ("café", {"case_sensitive": False, "context_lines": 0}),
    ("x.y", {"is_regex": True, "context_lines": 0}),
    ("x[^a]y", {"is_regex": True, "context_lines": 0}),
    (r"caf\xe9", {"is_regex": True, "context_lines": 0}),
    (r"\Aplain", {"is_regex": True}),
    (r"[[:digit:]]+", {"is_regex": True}),
    (r"[]a]", {"is_regex": True}),
    (r"\B", {"is_regex": True, "context_lines": 0}),
    (r"\p{L}", {"is_regex": True, "context_lines": 0}),
    (r"^\P{L}+$", {"is_regex": True, "context_lines": 0}),
    (r"(?P<w>fox)", {"is_regex": True}),
    ("no such words here", {}),
]


@pytest.mark.parametrize("i", range(len(GREP_CASES)))
def test_grep_tool_matches_jax(i, corpus):
    pattern, kw = GREP_CASES[i]
    kw = dict(kw)
    if kw.get("file_paths"):
        kw["file_paths"] = [f for f in corpus if kw["file_paths"] in f]
    outs = [_mod(pkg, "ask.tools").grep_tool(corpus, pattern, **kw) for pkg in PKGS]
    assert outs[0].encode() == outs[1].encode()


@pytest.mark.parametrize("pattern", [r"\p{NoSuchProp}", "(unclosed"])
def test_grep_bad_pattern_errors_match_jax(pattern, corpus):
    errs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as ei:
            _mod(pkg, "ask.tools").grep_tool(corpus, pattern, is_regex=True)
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and errs[0].startswith("Invalid regex pattern")


def test_grep_routes_match_jax(monkeypatch, corpus):
    """The port routes each pattern as the JAX package does, and a
    native-safe pattern goes through the port's own native scanner."""
    from semtools_tpu_torch.utils import grepscan, native

    assert grepscan.available() and native.lib_path().parent.name == "_build"
    patterns = [p for p, _ in GREP_CASES] + ["foo", r"\d+", r"foo (bar|baz)+", r"^x{1,3}$",
                                             r"x\.y", "[abc]+", r"foo\[^bar", "[a-z][^0-9]",
                                             r"x\Z", r"[[.a.]]", r"[[=a=]]", r"a\B", r"x\pLy"]
    lines = {"ascii": ["abc", "123"], "unicode": ["abc", "café"]}
    ta, tb = (_mod(pkg, "ask.tools") for pkg in PKGS)
    for p in patterns:
        assert ta._has_bytewise_unsafe_construct(p) == tb._has_bytewise_unsafe_construct(p)
        for icase in (False, True):
            for ls in lines.values():
                assert ta._native_grep_safe(p, icase, ls) == tb._native_grep_safe(p, icase, ls)
    calls = []
    real = grepscan.match_lines
    monkeypatch.setattr(grepscan, "match_lines",
                        lambda *a: calls.append(a) or real(*a))
    tools = _mod(PKGS[1], "ask.tools")
    out = tools.grep_tool(corpus[:2], r"page \d+", is_regex=True, context_lines=0)
    assert len(calls) == 2 and out.count("<chunk") == 2
    calls.clear()
    tools.grep_tool(corpus, r"\d", is_regex=True)  # unicode content: Python re
    assert [c[0] for c in calls] == corpus[:2]


def test_read_tool_matches_jax(corpus):
    for args in ((corpus[0], 1, 3), (corpus[0], 135, 999), (corpus[2], 0, 2)):
        outs = [_mod(pkg, "ask.tools").read_tool(*args) for pkg in PKGS]
        assert outs[0] == outs[1]
    assert outs[0].startswith(f"<chunk file={corpus[2]} start=0 end=2>\n")


def test_tool_definitions_match_jax():
    a, b = (_mod(pkg, "ask.tools") for pkg in PKGS)
    assert a.chat_tool_defs() == b.chat_tool_defs()
    assert a.responses_tool_defs() == b.responses_tool_defs()
    pa, pb = (_mod(pkg, "ask.prompts") for pkg in PKGS)
    assert (pa.SYSTEM_PROMPT, pa.STDIN_SYSTEM_PROMPT) == (pb.SYSTEM_PROMPT,
                                                          pb.STDIN_SYSTEM_PROMPT)


# -- the agent loops -----------------------------------------------------------------


def _multi_call(calls, api):
    if api == "responses":
        return {"output": [
            {"type": "function_call", "name": n,
             "arguments": a if isinstance(a, str) else json.dumps(a),
             "call_id": f"call_{i}", "id": f"fc_{i}"} for i, (n, a) in enumerate(calls)]}
    return {"choices": [{"message": {"role": "assistant", "content": None, "tool_calls": [
        {"id": f"c{i}", "type": "function",
         "function": {"name": n, "arguments": a if isinstance(a, str) else json.dumps(a)}}
        for i, (n, a) in enumerate(calls)]}}]}


def _text(api, text):
    return responses_text(text) if api == "responses" else chat_text_response(text)


def _one(api, name, args):
    return (responses_tool_call if api == "responses" else chat_tool_call_response)(name, args)


def _scripts(corpus):
    """name -> (api, script maker, max_iterations)."""
    four = [("search", {"query": q, "config": {"top_k": 3, "n_lines": 1}}) for q in (
        "gamma target line", "disk full error", "river mountain", "vector search kernel")]
    return {
        "chat_read": ("chat", lambda api: [
            _one(api, "read", {"path": corpus[0], "start_line": 0, "end_line": 2}),
            _text(api, "Answer [1].\n\n## References\n[1] doc_0.txt:1")], 5),
        "responses_grep": ("responses", lambda api: [
            _one(api, "grep", {"pattern": "gamma target", "context_lines": 1}),
            _text(api, "Found it [1].")], 5),
        "chat_four_searches_grep_read": ("chat", lambda api: [
            _multi_call(four, api),
            _multi_call([("grep", {"pattern": r"page \d+", "is_regex": True,
                                   "file_paths": corpus[:1]}),
                         ("read", {"path": corpus[1], "start_line": 36, "end_line": 40})], api),
            _text(api, "Done [1].")], 5),
        "responses_four_searches": ("responses", lambda api: [
            _multi_call(four, api), _text(api, "Done [1].")], 5),
        "responses_threshold_and_configs": ("responses", lambda api: [
            _multi_call([("search", {"query": "gamma", "config": {"top_k": 1}}),
                         ("search", {"query": "alpha", "config": {"top_k": 2}}),
                         ("search", {"query": "disk", "config": {"max_distance": 0.5,
                                                                 "ignore_case": True}})],
                        api),
            _text(api, "ok")], 5),
        "max_iterations": ("responses", lambda api: [
            _one(api, "read", {"path": corpus[0], "start_line": 0, "end_line": 1}),
            _one(api, "read", {"path": corpus[0], "start_line": 1, "end_line": 2})], 2),
        "faults": ("responses", lambda api: [
            _multi_call([("search", '{"query": "alpha", '), ("teleport", {"to": "mars"}),
                         ("read", {"start_line": 0, "end_line": 2}),
                         ("grep", {"pattern": "(bad", "is_regex": True}),
                         ("search", {"query": "x", "config": {"top_k": "many"}}),
                         ("grep", {"pattern": "gamma target"})], api),
            _text(api, "Recovered")], 5),
        "chat_faults": ("chat", lambda api: [
            _one(api, "read", {"path": corpus[0]}), _text(api, "Retry worked")], 5),
        "missing_file_batch_falls_back": ("chat", lambda api: [
            _multi_call([("search", {"query": "a"}), ("search", {"query": "b"})], api),
            _text(api, "none")], 5),
    }


def _agent_run(pkg, model, files, api, script, max_iter, capsys, workspace=None):
    agent = _mod(pkg, "ask.agent")
    client_mod = _mod(pkg, "ask.openai_client")
    api_mode = _mod(pkg, "ask.config").ApiMode(api)
    with FakeServer(FakeOpenAI(script)) as server:
        client = client_mod.OpenAIClient("k", server.url)
        capsys.readouterr()
        out = agent.ask_agent(files, "q?", model, client, "gpt-test", max_iter, workspace,
                              api_mode)
        stdout = capsys.readouterr().out
    return (out.response, out.files_searched, stdout), server.app.requests


@pytest.mark.parametrize("name", sorted(_scripts(["f0", "f1", "f2"])))
def test_agent_matches_jax(name, corpus, models, capsys, tmp_path):
    api, make, max_iter = _scripts(corpus)[name]
    files = corpus + [str(tmp_path / "gone.txt")] if name.startswith("missing") else corpus
    runs = [_agent_run(pkg, models[pkg], files, api, make(api), max_iter, capsys)
            for pkg in PKGS]
    assert runs[1][0] == runs[0][0]
    dists = _assert_same_requests(runs[0][1], runs[1][1])
    reqs = runs[0][1]
    if "search" in name:
        assert dists
    if name == "max_iterations":
        assert "Max iterations (2) reached" in runs[0][0][0]
    if name in ("faults", "missing_file_batch_falls_back", "chat_faults"):
        assert "Error:" in json.dumps(reqs[-1]["body"])


def test_parallel_searches_one_batched_scan(corpus, models, capsys, monkeypatch):
    """Four search calls of one turn with one config: one batched scan in the
    port, as in the JAX package; never the single-query path."""
    agent = _mod(PKGS[1], "ask.agent")
    tools = _mod(PKGS[1], "ask.tools")
    search = _mod(PKGS[1], "search")
    batches, scans = [], []
    real_tool, real_scan = tools.search_tool_batched, search.search_documents_batched
    monkeypatch.setattr(tools, "search_tool_batched",
                        lambda f, qs, *a, **k: batches.append(list(qs)) or real_tool(f, qs, *a, **k))
    monkeypatch.setattr(search, "search_documents_batched",
                        lambda d, q, c: scans.append(tuple(q.shape)) or real_scan(d, q, c))
    monkeypatch.setattr(agent, "search_tool",
                        lambda *a, **k: pytest.fail("single-query search ran"))
    api, make, max_iter = _scripts(corpus)["responses_four_searches"]
    (response, searched, stdout), reqs = _agent_run(PKGS[1], models[PKGS[1]], corpus, api,
                                                   make(api), max_iter, capsys)
    assert batches == [["gamma target line", "disk full error", "river mountain",
                        "vector search kernel"]]
    assert scans == [(4, models[PKGS[1]].dim)]
    assert stdout.count("[Tool Call: search]") == 4
    fco = [it for it in reqs[1]["body"]["input"] if it.get("type") == "function_call_output"]
    assert [o["call_id"] for o in fco] == [f"call_{i}" for i in range(4)]
    assert "gamma target line" in fco[0]["output"]


@pytest.mark.parametrize("api", ["chat", "responses"])
def test_stdin_mode_matches_jax(api, capsys):
    runs = []
    for pkg in PKGS:
        agent = _mod(pkg, "ask.agent")
        mode = _mod(pkg, "ask.config").ApiMode(api)
        with FakeServer(FakeOpenAI([_text(api, "stdin answer")])) as server:
            client = _mod(pkg, "ask.openai_client").OpenAIClient("k", server.url)
            out = agent.ask_agent_with_stdin("piped content", "summarize", client, "m", mode)
        runs.append(((out.response, out.files_searched), server.app.requests))
    assert runs[0] == runs[1]
    assert "tools" not in runs[0][1][0]["body"]


def test_llm_error_matches_jax():
    errs = []
    for pkg in PKGS:
        with FakeServer(FakeOpenAI([])) as server:  # an exhausted script: 500
            client = _mod(pkg, "ask.openai_client").OpenAIClient("k", server.url)
            with pytest.raises(RuntimeError) as ei:
                client.chat_completion("m", [{"role": "user", "content": "x"}])
        errs.append(str(ei.value))
    assert errs[0] == errs[1] == 'LLM API error 500: {"error": "script exhausted"}'


# -- the CLI --------------------------------------------------------------------------


class _Tty(io.StringIO):
    def isatty(self) -> bool:
        return True


def _cli(pkg, argv, script, home, monkeypatch, capsys, stdin=None):
    cli = _mod(pkg, "cli")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin) if stdin is not None else _Tty())
    with FakeServer(FakeOpenAI(script)) as server:
        capsys.readouterr()
        extra = ["--device", "cpu"] if pkg == PKGS[1] else []
        rc = cli.main([*argv, "--base-url", server.url, *extra])
        captured = capsys.readouterr()
    return (rc, captured.out, captured.err), server.app.requests


@pytest.fixture()
def cli_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    monkeypatch.delenv("SEMTOOLS_WORKSPACE", raising=False)
    return tmp_path


@pytest.mark.parametrize("api,flags", [("chat", []), ("chat", ["-j"]), ("responses", []),
                                       ("responses", ["-j"])])
def test_cli_ask_matches_jax(api, flags, corpus, cli_env, monkeypatch, capsys):
    _, make, _ = _scripts(corpus)["chat_four_searches_grep_read"]
    runs = [_cli(pkg, ["ask", "where is gamma?", *corpus, "--api-mode", api, *flags],
                 make(api), cli_env / f"home_{pkg}", monkeypatch, capsys) for pkg in PKGS]
    assert runs[0][0][:2] == runs[1][0][:2]
    assert runs[0][0][0] == 0
    _assert_same_requests(runs[0][1], runs[1][1])
    if flags:
        doc = json.loads(runs[1][0][1][runs[1][0][1].rindex("\n{"):])
        assert doc["response"] == "Done [1]." and corpus[0] in doc["files_searched"]


def test_cli_ask_workspace_matches_jax(corpus, cli_env, monkeypatch, capsys):
    """``ask -w``: the search tool on each package's workspace (built by the
    first search, warm in the second ask), all files and a subset."""
    _, make, _ = _scripts(corpus)["responses_four_searches"]
    for files in (corpus, corpus[:1], corpus):
        runs = []
        for pkg in PKGS:
            home = cli_env / f"home_{pkg}"
            monkeypatch.setenv("HOME", str(home))
            assert _mod(pkg, "cli").main(["workspace", "use", "w"]) == 0
            runs.append(_cli(pkg, ["ask", "q?", *files, "-w", "w", "--api-mode", "responses"],
                             make("responses"), home, monkeypatch, capsys))
        assert runs[0][0][:2] == runs[1][0][:2] and runs[0][0][0] == 0
        assert _assert_same_requests(runs[0][1], runs[1][1])
        assert ("Updating workspace" in runs[0][0][2]) == ("Updating workspace" in runs[1][0][2])


@pytest.mark.parametrize("api", ["chat", "responses"])
def test_cli_ask_stdin_matches_jax(api, cli_env, monkeypatch, capsys):
    runs = [_cli(pkg, ["ask", "summarize", "--api-mode", api, "-j"], [_text(api, "it says hi")],
                 cli_env, monkeypatch, capsys, stdin="hello\nworld\n") for pkg in PKGS]
    assert runs[0] == runs[1]
    assert json.loads(runs[0][0][1])["files_searched"] == ["<stdin>"]


@pytest.mark.parametrize("case", ["no_key", "no_input", "no_input_json"])
def test_cli_ask_errors_match_jax(case, corpus, cli_env, monkeypatch, capsys):
    if case == "no_key":
        monkeypatch.delenv("OPENAI_API_KEY")
    argv = ["ask", "q", *(["-j"] if case.endswith("json") else [])]
    runs = [_cli(pkg, argv, [], cli_env, monkeypatch, capsys, stdin="") for pkg in PKGS]
    assert runs[0] == runs[1]
    assert runs[0][0][0] == 1 and not runs[0][1]


def test_ask_json_schema_matches_jax():
    a, b = (_mod(pkg, "utils.json_mode") for pkg in PKGS)
    args = ("q", "answer", ["f1", "<stdin>"])
    assert a.dumps(a.ask_output(*args)) == b.dumps(b.ask_output(*args))


def test_forwarded_ask_prints_the_direct_output(corpus, cli_env, monkeypatch, capsys):
    """An ``ask`` (and a ``parse``) forwarded to the port's daemon runs under
    its exclusive gate and prints what the same command prints run here."""
    import threading
    import time

    from semtools_tpu_torch import daemon
    from semtools_tpu_torch.store import coalesce

    if not daemon.supported():
        pytest.skip("the daemon needs unix sockets")
    assert not daemon._read_only(["ask", "q"]) and not daemon._read_only(["parse", "f"])
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_DIR", str(cli_env / "run"))
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("HOME", str(cli_env))
    monkeypatch.setattr(coalesce, "_enabled", False)
    _, make, _ = _scripts(corpus)["chat_four_searches_grep_read"]
    argv = ["ask", "where?", *corpus, "--api-mode", "chat", "--api-key", "k"]
    server = threading.Thread(target=daemon.serve, kwargs={"warm": False}, daemon=True)
    server.start()
    try:
        for _ in range(200):
            if daemon.ping():
                break
            time.sleep(0.05)
        outs = []
        for forward in (True, False):
            with FakeServer(FakeOpenAI(make("chat"))) as llm:
                capsys.readouterr()
                if forward:
                    rc = daemon.forward([*argv, "--base-url", llm.url], None)
                else:
                    monkeypatch.setattr(sys, "stdin", _Tty())
                    rc = _mod(PKGS[1], "cli").main([*argv, "--base-url", llm.url])
                outs.append((rc, capsys.readouterr().out, llm.app.requests))
        capsys.readouterr()
        assert daemon.forward(["parse", corpus[0]], None) == 0
        assert capsys.readouterr().out == f"{corpus[0]}\n"
    finally:
        daemon.stop()
        server.join(timeout=10)
    assert not server.is_alive()
    assert outs[0][:2] == outs[1][:2] and outs[0][0] == 0 and "Done [1]." in outs[0][1]
    _assert_same_requests(outs[0][2], outs[1][2])


def test_parse_and_stdin_ask_import_no_torch(tmp_path):
    """``parse`` (local and LlamaParse) and an ``ask`` on piped stdin do no
    device work: a process that runs them never imports torch."""
    import subprocess
    from pathlib import Path

    from tests.fake_servers import FakeLlamaParse

    repo = Path(__file__).resolve().parent.parent
    doc = tmp_path / "a.html"
    doc.write_text("<p>hello</p>")
    pdf = tmp_path / "b.pdf"
    pdf.write_bytes(b"%PDF-1.4 fake")
    with FakeServer(FakeOpenAI([chat_text_response("hi")])) as llm, \
            FakeServer(FakeLlamaParse()) as lp:
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({"parse": {"api_key": "k", "base_url": lp.url,
                                             "check_interval": 0.01}}))
        script = (
            "import io, sys\n"
            "from semtools_tpu_torch.cli import main\n"
            f"assert main(['parse', '-b', 'local', {str(doc)!r}]) == 0\n"
            f"assert main(['parse', '-c', {str(cfg)!r}, {str(pdf)!r}]) == 0\n"
            "sys.stdin = io.StringIO('piped')\n"
            f"assert main(['ask', 'q', '--api-mode', 'chat', '--base-url', {llm.url!r},\n"
            "             '--api-key', 'k']) == 0\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n"
            "print('NO_TORCH_OK')\n"
        )
        proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                              env=dict(os.environ, HOME=str(tmp_path), PYTHONPATH=str(repo),
                                       SEMTOOLS_TPU_DAEMON="off"),
                              capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("NO_TORCH_OK") and "\nhi\n" in proc.stdout


def test_native_build_ignores_inherited_cxx(monkeypatch):
    """The port's native library is built by the Makefile's own compiler: an
    inherited ``CXX`` (a wrapper linking libstdc++ statically) would give the
    grep scanner a second C++ runtime, whose ``std::regex`` crashes once
    numpy or torch has loaded the shared one."""
    import subprocess

    from semtools_tpu_torch.utils import native

    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, env=kw.get("env"))
        return subprocess.CompletedProcess(cmd, 1)

    monkeypatch.setenv("CXX", "/opt/wrapper/g++")
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native.build() is False
    assert seen["cmd"][0] == "make" and "CXX" not in seen["env"]
    assert seen["env"]["PATH"] == os.environ["PATH"]


def test_native_library_without_recipe_stamp_is_rebuilt(monkeypatch, tmp_path):
    """A library newer than its sources but built before the inherited
    ``CXX`` was dropped (no recipe stamp beside it) is remade with ``make
    -B``, the stamp is written, and a stamped library is left alone."""
    import subprocess

    from semtools_tpu_torch.utils import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    lib = native.lib_path()
    lib.write_bytes(b"old")
    newest = max(p.stat().st_mtime for p in native.CPP_DIR.iterdir())
    os.utime(lib, (newest + 60, newest + 60))
    assert native._stale(lib)

    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        lib.write_bytes(b"new")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv("SEMTOOLS_TPU_NO_NATIVE_BUILD", raising=False)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: (_ for _ in ()).throw(OSError(path)))
    assert native.load() is None  # the fake library does not load; the build ran
    assert len(cmds) == 1 and "-B" in cmds[0]
    assert native.recipe_path().read_text() == native.RECIPE
    os.utime(lib, (newest + 120, newest + 120))
    assert not native._stale(lib)
    assert native.build() and "-B" not in cmds[-1]
