"""``parse`` with the LlamaParse backend: the port against the JAX package.

Every scenario of ``tests/test_parse.py`` runs through both packages against
``tests/fake_servers.FakeLlamaParse`` with the same files and settings. The
results, stdout and stderr, the cache entries (bytes, with the cache
directory's own path blanked) and the requests the fake server received must
be equal. A request is compared by method, path, ``Authorization`` and its
form fields (headers and bytes of each multipart part); the boundary is not
compared. The JAX client talks ``httpx``, the port's the standard library.
"""

from __future__ import annotations

import importlib
import json
import re
import sys
from pathlib import Path

import pytest

from tests.fake_servers import FakeLlamaParse, FakeServer

PKGS = ("semtools_tpu", "semtools_tpu_torch")
REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "example_semtools_config.json"


def _parts(body: bytes, content_type: str):
    """[(part headers, part bytes)] of a multipart body."""
    m = re.search(r"boundary=([^;\s]+)", content_type)
    assert m, content_type
    sep = b"--" + m.group(1).encode()
    chunks = body.split(sep)
    assert chunks[0] == b"" and chunks[-1] == b"--\r\n", body[-64:]
    out = []
    for chunk in chunks[1:-1]:
        assert chunk.startswith(b"\r\n") and chunk.endswith(b"\r\n")
        head, _, content = chunk[2:-2].partition(b"\r\n\r\n")
        out.append((head.decode(), content))
    return out


class RecordingLlamaParse(FakeLlamaParse):
    """FakeLlamaParse that also keeps each request's headers and form."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = []

    def handle(self, method, path, headers, body):
        rec = {"method": method, "path": path,
               "authorization": headers.get("Authorization")}
        if method == "POST":
            ctype = headers.get("Content-Type", "")
            rec["content_type"] = ctype.split(";")[0]
            rec["form"] = _parts(body, ctype)
        self.seen.append(rec)
        return super().handle(method, path, headers, body)


class Unauthorized(RecordingLlamaParse):
    def handle(self, method, path, headers, body):
        self.seen.append({"method": method, "path": path})
        return 401, {"error": "bad key"}


def _mods(pkg):
    parse = importlib.import_module(f"{pkg}.parse")
    return parse, importlib.import_module(f"{pkg}.parse.client")


def _config(pkg, url, **kw):
    parse, _ = _mods(pkg)
    settings = dict(api_key="test-key", base_url=url, check_interval=0.01, max_timeout=5.0,
                    max_retries=3, retry_delay_ms=1.0, backoff_multiplier=1.0)
    settings.update(kw)
    return parse.LlamaParseConfig(**settings)


def _cache_files(cache: Path):
    """{name: bytes} of a cache directory, its own path blanked."""
    out = {}
    if not cache.exists():
        return out
    for p in sorted(cache.iterdir()):
        out[p.name] = p.read_bytes().replace(str(cache).encode(), b"<CACHE>")
    return out


@pytest.fixture()
def docs(tmp_path):
    d = tmp_path / "docs"
    d.mkdir()
    pdf = d / "doc.pdf"
    pdf.write_bytes(b"%PDF-1.4 fake")
    return d


def _run(pkg, tmp_path, capsys, app, action, **cfg):
    """Observables of ``action(backend, config)`` for one package."""
    parse, client = _mods(pkg)
    cache = tmp_path / pkg / "cache"
    with FakeServer(app) as server:
        config = _config(pkg, server.url, **cfg)
        backend = parse.LlamaParseBackend(config, cache_dir=str(cache))
        capsys.readouterr()
        try:
            result = action(backend, config)
            error = None
        except client.JobError as e:
            result, error = None, (type(e).__name__, str(e))
    captured = capsys.readouterr()
    return {
        "result": json.loads(json.dumps(result, default=repr).replace(str(cache), "<CACHE>")),
        "error": error, "out": captured.out, "err": captured.err,
        "cache": _cache_files(cache), "requests": app.seen, "uploads": app.upload_attempts,
        "configurations": app.configurations,
    }


def _both(tmp_path, capsys, make_app, action, **cfg):
    jax_obs, torch_obs = (_run(pkg, tmp_path, capsys, make_app(), action, **cfg)
                          for pkg in PKGS)
    return jax_obs, torch_obs


def _detailed(files):
    return lambda b, c: [(r.input_path, r.output_path, r.was_cached)
                         for r in b.parse_detailed(files)]


SCENARIOS = {
    "pending_polls": (dict(pending_polls=2), {}),
    "retry_5xx_then_success": (dict(fail_uploads=2), {}),
    "failed_job": (dict(job_status="FAILED"), {}),
    "failed_page": (dict(markdown_pages=["P1", "P2"], failed_page=True), {}),
    "fast_tier_expands_text": (dict(), dict(parse_kwargs={"tier": "fast"})),
    "example_config_kwargs": (dict(), "example"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_backend_scenarios_match_jax(name, tmp_path, docs, capsys):
    app_kw, cfg = SCENARIOS[name]
    if cfg == "example":
        jax_parse = importlib.import_module("semtools_tpu.parse")
        cfg = dict(parse_kwargs=jax_parse.load_parse_config(str(EXAMPLE)).parse_kwargs)
    files = [str(docs / "doc.pdf")]
    jax_obs, torch_obs = _both(tmp_path, capsys, lambda: RecordingLlamaParse(**app_kw),
                               _detailed(files), **cfg)
    assert torch_obs == jax_obs
    assert jax_obs["requests"], "the scenario sent no request"
    if name == "retry_5xx_then_success":
        assert jax_obs["uploads"] == 3 and "Retrying in 1ms..." in jax_obs["err"]
    if name == "failed_page":
        assert "ocr exploded" in jax_obs["err"]
    if name == "failed_job":
        assert jax_obs["result"] == [] and "Job failed with status: FAILED" in jax_obs["err"]
    if name == "example_config_kwargs":
        sent = jax_obs["configurations"][0]
        assert sent["processing_options"]["ocr_parameters"]["languages"] == ["en", "de"]


def test_retry_exhaustion_matches_jax(tmp_path, docs, capsys):
    pdf = str(docs / "doc.pdf")
    jax_obs, torch_obs = _both(
        tmp_path, capsys, lambda: RecordingLlamaParse(fail_uploads=99),
        lambda b, c: b.client.create_parse_job(pdf, c.base_url, "k", c), max_retries=2)
    assert torch_obs == jax_obs
    assert jax_obs["error"] == ("RetryExhausted", "Job creation failed after 3 attempts. "
                                "Last error: server error")
    # through the backend: reported and dropped
    jax_obs, torch_obs = _both(tmp_path, capsys, lambda: RecordingLlamaParse(fail_uploads=99),
                               _detailed([pdf]), max_retries=1)
    assert torch_obs == jax_obs and jax_obs["result"] == []


def test_terminal_4xx_matches_jax(tmp_path, docs, capsys):
    pdf = str(docs / "doc.pdf")
    jax_obs, torch_obs = _both(
        tmp_path, capsys, Unauthorized,
        lambda b, c: b.client.create_parse_job(pdf, c.base_url, "k", c))
    assert torch_obs == jax_obs
    assert jax_obs["error"][0] == "InvalidResponse" and len(jax_obs["requests"]) == 1


def test_connection_refused_is_retried(tmp_path, docs, capsys):
    """No server: both retry every attempt, then give up; the transport's
    own error text may differ, the program's words may not."""
    pdf = str(docs / "doc.pdf")
    obs = []
    for pkg in PKGS:
        _, client = _mods(pkg)
        server = FakeServer(RecordingLlamaParse())
        url = server.url
        server.httpd.server_close()  # the port is now closed
        config = _config(pkg, url, max_retries=2)
        capsys.readouterr()
        with pytest.raises(client.RetryExhausted) as ei:
            client.ParseClient().create_parse_job(pdf, url, "k", config)
        err = capsys.readouterr().err
        obs.append((str(ei.value).split("Last error:")[0],
                    re.sub(r"\): .*\. Retrying", "): <E>. Retrying", err)))
    assert obs[0] == obs[1]
    assert obs[0][1].count("Retrying in 1ms...") == 2


def test_cache_round_trip_and_no_network(tmp_path, docs, capsys):
    files = [str(docs / "doc.pdf")]

    def twice(b, c):
        first = b.parse_detailed(files)
        second = b.parse_detailed(files)
        return [(r.output_path, r.was_cached) for r in first + second]

    jax_obs, torch_obs = _both(tmp_path, capsys, RecordingLlamaParse, twice)
    assert torch_obs == jax_obs
    assert [c for _, c in jax_obs["result"]] == [False, True]
    assert jax_obs["result"][0][0].startswith("<CACHE>/doc.pdf.")
    assert len([r for r in jax_obs["requests"] if r["method"] == "POST"]) == 1


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_cache_shared_across_packages(writer, reader, tmp_path, docs, capsys):
    """One package's cache entry is served by the other, with no request."""
    pdf = str(docs / "doc.pdf")
    cache = tmp_path / "shared"
    w_parse, _ = _mods(writer)
    r_parse, _ = _mods(reader)
    app = RecordingLlamaParse()
    with FakeServer(app) as server:
        out = w_parse.LlamaParseBackend(_config(writer, server.url),
                                        cache_dir=str(cache)).parse([pdf])
        n = len(app.seen)
        got = r_parse.LlamaParseBackend(_config(reader, server.url),
                                        cache_dir=str(cache)).parse_detailed([pdf])
    assert len(app.seen) == n
    assert [(g.output_path, g.was_cached) for g in got] == [(out[0], True)]
    assert r_parse.CacheManager(str(cache)).get_cached_result(pdf) == out[0]
    # the other backend's namespace stays separate in both packages
    assert r_parse.CacheManager(str(cache), backend="local").get_cached_result(pdf) is None


def test_cache_manager_keys_match_jax(tmp_path, docs):
    pdf = str(docs / "doc.pdf")
    (docs / "notes.txt").write_text("x")
    managers = [_mods(pkg)[0].CacheManager(str(tmp_path / pkg), backend=b)
                for pkg in PKGS for b in ("llama-parse", "local")]
    names = [(m.parsed_path_for(pdf).name, m.metadata_path_for(pdf).name) for m in managers]
    assert names[:2] == names[2:]
    for m in managers:
        assert m.should_skip_file(str(docs / "notes.txt"))
        assert m.should_skip_file(str(docs / "missing.pdf"))
        assert not m.should_skip_file(pdf)


def test_fan_out_matches_jax(tmp_path, docs, capsys):
    files = []
    for i in range(7):
        f = docs / f"f{i}.pdf"
        f.write_bytes(b"%PDF" + bytes([i]))
        files.append(str(f))
    (docs / "notes.txt").write_text("already readable")
    files.append(str(docs / "notes.txt"))
    jax_obs, torch_obs = _both(tmp_path, capsys, RecordingLlamaParse, _detailed(files))
    key = lambda r: json.dumps(r, sort_keys=True, default=repr)  # noqa: E731
    for obs in (jax_obs, torch_obs):  # seven jobs in flight at once: order varies
        obs["requests"] = sorted(obs["requests"], key=key)
        obs["requests"] = [dict(r, path=re.sub(r"job-\d+", "job-N", r["path"]))
                           for r in obs["requests"]]
    assert torch_obs == jax_obs
    assert len(jax_obs["result"]) == 8 and jax_obs["result"][0][1] == files[-1]


@pytest.mark.parametrize("which", ["example", "missing", "partial"])
def test_config_loaders_match_jax(which, tmp_path, monkeypatch):
    """Both packages resolve the same parse and ask settings: file over env
    over default."""
    monkeypatch.setenv("LLAMA_CLOUD_API_KEY", "env-llama")
    monkeypatch.setenv("OPENAI_API_KEY", "env-openai")
    path = {"example": EXAMPLE, "missing": tmp_path / "none.json",
            "partial": tmp_path / "partial.json"}[which]
    if which == "partial":
        path.write_text(json.dumps({"parse": {"max_retries": 2},
                                    "ask": {"model": "m", "api_mode": "chat"}}))
    seen = []
    for pkg in PKGS:
        pc = _mods(pkg)[0].load_parse_config(str(path))
        ac = importlib.import_module(f"{pkg}.ask.config").load_ask_config(str(path))
        seen.append((vars(pc), ac.api_key, ac.base_url, ac.model, ac.max_iterations,
                     ac.api_mode.value))
    assert seen[0] == seen[1]
    if which != "example":
        assert seen[0][0]["api_key"] == "env-llama" and seen[0][1] == "env-openai"


def _cli(pkg, argv, home, monkeypatch, capsys):
    import io

    cli = importlib.import_module(f"{pkg}.cli")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    capsys.readouterr()
    rc = cli.main(argv)
    captured = capsys.readouterr()
    return rc, captured.out.replace(str(home), "<HOME>"), captured.err.replace(str(home), "<HOME>")


@pytest.mark.parametrize("json_flag", [False, True])
def test_cli_parse_matches_jax(json_flag, tmp_path, docs, capsys, monkeypatch):
    """``parse`` through each CLI with a config file naming the fake server:
    the same stdout (text or ``-j``) and stderr, twice (the second from the
    cache), and the same requests."""
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    (docs / "notes.md").write_text("# readable\n")
    files = [str(docs / "doc.pdf"), str(docs / "notes.md"), str(docs / "gone.pdf")]
    obs = []
    for pkg in PKGS:
        home = tmp_path / f"home_{pkg}"
        home.mkdir()
        app = RecordingLlamaParse(fail_uploads=1)
        with FakeServer(app) as server:
            cfg = home / "cfg.json"
            cfg.write_text(json.dumps({"parse": {
                "api_key": "k", "base_url": server.url, "check_interval": 0.01,
                "retry_delay_ms": 1, "max_retries": 2}}))
            argv = ["parse", "-c", str(cfg), "-v", *files] + (["-j"] if json_flag else [])
            runs = [_cli(pkg, argv, home, monkeypatch, capsys) for _ in range(2)]
        obs.append((runs, app.seen, _cache_files(home / ".parse")))
    assert obs[1] == obs[0]
    runs = obs[0][0]
    assert runs[0][0] == runs[1][0] == 0
    assert "Job creation failed (attempt 1/3): server error. Retrying in 1ms..." in runs[0][2]
    assert "Warning: File does not exist:" in runs[0][2]
    assert "Using cached result for:" in runs[1][2]
    if json_flag:
        assert [r["was_cached"] for r in json.loads(runs[1][1])["results"]] == [True, False, False]


def test_shims_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("HOME", str(tmp_path))
    f = tmp_path / "notes.txt"
    f.write_text("plain text\n")
    outs = []
    for pkg in PKGS:
        shims = importlib.import_module(f"{pkg}.shims")
        monkeypatch.setattr(sys, "argv", ["parse", str(f)])
        capsys.readouterr()
        assert shims.parse_main() == 0
        outs.append(capsys.readouterr().out)
        assert {n for n in dir(shims) if n.endswith("_main")} == {
            "parse_main", "search_main", "workspace_main", "ask_main"}
    assert outs[0] == outs[1] == f"{f}\n"


@pytest.mark.parametrize("filename", ["doc.pdf", 'quo"te\\d ü.pdf', "tab\tname.docx"])
def test_multipart_body_matches_httpx(filename):
    """The port's form encoding is the one ``httpx`` writes for the JAX
    client's ``files=``/``data=``, boundary aside."""
    import httpx

    from semtools_tpu_torch.utils import http

    config = json.dumps({"tier": "cost_effective", "note": "é"})
    body, ctype = http.encode_multipart({"configuration": config},
                                        [("file", filename, b"%PDF\x00\xff", "application/pdf")])
    want = httpx.Request("POST", "http://x/", data={"configuration": config},
                         files={"file": (filename, b"%PDF\x00\xff", "application/pdf")})
    want_body = want.read()
    want_boundary = want.headers["content-type"].split("boundary=")[1]
    boundary = ctype.split("boundary=")[1]
    assert ctype.split(";")[0] == want.headers["content-type"].split(";")[0]
    assert body.replace(boundary.encode(), b"B") == want_body.replace(want_boundary.encode(), b"B")
