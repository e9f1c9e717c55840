"""The port's daemon (``semtools_tpu_torch/daemon.py``) and read coalescing
(``store/coalesce.py``): the cases of the JAX package's
``tests/test_daemon.py`` and ``tests/test_coalesce.py`` that concern the port,
on the CPU (``SEMTOOLS_TORCH_DEVICE=cpu``).

Forwarded and coalesced outputs must equal the same command run directly
(byte for byte: the same process, model and store). Every test uses its own
``SEMTOOLS_TPU_DAEMON_DIR``; socket waits are seconds and every thread join
has a timeout, so nothing can hang.
"""

from __future__ import annotations

import io
import json
import os
import socket as _socket
import stat
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from semtools_tpu import daemon as jax_daemon
from semtools_tpu_torch import cli as torch_cli
from semtools_tpu_torch import daemon
from semtools_tpu_torch.store import coalesce, device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

REPO = Path(__file__).resolve().parent.parent
DOC = "first line about cats\nsecond line about databases\nthird line about rivers\n"

pytestmark = pytest.mark.skipif(not daemon.supported(), reason="daemon requires unix sockets")


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_DIR", str(tmp_path / "run"))
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("SEMTOOLS_WORKSPACE", raising=False)
    # serve() turns forwarding off and coalescing on for its process:
    # restored after each test
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "auto")
    monkeypatch.setattr(coalesce, "_enabled", False)
    monkeypatch.setattr(coalesce, "_stats", [0, 0])
    monkeypatch.setattr(coalesce, "_open", {})
    device_cache.invalidate()
    yield tmp_path
    device_cache.invalidate()


@pytest.fixture()
def running_daemon(env):
    t = threading.Thread(target=daemon.serve, kwargs={"warm": False}, daemon=True)
    t.start()
    for _ in range(200):
        if daemon.ping():
            break
        time.sleep(0.05)
    else:
        pytest.fail("daemon did not start")
    yield env
    daemon.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _direct(argv, capsys, monkeypatch, stdin=""):
    """(exit, stdout) of the same command run in this process, unforwarded."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    rc = torch_cli.main(argv)
    return rc, capsys.readouterr().out


def _forwarded(argv, capsys, stdin=None):
    capsys.readouterr()
    rc = daemon.forward(argv, stdin)
    return rc, capsys.readouterr().out


# -- transport and protocol --------------------------------------------------------


def test_socket_is_the_ports_own(running_daemon, monkeypatch):
    """The JAX CLI and native client forward to daemon.sock; the port's
    daemon listens elsewhere, so neither package runs the other's commands."""
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "auto")  # a client's view
    assert daemon.socket_path().name == "daemon-torch.sock"
    assert daemon.socket_path().parent == jax_daemon.socket_path().parent
    assert daemon.socket_path() != jax_daemon.socket_path()
    assert daemon.ping() and not jax_daemon.ping()
    assert not jax_daemon.should_forward(["search", "x"])  # auto: no daemon.sock
    assert daemon.should_forward(["search", "x"])


def test_socket_permissions(running_daemon):
    path = daemon.socket_path()
    assert stat.S_IMODE(os.stat(path.parent).st_mode) == 0o700
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600


def test_forward_matches_direct(running_daemon, capsys, monkeypatch):
    f = running_daemon / "doc.txt"
    f.write_text(DOC)
    qf = running_daemon / "q.txt"
    qf.write_text("databases\ncats\n")
    for argv, stdin in (
        (["search", "databases", str(f), "--top-k", "1", "-n", "0"], None),
        (["search", "databases", str(f), "--top-k", "2", "-j"], None),
        (["search", "beta", "-n", "0"], "alpha\nbeta\n"),  # stdin mode
        (["search", "-Q", str(qf), str(f), "--top-k", "1", "-n", "0"], None),
        (["search", "-Q", "-", str(f), "--top-k", "1", "-n", "0"], "databases\n"),
    ):
        rc, out = _forwarded(argv, capsys, stdin)
        assert (rc, out) == _direct(argv, capsys, monkeypatch, stdin or "")
        assert rc == 0 and out
    assert "# query: databases" in out
    assert _forwarded(["search", "q"], capsys)[0] == 1  # no input at all


def test_no_daemon_returns_none(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_DIR", str(tmp_path / "empty"))
    assert daemon.forward(["search", "x"], None) is None
    assert not daemon.ping() and not daemon.stop()


def test_should_forward_rules(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    assert not daemon.should_forward(["search", "x"])
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "always")
    assert daemon.should_forward(["search", "x"])
    assert not daemon.should_forward(["daemon", "status"])  # never self-forward
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "auto")
    assert not daemon.should_forward(["search", "x"])  # no socket in auto


def test_env_forwarding_allowlist():
    for key in ("SEMTOOLS_WORKSPACE", "SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TORCH_DEVICE",
                "OPENAI_API_KEY", "HOME"):
        assert daemon._env_key_forwardable(key)
    for key in ("SEMTOOLS_TPU_DAEMON", "SEMTOOLS_TPU_DAEMON_DIR", "LD_PRELOAD", "PATH"):
        assert not daemon._env_key_forwardable(key)


def test_semtools_env_scoped_per_request(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")  # stale daemon state
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")  # the device it was started on
    seen = {}

    def fake_main(argv):
        seen["int8"] = os.environ.get("SEMTOOLS_TPU_STORE_INT8")
        seen["model"] = os.environ.get("SEMTOOLS_TPU_MODEL")
        seen["device"] = os.environ.get("SEMTOOLS_TORCH_DEVICE")
        return 0

    monkeypatch.setattr(torch_cli, "main", fake_main)
    resp = daemon._run_command({"argv": ["workspace", "status"],
                                "env": {"SEMTOOLS_TPU_MODEL": "m1", "LD_PRELOAD": "/evil.so"}})
    assert resp["exit"] == 0
    # a request that names no device runs on the daemon's
    assert seen == {"int8": None, "model": "m1", "device": "cpu"}
    assert os.environ["SEMTOOLS_TPU_STORE_INT8"] == "1"  # restored
    assert "SEMTOOLS_TPU_MODEL" not in os.environ and "LD_PRELOAD" not in os.environ
    resp = daemon._run_command({"argv": ["workspace", "status"],
                                "env": {"SEMTOOLS_TORCH_DEVICE": "meta"}})
    assert resp["exit"] == 0 and seen["device"] == "meta"  # one that names one, on its own
    assert os.environ["SEMTOOLS_TORCH_DEVICE"] == "cpu"


def test_busy_daemon_answers_instead_of_queueing(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_BUSY_WAIT_S", "0.05")
    assert daemon._gate.acquire_writer(timeout=1)
    try:
        assert daemon._run_command({"argv": ["--version"]}) == {"busy": True}
        assert daemon._run_command({"argv": ["search", "q"]}) == {"busy": True}
    finally:
        daemon._gate.release_writer()
    resp = daemon._run_command({"argv": ["--version"]})
    assert resp.get("exit") == 0 and "semtools" in resp["stdout"]
    seen = {}
    monkeypatch.setattr(daemon, "_request",
                        lambda obj, timeout=0: seen.update(timeout=timeout) or {"busy": True})
    assert daemon.forward(["workspace", "status"], None) is None  # runs locally
    assert seen["timeout"] == 4 * 3600.0  # one long cap for every forwarded command


def _raw_request(payload: bytes) -> dict:
    with _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM) as s:
        s.settimeout(10.0)
        s.connect(str(daemon.socket_path()))
        s.sendall(payload)
        s.shutdown(_socket.SHUT_WR)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def test_malformed_requests_get_clean_replies(running_daemon, monkeypatch):
    for payload in (b"[1, 2, 3]\n", b'"ping"\n', b"42\n", b'{"op": "\xff\xfe"}\n'):
        assert _raw_request(payload)["exit"] == 2
    for req in ({"argv": "search q"}, {"argv": [1, 2]}, {"argv": ["-V"], "env": ["x"]},
                {"argv": ["-V"], "env": {"SEMTOOLS_X": 7}}, {"argv": ["-V"], "cwd": 5},
                {"argv": ["-V"], "stdin": 9}):
        assert _raw_request(json.dumps(req).encode() + b"\n").get("exit") == 2, req
    body = json.dumps({"op": "ping"}).encode()
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_MAX_REQUEST", str(len(body)))  # exactly at the cap
    assert _raw_request(body + b"\n").get("ok") is True
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_MAX_REQUEST", str(len(body) - 1))
    resp = _raw_request(body + b"\n")
    assert resp.get("too_large") is True and "exit" not in resp
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_MAX_REQUEST", "1024")
    assert daemon.forward(["search", "q"], stdin_text="y" * 4096) is None
    assert daemon.ping()


# -- the reader/writer gate ----------------------------------------------------------


def test_read_only_classification():
    assert daemon._read_only(["search", "q", "f.txt"])
    assert daemon._read_only(["workspace", "status", "-j"])
    for argv in (["workspace", "compact"], ["workspace", "use", "w"], ["workspace", "prune"],
                 ["daemon", "status"], ["--version"], []):
        assert not daemon._read_only(argv)


def test_gate_contexts(tmp_path, monkeypatch):
    gate = daemon._Gate()
    other = tmp_path / "other"
    other.mkdir()
    monkeypatch.setenv("SEMTOOLS_GATE_PROBE", "daemon-value")
    start_cwd = os.getcwd()
    ctx = {"SEMTOOLS_GATE_PROBE": "client"}
    assert gate.acquire_reader(str(tmp_path), ctx, timeout=1)
    assert os.getcwd() == str(tmp_path) and os.environ["SEMTOOLS_GATE_PROBE"] == "client"
    assert gate.acquire_reader(str(tmp_path), ctx, timeout=0.05)  # same ctx joins
    assert not gate.acquire_reader(str(other), ctx, timeout=0.05)
    assert not gate.acquire_reader(str(tmp_path), {}, timeout=0.05)
    assert not gate.acquire_writer(timeout=0.05)
    gate.release_reader()
    assert os.environ["SEMTOOLS_GATE_PROBE"] == "client"  # one reader remains
    gate.release_reader()
    assert os.getcwd() == start_cwd and os.environ["SEMTOOLS_GATE_PROBE"] == "daemon-value"
    assert gate.acquire_writer(timeout=1)
    assert not gate.acquire_reader(str(tmp_path), {}, timeout=0.05)
    gate.release_writer()


def test_concurrent_searches_truly_overlap(running_daemon, monkeypatch):
    """Two forwarded searches are inside command execution at the same
    instant (a barrier in a stubbed main), each reading only its own
    captured output."""
    barrier = threading.Barrier(2, timeout=10)
    real_main = torch_cli.main

    def barrier_main(argv):
        if argv and argv[0] == "search":
            barrier.wait()
            print(f"served {argv[1]}")
            return 0
        return real_main(argv)

    monkeypatch.setattr(torch_cli, "main", barrier_main)
    results = [None, None]

    def one(i):
        results[i] = daemon._request({"argv": ["search", f"q{i}"], "stdin": None,
                                      "cwd": str(running_daemon), "env": {}}, timeout=30)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i, resp in enumerate(results):
        assert resp is not None and resp["exit"] == 0 and resp["stdout"] == f"served q{i}\n"


def test_connection_burst_waits_in_the_backlog(running_daemon, monkeypatch):
    """Clients that connect while the accept loop is held up wait in the
    listen backlog: a client with a timeout whose connect finds the backlog
    full gets EAGAIN at once, and forwarding then runs the command locally.
    The loop is stalled after its first accept, 32 clients connect, and each
    gets the daemon's answer once it goes on."""
    n = 32
    release, stalled = threading.Event(), threading.Event()
    real_verify = daemon._Server.verify_request

    def stall_once(self, request, client_address):
        if not stalled.is_set():
            stalled.set()
            release.wait(timeout=30)
        return real_verify(self, request, client_address)

    monkeypatch.setattr(daemon._Server, "verify_request", stall_once)
    first = threading.Thread(target=daemon.ping)
    first.start()
    assert stalled.wait(timeout=10)
    results = [None] * n

    def one(i):
        results[i] = daemon._request({"op": "ping"}, timeout=30)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    time.sleep(0.5)  # every connect has landed in the backlog, or failed
    release.set()
    for t in [first, *threads]:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in [first, *threads])
    assert all(r is not None and r.get("ok") for r in results), results


def test_concurrent_real_searches_end_to_end(running_daemon):
    results = [None] * 6

    def one(i):
        results[i] = daemon._request({
            "argv": ["search", "database", "--top-k", "1", "-n", "0"], "stdin": DOC,
            "cwd": str(running_daemon), "env": {"SEMTOOLS_TORCH_DEVICE": "cpu"},
        }, timeout=60)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len({json.dumps(r) for r in results}) == 1
    assert results[0]["exit"] == 0 and "<stdin>" in results[0]["stdout"]
    assert "databases" in results[0]["stdout"]


# -- workspace searches through the daemon ---------------------------------------------


def _workspace(root, capsys, monkeypatch, n_files=4):
    files = []
    for i in range(n_files):
        p = root / f"doc{i}.txt"
        p.write_text("\n".join(f"line {j} of file {i} about {w}" for j, w in enumerate(
            ["databases", "foxes", "rivers", "queries", "kernels"] * 8)) + "\n")
        files.append(str(p))
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "ws")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")
    assert _direct(["workspace", "use", "ws"], capsys, monkeypatch)[0] == 0
    return files


def test_workspace_search_edit_and_coalescing(running_daemon, capsys, monkeypatch):
    """Forwarded workspace searches equal the direct ones; after an edit the
    daemon's cached corpus is patched, not rebuilt; concurrent clients with
    different queries coalesce into one scan and each gets its direct
    answer."""
    files = _workspace(running_daemon, capsys, monkeypatch)
    argv = ["search", "rivers of file 2", *files, "--top-k", "3", "-j"]
    rc, out = _forwarded(argv, capsys)
    assert rc == 0 and json.loads(out)["results"]
    assert (rc, out) == _direct(argv, capsys, monkeypatch)

    builds = []
    real_build = patch_cache._build
    monkeypatch.setattr(patch_cache, "_build",
                        lambda *a, **k: builds.append(1) or real_build(*a, **k))
    lines = Path(files[1]).read_text().split("\n")
    lines[3] = "a brand new line about foxes in rivers"
    Path(files[1]).write_text("\n".join(lines))
    argv = ["search", "foxes in rivers", *files, "--top-k", "3", "-j"]
    rc, out = _forwarded(argv, capsys)
    assert rc == 0 and not builds  # patched, not rebuilt
    hit = json.loads(out)["results"][0]
    assert (hit["filename"], hit["match_line_number"]) == (files[1], 3)
    assert (rc, out) == _direct(argv, capsys, monkeypatch)

    queries = [f"{w} of file {i}" for i, w in enumerate(["foxes", "rivers", "kernels"] * 2)]
    want = [_direct(["search", q, *files, "--top-k", "3", "-j"], capsys, monkeypatch)
            for q in queries]
    env = {k: v for k, v in os.environ.items() if daemon._env_key_forwardable(k)}
    env["SEMTOOLS_TPU_COALESCE_WINDOW_MS"] = "400"
    got = [None] * len(queries)

    def one(i):
        got[i] = daemon._request({"argv": ["search", queries[i], *files, "--top-k", "3", "-j"],
                                  "stdin": None, "cwd": os.getcwd(), "env": env}, timeout=60)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert [(r["exit"], r["stdout"]) for r in got] == want
    merged, merged_queries = coalesce.stats()
    assert merged >= 1 and merged_queries >= 2


def test_forwarding_client_never_imports_torch(running_daemon, capsys, monkeypatch):
    """A forwarded command runs in a client that imports no torch (and no
    jax): what makes it cheap."""
    f = running_daemon / "doc.txt"
    f.write_text(DOC)
    argv = ["search", "databases", str(f), "--top-k", "2", "-n", "0"]
    script = (
        "import sys\n"
        "from semtools_tpu_torch.cli import main\n"
        f"rc = main({argv!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'numpy'))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    child_env = dict(os.environ, PYTHONPATH=str(REPO), SEMTOOLS_TPU_DAEMON="auto")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(running_daemon),
                          env=child_env, capture_output=True, text=True,
                          stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _direct(argv, capsys, monkeypatch)[1]


def test_cli_daemon_status_and_stop(running_daemon, capsys, monkeypatch):
    rc, out = _direct(["daemon", "status"], capsys, monkeypatch)
    assert rc == 0 and "Daemon running" in out and "daemon-torch.sock" in out
    rc, out = _direct(["daemon", "stop"], capsys, monkeypatch)
    assert rc == 0 and "Daemon stopped." in out
    for _ in range(100):
        if not daemon.ping():
            break
        time.sleep(0.05)
    rc, out = _direct(["daemon", "status"], capsys, monkeypatch)
    assert rc == 0 and "No daemon running." in out


def test_warm_builds_the_active_workspace_corpus(env, capsys, monkeypatch):
    """_warm puts the model on the device and builds the active workspace's
    slot corpus; it never creates a store for a fresh workspace."""
    files = _workspace(env, capsys, monkeypatch)
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "fresh")
    assert _direct(["workspace", "use", "fresh"], capsys, monkeypatch)[0] == 0
    daemon._warm()
    from semtools_tpu_torch.store import Workspace

    assert not (Path(Workspace.open("fresh").config.root_dir) / "store.sqlite").exists()
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "ws")
    assert _direct(["search", "foxes", *files, "--top-k", "1"], capsys, monkeypatch)[0] == 0
    device_cache.invalidate()
    daemon._warm()
    with Store(Workspace.open("ws").config.root_dir, device="cpu") as store:
        assert patch_cache.is_warm(store, "int8")


# -- coalescing (store/coalesce.py) ------------------------------------------------------


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture()
def coalesced_store(tmp_path, monkeypatch):
    monkeypatch.setattr(coalesce, "_enabled", True)
    monkeypatch.setattr(coalesce, "_stats", [0, 0])
    monkeypatch.setattr(coalesce, "_open", {})
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    device_cache.invalidate()
    s = Store(str(tmp_path / "ws"), dim=32, device="cpu")
    rows = _unit(np.random.default_rng(5), 400, 32)
    s.upsert_document_lines("/a.txt", rows[:200])
    s.upsert_document_lines("/b.txt", rows[200:])
    yield s
    s.close()
    device_cache.invalidate()


def _race(tmp_path, n, fn):
    """Run fn(i, store) in n threads, each with its own Store; (results, errors)."""
    results, errors = [None] * n, [None] * n

    def worker(i):
        try:
            st = Store(str(tmp_path / "ws"), dim=32, device="cpu")
            try:
                results[i] = fn(i, st)
            finally:
                st.close()
        except Exception as e:  # noqa: BLE001 - collected and asserted on
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def _hits(rows):
    return [(r.path, r.line_number, r.distance) for r in rows]


def test_concurrent_searches_merge_and_match_direct(coalesced_store, tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_COALESCE_WINDOW_MS", "200")
    s, paths = coalesced_store, ["/a.txt", "/b.txt"]
    qs = _unit(np.random.default_rng(9), 6, 32)
    want = [s._search_batched_retry(qs[i : i + 1], paths, 5) for i in range(6)]
    calls = []
    real = Store._search_batched_retry

    def counting(self, q, p, k, md=None):
        calls.append(q.shape[0])
        return real(self, q, p, k, md)

    monkeypatch.setattr(Store, "_search_batched_retry", counting)
    got, errors = _race(tmp_path, 6, lambda i, st: st.search_line_embeddings_batched(
        qs[i : i + 1], paths, 5))
    assert errors == [None] * 6
    assert calls == [6] and coalesce.stats() == (1, 6)  # one scan of all six rows
    for i in range(6):
        assert [(h[0], h[1]) for h in _hits(got[i][0])] == [(h[0], h[1]) for h in _hits(want[i][0])]
        np.testing.assert_allclose([h[2] for h in _hits(got[i][0])],
                                   [h[2] for h in _hits(want[i][0])], atol=1e-6, rtol=0)


def test_different_shapes_do_not_merge(coalesced_store, tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_COALESCE_WINDOW_MS", "60")
    s = coalesced_store
    q = _unit(np.random.default_rng(11), 1, 32)
    shapes = [(["/a.txt"], 3, None), (["/b.txt"], 3, None),
              (["/a.txt", "/b.txt"], 5, None), (["/a.txt", "/b.txt"], 5, 0.9)]
    want = [s._search_batched_retry(q, p, k, md) for p, k, md in shapes]
    got, errors = _race(tmp_path, len(shapes), lambda i, st: st.search_line_embeddings_batched(
        q, *shapes[i]))
    assert errors == [None] * len(shapes) and coalesce.stats()[0] == 0
    for g, w in zip(got, want):
        assert [(h[0], h[1], round(h[2], 6)) for h in _hits(g[0])] == \
            [(h[0], h[1], round(h[2], 6)) for h in _hits(w[0])]


def test_leader_error_falls_back_per_follower(coalesced_store, tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_COALESCE_WINDOW_MS", "200")
    s, paths = coalesced_store, ["/a.txt", "/b.txt"]
    qs = _unit(np.random.default_rng(13), 3, 32)
    real = Store._search_batched_retry
    state = {"first": True}

    def flaky(self, q, p, k, md=None):
        if state["first"] and q.shape[0] > 1:
            state["first"] = False
            raise RuntimeError("injected leader fault")
        return real(self, q, p, k, md)

    monkeypatch.setattr(Store, "_search_batched_retry", flaky)
    got, errors = _race(tmp_path, 3, lambda i, st: st.search_line_embeddings_batched(
        qs[i : i + 1], paths, 4))
    assert sum(e is not None for e in errors) == 1  # only the leader sees its fault
    want = real(s, qs, paths, 4)
    for i in range(3):
        if errors[i] is None:
            assert [(h[0], h[1]) for h in _hits(got[i][0])] == [(h[0], h[1]) for h in _hits(want[i])]
