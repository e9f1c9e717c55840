"""The port's native daemon client (``semtools_tpu_torch/native/
semtools_client.cpp``, built by ``utils.native.build_client``) against the
port's daemon: the cases of ``test_native_client.py`` (protocol round trip,
stdin, unicode and surrogate escapes, a non-UTF-8 argv, the busy fallback,
exit codes, ``-j``, and the Python fallback with no daemon and for
``daemon`` commands), the client's output byte-equal to the Python client's
forwarded search, and its fallback exec'ing ``semtools_tpu_torch.cli`` (never
the JAX package's CLI) with the port's socket name.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from semtools_tpu_torch import daemon
from semtools_tpu_torch.utils import native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def client() -> Path:
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native client")
    return native.build_client()


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_DIR", str(tmp_path / "run"))
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("SEMTOOLS_TPU_PYTHON", sys.executable)
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.delenv("SEMTOOLS_TPU_DAEMON", raising=False)
    monkeypatch.delenv("SEMTOOLS_WORKSPACE", raising=False)
    return {**os.environ}


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
    yield
    assert daemon.stop()
    t.join(timeout=10)
    assert not t.is_alive()
    os.environ.pop("SEMTOOLS_TPU_DAEMON", None)  # serve() turns it off for itself


def _run(client, env, args, stdin_text=None):
    return subprocess.run([str(client), *args], input=stdin_text, capture_output=True,
                          text=True, env=env, timeout=120)


class TestAgainstDaemon:
    def test_search_roundtrip(self, client, env, running_daemon, tmp_path):
        f = tmp_path / "doc.txt"
        f.write_text("first line about cats\nsecond line about databases\n")
        argv = ["search", "databases", str(f), "--top-k", "1", "-n", "0"]
        r = _run(client, env, argv, stdin_text="")
        assert r.returncode == 0, r.stderr
        assert "doc.txt" in r.stdout and "databases" in r.stdout
        # byte-equal to the Python client's forwarded run of the same search
        py = subprocess.run([sys.executable, "-m", "semtools_tpu_torch.cli", *argv], input="",
                            capture_output=True, text=True, env=env, timeout=120)
        assert (py.returncode, py.stdout) == (r.returncode, r.stdout)

    def test_stdin_mode(self, client, env, running_daemon):
        r = _run(client, env, ["search", "beta", "-n", "0"], stdin_text="alpha\nbeta\n")
        assert r.returncode == 0, r.stderr
        assert "<stdin>" in r.stdout

    def test_unicode_and_surrogate_escapes(self, client, env, running_daemon, tmp_path):
        """json.dumps emits non-ASCII as \\uXXXX (astral characters as
        surrogate pairs): the client decodes them back to UTF-8 bytes."""
        f = tmp_path / "uni.txt"
        f.write_text("café résumé line\nemoji \U0001F600 line\nplain text line\n")
        r = _run(client, env, ["search", "plain", str(f), "--top-k", "3", "-n", "3"],
                 stdin_text="")
        assert r.returncode == 0, r.stderr
        assert "café" in r.stdout
        assert "\U0001F600" in r.stdout

    def test_non_utf8_argv_roundtrip(self, client, env, running_daemon, tmp_path):
        """A latin-1 file name (a raw 0xE9 byte) reaches the daemon as the
        surrogateescape \\udcXX escape the Python client sends, and comes back
        as the raw byte."""
        f = tmp_path / os.fsdecode(b"caf\xe9.txt")
        f.write_text("alpha line\nbeta line\n")
        r = subprocess.run(
            [str(client), "search", "beta", str(f), "--top-k", "1", "-n", "0"],
            input=b"", capture_output=True, env=env, timeout=120,
        )
        assert r.returncode == 0, r.stderr
        assert b"beta" in r.stdout
        assert b"caf\xe9.txt" in r.stdout

    def test_busy_daemon_falls_back_to_local_run(self, client, env, running_daemon,
                                                 monkeypatch):
        """With the daemon mid-command the client gets the bounded busy reply
        and runs the command locally instead of queueing."""
        monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_BUSY_WAIT_S", "0.05")
        assert daemon._gate.acquire_writer(timeout=1)
        try:
            r = _run(client, env, ["search", "beta", "-n", "0"], stdin_text="alpha\nbeta\n")
        finally:
            daemon._gate.release_writer()
        assert r.returncode == 0, r.stderr
        assert "<stdin>" in r.stdout

    def test_exit_code_passthrough(self, client, env, running_daemon):
        r = _run(client, env, ["search", "q"], stdin_text="")
        assert r.returncode == 1
        assert "Error" in r.stderr

    def test_json_flag(self, client, env, running_daemon, tmp_path):
        f = tmp_path / "j.txt"
        f.write_text("alpha\nbeta\n")
        r = _run(client, env, ["search", "beta", str(f), "-j", "--top-k", "1"], stdin_text="")
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["results"]


class TestFallback:
    def test_no_daemon_runs_python(self, client, env, tmp_path):
        f = tmp_path / "doc.txt"
        f.write_text("x about cats\ny about databases\n")
        r = _run(client, env, ["search", "databases", str(f), "--top-k", "1", "-n", "0"],
                 stdin_text="")
        assert r.returncode == 0, r.stderr
        assert "databases" in r.stdout

    def test_no_daemon_refeeds_consumed_stdin(self, client, env):
        r = _run(client, env, ["search", "beta", "-n", "0"], stdin_text="alpha\nbeta\n")
        assert r.returncode == 0, r.stderr
        assert "<stdin>" in r.stdout

    def test_daemon_mgmt_always_python(self, client, env):
        r = _run(client, env, ["daemon", "status"], stdin_text="")
        assert "No daemon running" in r.stdout + r.stderr

    def test_fallback_execs_the_port_cli(self, client, env, tmp_path):
        """The fallback runs ``$SEMTOOLS_TPU_PYTHON -m semtools_tpu_torch.cli``
        with the arguments and the re-fed stdin, and the JAX package's socket
        (``daemon.sock``) is never reached, even when it exists."""
        record = tmp_path / "argv.json"
        fake = tmp_path / "fake-python"
        fake.write_text(f"#!{sys.executable}\n"
                        "import json, sys\n"
                        f"json.dump([sys.argv[1:], sys.stdin.read()], open({str(record)!r}, 'w'))\n")
        fake.chmod(0o755)
        run_dir = Path(env["SEMTOOLS_TPU_DAEMON_DIR"])
        run_dir.mkdir(parents=True)
        (run_dir / "daemon.sock").write_text("")  # the JAX package's socket name
        r = _run(client, {**env, "SEMTOOLS_TPU_PYTHON": str(fake)},
                 ["search", "beta", "-n", "0"], stdin_text="alpha\nbeta\n")
        assert r.returncode == 0, r.stderr
        argv, stdin = json.loads(record.read_text())
        assert argv == ["-m", "semtools_tpu_torch.cli", "search", "beta", "-n", "0"]
        assert stdin == "alpha\nbeta\n"
        assert b"semtools_tpu.cli" not in client.read_bytes()
