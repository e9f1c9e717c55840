"""Daemon mode: a resident process that keeps the card warm across CLI calls.

Counterpart of ``semtools_tpu/daemon.py``. A ``semtools`` command is a new
process: it pays Python and torch start-up, CUDA context creation, the model
upload, loading the kernel library and, in workspace mode, the slot-corpus
build. The daemon pays those once and runs commands in-process; its cached
slot corpora are patched across edits (``store/patch_cache.py``) and its
concurrent read-only searches coalesce into one scan (``store/coalesce.py``).

Protocol: newline-delimited JSON over a unix socket,
``$SEMTOOLS_TPU_DAEMON_DIR/daemon-torch.sock`` (default ``~/.semtools``), a
name of its own so that the JAX package's CLI and native client, which
forward to ``daemon.sock``, never reach this package's daemon:

    -> {"argv": [...], "stdin": "..."|null, "cwd": "...", "env": {...}}
    <- {"stdout": "...", "stderr": "...", "exit": 0}

The client is transparent: ``python -m semtools_tpu_torch.cli`` forwards to a
running daemon when ``SEMTOOLS_TPU_DAEMON=1`` (or ``auto`` and the socket
exists), before it imports torch. Start one with ``semtools daemon start``
(foreground: ``daemon run``).

Mutating commands run one at a time under an exclusive gate. Read-only
commands (``search``, ``workspace status``) run concurrently when they share
an execution context (cwd + forwarded env). All of a request's device work
runs in its handler thread on the default CUDA stream, so launches from
different requests are ordered on one stream (the kernels' self-resetting
counters rely on that). Output is captured, so TTY highlighting is off.

This module imports no torch: the client side (:func:`should_forward`,
:func:`forward`) runs before anything else of the port is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import socketserver
import sys
import threading
import time
from pathlib import Path
from typing import Optional

_SOCK_NAME = "daemon-torch.sock"


def supported() -> bool:
    """Unix sockets with POSIX permission semantics (serve() relies on
    chmod-based owner-only access); elsewhere every command runs locally."""
    return os.name == "posix" and hasattr(socket, "AF_UNIX")


def socket_path() -> Path:
    base = os.environ.get("SEMTOOLS_TPU_DAEMON_DIR") or os.path.join(
        os.path.expanduser("~"), ".semtools"
    )
    return Path(base) / _SOCK_NAME


# -- server -----------------------------------------------------------------


def _read_only(argv) -> bool:
    """Commands that never need the exclusive gate: ``search`` (its
    incremental upsert is safe under concurrent writers: the store's flock,
    copy-on-write upserts and generation-keyed device caches) and
    ``workspace status``. Everything else (``parse``, ``ask``, ``workspace
    index|compact|prune|use``) stays exclusive."""
    if argv and argv[0] == "search":
        return True
    return len(argv) >= 2 and argv[0] == "workspace" and argv[1] == "status"


def _install_ctx(cwd, env_overrides):
    """Apply a request's cwd + env to the process; returns restore state.

    Called only while no other command is mid-flight (the gate guarantees
    it), so os.environ is the daemon's own at that instant: every
    forwardable SEMTOOLS_* variable set there but absent from the request is
    unset for the command's duration (the request env is authoritative for
    that namespace). The one exception is ``SEMTOOLS_TORCH_DEVICE``: absent
    from the request, the command runs on the device the daemon was started
    on (``daemon run --device``), which holds its warm state."""
    effective = dict(env_overrides)
    for k in list(os.environ):
        if (k.startswith("SEMTOOLS_") and k not in effective and _env_key_forwardable(k)
                and k != "SEMTOOLS_TORCH_DEVICE"):
            effective[k] = None
    saved_cwd = os.getcwd()
    saved_env = {k: os.environ.get(k) for k in effective}
    if cwd:
        os.chdir(cwd)
    for k, v in effective.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved_cwd, saved_env


def _restore_ctx(state) -> None:
    saved_cwd, saved_env = state
    os.chdir(saved_cwd)
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


class _Gate:
    """Reader/writer gate with execution-context matching.

    Readers share the gate when their context (cwd, env overrides) is
    identical: the first reader in installs it, the last one out restores
    the daemon's own. A reader with another context waits like a writer;
    writers are exclusive. Acquisition is bounded by the busy wait: a
    caller that cannot start in time gets ``{"busy": true}`` and runs
    locally."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._ctx = None
        self._saved = None

    def acquire_reader(self, cwd, env_overrides, timeout: float) -> bool:
        ctx = (cwd or None, tuple(sorted(env_overrides.items())))
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._writer or (self._readers > 0 and self._ctx != ctx):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            if self._readers == 0:
                self._saved = _install_ctx(cwd, env_overrides)
                self._ctx = ctx
            self._readers += 1
            return True

    def release_reader(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                _restore_ctx(self._saved)
                self._saved = None
                self._ctx = None
            self._cond.notify_all()

    def acquire_writer(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._writer or self._readers > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            self._writer = True
            return True

    def release_writer(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


_gate = _Gate()


class _StreamRouter:
    """sys.stdout/stderr/stdin shim routing per-thread capture buffers.

    Concurrent readers each push their own StringIO; a thread without one
    writes to the underlying stream. Attribute access delegates to the
    calling thread's target, so a captured command sees StringIO semantics
    (``isatty()`` False)."""

    def __init__(self, fallback) -> None:
        self._fallback = fallback
        self._local = threading.local()

    def _target(self):
        return getattr(self._local, "stream", None) or self._fallback

    def push(self, stream) -> None:
        self._local.stream = stream

    def pop(self) -> None:
        self._local.stream = None

    def write(self, s):
        return self._target().write(s)

    def read(self, *a):
        return self._target().read(*a)

    def readline(self, *a):
        return self._target().readline(*a)

    def flush(self):
        return self._target().flush()

    def __getattr__(self, name):
        return getattr(self._target(), name)

    def __iter__(self):
        return iter(self._target())


_routers_lock = threading.Lock()
_routers = None


def _ensure_routers():
    """Install the stream routers (idempotent, thread-safe), re-installing
    any displaced since (pytest's capture does that between tests) with the
    displacing stream as the new fallback."""
    global _routers
    with _routers_lock:
        if _routers is None:
            _routers = (_StreamRouter(sys.stdout), _StreamRouter(sys.stderr),
                        _StreamRouter(sys.stdin))
        r_out, r_err, r_in = _routers
        if sys.stdout is not r_out:
            r_out._fallback = sys.stdout
            sys.stdout = r_out
        if sys.stderr is not r_err:
            r_err._fallback = sys.stderr
            sys.stderr = r_err
        if sys.stdin is not r_in:
            r_in._fallback = sys.stdin
            sys.stdin = r_in
        return _routers


def _busy_wait_s() -> float:
    """How long a forwarded command queues behind running ones before the
    daemon answers ``{"busy": true}`` and the client runs it locally (the
    daemon never started it, so nothing is duplicated)."""
    try:
        return float(os.environ.get("SEMTOOLS_TPU_DAEMON_BUSY_WAIT_S", "10"))
    except ValueError:
        return 10.0


def _max_request_bytes() -> int:
    """One-line request size cap: any local process can open the socket, so
    an endless line must not grow the daemon's heap without bound."""
    try:
        return int(os.environ.get("SEMTOOLS_TPU_DAEMON_MAX_REQUEST", str(64 << 20)))
    except ValueError:
        return 64 << 20


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one request per connection
        cap = _max_request_bytes()
        line = self.rfile.readline(cap + 2)
        if not line:
            return
        if len(line.rstrip(b"\n")) > cap:
            # no "exit" key: the client runs the command locally
            self._reply({"too_large": True})
            return
        try:
            req = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
            self._reply({"stdout": "", "stderr": "daemon: bad request\n", "exit": 2})
            return
        if not isinstance(req, dict):
            self._reply({"stdout": "", "stderr": "daemon: bad request\n", "exit": 2})
            return
        if req.get("op") == "ping":
            self._reply({"ok": True, "pid": os.getpid()})
            return
        if req.get("op") == "stop":
            self._reply({"ok": True})
            threading.Thread(target=self.server.shutdown, daemon=True).start()
            return
        self._reply(_run_command(req))

    def _reply(self, obj) -> None:
        self.wfile.write(json.dumps(obj).encode() + b"\n")


def _env_key_forwardable(key: str) -> bool:
    """Server-side allowlist for client env overrides: the SEMTOOLS_*
    namespace except the daemon's own control knobs (a client override of
    SEMTOOLS_TPU_DAEMON could make in-daemon commands forward to the daemon),
    plus the API credentials and HOME."""
    if key in ("SEMTOOLS_TPU_DAEMON", "SEMTOOLS_TPU_DAEMON_DIR"):
        return False
    if key.startswith("SEMTOOLS_"):
        return True
    return key in ("OPENAI_API_KEY", "OPENAI_BASE_URL", "LLAMA_CLOUD_API_KEY", "HOME")


def _exit_code(e: SystemExit) -> int:
    return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)


def _run_command(req) -> dict:
    from semtools_tpu_torch.cli import main as cli_main

    argv = req.get("argv") or []
    stdin_text = req.get("stdin")
    cwd = req.get("cwd")
    env_in = req.get("env") or {}
    # Shape-check before anything runs: a malformed request gets a clean
    # reply, not a dead handler thread.
    if (
        not isinstance(argv, list)
        or not all(isinstance(a, str) for a in argv)
        or not isinstance(stdin_text, (str, type(None)))
        or not isinstance(cwd, (str, type(None)))
        or not isinstance(env_in, dict)
        or not all(
            isinstance(k, str) and isinstance(v, (str, type(None))) for k, v in env_in.items()
        )
    ):
        return {"stdout": "", "stderr": "daemon: bad request\n", "exit": 2}
    env_overrides = {k: v for k, v in env_in.items() if _env_key_forwardable(k)}

    if _read_only(argv):
        return _run_reader(argv, stdin_text, cwd, env_overrides)

    if not _gate.acquire_writer(timeout=_busy_wait_s()):
        return {"busy": True}
    try:
        ctx_state = _install_ctx(cwd, env_overrides)
        out, err = io.StringIO(), io.StringIO()
        try:
            stdin = io.StringIO(stdin_text if stdin_text is not None else "")
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                old_stdin = sys.stdin
                sys.stdin = stdin
                try:
                    code = cli_main(argv)
                finally:
                    sys.stdin = old_stdin
        except SystemExit as e:
            code = _exit_code(e)
        except Exception as e:  # noqa: BLE001 - never kill the daemon on a command error
            err.write(f"Error: {e}\n")
            code = 1
        finally:
            _restore_ctx(ctx_state)
        return {"stdout": out.getvalue(), "stderr": err.getvalue(), "exit": code}
    finally:
        _gate.release_writer()


def _run_reader(argv, stdin_text, cwd, env_overrides) -> dict:
    """A read-only command under the shared side of the gate, captured
    through the thread-local stream routers."""
    from semtools_tpu_torch.cli import main as cli_main

    if not _gate.acquire_reader(cwd, env_overrides, timeout=_busy_wait_s()):
        return {"busy": True}
    try:
        r_out, r_err, r_in = _ensure_routers()
        out, err = io.StringIO(), io.StringIO()
        r_out.push(out)
        r_err.push(err)
        r_in.push(io.StringIO(stdin_text if stdin_text is not None else ""))
        try:
            code = cli_main(argv)
        except SystemExit as e:
            code = _exit_code(e)
        except Exception as e:  # noqa: BLE001 - never kill the daemon on a command error
            err.write(f"Error: {e}\n")
            code = 1
        finally:
            r_out.pop()
            r_err.pop()
            r_in.pop()
        return {"stdout": out.getvalue(), "stderr": err.getvalue(), "exit": code}
    finally:
        _gate.release_reader()


class _Server(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True
    # The listen backlog. socketserver's default is 5, and an agent lands
    # many searches at once: a client that connects with a timeout gets
    # EAGAIN, not a wait, when the backlog is full, and runs locally.
    request_queue_size = socket.SOMAXCONN


def serve(warm: bool = True) -> None:
    """Run the daemon in the foreground until stopped."""
    if not supported():
        raise RuntimeError(
            "the semtools daemon requires unix sockets and is unsupported "
            "on this platform; commands run locally without it"
        )
    # Commands executed inside the daemon must never forward to the daemon.
    os.environ["SEMTOOLS_TPU_DAEMON"] = "off"
    path = socket_path()
    # The socket runs commands as this user with client-supplied cwd/env:
    # owner-only directory and socket, whatever the umask.
    path.parent.mkdir(parents=True, exist_ok=True, mode=0o700)
    os.chmod(path.parent, 0o700)
    if path.exists():
        path.unlink()
    # The mesh is this process's: fixed now, so a request's
    # SEMTOOLS_TORCH_VIRTUAL_DEVICES cannot re-shape it.
    from semtools_tpu_torch.parallel.mesh import virtual_devices

    virtual_devices()
    if warm:
        _warm()
    from semtools_tpu_torch.store import coalesce

    coalesce.enable()
    with _Server(str(path), _Handler) as server:
        os.chmod(path, 0o600)
        print(f"semtools daemon listening on {path}", file=sys.stderr)
        try:
            server.serve_forever()
        finally:
            with contextlib.suppress(OSError):
                path.unlink()


def _warm() -> None:
    """Prepare the device before listening, so the first forwarded search
    pays none of it: the model's table on the device
    (``SEMTOOLS_TORCH_DEVICE``, else cuda), the kernel library loaded (``nvcc``
    builds it on a fresh checkout), and, when a workspace is active, its slot
    corpus built on the device."""
    try:
        from semtools_tpu_torch.models.static_model import MODEL_NAME, load_model
        from semtools_tpu_torch.utils.platform import resolve_device

        device = resolve_device()
        model = load_model(os.environ.get("SEMTOOLS_TPU_MODEL", MODEL_NAME), device=device)
        q = model.encode_single("warmup").cpu().numpy()
        if device.type == "cuda":
            from semtools_tpu_torch.ops import kernels

            kernels.library()
    except Exception as e:  # noqa: BLE001 - a failed warm-up leaves commands to load lazily
        print(f"daemon: warmup skipped ({e})", file=sys.stderr)
        return
    try:
        from semtools_tpu_torch.store import NoActiveWorkspace, Store, Workspace
        from semtools_tpu_torch.store.store import _DB_FILE

        try:
            ws = Workspace.open()
        except NoActiveWorkspace:
            return
        if not (Path(ws.config.root_dir) / _DB_FILE).exists():
            # A warm-up never CREATES a store: that would pin the default
            # dim before the first real search decides it from the model.
            return
        # Opened WITHOUT a model name: a name would invalidate rows stored
        # under another model, and a warm-up never mutates the store.
        with Store(ws.config.root_dir, device=device) as store:
            if store.dim != model.dim:
                print(f"daemon: workspace '{ws.config.name}' uses dim {store.dim} != model "
                      f"dim {model.dim}; not warmed", file=sys.stderr)
                return
            paths = store.get_all_document_paths()
            if paths:
                store.search_line_embeddings(q, paths, top_k=1)
                print(f"daemon: workspace '{ws.config.name}' corpus warmed "
                      f"({len(paths)} documents)", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - the corpus then builds at the first search
        print(f"daemon: workspace warm failed ({e})", file=sys.stderr)


# -- client -----------------------------------------------------------------


def _request(obj, timeout: float = 600.0) -> Optional[dict]:
    if not supported():
        return None
    path = socket_path()
    if not path.exists():
        return None
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(timeout)
            s.connect(str(path))
            s.sendall(json.dumps(obj).encode() + b"\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
        return json.loads(buf) if buf else None
    except (OSError, json.JSONDecodeError):
        return None


def ping() -> bool:
    resp = _request({"op": "ping"}, timeout=5.0)
    return bool(resp and resp.get("ok"))


def stop() -> bool:
    resp = _request({"op": "stop"}, timeout=5.0)
    return bool(resp and resp.get("ok"))


# Client timeout for a forwarded command: uniformly long. A cold search over a
# large corpus can run for minutes; a shorter cap would make the client abandon
# the socket and re-run the same command locally while the daemon still runs
# it. Queueing behind a busy daemon is bounded separately ({"busy": true}).
_FORWARD_TIMEOUT_S = 4 * 3600.0


def forward(argv, stdin_text: Optional[str]) -> Optional[int]:
    """Run ``argv`` on the daemon; None if no daemon is reachable (or it is
    busy, or the request is too large), and the caller runs it locally."""
    if stdin_text is not None:
        # Don't ship a request the daemon will refuse: 12 bytes per char is
        # json.dumps' worst case; pay for an exact encode only near the cap.
        cap = _max_request_bytes() - 65536
        if len(stdin_text) * 12 > cap and len(json.dumps(stdin_text)) > cap:
            return None
    # The client's whole forwardable namespace; keys it has UNSET are unset
    # server-side too (see _install_ctx).
    env = {k: v for k, v in os.environ.items() if _env_key_forwardable(k)}
    for k in ("OPENAI_API_KEY", "OPENAI_BASE_URL", "LLAMA_CLOUD_API_KEY", "HOME"):
        env[k] = os.environ.get(k)
    resp = _request({"argv": list(argv), "stdin": stdin_text, "cwd": os.getcwd(), "env": env},
                    timeout=_FORWARD_TIMEOUT_S)
    if resp is None or "exit" not in resp:
        return None
    sys.stdout.write(resp.get("stdout", ""))
    sys.stderr.write(resp.get("stderr", ""))
    return int(resp["exit"])


def should_forward(argv) -> bool:
    """Forward when enabled and the command isn't daemon management."""
    if not supported():
        return False
    mode = os.environ.get("SEMTOOLS_TPU_DAEMON", "auto").lower()
    if mode in ("0", "off", "never", ""):
        return False
    if argv and argv[0] == "daemon":
        return False
    if mode in ("1", "on", "always"):
        return True
    return socket_path().exists()  # auto
