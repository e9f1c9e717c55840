"""The ``semtools`` command line of the PyTorch port.

Counterpart of ``semtools_tpu/cli.py``: the ``parse``, ``search``,
``workspace``, ``ask`` and ``daemon`` subcommands with the same flags,
defaults, text output and ``--json`` schemas, plus ``--device`` on
``search``, ``ask`` and ``daemon`` (default ``cuda``; see
:func:`semtools_tpu_torch.utils.platform.resolve_device`)::

    python -m semtools_tpu_torch.cli parse [-c CONFIG] [-b llama-parse|local] [-v] [-j] FILES...
    python -m semtools_tpu_torch.cli search QUERY [FILES...] [-n N] [--top-k K]
        [-m DIST] [-i] [-j] [-Q QUERIES_FILE] [-w WORKSPACE] [--model-path P]
        [--device D]
    python -m semtools_tpu_torch.cli ask QUERY [FILES...] [-c CONFIG] [--api-key K]
        [--base-url URL] [-m MODEL] [--api-mode chat|responses] [-j] [-w WORKSPACE]
        [--device D]
    python -m semtools_tpu_torch.cli workspace [-j] use|status|prune|compact [NAME]
    python -m semtools_tpu_torch.cli workspace [-j] index [NAME] [--force]
    python -m semtools_tpu_torch.cli daemon [run|start|stop|status] [--device D]

``search`` and ``ask`` run in workspace mode when ``-w`` or
``SEMTOOLS_WORKSPACE`` names a workspace (the JAX package's on-disk
workspaces, shared by both packages). When this package's daemon runs
(``daemon start``), every command but ``daemon`` is forwarded to it before
torch is imported (``SEMTOOLS_TPU_DAEMON=off`` runs it here). ``parse``,
and ``ask`` with piped stdin and no files (one LLM call, no tools), import
no torch.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from typing import List, Optional

from semtools_tpu_torch.utils import json_mode
from semtools_tpu_torch.utils.text import read_file_text, split_lines

_HIGHLIGHT_ON = "\x1b[43m\x1b[30m"
_HIGHLIGHT_OFF = "\x1b[0m"


def _fmt_distance(d: float) -> str:
    """Shortest round-trip float formatting (Rust ``{}`` on f64 parity)."""
    return repr(float(d))


def _print_search_results(results) -> None:
    is_tty = sys.stdout.isatty()
    for r in results:
        print(f"{r.filename}:{r.start}::{r.end} ({_fmt_distance(r.distance)})")
        for i, line in enumerate(r.lines):
            line_number = r.start + i
            text = f"{line_number + 1:4}: {line}"
            if line_number == r.match_line and is_tty:
                print(f"{_HIGHLIGHT_ON}{text}{_HIGHLIGHT_OFF}")
            else:
                print(text)
        print()


def _print_workspace_search_results(ranked_lines, n_lines: int) -> None:
    """Workspace hits, with context re-read from the live files."""
    is_tty = sys.stdout.isatty()
    for rl in ranked_lines:
        match_line = rl.line_number
        start = max(0, match_line - n_lines)
        end = match_line + n_lines + 1
        print(f"{rl.path}:{start}::{end} ({_fmt_distance(rl.distance)})")
        try:
            lines = split_lines(read_file_text(rl.path))
        except OSError:
            print("    [Error: Could not read file content]")
            print()
            continue
        for ln in range(start, min(end, len(lines))):
            text = f"{ln + 1:4}: {lines[ln]}"
            if ln == match_line and is_tty:
                print(f"{_HIGHLIGHT_ON}{text}{_HIGHLIGHT_OFF}")
            else:
                print(text)
        print()


def _search_result_json(r) -> dict:
    return json_mode.search_result(
        r.filename, r.start, r.end, r.match_line, r.distance, "\n".join(r.lines)
    )


def _ranked_line_json(rl, n_lines: int) -> dict:
    match_line = rl.line_number
    start = max(0, match_line - n_lines)
    end = match_line + n_lines + 1
    try:
        lines = split_lines(read_file_text(rl.path))
        content = "\n".join(lines[start : min(end, len(lines))])
    except OSError:
        content = "[Error: Could not read file content]"
    return json_mode.search_result(rl.path, start, end, match_line, rl.distance, content)


def _read_queries_file(path: str, files_given: bool) -> List[str]:
    """Non-empty lines of a --queries-file; '-' reads queries from stdin
    (only when document files are given)."""
    if path == "-":
        if not files_given:
            raise ValueError(
                "--queries-file - needs document files as arguments "
                "(stdin cannot be both the query list and the document)"
            )
        if sys.stdin.isatty():
            raise ValueError("--queries-file - expects queries piped on stdin")
        text = sys.stdin.read()
    else:
        text = read_file_text(path)
    return [ln for ln in split_lines(text) if ln.strip()]


def _print_output(results, as_json: bool) -> None:
    if as_json:
        print(json_mode.dumps(
            json_mode.search_output([_search_result_json(r) for r in results])
        ))
    else:
        _print_search_results(results)


def _print_batched(queries, per_query, printer, to_json) -> None:
    """NDJSON (one {query, results} line per query) under -j (``to_json``
    given), else per-query blocks introduced by a '# query:' header line."""
    for q, results in zip(queries, per_query):
        if to_json is not None:
            print(json_mode.batch_search_line(q, [to_json(r) for r in results]))
        else:
            print(f"# query: {q}")
            printer(results)


def parse_cmd(args) -> int:
    from semtools_tpu_torch.parse import LlamaParseBackend, load_parse_config

    parse_config = load_parse_config(args.config)

    for f in args.files:
        if not os.path.exists(f):
            print(f"Warning: File does not exist: {f}", file=sys.stderr)

    if args.backend == "llama-parse":
        backend = LlamaParseBackend(parse_config, verbose=args.verbose)
    elif args.backend == "local":
        from semtools_tpu_torch.parse import LocalParseBackend

        backend = LocalParseBackend(verbose=args.verbose)
    else:
        print(
            f"Error: Unknown backend '{args.backend}'. "
            "Supported backends: llama-parse, local",
            file=sys.stderr,
        )
        return 1
    if args.json:
        results = backend.parse_detailed(args.files)
        print(json_mode.dumps(json_mode.parse_output([
            json_mode.parse_result(r.input_path, r.output_path, r.was_cached)
            for r in results
        ])))
    else:
        for path in backend.parse(args.files):
            print(path)
    return 0


def search_cmd(args) -> int:
    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.search import (
        Document,
        SearchConfig,
        _encode_queries,
        search_documents,
        search_documents_batched,
        search_files,
        search_files_batched,
        search_with_workspace,
        search_with_workspace_batched,
    )
    from semtools_tpu_torch.store import NoActiveWorkspace, Workspace

    if args.query is None and not args.queries_file:
        print("Error: a QUERY argument or --queries-file is required", file=sys.stderr)
        return 2
    if args.query is not None and args.queries_file:
        # Under --queries-file every positional is a file.
        args.files = [args.query] + list(args.files)
        args.query = None
    model = StaticModel.from_pretrained(
        args.model_path or os.environ.get("SEMTOOLS_TPU_MODEL", "minishlab/potion-multilingual-128M"),
        device=args.device,
    )

    queries: Optional[List[str]] = None
    if args.queries_file:
        queries = _read_queries_file(args.queries_file, bool(args.files))
        if not queries:
            print(f"Error: no queries in {args.queries_file}", file=sys.stderr)
            return 1

    query = (args.query or "").lower() if args.ignore_case else (args.query or "")
    config = SearchConfig(
        n_lines=args.n_lines,
        top_k=args.top_k,
        max_distance=args.max_distance,
        ignore_case=args.ignore_case,
    )

    if not args.files and not sys.stdin.isatty():
        stdin_lines = sys.stdin.read().split("\n")
        if stdin_lines and stdin_lines[-1] == "":
            stdin_lines.pop()
        if stdin_lines:
            to_embed = [ln.lower() for ln in stdin_lines] if args.ignore_case else stdin_lines
            documents = [Document("<stdin>", stdin_lines, model.encode(to_embed, max_length=2048))]
            if queries is not None:
                per = search_documents_batched(
                    documents, _encode_queries(queries, model, config), config
                )
                _print_batched(queries, per, _print_search_results,
                               _search_result_json if args.json else None)
                return 0
            results = search_documents(documents, model.encode_single(query), config)
            _print_output(results, args.json)
            return 0

    if not args.files:
        msg = "No input provided. Either specify files as arguments or pipe input to stdin."
        if args.json:
            print(json_mode.dumps(json_mode.error_output(msg, "NoInput")), file=sys.stderr)
        else:
            print(f"Error: {msg}", file=sys.stderr)
        return 1

    try:
        Workspace.active(args.workspace)
        workspace_active = True
    except NoActiveWorkspace:
        workspace_active = False

    if workspace_active:
        if queries is not None:
            per = search_with_workspace_batched(args.files, queries, model, config,
                                                args.workspace)
            _print_batched(
                queries, per,
                lambda rs: _print_workspace_search_results(rs, args.n_lines),
                (lambda rl: _ranked_line_json(rl, args.n_lines)) if args.json else None,
            )
            return 0
        ranked = search_with_workspace(args.files, query, model, config, args.workspace)
        if args.json:
            print(json_mode.dumps(json_mode.search_output(
                [_ranked_line_json(rl, args.n_lines) for rl in ranked])))
        else:
            _print_workspace_search_results(ranked, args.n_lines)
        return 0

    if queries is not None:
        _print_batched(queries, search_files_batched(args.files, queries, model, config),
                       _print_search_results, _search_result_json if args.json else None)
        return 0
    _print_output(search_files(args.files, query, model, config), args.json)
    return 0


# -- workspace ------------------------------------------------------------------


def workspace_use_cmd(args) -> int:
    from semtools_tpu_torch.store import Store, Workspace, WorkspaceConfig

    name = args.name
    ws = Workspace(WorkspaceConfig(name=name, root_dir=Workspace.root_path(name)))
    ws.save()

    if args.json:
        total_documents = 0
        try:
            with Store(ws.config.root_dir) as store:
                total_documents = store.get_stats().total_documents
        except Exception:
            pass
        print(json_mode.dumps(
            json_mode.workspace_output(ws.config.name, ws.config.root_dir, total_documents)
        ))
    else:
        print(f"Workspace '{name}' configured.")
        print("To activate it, run:")
        print(f"  export SEMTOOLS_WORKSPACE={name}")
        print()
        print("Or add this to your shell profile (.bashrc, .zshrc, etc.)")
        print()
        print("Or use the `--workspace` option on the commands that support it")
    return 0


def workspace_status_cmd(args) -> int:
    from semtools_tpu_torch.store import Store, Workspace

    Workspace.active(args.name)
    ws = Workspace.open(args.name)
    with Store(ws.config.root_dir) as store:
        stats = store.get_stats()
        live, cap = store.fragmentation()

    if args.json:
        print(json_mode.dumps(
            json_mode.workspace_output(
                ws.config.name, ws.config.root_dir, stats.total_documents,
                slots_live=live, slots_allocated=cap,
            )
        ))
    else:
        print(f"Active workspace: {ws.config.name}")
        print(f"Root: {ws.config.root_dir}")
        print(f"Documents: {stats.total_documents}")
        if stats.has_index:
            print(f"Index: Yes ({stats.index_type or 'Unknown'})")
        else:
            print("Index: No")
        # Dead slots inflate device memory and scan length (Store._slot_rows)
        if cap > live and cap - live >= 1024 and cap > live * 3 // 2:
            print(
                f"Slots: {live} live / {cap} allocated — "
                "run 'semtools workspace compact' to reclaim"
            )
    return 0


def workspace_prune_cmd(args) -> int:
    from semtools_tpu_torch.store import Store, Workspace

    Workspace.active(args.name)
    ws = Workspace.open(args.name)
    with Store(ws.config.root_dir) as store:
        all_paths = store.get_all_document_paths()
        missing = [p for p in all_paths if not os.path.exists(p)]
        if missing:
            store.delete_documents(missing)
        files_removed = len(missing)
        files_remaining = len(all_paths) - files_removed

    if args.json:
        print(json_mode.dumps(json_mode.prune_output(files_removed, files_remaining)))
    elif not missing:
        print("No stale documents found. Workspace is clean.")
    else:
        print(f"Found {len(missing)} stale documents:")
        for p in missing:
            print(f"  - {p}")
        print(f"Removed {len(missing)} stale documents from workspace.")
    return 0


def workspace_compact_cmd(args) -> int:
    from semtools_tpu_torch.store import Store, Workspace

    Workspace.active(args.name)
    ws = Workspace.open(args.name)
    with Store(ws.config.root_dir) as store:
        report = store.compact()
    if args.json:
        print(json_mode.dumps({"workspace": ws.config.name, **report}))
    else:
        if report["slots_reclaimed"] == 0:
            print(f"Workspace is already compact ({report['rows_live']} lines).")
        else:
            print(
                f"Compacted {report['rows_live']} lines: reclaimed "
                f"{report['slots_reclaimed']} of {report['slots_before']} slots."
            )
        if report["index_remapped"]:
            print("IVF-PQ index remapped in place (no rebuild needed).")
    return 0


def workspace_index_cmd(args) -> int:
    from semtools_tpu_torch.store import Store, Workspace

    Workspace.active(args.name)
    ws = Workspace.open(args.name)
    with Store(ws.config.root_dir) as store:
        index = store.build_ann_index(force=args.force, verbose=True)
        stats = store.get_stats()
    if args.json:
        print(json_mode.dumps({
            "workspace": ws.config.name,
            "index_type": stats.index_type,
            "built": index is not None,
            "total_lines": stats.total_lines,
        }))
    elif index is not None and stats.index_type == "ivf-pq":
        print(f"Index ready: ivf-pq serving {stats.total_lines} lines")
    elif index is not None:
        print(
            f"IVF-PQ index built (capacity fallback); corpus fits "
            f"on-device so '{stats.index_type}' serves "
            f"{stats.total_lines} lines"
        )
    else:
        print(
            f"Corpus fits the device tiers ('{stats.index_type}' over "
            f"{stats.total_lines} lines); no ANN index needed "
            "(pass --force to build the capacity fallback anyway)"
        )
    return 0


def ask_cmd(args) -> int:
    from semtools_tpu_torch.ask import run_ask

    return run_ask(args)


def daemon_cmd(args) -> int:
    import subprocess
    import time

    from semtools_tpu_torch import daemon

    action = args.action
    if not daemon.supported():
        if action in ("run", "start"):
            print(
                "Error: the semtools daemon requires unix sockets and is "
                "unsupported on this platform; commands run locally "
                "without it.",
                file=sys.stderr,
            )
            return 1
        print("Daemon unsupported on this platform (commands run locally).")
        return 0
    if action == "run":
        if args.device:
            os.environ["SEMTOOLS_TORCH_DEVICE"] = args.device
        daemon.serve()
        return 0
    if action == "start":
        if daemon.ping():
            print("Daemon already running.")
            return 0
        # The native client (a `semtools` that forwards without starting
        # Python) is built beside the daemon it talks to.
        from semtools_tpu_torch.utils import native

        try:
            native.build_client()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            print(f"Warning: native client not built ({e})", file=sys.stderr)
        log_path = daemon.socket_path().parent / "daemon-torch.log"
        log_path.parent.mkdir(parents=True, exist_ok=True)
        cmd = [sys.executable, "-m", "semtools_tpu_torch.cli", "daemon", "run"]
        if args.device:
            cmd += ["--device", args.device]
        with open(log_path, "ab") as log:
            subprocess.Popen(cmd, stdout=log, stderr=log, stdin=subprocess.DEVNULL,
                             start_new_session=True)
        # the warm-up (model upload, kernel build on a fresh checkout, the
        # workspace corpus) comes before the socket
        for _ in range(600):
            if daemon.ping():
                print(f"Daemon started (socket {daemon.socket_path()}).")
                return 0
            time.sleep(0.3)
        print("Error: daemon did not come up; see", log_path, file=sys.stderr)
        return 1
    if action == "stop":
        if daemon.stop():
            print("Daemon stopped.")
            return 0
        print("No daemon running.")
        return 0
    if daemon.ping():
        print(f"Daemon running (socket {daemon.socket_path()}).")
    else:
        print("No daemon running.")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from semtools_tpu_torch import __version__

    parser = argparse.ArgumentParser(
        prog="semtools", description="Semantic document search (PyTorch port)"
    )
    parser.add_argument(
        "-V", "--version", action="version", version=f"semtools {__version__}"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("parse", help="Parse documents using various backends")
    p.add_argument("-c", "--config", default=None, help="Path to the config file")
    p.add_argument(
        "-b", "--backend", default="llama-parse",
        help="Backend type (llama-parse | local)",
    )
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Verbose output while parsing")
    p.add_argument("-j", "--json", action="store_true",
                   help="Output results in JSON format")
    p.add_argument("files", nargs="+", help="Files to parse")
    p.set_defaults(func=parse_cmd)

    s = sub.add_parser("search", help="Fast semantic keyword search")
    s.add_argument("query", nargs="?", default=None,
                   help="Query text (or use --queries-file for a batch)")
    s.add_argument("files", nargs="*", help="Files to search, optional if using stdin")
    s.add_argument("-Q", "--queries-file", dest="queries_file", default=None,
                   help="Run every non-empty line of FILE as a query in one "
                   "batched scan ('-' reads queries from stdin when files "
                   "are given); output is per-query blocks, or NDJSON with -j")
    s.add_argument("-n", "--n-lines", "--context", dest="n_lines", type=int, default=3,
                   help="How many lines before/after to return as context")
    s.add_argument("--top-k", dest="top_k", type=int, default=3,
                   help="The top-k files or texts to return (ignored if max_distance is set)")
    s.add_argument("-m", "--max-distance", "--threshold", dest="max_distance",
                   type=float, default=None,
                   help="Return all results with distance below this threshold (0.0+)")
    s.add_argument("-i", "--ignore-case", action="store_true",
                   help="Perform case-insensitive search (default is false)")
    s.add_argument("-j", "--json", action="store_true",
                   help="Output results in JSON format")
    s.add_argument("-w", "--workspace", default=None,
                   help="Use a specific workspace")
    s.add_argument("--model-path", default=None, help="Embedding model name or directory")
    s.add_argument("--device", default=None,
                   help="torch device (default: $SEMTOOLS_TORCH_DEVICE, else cuda)")
    s.set_defaults(func=search_cmd)

    a = sub.add_parser("ask", help="Document-based question answering agent")
    a.add_argument("query", help="Query to prompt the agent with")
    a.add_argument("files", nargs="*", help="Files to search, optional if using stdin")
    a.add_argument("-c", "--config", default=None,
                   help="Path to the config file. Defaults to ~/.semtools_config.json")
    a.add_argument("--api-key", default=None,
                   help="OpenAI API key (overrides config file and env var)")
    a.add_argument("--base-url", default=None,
                   help="OpenAI base URL (overrides config file)")
    a.add_argument("-m", "--model", default=None,
                   help="Model to use for the agent (overrides config file)")
    a.add_argument("--api-mode", default=None, choices=["chat", "responses"],
                   help="API mode to use (overrides config file)")
    a.add_argument("-j", "--json", action="store_true",
                   help="Output results in JSON or text format")
    a.add_argument("-w", "--workspace", default=None,
                   help="Use a specific workspace")
    a.add_argument("--device", default=None,
                   help="torch device of the search tool (default: "
                   "$SEMTOOLS_TORCH_DEVICE, else cuda)")
    a.set_defaults(func=ask_cmd)

    w = sub.add_parser("workspace", help="Manage semtools workspaces")
    # -j is global on the workspace subcommand (accepted before or after the
    # action, like the reference's `global = true` clap flag).
    w.add_argument("-j", "--json", action="store_true")
    wsub = w.add_subparsers(dest="wcmd", required=True)
    for action, help_text, func in (
        ("use", "Use or create a workspace", workspace_use_cmd),
        ("status", "Show active workspace and stats", workspace_status_cmd),
        ("prune", "Remove stale files from store", workspace_prune_cmd),
        ("index", "Build or refresh the IVF-PQ ANN index", workspace_index_cmd),
        ("compact", "Reclaim slot space left by deleted/rewritten documents",
         workspace_compact_cmd),
    ):
        a = wsub.add_parser(action, help=help_text)
        if action == "use":
            a.add_argument("name")
        else:
            a.add_argument("name", nargs="?", default=None)
        if action == "index":
            a.add_argument("-f", "--force", action="store_true",
                           help="Build even below the corpus-size threshold")
        a.add_argument("-j", "--json", action="store_true", default=argparse.SUPPRESS)
        a.set_defaults(func=func)

    d = sub.add_parser(
        "daemon", help="Resident process that keeps the model, the kernels and "
        "the workspace corpus on the device across invocations"
    )
    d.add_argument("action", choices=["run", "start", "stop", "status"],
                   nargs="?", default="status")
    d.add_argument("--device", default=None,
                   help="torch device the daemon warms up (default: "
                   "$SEMTOOLS_TORCH_DEVICE, else cuda)")
    d.set_defaults(func=daemon_cmd)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Forward to a running daemon before anything imports torch: that is
    # what makes a forwarded command cheap.
    from semtools_tpu_torch import daemon as _daemon

    if _daemon.should_forward(argv):
        stdin_text = None if sys.stdin.isatty() else sys.stdin.read()
        code = _daemon.forward(argv, stdin_text)
        if code is not None:
            return code
        # Daemon unreachable or busy: run here, with the stdin already read.
        if stdin_text is not None:
            sys.stdin = io.StringIO(stdin_text)

    from semtools_tpu_torch.utils.tracing import maybe_device_trace

    args = build_parser().parse_args(argv)
    try:
        with maybe_device_trace():
            return args.func(args)
    except Exception as e:  # uniform error surface, like the JAX CLI
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
