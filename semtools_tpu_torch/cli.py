"""The ``semtools search`` command of the PyTorch port.

Counterpart of ``semtools_tpu/cli.py``'s ``search`` subcommand: the same
flags, defaults, text output and ``--json`` schema, plus ``--device``
(default ``cuda``; see :func:`semtools_tpu_torch.utils.platform.resolve_device`)::

    python -m semtools_tpu_torch.cli search QUERY [FILES...] [-n N] [--top-k K]
        [-m DIST] [-i] [-j] [-Q QUERIES_FILE] [--model-path P] [--device D]

Workspace search (``-w`` / ``SEMTOOLS_WORKSPACE``) and the other
subcommands are not ported yet: they exit 1 with a message rather than run
a different mode.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from semtools_tpu.utils import json_mode
from semtools_tpu.utils.text import read_file_text, split_lines

_HIGHLIGHT_ON = "\x1b[43m\x1b[30m"
_HIGHLIGHT_OFF = "\x1b[0m"
_NOT_PORTED = ("parse", "ask", "workspace", "daemon")


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


def _search_result_json(r) -> dict:
    return json_mode.search_result(
        r.filename, r.start, r.end, r.match_line, r.distance, "\n".join(r.lines)
    )


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


def _print_batched(queries, per_query, as_json: bool) -> None:
    """NDJSON (one {query, results} line per query) under -j, else
    per-query blocks introduced by a '# query:' header line."""
    for q, results in zip(queries, per_query):
        if as_json:
            print(json_mode.batch_search_line(q, [_search_result_json(r) for r in results]))
        else:
            print(f"# query: {q}")
            _print_search_results(results)


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
    )

    if args.query is None and not args.queries_file:
        print("Error: a QUERY argument or --queries-file is required", file=sys.stderr)
        return 2
    if args.query is not None and args.queries_file:
        # Under --queries-file every positional is a file.
        args.files = [args.query] + list(args.files)
        args.query = None
    if args.workspace or os.environ.get("SEMTOOLS_WORKSPACE"):
        print(
            "Error: workspace search is not ported yet (see ROADMAP.md)",
            file=sys.stderr,
        )
        return 1

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
                _print_batched(queries, per, args.json)
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

    if queries is not None:
        _print_batched(queries, search_files_batched(args.files, queries, model, config), args.json)
        return 0
    _print_output(search_files(args.files, query, model, config), args.json)
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
                   help="Use a specific workspace (not ported yet)")
    s.add_argument("--model-path", default=None, help="Embedding model name or directory")
    s.add_argument("--device", default=None,
                   help="torch device (default: $SEMTOOLS_TORCH_DEVICE, else cuda)")
    s.set_defaults(func=search_cmd)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from semtools_tpu_torch.utils.tracing import maybe_device_trace

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        print(
            f"Error: '{argv[0]}' is not ported yet (see ROADMAP.md)",
            file=sys.stderr,
        )
        return 1
    args = build_parser().parse_args(argv)
    try:
        with maybe_device_trace():
            return args.func(args)
    except Exception as e:  # uniform error surface, like the JAX CLI
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
