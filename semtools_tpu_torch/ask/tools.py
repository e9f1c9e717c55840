"""Agent tools: search (semantic), grep (exact/regex), read (line range).

Counterpart of ``semtools_tpu/ask/tools.py``: the same schemas, result
envelopes and grep routing; the search tool runs the port's batched
searches, whose scans are the card's kernels.

Tool JSON schemas and the ``<chunk file=.. start=.. end=.. distance=..>``
result envelope are part of the cross-CLI contract (reference:
src/ask/tools.rs:34-94 for the chunk format, :98-205 for the schemas) — an
LLM prompted against the reference behaves identically against this
implementation.

The grep engine prefers the native C++ scanner
(:mod:`semtools_tpu_torch.utils.grepscan`) and falls back to Python ``re``
when the shared library is unavailable.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Sequence

from semtools_tpu_torch.utils.text import read_file_text, split_lines
from semtools_tpu_torch.utils.tracing import stage

# -- schemas (shared by both chat and responses APIs) -----------------------

_SEARCH_CONFIG_SCHEMA = {
    "type": "object",
    "properties": {
        "n_lines": {
            "type": "integer",
            "description": "Number of context lines to include before and after each match",
            "default": 5,
        },
        "ignore_case": {
            "type": "boolean",
            "description": "Whether to ignore case when searching",
            "default": False,
        },
        "max_distance": {
            "type": "number",
            "description": "Maximum semantic distance for matches (lower is more similar)",
            "default": 0.5,
        },
        "top_k": {
            "type": "integer",
            "description": "Number of top results to return",
            "default": 3,
        },
    },
    "required": [],
    "title": "Config",
    "additionalProperties": False,
}

SEARCH_TOOL = {
    "name": "search",
    "description": (
        "Search through files using semantic keyword search. Returns relevant "
        "document chunks with their file paths and line numbers. If top-k is "
        "not specified, returns all relevant results within the max distance "
        "threshold."
    ),
    "parameters": {
        "$defs": {"Config": _SEARCH_CONFIG_SCHEMA},
        "type": "object",
        "properties": {
            "query": {
                "type": "string",
                "description": "The search query. Works best as a comma separated list of keywords.",
            },
            "config": {"$ref": "#/$defs/Config"},
        },
        "required": ["query", "config"],
        "additionalProperties": False,
    },
}

READ_TOOL = {
    "name": "read",
    "description": (
        "Read a specific range of lines from a file. Returns the content "
        "between start_line and end_line."
    ),
    "parameters": {
        "type": "object",
        "properties": {
            "path": {"type": "string", "description": "The file path to read from"},
            "start_line": {
                "type": "integer",
                "description": "The starting line number (0-based)",
            },
            "end_line": {
                "type": "integer",
                "description": "The ending line number (exclusive, 0-based)",
            },
        },
        "required": ["path", "start_line", "end_line"],
        "additionalProperties": False,
    },
}

GREP_TOOL = {
    "name": "grep",
    "description": (
        "Search for exact patterns or regular expressions in files. Use this "
        "when you know the exact string, function name, class name, or regex "
        "pattern to search for. Best for exhaustive searches of exact "
        "strings/patterns."
    ),
    "parameters": {
        "type": "object",
        "properties": {
            "pattern": {
                "type": "string",
                "description": "The exact string or regular expression pattern to search for",
            },
            "file_paths": {
                "type": "array",
                "items": {"type": "string"},
                "description": (
                    "Optional list of specific file paths to search. If empty or "
                    "not provided, searches all available files."
                ),
                "default": [],
            },
            "is_regex": {
                "type": "boolean",
                "description": "Whether the pattern is a regular expression",
                "default": False,
            },
            "case_sensitive": {
                "type": "boolean",
                "description": "Whether the search should be case sensitive",
                "default": True,
            },
            "context_lines": {
                "type": "integer",
                "description": "Number of lines to show before and after each match for context",
                "default": 5,
            },
        },
        "required": ["pattern"],
        "additionalProperties": False,
    },
}

ALL_TOOLS = [GREP_TOOL, SEARCH_TOOL, READ_TOOL]


def chat_tool_defs() -> List[Dict]:
    """Chat Completions API tool wrapper."""
    return [{"type": "function", "function": dict(t)} for t in ALL_TOOLS]


def responses_tool_defs() -> List[Dict]:
    """Responses API tool wrapper (flat function objects)."""
    return [{"type": "function", **t} for t in ALL_TOOLS]


# -- result formatting ------------------------------------------------------


def format_search_results(results) -> str:
    out = []
    for r in results:
        out.append(
            f"<chunk file={r.filename} start={r.start} end={r.end} "
            f"distance={repr(float(r.distance))}>\n"
        )
        for line in r.lines:
            out.append(f"{line}\n")
        out.append("</chunk>\n")
    return "".join(out)


def format_ranked_lines(ranked_lines, n_lines: int) -> str:
    out = []
    for rl in ranked_lines:
        match_line = rl.line_number
        start = max(0, match_line - n_lines)
        end = match_line + n_lines + 1
        out.append(
            f"<chunk file={rl.path} start={start} end={end} "
            f"distance={repr(float(rl.distance))}>\n"
        )
        try:
            lines = split_lines(read_file_text(rl.path))
            for line in lines[start : min(end, len(lines))]:
                out.append(f"{line}\n")
        except OSError:
            out.append("[Error: Could not read file content]")
        out.append("</chunk>\n")
    return "".join(out)


# -- tool implementations ---------------------------------------------------


def search_tool(
    files: Sequence[str],
    query: str,
    model,
    config,
    files_searched: List[str],
    workspace_name: Optional[str] = None,
) -> str:
    """Single-query tool call — a batch of one through
    :func:`search_tool_batched` (one dispatch path to maintain)."""
    return search_tool_batched(
        files, [query], model, config, files_searched, workspace_name
    )[0]


def search_tool_batched(
    files: Sequence[str],
    queries: Sequence[str],
    model,
    config,
    files_searched: List[str],
    workspace_name: Optional[str] = None,
) -> List[str]:
    """Batched :func:`search_tool`: one tool response per query, served
    by a single batched scan (search_*_batched). LLMs routinely make
    several search calls in one turn — executing them as one device
    dispatch instead of Q sequential searches is the agent-loop analogue
    of the CLI's ``--queries-file``."""
    from semtools_tpu_torch.search import (
        search_files_batched,
        search_with_workspace_batched,
    )
    from semtools_tpu_torch.store import NoActiveWorkspace, Workspace

    if not files:
        raise ValueError(
            "Error: No input provided. Either specify files as arguments or pipe input to stdin."
        )

    try:
        Workspace.active(workspace_name)
        ws_active = True
    except NoActiveWorkspace:
        ws_active = False

    if ws_active:
        per = search_with_workspace_batched(
            files, list(queries), model, config, workspace_name
        )
        out = []
        for ranked in per:
            for rl in ranked:
                if rl.path not in files_searched:
                    files_searched.append(rl.path)
            out.append(format_ranked_lines(ranked, config.n_lines))
        return out

    per = search_files_batched(files, list(queries), model, config)
    out = []
    for results in per:
        for r in results:
            if r.filename not in files_searched:
                files_searched.append(r.filename)
        out.append(format_search_results(results))
    return out


def read_tool(path: str, start_line: int, end_line: int) -> str:
    lines = split_lines(read_file_text(path))
    actual_end = min(end_line, len(lines))
    body = "\n".join(lines[start_line:actual_end])
    return f"<chunk file={path} start={start_line} end={actual_end}>\n{body}</chunk>\n"


def _python_grep(
    path: str, pattern: "re.Pattern[str]", lines: List[str]
) -> List[int]:
    return [i for i, line in enumerate(lines) if pattern.search(line)]


def grep_tool(
    all_files: Sequence[str],
    pattern: str,
    file_paths: Optional[Sequence[str]] = None,
    is_regex: bool = False,
    case_sensitive: bool = True,
    context_lines: int = 5,
) -> str:
    import os

    files_to_search = list(file_paths) if file_paths else list(all_files)
    if not files_to_search:
        raise ValueError("No files to search")

    pat_text = pattern if is_regex else re.escape(pattern)
    flags = 0 if case_sensitive else re.IGNORECASE
    try:
        compiled = _compile_grep_pattern(pat_text, flags)
    except re.error as e:
        raise ValueError(f"Invalid regex pattern: {e}")

    out = []
    any_match = False
    for file_path in files_to_search:
        if not os.path.isfile(file_path):
            continue
        try:
            lines = split_lines(read_file_text(file_path))
        except OSError as e:
            print(f"Warning: Could not search {file_path}: {e}", file=sys.stderr)
            continue
        with stage("grep"):
            match_lines = _grep_lines(file_path, compiled, lines)
        for mi in match_lines:
            any_match = True
            start = max(0, mi - context_lines)
            end = min(mi + context_lines + 1, len(lines))
            out.append(f"<chunk file={file_path} start={start} end={end}>\n")
            for line in lines[start:end]:
                out.append(f"{line}\n")
            out.append("</chunk>\n")

    if not any_match:
        return "No matches found."
    return "".join(out)


# Unicode property classes of the reference's rust-regex dialect
# (\p{L}, \P{Greek}, \pN — the reference's src/ask/tools.rs:443-516 uses
# grep-regex, whose pattern language implements UTS#18 properties).
# Python `re` rejects them ("bad escape \p"); the stdlib-adjacent
# `regex` module implements the same UTS#18 property names with `re`'s
# API, so patterns mentioning \p/\P compile through it instead. `regex`
# is a behavioral superset of `re` for `re`-valid patterns, so the
# textual (over-matching) detection below is safe: a false positive
# (e.g. a literal r"\\p") compiles to the same matcher either way.
_UNICODE_PROPERTY = re.compile(r"\\[pP]")


def _compile_grep_pattern(pat_text: str, flags: int):
    """Compile a grep pattern: Python ``re`` (the documented authority),
    except \\p/\\P Unicode property classes go through the ``regex``
    module — matching the capability the reference's rust-regex engine
    grants agents instead of bouncing a ValueError."""
    if _UNICODE_PROPERTY.search(pat_text):
        try:
            import regex as _regex
        except ImportError:  # pragma: no cover - regex is bundled
            return re.compile(pat_text, flags)  # documented bad-escape error
        try:
            return _regex.compile(pat_text, flags)
        except _regex.error as e:
            # normalize to re.error so grep_tool's single except clause
            # turns any bad pattern into the agent-visible ValueError
            raise re.error(str(e))
    return re.compile(pat_text, flags)


# Pattern escapes whose match set depends on Unicode tables (\d matches
# U+0660, \w matches é, \b derives from \w) — the native scanner's
# std::regex applies them bytewise to UTF-8, so they are only equivalent
# to Python re over pure-ASCII content.
# \x/\u/\U/\N escapes can NAME a non-ASCII codepoint with an ASCII
# pattern (r"caf\xe9"): Python matches the character, std::regex matches
# the single byte — which never occurs inside the UTF-8 encoding.
_UNICODE_SENSITIVE = re.compile(r"\\[dwsbDWSBxuUN]")

# Constructs Python re and std::regex (ECMAScript) both ACCEPT but parse
# DIFFERENTLY even over pure-ASCII content — found by the differential
# fuzz harness (scripts/fuzz_grep_dialect.py) and pinned by
# tests/test_ask.py::test_dialect_divergent_constructs_route_to_python:
#   \A \Z   Python string anchors; ECMAScript identity-escapes them to
#           the LITERAL characters A / Z
#   [: [. [= POSIX classes/collation inside a bracket ([[:digit:]]):
#           first-class in ECMAScript, plain characters to Python re
#   [] [^]  a leading ] is a LITERAL member to Python re ("[]a]" = {], a})
#           but closes an EMPTY (never-matching) class in ECMAScript
#   \B      matches the EMPTY string in ECMAScript but not in Python re
#   \p \P   Unicode property classes (handled via the regex module, see
#           _compile_grep_pattern); ECMAScript identity-escapes them to
#           literal p/P
# Everything else Python-only (named groups, lookbehind, inline flags,
# {,n} bounds, conditionals, atomic groups) makes std::regex THROW, and
# the ValueError already falls back to the Python path. Over-matching
# here is always safe — Python re is the authority; routing native is
# only an optimization.
_DIALECT_DIVERGENT = re.compile(r"\\[AZBpP]|\[[:.=]|\[\^?\]")


def _has_bytewise_unsafe_construct(pattern: str) -> bool:
    """Unescaped ``.`` or negated class: over UTF-8 bytes these match ONE
    BYTE of a multi-byte character ('x.y' misses 'x€y'; '[^a]' matches a
    lone continuation byte), so they only equal Python re on ASCII
    content. Escaped metacharacters (re.escape'd literals) are exact."""
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            i += 2
            continue
        if in_class:
            if c == "]":
                in_class = False
        elif c == ".":
            return True
        elif c == "[":
            in_class = True
            if i + 1 < len(pattern) and pattern[i + 1] == "^":
                return True
        i += 1
    return False


def _native_grep_safe(pattern: str, ignore_case: bool, lines: List[str]) -> bool:
    """True when the native scanner provably matches Python re semantics.

    Non-ASCII patterns (std::regex is byte-oriented, its icase never folds
    past ASCII) always route to Python; Unicode-class escapes, wildcards /
    negated classes, and case-insensitive matching (e.g. Kelvin sign
    folding to 'k') silently diverge over non-ASCII content rather than
    erroring — so those combinations route to the authoritative Python
    path up front.
    """
    if not pattern.isascii():
        return False
    if _DIALECT_DIVERGENT.search(pattern):
        return False
    if (
        ignore_case
        or _UNICODE_SENSITIVE.search(pattern)
        or _has_bytewise_unsafe_construct(pattern)
    ):
        return all(line.isascii() for line in lines)
    return True


def _grep_lines(path: str, compiled: "re.Pattern[str]", lines: List[str]) -> List[int]:
    """Match line indices; native scanner when available, else Python re."""
    ignore_case = bool(compiled.flags & re.IGNORECASE)
    try:
        from semtools_tpu_torch.utils import grepscan

        if grepscan.available() and _native_grep_safe(
            compiled.pattern, ignore_case, lines
        ):
            return grepscan.match_lines(path, compiled.pattern, ignore_case)
    except (ImportError, ValueError, OSError):
        # ValueError: the native scanner rejected the pattern (std::regex
        # lacks some Python re constructs, e.g. named groups/lookbehind)
        # or could not read the file — the Python path is authoritative.
        pass
    return _python_grep(path, compiled, lines)
