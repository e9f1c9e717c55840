"""Text helpers shared across search, store, and the CLI.

A copy of ``semtools_tpu/utils/text.py``: the port imports nothing of the
JAX package, and line splitting must stay identical to it.
"""

from __future__ import annotations

from typing import List


def split_lines(content: str) -> List[str]:
    """Split text into lines exactly like Rust's ``str::lines()``.

    Only ``\\n`` terminates a line (with a preceding ``\\r`` stripped), and a
    trailing newline does not produce a final empty line. Python's
    ``str.splitlines()`` is NOT equivalent: it also splits on \\v, \\f,
    \\x1c-\\x1e, \\x85, and U+2028/U+2029, which would shift line numbers
    relative to the reference CLI on files containing those characters.
    """
    if not content:
        return []
    parts = content.split("\n")
    if parts and parts[-1] == "":
        parts.pop()
    return [p[:-1] if p.endswith("\r") else p for p in parts]


def read_file_text(path: str) -> str:
    """Read a file as UTF-8 with replacement for undecodable bytes.

    ``newline=""`` disables universal-newline translation so a lone ``\\r``
    is NOT a line break — matching Rust's ``fs::read_to_string`` +
    ``str::lines()`` (the reference's read path), where only ``\\n``
    terminates a line.
    """
    with open(path, "r", encoding="utf-8", errors="replace", newline="") as fh:
        return fh.read()
