"""Differential fuzz of the grep router: the native scanner against Python ``re``.

Counterpart of the repository's ``scripts/fuzz_grep_dialect.py``, on the
port's grep tool. The grep tool's native fast path (``cpp/grepscan.cpp``
behind :mod:`semtools_tpu_torch.utils.grepscan`) is only taken when
``ask.tools._native_grep_safe`` rules the pattern/content combination
provably equivalent to Python ``re``, the authority. This harness fuzzes
the property:

    _native_grep_safe(pattern, ignore_case, lines) is True
    and the native engine accepts the pattern
    =>  native match-line set == Python re match-line set.

Patterns come from a grammar over the constructs the two engines treat
differently in each direction (anchors incl. \\A/\\Z, classes incl.
POSIX [[:digit:]], greedy/lazy/bounded quantifiers incl. {,n}, groups incl.
named/lookaround/inline flags, escapes, alternation, backrefs); content
mixes targeted ASCII tokens with random ASCII and non-ASCII lines (the
content-dependent routing branches). The native scanner is the port's own
build of ``cpp/`` (``utils/native.py``), made with the machine's ``g++``.

Usage: python -m semtools_tpu_torch.evals fuzz_grep [--cases 10000] [--seed 0]
Prints a summary line and one JSON line; exit 1 on any mismatch (a
reproducer per mismatch), 2 when the native scanner is unavailable.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import sys
import tempfile
import warnings

from semtools_tpu_torch.ask.tools import _compile_grep_pattern, _native_grep_safe
from semtools_tpu_torch.utils import grepscan

ATOMS = [
    "a", "b", "Z", "A", "0", "5", " ", "_", ",", "-", "/",
    r"\d", r"\D", r"\w", r"\W", r"\s", r"\S", r"\b", r"\B",
    r"\A", r"\Z", r"\.", r"\\", r"\*", r"\[", r"\]", r"\$", r"\^",
    r"\x41", r"\t",
    r"\p{L}", r"\p{N}", r"\p{Alpha}", r"\P{L}", r"\pL", r"\p{Lu}",
    ".", "[abc]", "[a-f]", "[^ab]", "[0-9-]", "[]a]", "[[:digit:]]",
    "[[:alpha:]]", "[[.a.]]", "[a\\]b]", "[.,;]", "[=a=]",
]
QUANTS = ["", "", "", "*", "+", "?", "*?", "+?", "??", "{2}", "{1,3}",
          "{,3}", "{2,}", "{0,2}?"]
WRAPPERS = [
    ("(", ")"), ("(?:", ")"), ("(?P<g1>", ")"), ("(?=", ")"), ("(?!", ")"),
    ("(?<=", ")"), ("(?i:", ")"),
]

TOKENS = [
    "foo", "Afoo", "Zed", "foo bar", ":digit:", "[d]", "123", "aab",
    "a{,3}b", "x0y", "end Z", "A", "", "aaa", "ab,cd", "tab\tsep",
    "café", "€ euro", "xéy", "0660:٠", "Kelvin K",
]
ASCII = "abAZ01 ,.-_/"


def gen_pattern(rng: random.Random) -> str:
    parts = []
    for _ in range(rng.randint(1, 4)):
        atom = rng.choice(ATOMS)
        q = rng.choice(QUANTS)
        # quantifying an anchor is an error in both engines; keep some
        if q and atom in (r"\A", r"\Z", r"\b", r"\B") and rng.random() < 0.8:
            q = ""
        piece = atom + q
        if rng.random() < 0.15:
            a, b = rng.choice(WRAPPERS)
            piece = a + piece + b
            if rng.random() < 0.3:
                piece += rng.choice(QUANTS)
        parts.append(piece)
    pat = "".join(parts)
    if rng.random() < 0.15:
        pat = "^" + pat
    if rng.random() < 0.15:
        pat = pat + "$"
    if rng.random() < 0.1:
        other = gen_pattern(rng) if rng.random() < 0.3 else rng.choice(TOKENS)
        pat = pat + "|" + other
    if rng.random() < 0.05:
        pat = "(a)" + pat + r"\1"
    return pat


def gen_lines(rng: random.Random) -> list:
    lines = rng.sample(TOKENS, rng.randint(2, 6))
    for _ in range(rng.randint(1, 4)):
        lines.append("".join(rng.choice(ASCII) for _ in range(rng.randint(0, 12))))
    rng.shuffle(lines)
    return lines


def run(cases: int, seed: int) -> dict:
    """Fuzz ``cases`` valid patterns from ``seed``; the counts."""
    rng = random.Random(seed)
    tried = routed = accepted = mismatches = 0
    # Python re warns of possible nested sets ([[...), which the grammar
    # makes on purpose.
    with tempfile.TemporaryDirectory() as td, warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        path = os.path.join(td, "f.txt")
        while tried < cases:
            pattern = gen_pattern(rng)
            lines = gen_lines(rng)
            ignore_case = rng.random() < 0.25
            flags = re.IGNORECASE if ignore_case else 0
            try:
                compiled = _compile_grep_pattern(pattern, flags)
            except re.error:
                continue  # grep_tool raises before any engine runs
            tried += 1
            if not _native_grep_safe(pattern, ignore_case, lines):
                continue  # routed to the Python authority
            routed += 1
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            try:
                nat = grepscan.match_lines(path, pattern, ignore_case)
            except ValueError:
                continue  # native rejected: grep_tool falls back to Python
            accepted += 1
            py = [i for i, ln in enumerate(lines) if compiled.search(ln)]
            if nat != py:
                mismatches += 1
                print(f"MISMATCH pattern={pattern!r} ignore_case={ignore_case}")
                print(f"  lines={lines!r}")
                print(f"  python={py} native={nat}")
    return {"cases": tried, "routed_native": routed, "compared": accepted,
            "mismatches": mismatches, "seed": seed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m semtools_tpu_torch.evals fuzz_grep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not grepscan.available():
        print("native scanner unavailable: nothing to fuzz", file=sys.stderr)
        return 2
    r = run(args.cases, args.seed)
    print(f"fuzz_grep: {r['cases']} valid cases, {r['routed_native']} routed native, "
          f"{r['compared']} native-accepted+compared, {r['mismatches']} mismatches")
    print(json.dumps({"fuzz_grep": r}))
    return 1 if r["mismatches"] else 0
