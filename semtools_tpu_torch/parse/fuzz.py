"""Fuzz harness for the port's offline ``local`` parse backend.

Counterpart of ``scripts/fuzz_localparse.py``, run against the port's
converters (:mod:`semtools_tpu_torch.parse.extract` and
:mod:`~semtools_tpu_torch.parse.pdftext`):

    python -m semtools_tpu_torch.parse.fuzz [--cases N] [--seed S] [--out DIR]

The backend's contract (``parse/local_backend.py``) is per-file failure
isolation: any ``Exception`` a converter raises is wrapped into
``LocalParseError`` and the batch continues. What that contract cannot
contain, and what this harness hunts, is:

  * hangs (unbounded loops, catastrophic runtime),
  * memory bombs (decompression bombs, crafted size fields),
  * BaseExceptions that escape ``except Exception``.

Method: seed documents per format (valid and adversarial structured seeds,
:mod:`~semtools_tpu_torch.parse.fuzz_seeds`), then mutate them with
byte-level and structure-aware operators under a fixed RNG, drawn in the
JAX package's harness's order, so that one seed gives both harnesses the
same cases. Every case runs under a wall-clock alarm and the process under
a 2 GiB address-space rlimit; a timeout, a MemoryError, a RecursionError, a
non-string result or a non-Exception escape is a finding (its input saved
under ``--out``, default ``chiprun_out/fuzz_failures`` in the checkout).
The last line counts the cases: ok, handled errors and findings; the exit
code is 1 when there is a finding.

Standard library only (this module and the parse package it imports load
neither torch nor numpy): the rlimit would be meaningless under them.
"""

from __future__ import annotations

import argparse
import random
import re
import resource
import signal
import sys
import time
from pathlib import Path

from semtools_tpu_torch.parse import fuzz_seeds as seeds
from semtools_tpu_torch.parse.extract import (
    docx_to_markdown,
    epub_to_markdown,
    html_to_markdown,
    odt_to_markdown,
    pptx_to_markdown,
    rtf_to_text,
    xlsx_to_markdown,
)
from semtools_tpu_torch.parse.pdftext import pdf_to_text

TIMEOUT_S = 10.0
RLIMIT_BYTES = 2 << 30  # 2 GiB: converters bounded far below this
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "fuzz_failures"


class FuzzTimeout(BaseException):
    """BaseException so converters' ``except Exception`` can't eat it."""


def _alarm(_sig, _frm):
    raise FuzzTimeout()


SEEDS = {
    "pdf": [seeds.simple_pdf(), seeds.simple_pdf(compress=True),
            seeds.pdf_cyclic_kids(), seeds.pdf_ref_cycle(),
            seeds.pdf_predictor_bomb(), seeds.pdf_filter_chain_bomb()],
    "docx": [seeds.docx_seed()],
    "pptx": [seeds.pptx_seed()],
    "xlsx": [seeds.xlsx_seed(), seeds.xlsx_colref_bomb()],
    "html": [seeds.html_seed()],
    "rtf": [seeds.rtf_seed()],
    "odt": [seeds.odt_seed(), seeds.odt_space_bomb()],
    "epub": [seeds.epub_seed()],
}

# Built per run (expensive): checked as fixed adversarial cases, not mutated.
BOMB_CASES = [
    ("pdf", "flate_bomb", seeds.pdf_flate_bomb),
    ("docx", "zip_member_bomb", seeds.zip_member_bomb),
    ("odt", "space_bomb", seeds.odt_space_bomb),
]

CONVERTERS = {
    "pdf": pdf_to_text,
    "docx": docx_to_markdown,
    "pptx": pptx_to_markdown,
    "xlsx": xlsx_to_markdown,
    "html": html_to_markdown,
    "rtf": rtf_to_text,
    "odt": odt_to_markdown,
    "epub": epub_to_markdown,
}


def _mutate(rng: random.Random, data: bytes) -> bytes:
    """1-4 byte-level operators; each draws from ``rng`` in the JAX
    package's harness's order (op 6, the splice, is done by the caller)."""
    ops = rng.randint(1, 4)
    buf = bytearray(data)
    for _ in range(ops):
        if not buf:
            return bytes(buf)
        op = rng.randrange(8)
        if op == 0:  # flip random bytes
            for _ in range(rng.randint(1, 16)):
                i = rng.randrange(len(buf))
                buf[i] = rng.randrange(256)
        elif op == 1:  # truncate
            buf = buf[: rng.randrange(len(buf))]
        elif op == 2:  # delete span
            i = rng.randrange(len(buf))
            j = min(len(buf), i + rng.randint(1, 64))
            del buf[i:j]
        elif op == 3:  # duplicate span
            i = rng.randrange(len(buf))
            j = min(len(buf), i + rng.randint(1, 128))
            buf[i:i] = buf[i:j]
        elif op == 4:  # insert junk
            i = rng.randrange(len(buf) + 1)
            buf[i:i] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 32)))
        elif op == 5:  # blow up an integer literal
            ints = list(re.finditer(rb"\d{1,9}", bytes(buf)))
            if ints:
                m = ints[rng.randrange(len(ints))]
                big = str(rng.choice([2**31, 2**63, 10**12, -1, 0])).encode()
                buf[m.start():m.end()] = big
        elif op == 7:  # repeat whole tail
            i = rng.randrange(len(buf))
            buf += buf[i:] * rng.randint(1, 3)
        if len(buf) > (4 << 20):
            buf = buf[: 4 << 20]
    return bytes(buf)


def _run_case(fmt: str, data: bytes):
    """(status, detail); status: ok | handled | finding-<kind>. Needs the
    SIGALRM handler :func:`main` installs (:func:`_alarm`)."""
    conv = CONVERTERS[fmt]
    signal.setitimer(signal.ITIMER_REAL, TIMEOUT_S)
    t0 = time.perf_counter()
    try:
        out = conv(data)
        if not isinstance(out, str):
            return "finding-type", f"returned {type(out).__name__}"
        return "ok", ""
    except FuzzTimeout:
        return "finding-timeout", f">{TIMEOUT_S}s"
    except MemoryError:
        return "finding-memory", "MemoryError under rlimit"
    except RecursionError as e:
        # Contained by `except Exception`, but flagged: converters should
        # bound their own depth instead of riding the interpreter limit.
        return "finding-recursion", str(e)[:80]
    except Exception:
        return "handled", ""
    except BaseException as e:  # escapes the backend contract; reported, not re-raised
        return "finding-escape", f"{type(e).__name__}: {e}"
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        dt = time.perf_counter() - t0
        if dt > TIMEOUT_S:  # the alarm should have fired
            print(f"  slow case ({dt:.1f}s) in {fmt}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=800, help="mutated cases per format")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="where findings' inputs are saved")
    args = ap.parse_args(argv)

    try:
        resource.setrlimit(resource.RLIMIT_AS, (RLIMIT_BYTES, RLIMIT_BYTES))
    except (ValueError, OSError):
        pass  # macOS ignores/denies RLIMIT_AS; alarms still bound each case
    signal.signal(signal.SIGALRM, _alarm)
    outdir = Path(args.out)
    rng = random.Random(args.seed)
    t_start = time.perf_counter()

    findings = []
    counts = {"ok": 0, "handled": 0}

    # Fixed adversarial cases first: these must terminate fast.
    for fmt, name, build in BOMB_CASES:
        data = build()
        t0 = time.perf_counter()
        status, detail = _run_case(fmt, data)
        print(f"[bomb] {fmt}/{name}: {status} ({time.perf_counter() - t0:.2f}s) {detail}")
        if status.startswith("finding"):
            findings.append((fmt, name, status, detail))
        del data

    for fmt, fmt_seeds in SEEDS.items():
        for i in range(args.cases):
            base = rng.choice(fmt_seeds)
            if rng.random() < 0.1 and len(fmt_seeds) > 1:  # splice
                other = rng.choice(fmt_seeds)
                cut = rng.randrange(1, len(base))
                base = base[:cut] + other[rng.randrange(len(other)):]
            data = _mutate(rng, base)
            status, detail = _run_case(fmt, data)
            if status.startswith("finding"):
                outdir.mkdir(parents=True, exist_ok=True)
                p = outdir / f"{fmt}_{status}_{args.seed}_{i}.bin"
                p.write_bytes(data)
                findings.append((fmt, str(p), status, detail))
                print(f"[FINDING] {fmt} case {i}: {status} {detail} -> {p}")
            else:
                counts[status] = counts.get(status, 0) + 1

    dt = time.perf_counter() - t_start
    total = sum(counts.values()) + len(findings)
    print(
        f"\n{total} cases in {dt:.1f}s: {counts.get('ok', 0)} ok, "
        f"{counts.get('handled', 0)} handled errors, {len(findings)} findings"
    )
    for f in findings:
        print("  FINDING:", f)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
