"""The port's local-parse fuzz (``semtools_tpu_torch.parse.fuzz`` and its
seed builders ``parse.fuzz_seeds``) against the JAX package's
``scripts/fuzz_localparse.py`` and ``tests/seeds.py``.

Every builder gives the same bytes in both (at small bomb sizes where it
takes one; zip timestamps pinned). Both harnesses run unmodified in child
processes at ``--cases 15 --seed 1`` with the wall clock pinned (zip members
carry it), and must count the same ok, handled and finding cases; the
port's child must load no torch, numpy, jax or JAX package. A converter
planted to hang, to escape ``except Exception`` or to misbehave otherwise
must come out as the finding the reference's statuses name.
"""

from __future__ import annotations

import importlib.util
import random
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from semtools_tpu_torch.parse import fuzz
from semtools_tpu_torch.parse import fuzz_seeds
from tests import seeds

REPO = Path(__file__).resolve().parents[1]
PINNED_TIME = 1_700_000_000.0
HEAVY = ("torch", "numpy", "jax", "jaxlib", "semtools_tpu")
# Runs a harness (a script path, or ``-m`` and a module) with the wall clock
# pinned, then prints the top-level packages it loaded among HEAVY.
HARNESS = (
    "import runpy, sys, time\n"
    f"time.time = lambda: {PINNED_TIME!r}\n"
    "target, sys.argv = sys.argv[1], sys.argv[1:]\n"
    "code = 0\n"
    "try:\n"
    "    if target == '-m':\n"
    "        sys.argv = sys.argv[1:]\n"
    "        runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "    else:\n"
    "        runpy.run_path(target, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    code = e.code\n"
    f"print('LOADED', sorted({{m.split('.')[0] for m in sys.modules}} & set({HEAVY!r})))\n"
    "sys.exit(code)\n"
)
SUMMARY = re.compile(r"^(\d+) cases in [\d.]+s: (\d+) ok, (\d+) handled errors, (\d+) findings$",
                     re.M)

BUILDERS = [
    ("simple_pdf", {}), ("simple_pdf", {"compress": True}), ("docx_seed", {}),
    ("pptx_seed", {}), ("xlsx_seed", {}), ("odt_seed", {}), ("epub_seed", {}),
    ("html_seed", {}), ("rtf_seed", {}), ("pdf_cyclic_kids", {}), ("pdf_ref_cycle", {}),
    ("pdf_flate_bomb", {"decoded_size": 1 << 16}), ("pdf_filter_chain_bomb", {}),
    ("pdf_predictor_bomb", {}), ("xlsx_colref_bomb", {}), ("odt_space_bomb", {}),
    ("zip_member_bomb", {"decoded_size": 1 << 16}),
]


def _public(module):
    return {n for n, v in vars(module).items()
            if callable(v) and not n.startswith("_") and getattr(v, "__module__", "") ==
            module.__name__}


def test_every_builder_is_copied():
    assert _public(fuzz_seeds) == _public(seeds)
    assert {name for name, _ in BUILDERS} | {"zip_bytes", "assemble_pdf"} == _public(seeds)


@pytest.mark.parametrize("name,kwargs", BUILDERS, ids=lambda v: str(v))
def test_builder_bytes_equal(monkeypatch, name, kwargs):
    monkeypatch.setattr(time, "time", lambda: PINNED_TIME)
    assert getattr(fuzz_seeds, name)(**kwargs) == getattr(seeds, name)(**kwargs)


def test_helpers_bytes_equal(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: PINNED_TIME)
    members = [("a.xml", "<a/>"), ("b.bin", b"\0\1")]
    assert fuzz_seeds.zip_bytes(members) == seeds.zip_bytes(members)
    assert fuzz_seeds.zip_bytes(dict(members)) == seeds.zip_bytes(dict(members))
    objects = [(1, b"<< >>"), (7, b"(x)")]
    assert fuzz_seeds.assemble_pdf(objects) == seeds.assemble_pdf(objects)
    assert (fuzz_seeds.assemble_pdf(objects, header=b"%PDF-1.7\n")
            == seeds.assemble_pdf(objects, header=b"%PDF-1.7\n"))


def test_the_harness_draws_the_same_cases():
    """One seed gives both harnesses the same mutated bytes, case by case."""
    spec = importlib.util.spec_from_file_location("jax_fuzz_localparse",
                                                  REPO / "scripts" / "fuzz_localparse.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for seed in (0, 1, 7):
        a, b = random.Random(seed), random.Random(seed)
        for data in (seeds.rtf_seed(), seeds.html_seed(), seeds.simple_pdf()):
            for _ in range(40):
                assert fuzz._mutate(a, data) == ref._mutate(b, data)


def _run(cmd, cwd: Path):
    return subprocess.Popen([sys.executable, "-c", HARNESS, *cmd], cwd=str(cwd),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            stdin=subprocess.DEVNULL)


def test_fuzz_counts_equal_the_reference(tmp_path):
    args = ["--cases", "15", "--seed", "1"]
    procs = {
        "jax": _run([str(REPO / "scripts" / "fuzz_localparse.py"), *args,
                     "--out", str(tmp_path / "jax")], REPO),
        "port": _run(["-m", "semtools_tpu_torch.parse.fuzz", *args,
                      "--out", str(tmp_path / "port")], REPO),
    }
    outs = {}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, f"{name}: {out[-3000:]}"
        outs[name] = out
    counts = {name: SUMMARY.search(out).groups() for name, out in outs.items()}
    assert counts["port"] == counts["jax"]
    total, ok, handled, findings = map(int, counts["port"])
    assert findings == 0 and total == ok + handled == 15 * len(fuzz.SEEDS)  # bombs uncounted
    assert "LOADED []" in outs["port"]
    bombs = [ln.split(" (")[0] for ln in outs["port"].splitlines() if ln.startswith("[bomb]")]
    assert bombs == [ln.split(" (")[0] for ln in outs["jax"].splitlines()
                     if ln.startswith("[bomb]")]


class Planted(BaseException):
    """What a converter could raise past ``except Exception``."""


def _spin(_data):
    while True:
        pass


def _raise(exc):
    def conv(_data):
        raise exc
    return conv


PLANTED = [
    ("hang", _spin, "finding-timeout"),
    ("escape", _raise(Planted("planted")), "finding-escape"),
    ("keyboard", _raise(KeyboardInterrupt()), "finding-escape"),
    ("memory", _raise(MemoryError()), "finding-memory"),
    ("recursion", _raise(RecursionError("deep")), "finding-recursion"),
    ("bytes", lambda _data: b"not text", "finding-type"),
    ("value", _raise(ValueError("bad")), "handled"),
    ("text", lambda _data: "text", "ok"),
]


@pytest.mark.parametrize("what,conv,status", PLANTED, ids=[p[0] for p in PLANTED])
def test_planted_converter_status(monkeypatch, what, conv, status):
    monkeypatch.setattr(fuzz, "TIMEOUT_S", 0.2)
    monkeypatch.setitem(fuzz.CONVERTERS, "html", conv)
    old = signal.signal(signal.SIGALRM, fuzz._alarm)
    try:
        t0 = time.perf_counter()
        got, detail = fuzz._run_case("html", b"<p>x</p>")
        assert time.perf_counter() - t0 < 5
    finally:
        signal.signal(signal.SIGALRM, old)
    assert got == status, detail
    if what == "escape":
        assert detail == "Planted: planted"


def test_main_saves_findings_and_exits_1(tmp_path):
    """A planted hang (one format) and a planted BaseException (another) in
    the harness's own run: each case a finding, its input saved, exit 1."""
    script = (
        "import sys\n"
        "from semtools_tpu_torch.parse import fuzz\n"
        "class Planted(BaseException):\n"
        "    pass\n"
        "def spin(data):\n"
        "    while True:\n"
        "        pass\n"
        "def escape(data):\n"
        "    raise Planted('planted')\n"
        "fuzz.TIMEOUT_S = 0.1\n"
        "fuzz.BOMB_CASES = []\n"
        "fuzz.CONVERTERS.update(rtf=spin, html=escape)\n"
        f"sys.exit(fuzz.main(['--cases', '2', '--seed', '3', '--out', {str(tmp_path)!r}]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO), capture_output=True,
                          text=True, stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-2000:]
    total, ok, handled, findings = map(int, SUMMARY.search(proc.stdout).groups())
    assert findings == 4 and total == 2 * len(fuzz.SEEDS)
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved == ["html_finding-escape_3_0.bin", "html_finding-escape_3_1.bin",
                     "rtf_finding-timeout_3_0.bin", "rtf_finding-timeout_3_1.bin"]
    assert "Planted: planted" in proc.stdout
