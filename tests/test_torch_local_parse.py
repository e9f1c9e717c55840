"""``parse -b local``: the port's converters against the JAX package's.

Every test of ``tests/test_local_parse.py`` runs again here with each JAX
converter (``semtools_tpu.parse.extract`` / ``pdftext``) replaced by a twin
that calls it and the port's converter of the same name on the same bytes:
the outputs must be byte-equal, or both must raise the same exception type
with the same message. So every document and every hostile input (flate and
zip bombs, self-referential page trees, predictor sizes) that the JAX tests
build goes through both packages, and the JAX test's own assertions still
hold. Then the backend and the CLI: ``parse -b local`` through both CLIs
(stdout, ``-j``, stderr and cache bytes equal) and the unknown backend.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import io
import json
import sys
import time
import zlib

import pytest

import tests.test_local_parse as jax_tests
from tests import seeds

PKGS = ("semtools_tpu", "semtools_tpu_torch")
CONVERTERS = ("pdf_to_text", "docx_to_markdown", "pptx_to_markdown", "xlsx_to_markdown",
              "html_to_markdown", "rtf_to_text", "odt_to_markdown", "epub_to_markdown")
# the ToUnicode CMap parser, which the JAX tests call directly
TWINNED = CONVERTERS + ("_parse_tounicode",)
PDFTEXT = ("pdf_to_text", "_parse_tounicode")


def _module_of(pkg, name):
    return importlib.import_module(f"{pkg}.parse.{'pdftext' if name in PDFTEXT else 'extract'}")


def _jax_test_cases():
    cases = []
    for name, obj in vars(jax_tests).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            cases.append((name, None))
        elif name.startswith("Test") and inspect.isclass(obj):
            cases += [(f"{name}::{m}", obj) for m in vars(obj) if m.startswith("test_")]
    return cases


CASES = _jax_test_cases()
# tests of the JAX package's internals or of inputs no converter sees; their
# port counterparts are the tests below
NO_CONVERTER = {"TestLocalBackend::test_unsupported_extension",
                "TestCraftedInputBombs::test_shared_stream_charges_decode_budget_once",
                "test_cli_unknown_backend_lists_both"}


def _twin(name, calls):
    jax_fn = getattr(_module_of(PKGS[0], name), name)
    port_fn = getattr(_module_of(PKGS[1], name), name)

    @functools.wraps(jax_fn)
    def both(data, *args, **kwargs):
        try:
            want = jax_fn(data, *args, **kwargs)
        except Exception as e:  # the port must fail alike
            try:
                port_fn(data, *args, **kwargs)
            except Exception as p:
                assert (type(p).__name__, str(p)) == (type(e).__name__, str(e)), name
            else:
                pytest.fail(f"{name}: the JAX package raised {e!r}, the port did not")
            calls.append(name)
            raise
        got = port_fn(data, *args, **kwargs)
        if isinstance(want, str):
            assert isinstance(got, str) and got.encode() == want.encode(), name
        else:
            assert got == want, name
        calls.append(name)
        return want

    return both


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_jax_local_parse_case_matches_port(case, request, monkeypatch):
    owner = dict(CASES)[case]
    fn = getattr(owner(), case.split("::")[1]) if owner else getattr(jax_tests, case)
    calls = []
    for name in TWINNED:
        twin = _twin(name, calls)
        monkeypatch.setattr(_module_of(PKGS[0], name), name, twin)
        if hasattr(jax_tests, name):
            monkeypatch.setattr(jax_tests, name, twin)
    kwargs = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    fn(**kwargs)
    if case in NO_CONVERTER:
        assert not calls
    else:
        assert calls, f"{case} reached no converter"


def test_supported_extensions_match_jax():
    """Both local backends route the same extensions to the same converter."""
    routes = []
    for pkg in PKGS:
        lb = importlib.import_module(f"{pkg}.parse.local_backend")
        routes.append({ext: fn.__name__ for ext, fn in lb._CONVERTERS.items()})
        assert lb.supported_extensions() == sorted(routes[-1])
    assert routes[0] == routes[1] and len(routes[0]) == 13


def test_decode_budget_charged_once_in_port():
    """The port's ``PdfDocument`` decodes a stream shared by three pages
    once, as the JAX one does (its test reads that package's internals)."""
    payload = zlib.compress(b"BT (shared) Tj ET" + b" " * 60000)
    objects = [
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [3 0 R 4 0 R 5 0 R] /Count 3 >>"),
        (3, b"<< /Type /Page /Parent 2 0 R /Contents 6 0 R >>"),
        (4, b"<< /Type /Page /Parent 2 0 R /Contents 6 0 R >>"),
        (5, b"<< /Type /Page /Parent 2 0 R /Contents 6 0 R >>"),
        (6, b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(payload)
            + payload + b"\nendstream"),
    ]
    spent = []
    for pkg in PKGS:
        pdftext = importlib.import_module(f"{pkg}.parse.pdftext")
        doc = pdftext.PdfDocument(seeds.assemble_pdf(objects))
        for _ in range(3):
            assert doc.stream_of(pdftext.Ref(6)) is not None
        spent.append(doc.MAX_DECODE_BUDGET - doc._decode_budget)
        assert pdftext.pdf_to_text(seeds.assemble_pdf(objects)).count("shared") == 3
    assert spent[0] == spent[1] < 2 * 60017


@pytest.mark.parametrize("bomb", ["pdf_cyclic_kids", "pdf_flate_bomb", "pdf_filter_chain_bomb",
                                  "pdf_predictor_bomb", "xlsx_colref_bomb", "odt_space_bomb"])
def test_port_bombs_terminate(bomb):
    """Each hostile input alone through the port, timed on its own."""
    conv = {"xlsx": "xlsx_to_markdown", "odt": "odt_to_markdown"}.get(bomb.split("_")[0],
                                                                        "pdf_to_text")
    fn = getattr(_module_of(PKGS[1], conv), conv)
    data = getattr(seeds, bomb)()
    t0 = time.perf_counter()
    out = fn(data)
    assert time.perf_counter() - t0 < 5.0
    assert out == getattr(_module_of(PKGS[0], conv), conv)(data)


def _cli(pkg, argv, home, monkeypatch, capsys):
    cli = importlib.import_module(f"{pkg}.cli")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    capsys.readouterr()
    rc = cli.main(argv)
    captured = capsys.readouterr()
    return rc, captured.out.replace(str(home), "<HOME>"), captured.err.replace(str(home), "<HOME>")


def _docs(root):
    files = {
        "a.docx": jax_tests._docx_bytes(), "b.pptx": jax_tests._pptx_bytes(),
        "c.xlsx": jax_tests._xlsx_bytes(), "d.pdf": jax_tests._simple_pdf(compress=True),
        "e.html": b"<h1>T</h1><p>body</p>", "f.rtf": rb"{\rtf1 rtf body\par}",
        "g.odt": jax_tests._odt_bytes(), "h.epub": jax_tests._epub_bytes(),
        "broken.docx": b"this is not a zip", "movie.mp4": b"\x00\x01", "notes.txt": b"plain\n",
    }
    root.mkdir()
    for name, data in files.items():
        (root / name).write_bytes(data)
    return [str(root / n) for n in sorted(files)] + [str(root / "missing.pdf")]


@pytest.mark.parametrize("flags", [[], ["-j"], ["-v", "-j"]])
def test_cli_local_backend_matches_jax(flags, tmp_path, monkeypatch, capsys):
    """``parse -b local`` through both CLIs over every format, a broken and an
    unsupported document, a text file and a missing one: the same stdout and
    stderr, twice (the second served from the cache), and the same cache."""
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    files = _docs(tmp_path / "docs")
    obs = []
    for pkg in PKGS:
        home = tmp_path / f"home_{pkg}"
        home.mkdir()
        runs = [_cli(pkg, ["parse", "-b", "local", *flags, *files], home, monkeypatch, capsys)
                for _ in range(2)]
        cache = {p.name: p.read_bytes().replace(str(home).encode(), b"<HOME>")
                 for p in sorted((home / ".parse").iterdir())}
        obs.append((runs, cache))
    assert obs[1] == obs[0]
    (rc1, out1, err1), (rc2, out2, err2) = obs[0][0]
    assert rc1 == rc2 == 0
    assert err1.count("Error processing file") == 2 and "not supported" in err1
    assert len(obs[0][1]) == 2 * 8  # eight documents converted: .md + metadata each
    if "-j" in flags:
        cached = [r["was_cached"] for r in json.loads(out2)["results"]]
        assert cached.count(True) == 8


def test_cli_unknown_backend_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    f = tmp_path / "x.pdf"
    f.write_bytes(jax_tests._simple_pdf())
    outs = [_cli(pkg, ["parse", "-b", "bogus", str(f)], tmp_path, monkeypatch, capsys)
            for pkg in PKGS]
    assert outs[0] == outs[1]
    assert outs[0][0] == 1 and "llama-parse, local" in outs[0][2]


def test_local_cache_shared_across_packages(tmp_path):
    """The local backend's entries are one format: each package serves the
    other's, under the ``local`` namespace only."""
    doc = tmp_path / "r.docx"
    doc.write_bytes(jax_tests._docx_bytes())
    for writer, reader in (PKGS, PKGS[::-1]):
        cache = tmp_path / f"cache_{writer}"
        w = importlib.import_module(f"{writer}.parse").LocalParseBackend(cache_dir=str(cache))
        r = importlib.import_module(f"{reader}.parse").LocalParseBackend(cache_dir=str(cache))
        first = w.parse_detailed([str(doc)])
        again = r.parse_detailed([str(doc)])
        assert [(g.output_path, g.was_cached) for g in again] == [(first[0].output_path, True)]
        cloud = importlib.import_module(f"{reader}.parse").CacheManager(str(cache))
        assert cloud.get_cached_result(str(doc)) is None
