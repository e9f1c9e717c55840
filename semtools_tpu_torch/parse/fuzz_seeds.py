"""The fuzz's seed documents: valid seeds and crafted-input bombs.

A copy of the JAX package's builders (``tests/seeds.py``: one canonical
construction per adversarial document shape, shared there by the regression
tests and ``scripts/fuzz_localparse.py``), giving byte for byte the same
documents, so that the port's fuzz (:mod:`semtools_tpu_torch.parse.fuzz`)
mutates what the JAX package's mutates. Standard library only: the fuzz
runs under an address-space rlimit that numpy or torch would break.
"""

from __future__ import annotations

import io
import zipfile
import zlib
from typing import Dict, Iterable, Tuple, Union

Members = Union[Dict[str, Union[str, bytes]], Iterable[Tuple[str, Union[str, bytes]]]]


def zip_bytes(members: Members) -> bytes:
    buf = io.BytesIO()
    items = members.items() if isinstance(members, dict) else members
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, data in items:
            zf.writestr(name, data)
    return buf.getvalue()


def assemble_pdf(objects: Iterable[Tuple[int, bytes]], header: bytes = b"%PDF-1.4\n") -> bytes:
    out = bytearray(header)
    for num, body in objects:
        out += b"%d 0 obj\n" % num + body + b"\nendobj\n"
    out += b"%%EOF\n"
    return bytes(out)


# ---------------------------------------------------------------------------
# Valid seeds


def simple_pdf(compress: bool = False) -> bytes:
    text = b"BT /F1 12 Tf 72 700 Td (Hello fuzz world) Tj ET"
    if compress:
        z = zlib.compress(text)
        stream = b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(z) + z + b"\nendstream"
    else:
        stream = b"<< /Length %d >>\nstream\n" % len(text) + text + b"\nendstream"
    return assemble_pdf([
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>"),
        (3, b"<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>"),
        (4, stream),
    ])


def docx_seed() -> bytes:
    doc = (
        '<?xml version="1.0"?>'
        '<w:document xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main">'
        "<w:body>"
        '<w:p><w:pPr><w:pStyle w:val="Heading1"/></w:pPr><w:r><w:t>Title</w:t></w:r></w:p>'
        "<w:p><w:r><w:rPr><w:b/></w:rPr><w:t>bold</w:t></w:r><w:r><w:t> text</w:t></w:r></w:p>"
        "<w:tbl><w:tr><w:tc><w:p><w:r><w:t>a</w:t></w:r></w:p></w:tc>"
        "<w:tc><w:p><w:r><w:t>b</w:t></w:r></w:p></w:tc></w:tr></w:tbl>"
        "</w:body></w:document>"
    )
    return zip_bytes([("word/document.xml", doc)])


def pptx_seed() -> bytes:
    slide = (
        '<?xml version="1.0"?>'
        '<p:sld xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main" '
        'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main">'
        '<p:sp><p:ph type="title"/><a:p><a:r><a:t>Slide title</a:t></a:r></a:p></p:sp>'
        "<p:sp><a:p><a:r><a:t>bullet one</a:t></a:r></a:p></p:sp>"
        "</p:sld>"
    )
    return zip_bytes([("ppt/slides/slide1.xml", slide)])


_NS_S = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_NS_R = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
_NS_REL = "http://schemas.openxmlformats.org/package/2006/relationships"


def _xlsx_package(sheet_xml: str, shared_xml: str = "") -> bytes:
    wb = (
        f'<workbook xmlns="{_NS_S}" xmlns:r="{_NS_R}">'
        f'<sheets><sheet name="S1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    rels = (
        f'<Relationships xmlns="{_NS_REL}">'
        '<Relationship Id="rId1" Target="worksheets/sheet1.xml"/></Relationships>'
    )
    members = [
        ("xl/workbook.xml", wb),
        ("xl/_rels/workbook.xml.rels", rels),
        ("xl/worksheets/sheet1.xml", sheet_xml),
    ]
    if shared_xml:
        members.append(("xl/sharedStrings.xml", shared_xml))
    return zip_bytes(members)


def xlsx_seed() -> bytes:
    return _xlsx_package(
        f'<worksheet xmlns="{_NS_S}"><sheetData>'
        '<row r="1"><c r="A1" t="s"><v>0</v></c><c r="B1"><v>42</v></c></row>'
        '<row r="2"><c r="A2" t="inlineStr"><is><t>inline</t></is></c></row>'
        "</sheetData></worksheet>",
        shared_xml=f'<sst xmlns="{_NS_S}"><si><t>hello</t></si></sst>',
    )


def odt_seed() -> bytes:
    t = "urn:oasis:names:tc:opendocument:xmlns:text:1.0"
    o = "urn:oasis:names:tc:opendocument:xmlns:office:1.0"
    tb = "urn:oasis:names:tc:opendocument:xmlns:table:1.0"
    content = (
        f'<office:document-content xmlns:office="{o}" xmlns:text="{t}" '
        f'xmlns:table="{tb}"><office:body><office:text>'
        '<text:h text:outline-level="2">Head</text:h>'
        "<text:p>Body<text:tab/>text<text:s text:c='4'/>here.</text:p>"
        "<text:list><text:list-item><text:p>li</text:p></text:list-item></text:list>"
        "<table:table><table:table-row>"
        "<table:table-cell><text:p>x</text:p></table:table-cell>"
        "</table:table-row></table:table>"
        "</office:text></office:body></office:document-content>"
    )
    return zip_bytes([("content.xml", content)])


def epub_seed() -> bytes:
    return zip_bytes([
        ("META-INF/container.xml",
         '<container xmlns="urn:oasis:names:tc:opendocument:xmlns:container">'
         '<rootfiles><rootfile full-path="OEBPS/content.opf"/></rootfiles></container>'),
        ("OEBPS/content.opf",
         '<package xmlns="http://www.idpf.org/2007/opf"><manifest>'
         '<item id="c1" href="ch1.xhtml"/></manifest>'
         '<spine><itemref idref="c1"/></spine></package>'),
        ("OEBPS/ch1.xhtml",
         "<html><body><h1>T</h1><p>chapter text</p></body></html>"),
    ])


def html_seed() -> bytes:
    return (
        b"<html><head><title>T</title><style>x{}</style></head><body>"
        b"<h1>Header</h1><p>Some <b>bold</b> text with a "
        b'<a href="http://x">link</a>.</p><ul><li>one</li><li>two</li></ul>'
        b"<table><tr><td>a</td><td>b</td></tr></table></body></html>"
    )


def rtf_seed() -> bytes:
    return (
        rb"{\rtf1\ansi\deff0 {\fonttbl {\f0 Times;}}"
        rb"{\colortbl;\red0\green0\blue0;}"
        rb"\pard Plain text \b bold\b0 and \'e9 accents \u8364? euro.\par"
        rb"{\*\generator Fuzz 1.0;}}"
    )


# ---------------------------------------------------------------------------
# Crafted-input bombs (the converters must contain every one of these)


def pdf_cyclic_kids() -> bytes:
    """Pages node whose /Kids include itself and its parent — exponential
    page-tree visits under a depth cap alone."""
    return assemble_pdf([
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [2 0 R 2 0 R 3 0 R 1 0 R] /Count 9 >>"),
        (3, b"<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>"),
        (4, b"<< /Length 47 >>\nstream\n"
            b"BT /F1 12 Tf 72 700 Td (cycle survivor) Tj ET\nendstream"),
    ])


def pdf_ref_cycle() -> bytes:
    """Indirect references that resolve to each other forever."""
    return assemble_pdf([
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"5 0 R"),
        (5, b"2 0 R"),
        (3, b"<< /Type /Page /Contents 5 0 R >>"),
    ])


def pdf_flate_bomb(decoded_size: int = 512 << 20) -> bytes:
    """A few-KB FlateDecode stream claiming ``decoded_size`` bytes."""
    z = zlib.compress(b"\0" * decoded_size, 9)
    stream = b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(z) + z + b"\nendstream"
    return assemble_pdf([
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>"),
        (3, b"<< /Type /Page /Contents 4 0 R >>"),
        (4, stream),
    ])


def pdf_filter_chain_bomb() -> bytes:
    """[/Fl /Fl ...] chains multiply expansion per stage."""
    nested = zlib.compress(zlib.compress(zlib.compress(zlib.compress(zlib.compress(b"(hi) Tj")))))
    return assemble_pdf([
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>"),
        (3, b"<< /Type /Page /Contents 4 0 R >>"),
        (4, b"<< /Length %d /Filter [/Fl /Fl /Fl /Fl /Fl] >>\nstream\n"
            % len(nested) + nested + b"\nendstream"),
    ])


def pdf_predictor_bomb() -> bytes:
    """Giant /Columns sizing the per-row predictor allocation."""
    z = zlib.compress(b"\1" + b"\0" * 4096)
    stream = (
        b"<< /Length %d /Filter /FlateDecode "
        b"/DecodeParms << /Predictor 12 /Columns 1073741824 >> >>\nstream\n" % len(z)
        + z + b"\nendstream"
    )
    return assemble_pdf([
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>"),
        (3, b"<< /Type /Page /Contents 4 0 R >>"),
        (4, stream),
    ])


def xlsx_colref_bomb() -> bytes:
    """Cell ref ZZZZZZ1 (~300M columns) driving the row-padding loop."""
    return _xlsx_package(
        f'<worksheet xmlns="{_NS_S}"><sheetData>'
        '<row r="1"><c r="ZZZZZZ1"><v>7</v></c></row>'
        "</sheetData></worksheet>"
    )


def odt_space_bomb() -> bytes:
    """text:s with a giant run-length space count."""
    t = "urn:oasis:names:tc:opendocument:xmlns:text:1.0"
    o = "urn:oasis:names:tc:opendocument:xmlns:office:1.0"
    content = (
        f'<office:document-content xmlns:office="{o}" xmlns:text="{t}">'
        "<office:body><office:text>"
        "<text:p>a<text:s text:c='8000000000'/>b</text:p>"
        "</office:text></office:body></office:document-content>"
    )
    return zip_bytes([("content.xml", content)])


def zip_member_bomb(decoded_size: int = 512 << 20) -> bytes:
    """An OOXML member inflating to ``decoded_size`` bytes."""
    return zip_bytes([("word/document.xml", b"<w:document>" + b"\0" * decoded_size)])
