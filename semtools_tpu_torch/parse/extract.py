"""Offline document → markdown converters (stdlib only).

The port's own copy of ``semtools_tpu/parse/extract.py`` (the port imports
nothing of the JAX package); both must give byte-equal output on every
input (``tests/test_torch_local_parse.py``).

These back the ``local`` parse backend (see local_backend.py): the
reference's only backend ships every document to the LlamaParse cloud
(src/parse/backend.rs, src/parse/client.rs); this module handles the
common office formats without any network, trading LlamaParse's
layout/OCR fidelity for availability.

Formats: DOCX / PPTX / XLSX (OOXML zip + XML via ``xml.etree``), ODT
(OpenDocument), EPUB (OPF spine -> XHTML chapters), PDF (text layer, see
pdftext.py), HTML (``html.parser``), RTF (control-word stripper).  Each
converter takes raw ``bytes`` and returns markdown.
"""

from __future__ import annotations

import html
import io
import re
import zipfile
from html.parser import HTMLParser
from typing import Dict, List, Optional
from xml.etree import ElementTree as ET

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_P = "{http://schemas.openxmlformats.org/presentationml/2006/main}"
_S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_R = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
_REL = "{http://schemas.openxmlformats.org/package/2006/relationships}"


# Zip-bomb guard: an OOXML member must not expand past this when read.
# Real office XML tops out in the tens of MB (huge sharedStrings.xml);
# a member claiming more is hostile, not a document.
_MAX_MEMBER_BYTES = 128 << 20


def _zread(zf: zipfile.ZipFile, name: str) -> bytes:
    """``zf.read(name)`` with a decompressed-size bound.

    Raises ``KeyError`` for a missing member (like ``read``) and
    ``ValueError`` for one that inflates past ``_MAX_MEMBER_BYTES`` —
    both are contained by the local backend's per-file error isolation.
    """
    with zf.open(name) as fh:
        data = fh.read(_MAX_MEMBER_BYTES + 1)
    if len(data) > _MAX_MEMBER_BYTES:
        raise ValueError(f"{name}: zip member exceeds {_MAX_MEMBER_BYTES} bytes decompressed")
    return data


def _md_escape_cell(s: str) -> str:
    return s.replace("|", "\\|").replace("\n", " ").strip()


def _md_table(rows: List[List[str]]) -> str:
    if not rows:
        return ""
    width = max(len(r) for r in rows)
    rows = [r + [""] * (width - len(r)) for r in rows]
    out = ["| " + " | ".join(_md_escape_cell(c) for c in rows[0]) + " |"]
    out.append("|" + "---|" * width)
    for r in rows[1:]:
        out.append("| " + " | ".join(_md_escape_cell(c) for c in r) + " |")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# DOCX


def _docx_run_text(run) -> str:
    parts = []
    for el in run.iter():
        tag = el.tag
        if tag == f"{_W}t":
            parts.append(el.text or "")
        elif tag == f"{_W}tab":
            parts.append("\t")
        elif tag in (f"{_W}br", f"{_W}cr"):
            parts.append("\n")
    text = "".join(parts)
    if not text.strip():
        return text
    rpr = run.find(f"{_W}rPr")
    if rpr is not None:
        bold = rpr.find(f"{_W}b") is not None
        italic = rpr.find(f"{_W}i") is not None
        lead = text[: len(text) - len(text.lstrip())]
        trail = text[len(text.rstrip()) :]
        core = text.strip()
        if bold and core:
            core = f"**{core}**"
        if italic and core:
            core = f"*{core}*"
        text = lead + core + trail
    return text


def _docx_paragraph(par, rels: Dict[str, str]) -> str:
    ppr = par.find(f"{_W}pPr")
    prefix = ""
    if ppr is not None:
        style = ppr.find(f"{_W}pStyle")
        if style is not None:
            val = style.get(f"{_W}val", "")
            m = re.fullmatch(r"[Hh]eading(\d)", val)
            if m:
                prefix = "#" * int(m.group(1)) + " "
            elif val in ("Title", "title"):
                prefix = "# "
        if ppr.find(f"{_W}numPr") is not None:
            ilvl_el = ppr.find(f"{_W}numPr/{_W}ilvl")
            ilvl = int(ilvl_el.get(f"{_W}val", "0")) if ilvl_el is not None else 0
            prefix = "  " * ilvl + "- "
    parts = []
    for child in par:
        if child.tag == f"{_W}r":
            parts.append(_docx_run_text(child))
        elif child.tag == f"{_W}hyperlink":
            inner = "".join(_docx_run_text(r) for r in child.findall(f"{_W}r"))
            url = rels.get(child.get(f"{_R}id", ""), "")
            parts.append(f"[{inner}]({url})" if url else inner)
    return prefix + "".join(parts)


def _docx_rels(zf: zipfile.ZipFile) -> Dict[str, str]:
    try:
        root = ET.fromstring(_zread(zf, "word/_rels/document.xml.rels"))
    except (KeyError, ET.ParseError):
        return {}
    return {
        rel.get("Id", ""): rel.get("Target", "")
        for rel in root.findall(f"{_REL}Relationship")
    }


def docx_to_markdown(data: bytes) -> str:
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        rels = _docx_rels(zf)
        root = ET.fromstring(_zread(zf, "word/document.xml"))
    body = root.find(f"{_W}body")
    if body is None:
        return ""
    blocks: List[str] = []
    for el in body:
        if el.tag == f"{_W}p":
            blocks.append(_docx_paragraph(el, rels))
        elif el.tag == f"{_W}tbl":
            rows = []
            for tr in el.findall(f"{_W}tr"):
                rows.append([
                    " ".join(
                        _docx_paragraph(p, rels)
                        for p in tc.findall(f"{_W}p")
                    ).strip()
                    for tc in tr.findall(f"{_W}tc")
                ])
            blocks.append(_md_table(rows))
    text = "\n\n".join(b for b in blocks if b.strip())
    return re.sub(r"\n{3,}", "\n\n", text).strip() + "\n"


# ---------------------------------------------------------------------------
# PPTX


def _pptx_shape_text(sp) -> List[str]:
    """Markdown lines of one shape's text body."""
    lines = []
    for para in sp.iter(f"{_A}p"):
        runs = [t.text or "" for t in para.iter(f"{_A}t")]
        line = "".join(runs).strip()
        if line:
            lines.append(line)
    return lines


def _pptx_is_title(sp) -> bool:
    for ph in sp.iter(f"{_P}ph"):
        if ph.get("type") in ("title", "ctrTitle"):
            return True
    return False


def pptx_to_markdown(data: bytes) -> str:
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        slide_names = sorted(
            (n for n in zf.namelist()
             if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
            key=lambda n: int(re.search(r"(\d+)", n).group(1)),
        )
        slides = [ET.fromstring(_zread(zf, n)) for n in slide_names]
    blocks: List[str] = []
    for i, slide in enumerate(slides, 1):
        title: Optional[str] = None
        body_lines: List[str] = []
        for sp in slide.iter(f"{_P}sp"):
            lines = _pptx_shape_text(sp)
            if not lines:
                continue
            if title is None and _pptx_is_title(sp):
                title = lines[0]
                body_lines.extend(f"- {line}" for line in lines[1:])
            else:
                body_lines.extend(f"- {line}" for line in lines)
        header = f"## {title}" if title else f"## Slide {i}"
        blocks.append("\n\n".join([header] + (["\n".join(body_lines)] if body_lines else [])))
    return "\n\n".join(blocks).strip() + "\n"


# ---------------------------------------------------------------------------
# XLSX


_CELL_REF = re.compile(r"([A-Z]+)(\d+)")


def _col_index(ref: str) -> int:
    m = _CELL_REF.match(ref)
    if not m:
        return 0
    n = 0
    for ch in m.group(1):
        n = n * 26 + (ord(ch) - 64)
    # Excel's last column is XFD (16383). A crafted ref like "ZZZZZZ1"
    # must not drive the row-padding loop to hundreds of millions of
    # filler cells.
    return min(n - 1, 16_383)


def _xlsx_shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        root = ET.fromstring(_zread(zf, "xl/sharedStrings.xml"))
    except (KeyError, ET.ParseError):
        return []
    out = []
    for si in root.findall(f"{_S}si"):
        out.append("".join(t.text or "" for t in si.iter(f"{_S}t")))
    return out


def _xlsx_sheet_rows(root, shared: List[str]) -> List[List[str]]:
    rows: List[List[str]] = []
    for row in root.iter(f"{_S}row"):
        cells: List[str] = []
        for c in row.findall(f"{_S}c"):
            idx = _col_index(c.get("r", ""))
            ctype = c.get("t", "n")
            if ctype == "inlineStr":
                val = "".join(t.text or "" for t in c.iter(f"{_S}t"))
            else:
                v = c.find(f"{_S}v")
                val = v.text or "" if v is not None else ""
                if ctype == "s":
                    try:
                        val = shared[int(val)]
                    except (ValueError, IndexError):
                        pass
                elif ctype == "b":
                    val = "TRUE" if val == "1" else "FALSE"
            while len(cells) < idx:
                cells.append("")
            cells.append(val)
        rows.append(cells)
    while rows and not any(c.strip() for c in rows[-1]):
        rows.pop()
    return rows


def xlsx_to_markdown(data: bytes) -> str:
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        shared = _xlsx_shared_strings(zf)
        try:
            wb = ET.fromstring(_zread(zf, "xl/workbook.xml"))
            rel_root = ET.fromstring(_zread(zf, "xl/_rels/workbook.xml.rels"))
        except (KeyError, ET.ParseError):
            return ""
        rels = {
            rel.get("Id", ""): rel.get("Target", "")
            for rel in rel_root.findall(f"{_REL}Relationship")
        }
        blocks = []
        for sheet in wb.iter(f"{_S}sheet"):
            name = sheet.get("name", "Sheet")
            target = rels.get(sheet.get(f"{_R}id", ""), "")
            if target.startswith("/"):
                member = target[1:]
            else:
                member = "xl/" + target
            try:
                root = ET.fromstring(_zread(zf, member))
            except (KeyError, ET.ParseError):
                continue
            rows = _xlsx_sheet_rows(root, shared)
            if rows:
                blocks.append(f"## {name}\n\n{_md_table(rows)}")
            else:
                blocks.append(f"## {name}")
    return "\n\n".join(blocks).strip() + "\n"


# ---------------------------------------------------------------------------
# HTML


_BLOCK_TAGS = {"p", "div", "section", "article", "header", "footer", "main",
               "figure", "figcaption", "aside", "nav"}
_SKIP_TAGS = {"script", "style", "head", "noscript", "template", "svg"}


class _Html2Md(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.out: List[str] = []
        self.skip = 0
        self.pre = 0
        self.list_stack: List[Optional[int]] = []  # None=ul, int=next ol idx
        self.href: Optional[str] = None
        self.link_text: List[str] = []
        self.table: Optional[List[List[str]]] = None
        self.row: Optional[List[str]] = None
        self.cell: Optional[List[str]] = None

    # -- emit helpers
    def _break(self) -> None:
        while self.out and self.out[-1] in (" ",):
            self.out.pop()
        if self.out and not "".join(self.out[-2:]).endswith("\n\n"):
            self.out.append("\n\n" if not "".join(self.out[-1:]).endswith("\n") else "\n")

    def _emit(self, s: str) -> None:
        if self.cell is not None:
            self.cell.append(s)
        elif self.href is not None:
            self.link_text.append(s)
        else:
            self.out.append(s)

    # -- parser hooks
    def handle_starttag(self, tag, attrs):
        if tag in _SKIP_TAGS:
            self.skip += 1
            return
        if self.skip:
            return
        a = dict(attrs)
        if tag in ("h1", "h2", "h3", "h4", "h5", "h6"):
            self._break()
            self.out.append("#" * int(tag[1]) + " ")
        elif tag in _BLOCK_TAGS:
            self._break()
        elif tag == "br":
            self._emit("\n")
        elif tag == "hr":
            self._break()
            self.out.append("---")
            self._break()
        elif tag == "ul":
            self.list_stack.append(None)
        elif tag == "ol":
            self.list_stack.append(1)
        elif tag == "li":
            if self.out and not "".join(self.out[-1:]).endswith("\n"):
                self.out.append("\n")
            depth = max(0, len(self.list_stack) - 1)
            marker = "- "
            if self.list_stack and self.list_stack[-1] is not None:
                marker = f"{self.list_stack[-1]}. "
                self.list_stack[-1] += 1
            self.out.append("  " * depth + marker)
        elif tag == "a":
            self.href = a.get("href") or ""
            self.link_text = []
        elif tag in ("strong", "b"):
            self._emit("**")
        elif tag in ("em", "i"):
            self._emit("*")
        elif tag == "code" and not self.pre:
            self._emit("`")
        elif tag == "pre":
            self._break()
            self.out.append("```\n")
            self.pre += 1
        elif tag == "blockquote":
            self._break()
            self.out.append("> ")
        elif tag == "table":
            self.table = []
        elif tag == "tr" and self.table is not None:
            self.row = []
        elif tag in ("td", "th") and self.row is not None:
            self.cell = []
        elif tag == "img":
            alt = a.get("alt") or ""
            src = a.get("src") or ""
            self._emit(f"![{alt}]({src})")

    def handle_endtag(self, tag):
        if tag in _SKIP_TAGS:
            self.skip = max(0, self.skip - 1)
            return
        if self.skip:
            return
        if tag in ("h1", "h2", "h3", "h4", "h5", "h6") or tag in _BLOCK_TAGS:
            self._break()
        elif tag in ("ul", "ol"):
            if self.list_stack:
                self.list_stack.pop()
            self._break()
        elif tag == "a":
            text = "".join(self.link_text).strip()
            href = self.href or ""
            self.href = None
            self.link_text = []  # a stray/nested </a> must not re-emit it
            if text and href and not href.startswith(("#", "javascript:")):
                self._emit(f"[{text}]({href})")
            else:
                self._emit(text)
        elif tag in ("strong", "b"):
            self._emit("**")
        elif tag in ("em", "i"):
            self._emit("*")
        elif tag == "code" and not self.pre:
            self._emit("`")
        elif tag == "pre":
            self.pre = max(0, self.pre - 1)
            self.out.append("\n```")
            self._break()
        elif tag in ("td", "th"):
            if self.row is not None and self.cell is not None:
                self.row.append("".join(self.cell).strip())
            self.cell = None
        elif tag == "tr":
            if self.table is not None and self.row is not None:
                self.table.append(self.row)
            self.row = None
        elif tag == "table":
            if self.table:
                self._break()
                self.out.append(_md_table(self.table))
                self._break()
            self.table = None

    def handle_data(self, data):
        if self.skip:
            return
        if self.pre:
            self._emit(data)
            return
        text = re.sub(r"\s+", " ", data)
        if text == " " and (not self.out or "".join(self.out[-1:]).endswith(("\n", " "))) and self.cell is None and self.href is None:
            return
        if text:
            self._emit(text)


def html_to_markdown(data: bytes) -> str:
    for enc in ("utf-8", "latin-1"):
        try:
            text = data.decode(enc)
            break
        except UnicodeDecodeError:
            continue
    parser = _Html2Md()
    parser.feed(text)
    parser.close()
    out = "".join(parser.out)
    out = re.sub(r"[ \t]+\n", "\n", out)
    out = re.sub(r"\n{3,}", "\n\n", out)
    return out.strip() + "\n"


# ---------------------------------------------------------------------------
# RTF


_RTF_DEST_SKIP = {
    "fonttbl", "colortbl", "stylesheet", "info", "pict", "object",
    "header", "footer", "xmlnstbl", "themedata", "latentstyles",
    "datastore", "generator", "listtable", "listoverridetable",
}
_RTF_CTRL = re.compile(
    r"\\([a-zA-Z]+)(-?\d+)? ?|\\'([0-9a-fA-F]{2})|\\([^a-zA-Z])|([{}])"
)


def rtf_to_text(data: bytes) -> str:
    text = data.decode("latin-1", errors="replace")
    out: List[str] = []
    skip_depth = 0  # depth at which a skipped destination group started
    depth = 0
    uc_skip = 1
    pending_skip = 0
    pos = 0
    for m in _RTF_CTRL.finditer(text):
        if m.start() > pos and skip_depth == 0:
            chunk = text[pos : m.start()].replace("\r", "").replace("\n", "")
            if pending_skip:
                drop = min(pending_skip, len(chunk))
                chunk = chunk[drop:]
                pending_skip -= drop
            out.append(chunk)
        pos = m.end()
        word, num, hexb, sym, brace = m.groups()
        if brace == "{":
            depth += 1
        elif brace == "}":
            if skip_depth and depth <= skip_depth:
                skip_depth = 0
            depth -= 1
        elif skip_depth:
            continue
        elif hexb is not None:
            if pending_skip:
                pending_skip -= 1
            else:
                out.append(bytes([int(hexb, 16)]).decode("cp1252", "replace"))
        elif sym is not None:
            if sym == "*":
                skip_depth = depth  # \* destinations are app-specific
            elif sym in "{}\\":
                out.append(sym)
            elif sym == "~":
                out.append("\u00a0")
        elif word is not None:
            if word in _RTF_DEST_SKIP:
                skip_depth = depth
            elif word in ("par", "line", "row"):
                out.append("\n")
            elif word == "tab" or word == "cell":
                out.append("\t")
            elif word == "uc":
                uc_skip = int(num or 1)
            elif word == "u":
                out.append(chr(int(num or 0) & 0xFFFF))
                pending_skip = uc_skip
    if pos < len(text) and skip_depth == 0:
        out.append(text[pos:].replace("\r", "").replace("\n", "").rstrip("}"))
    result = "".join(out)
    result = re.sub(r"\n{3,}", "\n\n", result)
    return result.strip() + "\n" if result.strip() else ""


# ---------------------------------------------------------------------------
# ODT (OpenDocument Text — LibreOffice/OpenOffice)

_OFFICE = "{urn:oasis:names:tc:opendocument:xmlns:office:1.0}"
_TEXT = "{urn:oasis:names:tc:opendocument:xmlns:text:1.0}"
_TABLE = "{urn:oasis:names:tc:opendocument:xmlns:table:1.0}"


def _odt_inline_text(el) -> str:
    """Flattened text of a paragraph/heading, honoring tab, line-break,
    and run-length space elements."""
    parts: List[str] = [el.text or ""]
    for child in el:
        tag = child.tag
        if tag == f"{_TEXT}tab":
            parts.append("\t")
        elif tag == f"{_TEXT}line-break":
            parts.append("\n")
        elif tag == f"{_TEXT}s":
            try:
                # Clamp: text:c is attacker-controlled; an unclamped
                # repeat count is a one-attribute memory bomb.
                parts.append(" " * min(max(int(child.get(f"{_TEXT}c", "1")), 0), 1000))
            except ValueError:
                parts.append(" ")
        elif tag == f"{_TEXT}note":  # footnote body: keep the citation out
            pass
        else:
            parts.append(_odt_inline_text(child))
        parts.append(child.tail or "")
    return "".join(parts)


def _odt_block(el, blocks: List[str], list_depth: int = 0) -> None:
    tag = el.tag
    if tag == f"{_TEXT}h":
        try:
            level = max(1, min(6, int(el.get(f"{_TEXT}outline-level", "1"))))
        except ValueError:
            level = 1
        blocks.append("#" * level + " " + _odt_inline_text(el).strip())
    elif tag == f"{_TEXT}p":
        line = _odt_inline_text(el).strip()
        if list_depth:
            blocks.append("  " * (list_depth - 1) + "- " + line)
        elif line:
            blocks.append(line)
    elif tag == f"{_TEXT}list":
        for item in el:
            for sub in item:
                _odt_block(sub, blocks, list_depth + 1)
    elif tag == f"{_TABLE}table":
        rows: List[List[str]] = []
        for tr in el.iter(f"{_TABLE}table-row"):
            rows.append([
                " ".join(
                    _odt_inline_text(p).strip()
                    for p in tc.iter()
                    if p.tag in (f"{_TEXT}p", f"{_TEXT}h")
                ).strip()
                for tc in tr.findall(f"{_TABLE}table-cell")
            ])
        if rows:
            blocks.append(_md_table(rows))
    elif tag == f"{_OFFICE}text":
        for child in el:
            _odt_block(child, blocks, list_depth)


def odt_to_markdown(data: bytes) -> str:
    """OpenDocument Text -> markdown (content.xml body walk)."""
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        root = ET.fromstring(_zread(zf, "content.xml"))
    body = root.find(f"{_OFFICE}body")
    text = body.find(f"{_OFFICE}text") if body is not None else None
    if text is None:
        return ""
    blocks: List[str] = []
    _odt_block(text, blocks)
    out = "\n\n".join(b for b in blocks if b.strip())
    return re.sub(r"\n{3,}", "\n\n", out).strip() + "\n" if out.strip() else ""


# ---------------------------------------------------------------------------
# EPUB (zip of XHTML chapters; reading order from the OPF spine)

_CNT = "{urn:oasis:names:tc:opendocument:xmlns:container}"
_OPF = "{http://www.idpf.org/2007/opf}"


def _epub_spine_files(zf: zipfile.ZipFile) -> List[str]:
    """Chapter members in spine order; falls back to archive order of
    .x/html members when container/OPF metadata is missing or broken, or
    when no spine href resolves to a real member (e.g. hrefs the archive
    doesn't actually contain)."""
    import posixpath
    from urllib.parse import unquote

    names = set(zf.namelist())
    try:
        container = ET.fromstring(_zread(zf, "META-INF/container.xml"))
        rootfile = container.find(f"{_CNT}rootfiles/{_CNT}rootfile")
        opf_path = rootfile.get("full-path")
        opf = ET.fromstring(_zread(zf, opf_path))
        base = opf_path.rsplit("/", 1)[0] + "/" if "/" in opf_path else ""
        hrefs = {
            item.get("id"): item.get("href")
            for item in opf.find(f"{_OPF}manifest")
        }
        ordered = []
        for ref in opf.find(f"{_OPF}spine"):
            href = hrefs.get(ref.get("idref"))
            if href:
                # hrefs are URLs relative to the OPF: percent-encoded
                # (spaces are common) and possibly with ../ segments.
                member = posixpath.normpath(base + unquote(href.split("#")[0]))
                ordered.append(member)
        resolved = [m for m in ordered if m in names]
        if resolved:
            return resolved
    except (KeyError, ValueError, AttributeError, TypeError, ET.ParseError):
        pass  # missing/broken container or OPF: archive-order fallback
    return [
        n for n in zf.namelist()
        if n.lower().endswith((".xhtml", ".html", ".htm"))
    ]


def epub_to_markdown(data: bytes) -> str:
    blocks: List[str] = []
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for member in _epub_spine_files(zf):
            try:
                md = html_to_markdown(_zread(zf, member))
            except Exception:
                continue  # one damaged chapter degrades, never aborts the book
            if md.strip():
                blocks.append(md.strip())
    return "\n\n".join(blocks).strip() + "\n" if blocks else ""
