"""Minimal, dependency-free PDF text extraction.

The port's own copy of ``semtools_tpu/parse/pdftext.py`` (the port imports
nothing of the JAX package); both must give byte-equal output on every
input (``tests/test_torch_local_parse.py``).

Backs the offline ``local`` parse backend (the reference's only backend is
the LlamaParse cloud API, src/parse/backend.rs — useless on an air-gapped
machine; this module recovers the text layer of well-formed digital PDFs
without any network or third-party library).

Scope: the text layer of PDFs produced by normal typesetting pipelines —
classic xref tables AND xref-stream files (object streams are unpacked),
FlateDecode / ASCIIHexDecode / ASCII85Decode filters, simple-font and
Type0/CID text with ``/ToUnicode`` CMaps, and the standard text operators
(BT/ET, Tf, Td/TD/T*/Tm, Tj/TJ/'/").  Scanned (image-only) PDFs have no
text layer and yield empty output — OCR is out of scope, matching the
reference's default (OCR there is a LlamaParse cloud option,
example_semtools_config.json).

The interpreter favors robustness over completeness: unknown filters skip
the stream, undecodable codes degrade to a replacement character, and a
malformed object never aborts the document.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple


class Ref:
    """An indirect object reference ``n g R``."""

    __slots__ = ("num",)

    def __init__(self, num: int):
        self.num = num

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Ref({self.num})"


class Name(str):
    """A PDF name token (``/Foo``) — distinct from string literals."""


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _skip_ws(data: bytes, pos: int) -> int:
    n = len(data)
    while pos < n:
        c = data[pos]
        if c in _WS:
            pos += 1
        elif c == 0x25:  # '%' comment runs to EOL
            while pos < n and data[pos] not in b"\r\n":
                pos += 1
        else:
            break
    return pos


def _parse_name(data: bytes, pos: int) -> Tuple[Name, int]:
    pos += 1  # '/'
    out = bytearray()
    n = len(data)
    while pos < n:
        c = data[pos]
        if c in _WS or c in _DELIM:
            break
        if c == 0x23 and pos + 2 < n:  # '#xx' escape
            try:
                out.append(int(data[pos + 1 : pos + 3], 16))
                pos += 3
                continue
            except ValueError:
                pass
        out.append(c)
        pos += 1
    return Name(out.decode("latin-1")), pos


def _parse_literal_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    pos += 1  # '('
    out = bytearray()
    depth = 1
    n = len(data)
    while pos < n:
        c = data[pos]
        if c == 0x5C:  # backslash
            pos += 1
            if pos >= n:
                break
            e = data[pos]
            if e in b"nrtbf":
                out.append({0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12}[e])
                pos += 1
            elif e in b"()\\":
                out.append(e)
                pos += 1
            elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                oct_digits = bytearray()
                while pos < n and len(oct_digits) < 3 and 0x30 <= data[pos] <= 0x37:
                    oct_digits.append(data[pos])
                    pos += 1
                out.append(int(oct_digits, 8) & 0xFF)
            elif e in b"\r\n":  # line continuation
                pos += 1
                if e == 0x0D and pos < n and data[pos] == 0x0A:
                    pos += 1
            else:
                out.append(e)
                pos += 1
        elif c == 0x28:
            depth += 1
            out.append(c)
            pos += 1
        elif c == 0x29:
            depth -= 1
            if depth == 0:
                pos += 1
                break
            out.append(c)
            pos += 1
        else:
            out.append(c)
            pos += 1
    return bytes(out), pos


def _parse_hex_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    pos += 1  # '<'
    end = data.find(b">", pos)
    if end < 0:
        end = len(data)
    hx = re.sub(rb"[^0-9A-Fa-f]", b"", data[pos:end])
    if len(hx) % 2:
        hx += b"0"
    return bytes.fromhex(hx.decode("ascii")), end + 1


_NUM_RE = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)")
_REF_RE = re.compile(rb"(\d+)\s+(\d+)\s+R\b")


def parse_object(data: bytes, pos: int):
    """Parse one PDF object starting at ``pos``; returns (value, new_pos).

    Values map to: dict → dict[str, ...], array → list, name → Name,
    string → bytes, number → int/float, ref → Ref, bool → bool,
    null → None.
    """
    pos = _skip_ws(data, pos)
    if pos >= len(data):
        return None, pos
    c = data[pos]
    if data.startswith(b"<<", pos):
        pos += 2
        d: Dict[str, object] = {}
        while True:
            pos = _skip_ws(data, pos)
            if pos >= len(data) or data.startswith(b">>", pos):
                pos += 2
                break
            if data[pos] != 0x2F:  # tolerate junk keys: resync
                pos += 1
                continue
            key, pos = _parse_name(data, pos)
            val, pos = parse_object(data, pos)
            d[str(key)] = val
        return d, pos
    if c == 0x5B:  # '['
        pos += 1
        arr: List[object] = []
        while True:
            pos = _skip_ws(data, pos)
            if pos >= len(data) or data[pos] == 0x5D:
                pos += 1
                break
            val, pos = parse_object(data, pos)
            arr.append(val)
        return arr, pos
    if c == 0x2F:
        return _parse_name(data, pos)
    if c == 0x28:
        return _parse_literal_string(data, pos)
    if c == 0x3C:  # single '<' → hex string
        return _parse_hex_string(data, pos)
    if data.startswith(b"true", pos):
        return True, pos + 4
    if data.startswith(b"false", pos):
        return False, pos + 5
    if data.startswith(b"null", pos):
        return None, pos + 4
    m = _REF_RE.match(data, pos)
    if m:
        return Ref(int(m.group(1))), m.end()
    m = _NUM_RE.match(data, pos)
    if m:
        tok = m.group(0)
        return (float(tok) if b"." in tok else int(tok)), m.end()
    return None, pos + 1  # unknown token: skip a byte, stay robust


# ---------------------------------------------------------------------------
# Document model


_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class PdfDocument:
    # Decompression bounds: a crafted file must not be able to expand a
    # few KB of Flate data into GBs of heap (classic decompression bomb).
    # Real text content streams are KBs–MBs; 64 MiB per stream and a
    # 512 MiB cumulative budget per document are far above anything a
    # text-bearing PDF produces.
    MAX_STREAM_BYTES = 64 << 20
    MAX_DECODE_BUDGET = 512 << 20

    def __init__(self, data: bytes):
        self.data = data
        # obj num -> (dict|value, stream bytes|None)
        self.objects: Dict[int, Tuple[object, Optional[bytes]]] = {}
        self._decode_budget = self.MAX_DECODE_BUDGET
        # Decoded-stream memo, by object number: shared streams (a
        # ToUnicode CMap or Resources referenced from every page) decode
        # once and charge the budget once — without this, a large
        # legitimate PDF re-charges per page and can exhaust the budget
        # mid-document, silently degrading later pages.
        self._decoded: Dict[int, Optional[bytes]] = {}
        self._scan_objects()
        self._unpack_object_streams()

    # -- object loading ----------------------------------------------------

    def _scan_objects(self) -> None:
        """Sequential scan for ``N G obj ... endobj`` — deliberately does
        not trust the xref table (broken xrefs are common; a linear scan
        finds every top-level object regardless)."""
        data = self.data
        pos = 0
        while True:
            m = _OBJ_RE.search(data, pos)
            if m is None:
                break
            num = int(m.group(1))
            body_start = m.end()
            val, after = parse_object(data, body_start)
            stream: Optional[bytes] = None
            p = _skip_ws(data, after)
            if data.startswith(b"stream", p):
                p += 6
                if data.startswith(b"\r\n", p):
                    p += 2
                elif p < len(data) and data[p : p + 1] in (b"\n", b"\r"):
                    p += 1
                length = None
                if isinstance(val, dict):
                    length = val.get("Length")
                    if isinstance(length, Ref):
                        length = self._peek_length(length.num)
                if isinstance(length, int) and 0 <= length <= len(data) - p:
                    s_end = p + length
                    # validate: 'endstream' should follow (possibly after ws)
                    if data.find(b"endstream", s_end, s_end + 32) < 0:
                        s_end = data.find(b"endstream", p)
                else:
                    s_end = data.find(b"endstream", p)
                if s_end < 0:
                    s_end = len(data)
                stream = data[p:s_end]
                p = data.find(b"endobj", s_end)
            else:
                p = data.find(b"endobj", after)
            self.objects[num] = (val, stream)
            pos = (p + 6) if p >= 0 else (body_start + 1)

    def _peek_length(self, num: int) -> Optional[int]:
        """Resolve an indirect /Length before the full scan completes."""
        if num in self.objects:
            v = self.objects[num][0]
            return v if isinstance(v, int) else None
        m = re.search(rb"(?<![\d.])%d\s+\d+\s+obj\s+(\d+)" % num, self.data)
        return int(m.group(1)) if m else None

    def _unpack_object_streams(self) -> None:
        """xref-stream PDFs park objects inside /Type /ObjStm streams."""
        for num in list(self.objects):
            val, stream = self.objects[num]
            if not (isinstance(val, dict) and val.get("Type") == "ObjStm"):
                continue
            raw = self._decode_stream(val, stream)
            if raw is None:
                continue
            try:
                count = int(self.resolve(val.get("N")) or 0)
                first = int(self.resolve(val.get("First")) or 0)
            except (TypeError, ValueError):
                continue
            header = raw[:first].split()
            for i in range(count):
                try:
                    onum = int(header[2 * i])
                    off = int(header[2 * i + 1])
                except (IndexError, ValueError):
                    break
                oval, _ = parse_object(raw, first + off)
                self.objects.setdefault(onum, (oval, None))

    # -- resolution & filters ---------------------------------------------

    def resolve(self, v, depth: int = 0):
        while isinstance(v, Ref) and depth < 32:
            v = self.objects.get(v.num, (None, None))[0]
            depth += 1
        return v

    def stream_of(self, v) -> Optional[bytes]:
        """Decoded stream bytes of an object (ref or inline dict);
        memoized per object number (budget charged on first decode)."""
        if isinstance(v, Ref):
            if v.num in self._decoded:
                return self._decoded[v.num]
            entry = self.objects.get(v.num)
            if entry is None:
                return None
            d, raw = entry
        else:
            return None
        if raw is None or not isinstance(d, dict):
            return None
        out = self._decode_stream(d, raw)
        self._decoded[v.num] = out
        return out

    def _decode_stream(self, d: dict, raw: Optional[bytes]) -> Optional[bytes]:
        if raw is None:
            return None
        filters = self.resolve(d.get("Filter"))
        if filters is None:
            return raw
        if not isinstance(filters, list):
            filters = [filters]
        out = raw
        if len(filters) > 4:
            return None  # no legitimate chain is this deep
        for f in filters:
            f = self.resolve(f)
            if f == "FlateDecode" or f == "Fl":
                cap = min(self.MAX_STREAM_BYTES, self._decode_budget)
                if cap <= 0:
                    return None  # document decode budget exhausted
                try:
                    # decompressobj tolerates truncated tails (returns the
                    # prefix) and lets us bound the output size.
                    out = zlib.decompressobj().decompress(out, cap + 1)
                except zlib.error:
                    return None
                if len(out) > cap:
                    return None  # decompression bomb: skip the stream
                self._decode_budget -= len(out)
                parms = self.resolve(d.get("DecodeParms"))
                if isinstance(parms, dict) and self.resolve(parms.get("Predictor", 1)) not in (None, 1):
                    if len(out) > (8 << 20):
                        # The predictor undo is a pure-Python per-byte
                        # loop; real predicted streams (xref streams) are
                        # KBs. Refuse crafted giants rather than burn CPU.
                        return None
                    out = _undo_png_predictor(
                        out,
                        int(self.resolve(parms.get("Columns", 1)) or 1),
                        int(self.resolve(parms.get("Colors", 1)) or 1),
                        int(self.resolve(parms.get("BitsPerComponent", 8)) or 8),
                    )
            elif f == "ASCIIHexDecode" or f == "AHx":
                hx = re.sub(rb"[^0-9A-Fa-f]", b"", out.split(b">")[0])
                if len(hx) % 2:
                    hx += b"0"
                out = bytes.fromhex(hx.decode("ascii"))
            elif f == "ASCII85Decode" or f == "A85":
                try:
                    import base64

                    body = out.split(b"~>")[0]
                    if body.startswith(b"<~"):
                        body = body[2:]
                    out = base64.a85decode(re.sub(rb"\s", b"", body))
                except ValueError:
                    return None
            else:
                return None  # LZW/DCT/JBIG2/...: no text in practice
        return out

    # -- page tree ---------------------------------------------------------

    def pages(self) -> List[dict]:
        """Page dicts in document order (catalog walk; fallback: object
        order). Each gets inherited ``Resources`` merged in."""
        root = None
        for num, (val, _) in self.objects.items():
            if isinstance(val, dict) and val.get("Type") == "Catalog":
                root = val
                break
        ordered: List[dict] = []
        if root is not None:
            # Total-visit budget: the depth cap alone bounds DEPTH, but a
            # self-referential /Kids array (node listing itself) branches
            # at every level — ~3^64 visits without this counter.
            self._walk_budget = 100_000
            self._walk(self.resolve(root.get("Pages")), ordered, {}, 0)
        if not ordered:  # damaged catalog: any /Type /Page object
            for num in sorted(self.objects):
                val, _ = self.objects[num]
                if isinstance(val, dict) and val.get("Type") == "Page":
                    ordered.append(val)
        return ordered

    def _walk(self, node, out: List[dict], inherited: dict, depth: int) -> None:
        self._walk_budget -= 1
        if self._walk_budget < 0:
            return
        node = self.resolve(node)
        if not isinstance(node, dict) or depth > 64 or len(out) > 10000:
            return
        inh = dict(inherited)
        if "Resources" in node:
            inh["Resources"] = node["Resources"]
        if node.get("Type") == "Page":
            page = dict(node)
            page.setdefault("Resources", inh.get("Resources"))
            out.append(page)
            return
        for kid in self.resolve(node.get("Kids")) or []:
            self._walk(kid, out, inh, depth + 1)


def _undo_png_predictor(data: bytes, columns: int, colors: int, bpc: int) -> bytes:
    bpp = max(1, (colors * bpc) // 8)
    # Clamp to the data that actually exists: a crafted /Columns must not
    # drive a giant per-row allocation (rows beyond the data are void).
    rowlen = max(1, min((columns * colors * bpc + 7) // 8, len(data)))
    out = bytearray()
    prev = bytearray(rowlen)
    pos = 0
    while pos + 1 <= len(data):
        ftype = data[pos]
        row = bytearray(data[pos + 1 : pos + 1 + rowlen])
        pos += 1 + rowlen
        if ftype == 1:  # Sub
            for i in range(bpp, len(row)):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(len(row)):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(len(row)):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(len(row)):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out += row
        prev = row
    return bytes(out)


# ---------------------------------------------------------------------------
# Fonts


class FontDecoder:
    """Maps show-string bytes to unicode for one font resource."""

    def __init__(self, doc: PdfDocument, font_ref) -> None:
        font = doc.resolve(font_ref)
        self.two_byte = False
        self.cmap: Optional[Dict[int, str]] = None
        if not isinstance(font, dict):
            return
        subtype = font.get("Subtype")
        if subtype == "Type0":
            self.two_byte = True  # Identity-H is near-universal for Type0
        tou = font.get("ToUnicode")
        raw = doc.stream_of(tou) if tou is not None else None
        if raw is not None:
            self.cmap, codelen = _parse_tounicode(raw)
            if codelen:
                self.two_byte = codelen == 2

    def decode(self, s: bytes) -> str:
        if self.cmap is not None:
            step = 2 if self.two_byte else 1
            out = []
            for i in range(0, len(s) - step + 1, step):
                code = int.from_bytes(s[i : i + step], "big")
                out.append(self.cmap.get(code, "�"))
            return "".join(out)
        if self.two_byte:
            # CIDs without a ToUnicode map are unrecoverable glyph ids
            return "�" * (len(s) // 2)
        return s.decode("latin-1")


_HEXTOK = re.compile(rb"<([0-9A-Fa-f]+)>")


def _parse_tounicode(raw: bytes) -> Tuple[Dict[int, str], int]:
    """bfchar/bfrange sections of a ToUnicode CMap → {code: str}."""
    cmap: Dict[int, str] = {}
    codelen = 0

    def _src(h: bytes) -> int:
        nonlocal codelen
        codelen = max(codelen, len(h) // 2)
        return int(h, 16)

    def _dst(h: bytes) -> str:
        try:
            b = bytes.fromhex(h.decode("ascii"))
            return b.decode("utf-16-be")
        except (ValueError, UnicodeDecodeError):  # odd-length hex / bad UTF-16
            return "�"

    def _chr(cp: int) -> str:
        # Incremented destinations can walk past a plane boundary or into
        # the surrogate gap in damaged CMaps; degrade per-code, never abort.
        if 0 <= cp <= 0x10FFFF and not 0xD800 <= cp <= 0xDFFF:
            return chr(cp)
        return "�"

    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", raw, re.S):
        toks = _HEXTOK.findall(m.group(1))
        for i in range(0, len(toks) - 1, 2):
            cmap[_src(toks[i])] = _dst(toks[i + 1])
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", raw, re.S):
        body = m.group(1)
        pos = 0
        while True:
            mm = _HEXTOK.match(body, _ws_skip(body, pos))
            if not mm:
                break
            lo = _src(mm.group(1))
            mm2 = _HEXTOK.match(body, _ws_skip(body, mm.end()))
            if not mm2:
                break
            hi = _src(mm2.group(1))
            pos = _ws_skip(body, mm2.end())
            if pos < len(body) and body[pos] == 0x5B:  # [ <d1> <d2> ... ]
                end = body.find(b"]", pos)
                dsts = _HEXTOK.findall(body[pos:] if end == -1 else body[pos:end])
                for off, d in enumerate(dsts):
                    cmap[lo + off] = _dst(d)
                if end == -1:  # truncated array (chopped stream): consume rest
                    break
                pos = end + 1
            else:
                mm3 = _HEXTOK.match(body, pos)
                if not mm3:
                    break
                base_str = _dst(mm3.group(1))
                # Increment in CODE-POINT space from the decoded string: the
                # raw hex of an astral dst is a surrogate pair whose integer
                # value is NOT a code point (chr() of it would raise).
                for code in range(lo, min(hi, lo + 65535) + 1):
                    if len(base_str) <= 1:
                        cmap[code] = _chr(ord(base_str or "�") + code - lo)
                    else:  # multi-char dst: increment last code unit
                        cmap[code] = base_str[:-1] + _chr(
                            ord(base_str[-1]) + code - lo
                        )
                pos = mm3.end()
    return cmap, codelen


def _ws_skip(data: bytes, pos: int) -> int:
    while pos < len(data) and data[pos] in _WS:
        pos += 1
    return pos


# ---------------------------------------------------------------------------
# Content-stream text interpreter


_OP_RE = re.compile(rb"[A-Za-z'\"][A-Za-z0-9*'\"]*")


def _extract_page_text(doc: PdfDocument, page: dict) -> str:
    contents = page.get("Contents")
    if contents is None:
        return ""
    refs = contents if isinstance(contents, list) else [contents]
    stream = b"\n".join(
        s for s in (doc.stream_of(r) for r in refs) if s is not None
    )
    if not stream:
        return ""

    fonts: Dict[str, FontDecoder] = {}
    res = doc.resolve(page.get("Resources"))
    if isinstance(res, dict):
        fdict = doc.resolve(res.get("Font"))
        if isinstance(fdict, dict):
            for name, ref in fdict.items():
                fonts[name] = FontDecoder(doc, ref)
    default_font = FontDecoder(doc, None)

    out: List[str] = []
    stack: List[object] = []
    cur = default_font
    last_ty: Optional[float] = None

    def _newline() -> None:
        if out and not out[-1].endswith("\n"):
            out.append("\n")

    def _show(raw: bytes) -> None:
        out.append(cur.decode(raw))

    pos = 0
    n = len(stream)
    while pos < n:
        pos = _skip_ws(stream, pos)
        if pos >= n:
            break
        c = stream[pos]
        if c == 0x2F or c == 0x28 or c == 0x3C or c == 0x5B or c == 0x2B or c == 0x2D or c == 0x2E or 0x30 <= c <= 0x39:
            val, pos = parse_object(stream, pos)
            stack.append(val)
            continue
        m = _OP_RE.match(stream, pos)
        if not m:
            pos += 1
            continue
        op = m.group(0)
        pos = m.end()
        if op == b"Tj":
            if stack and isinstance(stack[-1], bytes):
                _show(stack[-1])
        elif op == b"TJ":
            if stack and isinstance(stack[-1], list):
                for el in stack[-1]:
                    if isinstance(el, bytes):
                        _show(el)
                    elif isinstance(el, (int, float)) and el < -180:
                        out.append(" ")
        elif op == b"'":
            _newline()
            if stack and isinstance(stack[-1], bytes):
                _show(stack[-1])
        elif op == b'"':
            _newline()
            if stack and isinstance(stack[-1], bytes):
                _show(stack[-1])
        elif op == b"Tf":
            if len(stack) >= 2 and isinstance(stack[-2], Name):
                cur = fonts.get(str(stack[-2]), default_font)
        elif op in (b"Td", b"TD"):
            if len(stack) >= 2 and isinstance(stack[-1], (int, float)):
                if stack[-1] != 0:
                    _newline()
                elif isinstance(stack[-2], (int, float)) and stack[-2] > 0 and out and not out[-1].endswith((" ", "\n")):
                    out.append(" ")
        elif op == b"T*":
            _newline()
        elif op == b"Tm":
            if len(stack) >= 6 and isinstance(stack[-1], (int, float)):
                ty = float(stack[-1])
                if last_ty is not None and ty != last_ty:
                    _newline()
                last_ty = ty
        elif op == b"ET":
            _newline()
        elif op == b"BI":  # inline image: skip to EI
            e = stream.find(b"EI", pos)
            pos = (e + 2) if e >= 0 else n
        if op not in (b"BI",):
            stack.clear()

    text = "".join(out)
    text = re.sub(r"[ \t]+\n", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip("\n")


def pdf_to_text(data: bytes) -> str:
    """Extract the text layer of a PDF, pages joined by blank lines."""
    if not data.lstrip()[:5].startswith(b"%PDF-"):
        raise ValueError("not a PDF file (missing %PDF- header)")
    doc = PdfDocument(data)
    parts = []
    for page in doc.pages():
        t = _extract_page_text(doc, page)
        if t:
            parts.append(t)
    return "\n\n".join(parts)
