"""Offline ``local`` parse backend.

Counterpart of ``semtools_tpu/parse/local_backend.py``.

Same public surface and cache semantics as :class:`LlamaParseBackend`
(parse/backend.py) — skip-list passthrough, (mtime, size) cache hits,
per-file failure isolation (a bad document is reported and dropped, the
batch continues; reference behavior src/parse/backend.rs:94-99) — but the
conversion runs entirely on this machine via the stdlib extractors in
extract.py / pdftext.py.  Selected with ``semtools parse -b local``; the
reference has no offline backend at all (its `-b` accepts only
"llama-parse", src/cmds/parse.rs:6), so this is a capability extension
for air-gapped use.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from semtools_tpu_torch.parse.backend import ParseResult
from semtools_tpu_torch.parse.cache import CacheManager
from semtools_tpu_torch.utils.tracing import stage


class LocalParseError(Exception):
    """A document the local backend cannot convert."""


def _pdf(data: bytes) -> str:
    from semtools_tpu_torch.parse.pdftext import pdf_to_text

    return pdf_to_text(data)


def _docx(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import docx_to_markdown

    return docx_to_markdown(data)


def _pptx(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import pptx_to_markdown

    return pptx_to_markdown(data)


def _xlsx(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import xlsx_to_markdown

    return xlsx_to_markdown(data)


def _html(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import html_to_markdown

    return html_to_markdown(data)


def _rtf(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import rtf_to_text

    return rtf_to_text(data)


def _odt(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import odt_to_markdown

    return odt_to_markdown(data)


def _epub(data: bytes) -> str:
    from semtools_tpu_torch.parse.extract import epub_to_markdown

    return epub_to_markdown(data)


_CONVERTERS: Dict[str, Callable[[bytes], str]] = {
    "pdf": _pdf,
    "docx": _docx,
    "docm": _docx,
    "pptx": _pptx,
    "pptm": _pptx,
    "xlsx": _xlsx,
    "xlsm": _xlsx,
    "html": _html,
    "htm": _html,
    "xhtml": _html,
    "rtf": _rtf,
    "odt": _odt,
    "epub": _epub,
}


def supported_extensions() -> List[str]:
    return sorted(_CONVERTERS)


class LocalParseBackend:
    """Converts documents to markdown offline; drop-in for
    :class:`LlamaParseBackend` on the ``parse``/``parse_detailed``
    surface."""

    def __init__(self, verbose: bool = False, cache_dir: Optional[str] = None):
        self.verbose = verbose
        self.cache_manager = CacheManager(cache_dir, backend="local")

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, file=sys.stderr)

    def convert(self, file_path: str) -> str:
        """Markdown for one document (no cache interaction)."""
        p = Path(file_path)
        ext = p.suffix[1:].lower() if p.suffix else ""
        conv = _CONVERTERS.get(ext)
        if conv is None:
            raise LocalParseError(
                f"{file_path}: extension '.{ext}' is not supported by the "
                f"local backend (supported: {', '.join(supported_extensions())}; "
                "use -b llama-parse for anything else)"
            )
        try:
            data = p.read_bytes()
        except OSError as e:
            raise LocalParseError(f"{file_path}: {e}") from e
        try:
            with stage("convert"):
                return conv(data)
        except LocalParseError:
            raise
        except Exception as e:
            raise LocalParseError(
                f"{file_path}: {type(e).__name__}: {e}"
            ) from e

    def parse_detailed(self, files: Sequence[str]) -> List[ParseResult]:
        results: List[ParseResult] = []
        for file_path in files:
            if self.cache_manager.should_skip_file(file_path):
                self._log(f"Skipping readable file: {file_path}")
                results.append(ParseResult(file_path, file_path, False))
                continue
            cached = self.cache_manager.get_cached_result(file_path)
            if cached is not None:
                self._log(f"Using cached result for: {file_path}")
                results.append(ParseResult(file_path, cached, True))
                continue
            self._log(f"Converting locally: {file_path}")
            try:
                content = self.convert(file_path)
            except LocalParseError as e:
                print(f"Error processing file: {e}", file=sys.stderr)
                continue
            out = self.cache_manager.write_results_to_disk(file_path, content)
            results.append(ParseResult(file_path, out, False))
        return results

    def parse(self, files: Sequence[str]) -> List[str]:
        return [r.output_path for r in self.parse_detailed(files)]
