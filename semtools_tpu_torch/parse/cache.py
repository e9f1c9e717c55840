"""Parse result cache under ``~/.parse``.

Counterpart of ``semtools_tpu/parse/cache.py``. Entries are byte-compatible
with the JAX package's (same keys, file names and metadata JSON), so each
package serves the other's cache.

Semantics follow the reference (src/parse/cache.rs): results are keyed on
the source file's (mtime, size); already-readable text formats are passed
through unparsed (the 13-extension skip list, cache.rs:33-49).

One deliberate fix over the reference: cache filenames there are keyed on
the *basename only* (cache.rs:96-97), so ``a/report.pdf`` and
``b/report.pdf`` collide. Here the key is ``{basename}.{8-hex path hash}``,
making cache entries unique per absolute path.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from semtools_tpu_torch.utils.hashing import fnv1a_64

SKIP_EXTENSIONS = {
    "txt", "md", "rst", "org", "csv", "json", "xml", "yaml", "yml",
    "py", "js", "ts", "rs",
}


@dataclass
class FileMetadata:
    modified_time: int
    size: int
    parsed_path: str
    backend: str = "llama-parse"


class CacheManager:
    """``backend`` discriminates cache entries between parse backends
    sharing one cache dir: the local extractor's output for ``scan.pdf``
    must never be served as the cloud parse of the same file (or vice
    versa). The default keeps reference-era entries (no ``backend`` field,
    undecorated filenames) valid for the llama-parse backend."""

    def __init__(self, cache_dir: Optional[str] = None, backend: str = "llama-parse"):
        self.cache_dir = Path(cache_dir or Path.home() / ".parse")
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.backend = backend

    # -- keys --------------------------------------------------------------

    def _key(self, file_path: str) -> str:
        base = Path(file_path).name
        path_hash = f"{fnv1a_64(os.path.abspath(file_path).encode()) & 0xFFFFFFFF:08x}"
        key = f"{base}.{path_hash}"
        # Non-default backends get their own namespace so the two .md
        # outputs for one source file never clobber each other.
        return key if self.backend == "llama-parse" else f"{key}.{self.backend}"

    def parsed_path_for(self, file_path: str) -> Path:
        return self.cache_dir / f"{self._key(file_path)}.md"

    def metadata_path_for(self, file_path: str) -> Path:
        return self.cache_dir / f"{self._key(file_path)}.metadata.json"

    # -- queries -----------------------------------------------------------

    @staticmethod
    def should_skip_file(file_path: str) -> bool:
        """True for missing files and already-readable text formats."""
        p = Path(file_path)
        if not p.exists():
            return True
        ext = p.suffix[1:].lower() if p.suffix else ""
        return ext in SKIP_EXTENSIONS

    def get_cached_result(self, file_path: str) -> Optional[str]:
        """Path of a still-valid cached parse, else None."""
        meta_path = self.metadata_path_for(file_path)
        if not meta_path.exists():
            return None
        try:
            cached = json.loads(meta_path.read_text())
            st = os.stat(file_path)
        except (OSError, ValueError):
            return None
        if (
            cached.get("modified_time") == int(st.st_mtime)
            and cached.get("size") == st.st_size
            and cached.get("backend", "llama-parse") == self.backend
            and Path(cached.get("parsed_path", "")).exists()
        ):
            return cached["parsed_path"]
        return None

    # -- writes ------------------------------------------------------------

    def write_results_to_disk(self, file_path: str, markdown_content: str) -> str:
        parsed_path = self.parsed_path_for(file_path)
        parsed_path.write_text(markdown_content)
        st = os.stat(file_path)
        meta = FileMetadata(
            modified_time=int(st.st_mtime),
            size=st.st_size,
            parsed_path=str(parsed_path),
            backend=self.backend,
        )
        self.metadata_path_for(file_path).write_text(
            json.dumps(meta.__dict__, indent=2)
        )
        return str(parsed_path)
