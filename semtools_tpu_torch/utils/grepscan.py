"""ctypes interface to the native grep scanner (cpp/grepscan.cpp).

Counterpart of ``semtools_tpu/utils/grepscan.py``: the scanner lives in the
port's native library (:mod:`semtools_tpu_torch.utils.native`, built into
``_build/``); ``semtools_tpu_torch.ask.tools`` falls back to Python ``re``
when the library or the symbol is unavailable.
"""

from __future__ import annotations

import ctypes
from typing import List

from semtools_tpu_torch.utils import native


def available() -> bool:
    return native.grep_lib() is not None


def match_lines(path: str, pattern: str, ignore_case: bool) -> List[int]:
    """0-based indices of lines matching ``pattern`` in ``path``.

    Raises ValueError on scanner errors (unreadable file, bad pattern);
    callers catch and fall back to the Python implementation.
    """
    lib = native.grep_lib()
    if lib is None:
        raise ValueError("native grep scanner not built")
    cap = 1 << 16
    while True:
        buf = (ctypes.c_longlong * cap)()
        n = lib.grepscan_match_lines(
            path.encode(), pattern.encode(), 1 if ignore_case else 0, buf, cap
        )
        if n < 0:
            raise ValueError(f"grepscan failed on {path} (code {n})")
        if n <= cap:
            return [buf[i] for i in range(n)]
        cap = n  # retry with exact capacity
