"""Loader for the native tokenizer library (``cpp/`` -> ``_build/``).

Counterpart of ``semtools_tpu/utils/native.py``. The library is built from
the repository's ``cpp/`` sources into the port's own ignored build
directory, ``semtools_tpu_torch/_build/libsemtools_native.so``, by the same
Makefile with its output path given on the command line; nothing is read
from or written to the JAX package's ``_native/``. The port binds only
``hashtok_encode_batch`` (cpp/hashtok.cpp), the hashed tokenizer's fast
path.

Loading is lazy: if the library is missing or older than its sources, the
loader runs one quiet ``make`` (disable with
``SEMTOOLS_TPU_NO_NATIVE_BUILD=1``); when that fails the tokenizer takes
its pure-Python implementation, whose ids are identical. This is host code:
no device work depends on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = Path(__file__).resolve().parent.parent
CPP_DIR = _PKG_DIR.parent / "cpp"
BUILD_DIR = _PKG_DIR / "_build"


def lib_path() -> Path:
    suffix = ".dylib" if sys.platform == "darwin" else ".so"
    return BUILD_DIR / f"libsemtools_native{suffix}"


def build() -> bool:
    """``make`` the library into ``_build/`` (only the library target);
    True when it exists afterwards."""
    if not (CPP_DIR / "Makefile").exists():
        return False
    out = str(lib_path())
    try:
        proc = subprocess.run(
            ["make", "-C", str(CPP_DIR), f"OUT={out}", out],
            capture_output=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0 and lib_path().exists()


def _stale(path: Path) -> bool:
    try:
        so_mtime = path.stat().st_mtime
        inputs = [p for pat in ("*.cpp", "*.h", "Makefile") for p in CPP_DIR.glob(pat)]
        return any(src.stat().st_mtime > so_mtime for src in inputs)
    except OSError:
        return False


def _bind(lib: ctypes.CDLL) -> None:
    lib.hashtok_encode_batch.restype = ctypes.c_longlong
    lib.hashtok_encode_batch.argtypes = [
        ctypes.c_char_p,  # concatenated texts
        ctypes.POINTER(ctypes.c_longlong),  # text offsets [n+1]
        ctypes.c_longlong,  # n_texts
        ctypes.c_longlong,  # vocab size
        ctypes.c_int,  # ngram_min
        ctypes.c_int,  # ngram_max
        ctypes.POINTER(ctypes.c_uint32),  # out ids
        ctypes.c_longlong,  # out capacity
        ctypes.POINTER(ctypes.c_longlong),  # out per-text offsets [n+1]
    ]


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use if possible."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = lib_path()
    # Rebuild a missing or stale library before the first dlopen (dlopen
    # caches by inode, so a rebuild after loading is not picked up).
    if not path.exists() or _stale(path):
        if os.environ.get("SEMTOOLS_TPU_NO_NATIVE_BUILD") or not build():
            if not path.exists():
                return None
    try:
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    return load() is not None
