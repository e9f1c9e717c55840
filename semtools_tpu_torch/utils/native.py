"""Loader for the native tokenizer library (``cpp/`` -> ``_build/``).

Counterpart of ``semtools_tpu/utils/native.py``. The library is built from
the repository's ``cpp/`` sources into the port's own ignored build
directory, ``semtools_tpu_torch/_build/libsemtools_native.so``, by the same
Makefile with its output path given on the command line; nothing is read
from or written to the JAX package's ``_native/``. The port binds
``hashtok_encode_batch`` (cpp/hashtok.cpp), the hashed tokenizer's fast
path, ``adc_scan_lists`` (cpp/adcscan.cpp), the IVF-PQ probe
(:func:`adc_lib`), and ``grepscan_match_lines`` (cpp/grepscan.cpp), the
ask agent's grep scanner (:func:`grep_lib`).

Loading is lazy: if the library is missing, older than its sources or
built by another recipe than :data:`RECIPE` (its stamp file says which), the
loader runs one quiet ``make`` (disable with
``SEMTOOLS_TPU_NO_NATIVE_BUILD=1``); when that fails the tokenizer, the
probe and grep take their pure-Python implementations, whose answers are
the same. This is host code: no device work depends on it.

:func:`build_client` compiles the port's native daemon client
(``semtools_tpu_torch/native/semtools_client.cpp``) into
``_build/semtools-client`` with ``g++`` from PATH, stamped as the library is.
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
# How build() makes the library; a library stamped otherwise (or not at all)
# is rebuilt, as one from before the inherited ``CXX`` was dropped must be.
RECIPE = "make with the Makefile's compiler, inherited CXX dropped\n"


def lib_path() -> Path:
    suffix = ".dylib" if sys.platform == "darwin" else ".so"
    return BUILD_DIR / f"libsemtools_native{suffix}"


def recipe_path() -> Path:
    return BUILD_DIR / "libsemtools_native.recipe"


def _recipe_current() -> bool:
    try:
        return recipe_path().read_text() == RECIPE
    except OSError:
        return False


def build() -> bool:
    """``make`` the library into ``_build/`` (only the library target);
    True when it exists afterwards.

    The Makefile's own compiler (``g++`` on PATH) builds it, not an
    inherited ``CXX``: a compiler wrapper that links libstdc++ statically
    gives the library a second C++ runtime, and its ``std::regex`` (the grep
    scanner) then crashes in a process that has loaded the shared one, as
    any process that imported numpy or torch has. A library not stamped
    with :data:`RECIPE` is remade even when it is newer than its sources."""
    if not (CPP_DIR / "Makefile").exists():
        return False
    out = str(lib_path())
    env = {k: v for k, v in os.environ.items() if k != "CXX"}
    force = [] if _recipe_current() else ["-B"]
    try:
        proc = subprocess.run(
            ["make", "-C", str(CPP_DIR), *force, f"OUT={out}", out],
            capture_output=True, timeout=120, env=env,
        )
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0 or not lib_path().exists():
        return False
    try:
        recipe_path().write_text(RECIPE)
    except OSError:
        pass
    return True


CLIENT_SOURCE = _PKG_DIR / "native" / "semtools_client.cpp"
CLIENT_RECIPE = "g++ -O2 -std=c++17, inherited CXX dropped\n"


def client_path() -> Path:
    return BUILD_DIR / "semtools-client"


def _client_current() -> bool:
    try:
        return ((BUILD_DIR / "semtools-client.recipe").read_text() == CLIENT_RECIPE
                and client_path().stat().st_mtime >= CLIENT_SOURCE.stat().st_mtime)
    except OSError:
        return False


def build_client() -> Path:
    """The native daemon client, compiled into ``_build/semtools-client``
    unless a build stamped with :data:`CLIENT_RECIPE` is newer than its
    source. ``g++`` from PATH compiles it, never an inherited ``CXX`` (see
    :func:`build`). Raises with the compiler's output when it fails."""
    if _client_current():
        return client_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = client_path().with_suffix(f".{os.getpid()}.tmp")
    env = {k: v for k, v in os.environ.items() if k != "CXX"}
    proc = subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Wextra", "-o", str(tmp),
                           str(CLIENT_SOURCE)], capture_output=True, text=True, timeout=300,
                          env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"native client build failed:\n{proc.stderr}")
    os.replace(tmp, client_path())
    (BUILD_DIR / "semtools-client.recipe").write_text(CLIENT_RECIPE)
    return client_path()


def _stale(path: Path) -> bool:
    if not _recipe_current():
        return True
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
    # Bound leniently: a library without one of these symbols still serves
    # the tokenizer, and that consumer takes its Python path.
    if hasattr(lib, "grepscan_match_lines"):
        lib.grepscan_match_lines.restype = ctypes.c_longlong
        lib.grepscan_match_lines.argtypes = [
            ctypes.c_char_p,  # file path
            ctypes.c_char_p,  # pattern
            ctypes.c_int,  # ignore_case
            ctypes.POINTER(ctypes.c_longlong),  # out line indices
            ctypes.c_longlong,  # out capacity
        ]
    if not hasattr(lib, "adc_scan_lists"):
        return
    lib.adc_scan_lists.restype = ctypes.c_longlong
    lib.adc_scan_lists.argtypes = [
        ctypes.c_void_p,  # codes [n_total, m] uint8
        ctypes.c_longlong,  # m
        ctypes.c_void_p,  # table [m, 256] f32
        ctypes.c_void_p,  # starts [n_lists] i64
        ctypes.c_void_p,  # ends [n_lists] i64
        ctypes.c_void_p,  # bias [n_lists] f32
        ctypes.c_longlong,  # n_lists
        ctypes.c_void_p,  # out scores [cap] f32
        ctypes.c_void_p,  # out rows [cap] i64
        ctypes.c_longlong,  # cap
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


def adc_lib() -> Optional[ctypes.CDLL]:
    """The library iff it carries the ADC probe (a stale build may not)."""
    lib = load()
    return lib if lib is not None and hasattr(lib, "adc_scan_lists") else None


def grep_lib() -> Optional[ctypes.CDLL]:
    """The library iff it carries the grep scanner."""
    lib = load()
    return lib if lib is not None and hasattr(lib, "grepscan_match_lines") else None
