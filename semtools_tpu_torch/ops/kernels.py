"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use from the sources in this package with
``nvcc`` for ``sm_90a`` into a plain-C shared library under ``_build/``
(ignored by git), keyed by a hash of the sources and flags and guarded by a
file lock so concurrent processes build once. Each source compiles to an
object in its own ``nvcc`` process, all started together, and one link
makes the library. They are bound with ctypes:
each entry point returns the ``cudaError_t`` of its launch, which
:func:`check` turns into an exception.

Nothing CUDA-specific happens at import, so every module of the port imports
on a machine without a card or a compiler. A missing ``nvcc`` or a failed
build raises; there is no fallback to the plain PyTorch versions.

Launch counts are integers per kernel, incremented under a lock by each
wrapper right after its kernel launched (:func:`launch_counts`), so the
daemon's handler threads count exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from semtools_tpu_torch.utils.filelock import lock_exclusive, unlock

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
SOURCES = ("fused_scan.cu", "int8_scan.cu", "int4_scan.cu", "select.cu", "select_above.cu",
           "stream.cu", "probe_tilemax.cu")
HEADERS = ("common.cuh", "int_scan.cuh", "topk.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
)

KERNELS = (
    "fused_tilemax", "fused_rescan_topk", "fused_scan_candidates", "select_subtiles",
    "int8_tilemax", "int8_rescan_topk", "int8_tilemax_masked", "int8_rescan_topk_masked",
    "int4_sims_max", "int4_sims_max_masked", "int4_cutoff_counts", "int4_extract_above",
    "int4_tilemax", "int4_rescan_topk", "int4_tilemax_masked", "int4_rescan_topk_masked",
    # the probes (ops/probes.py): the stream kernels, and the tile-max
    # kernel counted by variant (probes.VARIANTS)
    "stream_tiles", "stream_ring",
    "tilemax_bf16_plain", "tilemax_int8_convert_bf16", "tilemax_int8_int_dot",
    "tilemax_int8_f32_dot", "colsum_int8_convert_bf16", "colsum_int8", "tilemax_int4_u8",
    "tilemax_int4_shift", "tilemax_int4_and15", "tilemax_int4_floor", "tilemax_int4_native",
)
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_launches_lock = threading.Lock()

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# Seconds the last build took in this process (None: loaded a cached build).
last_build_seconds: Optional[float] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    with _launches_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launches_lock:
        for name in _launches:
            _launches[name] = 0


def count_launch(name: str) -> None:
    with _launches_lock:
        _launches[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "toolkit is needed to build the scan kernels"
    )


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(steps) -> str:
    """Run each (command, output) at once and wait for all; the joined
    command lines and compiler output, or RuntimeError if one failed."""
    procs = [(cmd, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
             for cmd, out in steps]
    log, failed = [], []
    for cmd, out, proc in procs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{Path(out).name}: nvcc exit {proc.returncode}\n{text[-4000:]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "\n".join(log)


def build() -> Path:
    """Compile the kernel library if this source hash has no build yet;
    returns its path. The build log (ptxas register and shared-memory
    report) sits beside it as ``.log``."""
    global last_build_seconds
    out = BUILD_DIR / f"libsemtools_kernels-{_source_key()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a+") as lock:
        lock_exclusive(lock)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            objs = [tmp.with_suffix(f".{Path(src).stem}.o") for src in SOURCES]
            steps = [([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(SRC_DIR / src)], obj)
                     for src, obj in zip(SOURCES, objs)]
            try:
                log = _run_all(steps)
                log += _run_all([([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)], tmp)])
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            finally:
                for obj in objs:
                    obj.unlink(missing_ok=True)
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            last_build_seconds = time.perf_counter() - t0
        finally:
            unlock(lock)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.semtools_scan_rows.restype = i32
    lib.semtools_scan_rows.argtypes = []
    lib.semtools_cuda_error_string.restype = ctypes.c_char_p
    lib.semtools_cuda_error_string.argtypes = [i32]
    lib.semtools_empty_launch.restype = i32
    lib.semtools_empty_launch.argtypes = [p]
    lib.semtools_fused_tilemax.restype = i32
    lib.semtools_fused_tilemax.argtypes = [p, p, i32, i32, i32, i64, p, i64, p]
    lib.semtools_fused_rescan_topk.restype = i32
    lib.semtools_fused_rescan_topk.argtypes = [p, p, i32, i32, i32, i64, p, i32, i32, p, p, p, p]
    lib.semtools_select_subtiles.restype = i32
    lib.semtools_select_subtiles.argtypes = [p, i32, i64, i32, i32, p, p, p]
    lib.semtools_fused_scan_candidates.restype = i32
    lib.semtools_fused_scan_candidates.argtypes = [p, p, i32, i32, i32, i64, i32, p, p, i64, p]
    for fmt in ("int8", "int4"):
        tilemax = getattr(lib, f"semtools_{fmt}_tilemax")
        tilemax.restype = i32
        tilemax.argtypes = [p, p, p, i32, i32, i64, p, i64, p]
        rescan = getattr(lib, f"semtools_{fmt}_rescan_topk")
        rescan.restype = i32
        rescan.argtypes = [p, p, p, i32, i32, i64, p, i32, i32, p, p, p, p]
    lib.semtools_int4_sims_rows.restype = i32
    lib.semtools_int4_sims_rows.argtypes = []
    lib.semtools_int4_sims_max.restype = i32
    lib.semtools_int4_sims_max.argtypes = [p, p, p, i32, i32, i64, p, p, i64, p]
    lib.semtools_int4_cutoff_counts.restype = i32
    lib.semtools_int4_cutoff_counts.argtypes = [p, p, i32, i64, p, i32, p, i32, p, i32, p, p, p,
                                                p, p, p, p, p]
    lib.semtools_int4_extract_above.restype = i32
    lib.semtools_int4_extract_above.argtypes = [p, p, i32, i64, p, p, p, p, i32, p, i64, p, p]
    lib.semtools_stream_tiles.restype = i32
    lib.semtools_stream_tiles.argtypes = [p, i64, i64, i32, p, p]
    lib.semtools_stream_ring.restype = i32
    lib.semtools_stream_ring.argtypes = [p, i64, i32, i32, p, p]
    lib.semtools_probe_tilemax.restype = i32
    lib.semtools_probe_tilemax.argtypes = [i32, p, p, i32, i64, i64, i64, i64, i64, i32, i32, p, p]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error; else count the launch."""
    if code != 0:
        msg = library().semtools_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")
    count_launch(kernel)
