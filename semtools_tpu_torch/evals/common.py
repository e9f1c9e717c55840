"""What the evaluation drivers share: the device, the environment, the
model's provenance, the agreement metrics, the grep truth, tool-output
parsing, launch counts and the transcript comparison.

The device is explicit, as everywhere in the port: ``--device cuda`` by
default, ``--device cpu`` on request; with no CUDA device and no
``--device cpu`` an evaluation exits 2 and runs nothing on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator, List, Optional

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "chiprun_out" / "evals"

CHUNK_RE = re.compile(r"<chunk file=(\S+) start=(\d+) end=(\d+)[^>]*>\n?")


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default cuda; no fallback)")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help=f"directory for the results (default {DEFAULT_OUT})")


def open_device(name: Optional[str]):
    """The evaluation's torch device (``name`` or ``cuda``), made the default
    of every store it opens. Exits 2 when CUDA is asked for and absent."""
    from semtools_tpu_torch.utils.platform import DEVICE_ENV, resolve_device

    try:
        dev = resolve_device(name or "cuda")
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(2)
    os.environ[DEVICE_ENV] = str(dev)
    return dev


@contextlib.contextmanager
def eval_env(corpus_prefix: str, **env: str) -> Iterator[Path]:
    """A fresh ``HOME`` (workspaces and caches) for one run, with the
    drivers' settings: no model download, one device unless sharding is
    asked for, and ``env``. Yields an empty directory for the corpus, named
    as the reference drivers name theirs (``corpus_prefix`` and eight random
    characters, so paths in tool outputs have the same length); both are
    removed afterwards."""
    with tempfile.TemporaryDirectory(prefix="semtools_eval_home_") as home, \
            tempfile.TemporaryDirectory(prefix=corpus_prefix) as corpus:
        os.environ["HOME"] = home
        os.environ["SEMTOOLS_TPU_NO_FETCH"] = "1"
        os.environ.setdefault("SEMTOOLS_TPU_SHARDED", "0")
        os.environ.update(env)
        yield Path(corpus)


def warm_up(dev) -> None:
    """Build or load what a first search would otherwise build inside a timed
    stage: the native tokenizer and grep scanner, and on the card the kernel
    library and the CUDA context."""
    from semtools_tpu_torch.utils import native

    native.load()
    if dev.type == "cuda":
        import torch

        from semtools_tpu_torch.ops import kernels

        kernels.library()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not available"


def device_block(dev) -> Dict[str, str]:
    if dev.type != "cuda":
        return {"type": "cpu"}
    import torch

    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "name_power_limit": card_line()}


def attempt_model_acquisition() -> dict:
    """Where the embedding model came from, for the results: local model2vec
    artifacts (``SEMTOOLS_TPU_MODEL_DIR`` or the HuggingFace cache), else a
    blocker record. Opens no socket: the drivers never download."""
    from semtools_tpu_torch.models.static_model import MODEL_NAME, _find_artifact_dir

    record = {"model_requested": MODEL_NAME}
    local = _find_artifact_dir(MODEL_NAME)
    if local is not None:
        record.update(acquired=True, source="local-cache", artifact_dir=local)
        return record
    record.update(
        acquired=False,
        source=None,
        blocker=(
            "no local model2vec artifacts (SEMTOOLS_TPU_MODEL_DIR or the "
            "HuggingFace cache) and the evaluation drivers never download "
            "(SEMTOOLS_TPU_NO_FETCH=1), so the built-in hashed fallback "
            "embedder scored these rows. Point SEMTOOLS_TPU_MODEL_DIR at "
            "the model's artifacts for the real-model rows."
        ),
    )
    return record


def agree_at_k(reference, got, tol: float = 3e-4) -> float:
    """Tie-aware, tolerance-based agreement: fraction of reference hits
    matched (greedily, one-to-one) by a returned hit with the same distance
    within ``tol``. Rounded-distance multisets (:func:`rounded_agreement`)
    flip at rounding boundaries when two paths compute the same score with
    different f32 summation orders."""
    remaining = sorted(h.distance for h in got)
    matched = 0
    for d in sorted(h.distance for h in reference):
        for i, r in enumerate(remaining):
            if abs(r - d) < tol:
                matched += 1
                del remaining[i]
                break
    return matched / max(len(reference), 1)


def rounded_agreement(reference, got) -> float:
    """The retrieval eval's agreement: the share of the reference's distances,
    rounded to 5 decimals, found in ``got``'s as a multiset."""
    a = Counter(round(h.distance, 5) for h in reference)
    b = Counter(round(h.distance, 5) for h in got)
    return sum((a & b).values()) / max(len(reference), 1)


def grep_truth(files, pattern: str) -> set:
    """Ground truth for grep questions: Python's ``re`` over the raw files
    (recomputed, not planted); the set of file stems."""
    rx = re.compile(pattern)
    return {Path(f).stem for f in files
            if rx.search(Path(f).read_text(errors="replace"))}


def chunk_files(tool_output: str) -> set:
    """The files named by a tool output's ``<chunk file=...>`` lines."""
    return {line.split("file=")[1].split(" ")[0]
            for line in tool_output.splitlines() if line.startswith("<chunk")}


def parse_chunks(text: str):
    """(file, start, end, first_line) for every chunk envelope in a tool
    output. start/end are the tools' 0-based [start, end) convention."""
    out = []
    for m in CHUNK_RE.finditer(text):
        body = text[m.end():].split("</chunk>", 1)[0]
        first = body.splitlines()[0] if body.splitlines() else ""
        out.append((m.group(1), int(m.group(2)), int(m.group(3)), first))
    return out


class LaunchLog:
    """Kernel launches (``ops/kernels.py``) counted from zero at creation,
    in total and by pass."""

    def __init__(self):
        from semtools_tpu_torch.ops import kernels

        self._kernels = kernels
        kernels.reset_launch_counts()
        self.by_pass: Dict[str, Dict[str, int]] = {}

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        before = self._kernels.launch_counts()
        try:
            yield
        finally:
            acc = self.by_pass.setdefault(name, {})
            for k, v in self._kernels.launch_counts().items():
                if v != before[k]:
                    acc[k] = acc.get(k, 0) + v - before[k]

    def report(self) -> dict:
        total = {k: v for k, v in self._kernels.launch_counts().items() if v}
        return {"total": total, "by_pass": self.by_pass}


def write_results(out_dir: str, name: str, payload: dict) -> Path:
    path = Path(out_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n")
    return path


# -- transcripts ----------------------------------------------------------------

TRUNCATED = "…[truncated]"
_DIST_RE = re.compile(r"distance=([-+0-9.eE]+|nan|inf)")
_BLOCK_RE = re.compile(r"  <chunk file=\S+ start=\d+ end=\d+ distance=D>\n(?:  (?!</chunk>).*\n)*"
                       r"  </chunk>\n")


def _split_distances(piece: str, cut: bool):
    """``piece`` with every distance written ``D``, and the distances. A
    piece cut by a truncation loses its last, partial line first."""
    if cut:
        piece = piece[:piece.rfind("\n") + 1]
    dists = [float(m.group(1)) for m in _DIST_RE.finditer(piece)]
    return _DIST_RE.sub("distance=D", piece), dists


def _near_tie_runs(text: str, dists: List[float], tol: float) -> str:
    """``text`` with each run of whole chunk blocks whose distances lie within
    ``tol`` of their neighbour's put in one canonical order."""
    blocks = list(_BLOCK_RE.finditer(text))
    if len(blocks) < 2 or len(dists) < len(blocks):
        return text
    out, pos, i = [], 0, 0
    while i < len(blocks):
        j = i + 1
        while (j < len(blocks) and blocks[j].start() == blocks[j - 1].end()
               and abs(dists[j] - dists[j - 1]) <= tol):
            j += 1
        out.append(text[pos:blocks[i].start()])
        out.extend(sorted(b.group(0) for b in blocks[i:j]))
        pos = blocks[j - 1].end()
        i = j
    out.append(text[pos:])
    return "".join(out)


def transcript_difference(got: str, want: str, got_root: str, want_root: str,
                          tol: float = 0.0) -> Optional[str]:
    """None when transcript ``got`` equals ``want`` once each corpus root is
    replaced, a ``distance=`` may differ by up to ``tol``, and (when ``tol``
    is not 0) whole search hits within ``tol`` of each other may trade
    places; else what differs. A tool output is cut at 400 characters, so
    with longer distances or roots a cut falls elsewhere: up to the last
    whole line before a cut, one transcript's text need only be a prefix of
    the other's."""
    got, want = got.replace(got_root, "<ROOT>"), want.replace(want_root, "<ROOT>")
    gp, wp = got.split(TRUNCATED), want.split(TRUNCATED)
    if len(gp) != len(wp):
        return f"{len(gp) - 1} truncated tool outputs against {len(wp) - 1}"
    for n, (g, w) in enumerate(zip(gp, wp)):
        cut = n < len(gp) - 1
        (g, gd), (w, wd) = _split_distances(g, cut), _split_distances(w, cut)
        bad = [(a, b) for a, b in zip(gd, wd) if abs(a - b) > tol]
        if bad:
            return f"distances differ by more than {tol}: {bad[:3]}"
        if tol:
            g, w = _near_tie_runs(g, gd, tol), _near_tie_runs(w, wd, tol)
        same = (g.startswith(w) or w.startswith(g)) if cut else g == w
        if not same or (not cut and len(gd) != len(wd)):
            at = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
            return f"text differs at {at}: {g[at - 80:at + 80]!r} against {w[at - 80:at + 80]!r}"
    return None
