"""Workspace mutation at scale: the slot corpus on the device is patched by
what an update changed, not rebuilt.

Counterpart of ``benchmarks/quantitative/bench_patch_scale.py``:

    python -m semtools_tpu_torch.probes.patch_scale [--docs 5000] [--lines 100]
        [--dim 256] [--device cpu] [--out PATH]
    python -m semtools_tpu_torch.probes.patch_scale --single-file [--lines 500000]

The first run builds a store of ``--docs`` documents of ``--lines`` unit
rows (``default_rng(7)``, upserted in batches of 500), searches it cold and
warm, then rewrites four documents (d1000-d1003; the last four when there
are fewer), each rewrite followed by a query for its row 9: every update
must ship O(doc) bytes (``patch_cache.uploaded_bytes()``).
``--single-file`` writes one document of ``--lines``
rows (``default_rng(9)``, content hashes 1..n), searches it, edits its
middle row (a new hash) and searches for it: the row-level diff must ship
one row and its index, not the document. Every query must find its planted
row first.

One JSON record (``config`` workspace_patch_500k, or patch_single_file_edit)
with the JAX driver's keys; beside them the card's name and power limit,
each step's launches (counts reset before it) and, per update, the store's
stage seconds (``slot_corpus_patch``, ``tier_pool``, ``tier_rerank``). Also
written to ``--out`` as a one-record JSON list.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from semtools_tpu_torch.probes import common

DOCS = 5000
LINES = 100
SINGLE_FILE_LINES = 500_000
DIM = 256
REWRITTEN = 1000  # the first of the four rewritten docs (the last four when fewer)
REPO = Path(__file__).resolve().parents[2]


def check(row: dict, dim: int = DIM) -> None:
    """The bytes' gates: each one-document update ships at most twice the
    document as int8 rows; the one-line edit at most 1 KiB (one row and its
    index)."""
    if row["config"] == "workspace_patch_500k":
        most = 2 * row["lines"] * dim
        if max(row["per_update_uploaded_bytes"]) > most:
            raise AssertionError(f"patch: an update shipped {row['per_update_uploaded_bytes']} "
                                 f"bytes (at most {most})")
    elif row["edit_shipped_bytes"] > 1024:
        raise AssertionError(f"patch: the one-line edit shipped {row['edit_shipped_bytes']} "
                             f"bytes (at most 1024)")


def _unit(rng, n: int, dim: int):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


class _Steps:
    """Each measured step's wall, launches and stage seconds."""

    def __init__(self, device):
        self.device = device
        self.launches = {}
        self.stages = {}

    def run(self, name: str, fn):
        import torch

        from semtools_tpu_torch.ops import kernels
        from semtools_tpu_torch.utils import tracing

        kernels.reset_launch_counts()
        tracing.reset()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        secs = time.perf_counter() - t0
        self.launches[name] = {k: v for k, v in kernels.launch_counts().items() if v}
        self.stages[name] = {s: t for s, t, _ in tracing.timings()}
        return out, secs


def many_docs(docs: int, lines: int, dim: int, device, card: str) -> dict:
    from semtools_tpu_torch.store import patch_cache
    from semtools_tpu_torch.store.store import Store

    rng = np.random.default_rng(7)
    tmp = tempfile.mkdtemp(prefix="patch_scale_")
    s = Store(str(Path(tmp) / "ws"), dim=dim, device=device)
    steps = _Steps(device)
    try:
        t0 = time.perf_counter()
        bulk = []
        rows_of = {}
        for i in range(docs):
            rows = _unit(rng, lines, dim)
            bulk.append((f"/d{i:04}.txt", rows))
            rows_of[f"/d{i:04}.txt"] = rows
            if len(bulk) >= 500:
                s.upsert_documents_bulk(bulk)
                bulk = []
        if bulk:
            s.upsert_documents_bulk(bulk)
        host_build_s = time.perf_counter() - t0
        paths = list(rows_of)

        q = rows_of["/d0007.txt"][42]
        hits, cold_s = steps.run("cold", lambda: s.search_line_embeddings(q, paths, top_k=10))
        assert (hits[0].path, hits[0].line_number) == ("/d0007.txt", 42), hits[0]
        built_bytes = patch_cache.uploaded_bytes()
        _, warm_s = steps.run("warm", lambda: s.search_line_embeddings(q, paths, top_k=10))

        per_update, patch_bytes, update_stages = [], [], []
        first = max(0, min(REWRITTEN, docs - 4))
        for i in range(4):
            new_rows = _unit(rng, lines, dim)
            path = f"/d{first + i:04}.txt"
            before = patch_cache.uploaded_bytes()

            def update():
                s.upsert_document_lines(path, new_rows)
                return s.search_line_embeddings(new_rows[9], paths, top_k=1)

            hits, secs = steps.run(f"update{i}", update)
            per_update.append(round(secs, 4))
            patch_bytes.append(patch_cache.uploaded_bytes() - before)
            update_stages.append(steps.stages[f"update{i}"])
            assert (hits[0].path, hits[0].line_number) == (path, 9), hits[0]
        return {
            "config": "workspace_patch_500k",
            "total_lines": docs * lines,
            "tier": s.serving_tier(),
            "host_build_seconds": round(host_build_s, 2),
            "cold_first_query_s": round(cold_s, 2),
            "warm_query_s": round(warm_s, 4),
            "per_update_query_s": per_update,
            "per_update_uploaded_bytes": patch_bytes,
            "initial_upload_bytes": built_bytes,
            # beside the JAX driver's keys
            "platform": device.type, "card": card, "docs": docs, "lines": lines,
            "cold_stages_s": steps.stages["cold"], "per_update_stages_s": update_stages,
            "launches": steps.launches,
        }
    finally:
        s.close()
        shutil.rmtree(tmp, ignore_errors=True)


def single_file_edit(n_lines: int, dim: int, device, card: str) -> dict:
    """A one-line edit in ONE document of ``n_lines`` rows: the row-level
    patch diff must ship O(1 row); the unchanged rows move on the device."""
    from semtools_tpu_torch.store import patch_cache
    from semtools_tpu_torch.store.store import Store

    rng = np.random.default_rng(9)
    tmp = tempfile.mkdtemp(prefix="patch_single_")
    s = Store(str(Path(tmp) / "ws"), dim=dim, device=device)
    steps = _Steps(device)
    try:
        rows = _unit(rng, n_lines, dim)
        # content-id hashes (what lines.h64 holds): the edited row's hash
        # changes, every other row's persists
        hashes = np.arange(n_lines, dtype=np.uint64) + 1
        t0 = time.perf_counter()
        s.upsert_document_lines("/big.txt", rows, hashes)
        build_s = time.perf_counter() - t0

        probe_at = n_lines // 4
        hits, cold_s = steps.run(
            "cold", lambda: s.search_line_embeddings(rows[probe_at], ["/big.txt"], top_k=3))
        assert (hits[0].path, hits[0].line_number) == ("/big.txt", probe_at)
        before = patch_cache.uploaded_bytes()

        edit_at = n_lines // 2
        rows[edit_at] = _unit(rng, 1, dim)[0]
        hashes2 = hashes.copy()
        hashes2[edit_at] = np.uint64(n_lines + 7)
        _, upsert_s = steps.run("edit_upsert",
                                lambda: s.upsert_document_lines("/big.txt", rows, hashes2))
        hits, query_s = steps.run(
            "edit_query", lambda: s.search_line_embeddings(rows[edit_at], ["/big.txt"], top_k=1))
        assert (hits[0].path, hits[0].line_number) == ("/big.txt", edit_at)
        shipped = patch_cache.uploaded_bytes() - before
        return {
            "config": "patch_single_file_edit",
            "total_lines": n_lines,
            "tier": s.serving_tier(),
            "host_build_seconds": round(build_s, 2),
            "cold_first_query_s": round(cold_s, 2),
            "edit_shipped_bytes": int(shipped),
            "whole_file_bytes_int8": n_lines * dim,  # what a whole-document patch ships
            "edit_upsert_s": round(upsert_s, 3),
            "edit_query_s": round(query_s, 4),
            # beside the JAX driver's keys
            "platform": device.type, "card": card,
            "edit_query_stages_s": steps.stages["edit_query"], "launches": steps.launches,
        }
    finally:
        s.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--single-file", action="store_true",
                    help="the one-line edit in one document of --lines rows")
    ap.add_argument("--docs", type=int, default=DOCS)
    ap.add_argument("--lines", type=int, default=None,
                    help=f"rows a document ({LINES}; --single-file {SINGLE_FILE_LINES})")
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="the record as a JSON list (default "
                    "chiprun_out/patch_scale.json or patch_single_file.json)")
    args = ap.parse_args(argv)
    with common.environ(SEMTOOLS_TPU_TIMINGS="1"):  # each update's stages
        return run(args)


def run(args) -> int:
    from semtools_tpu_torch.utils import tracing

    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    try:
        if args.single_file:
            row = single_file_edit(args.lines or SINGLE_FILE_LINES, args.dim, device, card)
        else:
            row = many_docs(args.docs, args.lines or LINES, args.dim, device, card)
    finally:
        tracing.reset()
    print(json.dumps(row), flush=True)
    name = "patch_single_file.json" if args.single_file else "patch_scale.json"
    out = Path(args.out) if args.out else REPO / "chiprun_out" / name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps([row], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
