"""The IVF-PQ tier under mutation: a forced-ANN store takes a one-document
edit and serves it through the reconcile's delta, with no rebuild.

Counterpart of ``benchmarks/quantitative/bench_ann_incremental.py``:

    python -m semtools_tpu_torch.probes.ann_incremental [--rows 1000000]
        [--docs 1000] [--device cpu] [--out PATH]

The store (the JAX driver's RNG order: ``default_rng(0)`` draws 2,000
centres, then each doc's rows, centre + 0.15 noise, unit rows, upserted in
batches of 100) is built under ``SEMTOOLS_TPU_FORCE_ANN=1`` with
``build_ann_index(force=True)`` on the device. Then a warm query near row
12,345, a rewrite of doc 42 (the last doc when there are fewer) followed at
once by a query for its row 7, and the warm query again. Asserts: the
edited row comes first at a distance under 1e-4, the tier stays
``ivf-pq``, and nothing was rebuilt (``ann.npz`` and ``ann_meta.npz``
untouched, the build token the same, the edited doc alone in the delta).

One JSON record (``config`` ann_incremental) with the JAX driver's keys;
beside them the card's name and power limit, the build's stages, each
step's launches (counts reset before it) and the delta's size. Also written
to ``--out`` as a one-record JSON list.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from semtools_tpu_torch.probes import common

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "ann_incremental.json"
D = 256
CENTRES = 2000
EDITED_DOC = 42
QUERY_ROW = 12345


def _files_state(store):
    """(mtime_ns, size) of the index pair and the meta's build token."""
    ann, meta = store._ann_paths()
    with np.load(meta) as m:
        token = int(m["build_token"])
    return [(p.stat().st_mtime_ns, p.stat().st_size) for p in (ann, meta)], token


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--docs", type=int, default=1000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="the record as a JSON list")
    args = ap.parse_args(argv)
    with common.environ(SEMTOOLS_TPU_FORCE_ANN="1", SEMTOOLS_TPU_TIMINGS="1",  # build stages
                        SEMTOOLS_TPU_SHARDED=os.environ.get("SEMTOOLS_TPU_SHARDED", "0")):
        return run(args)


def run(args) -> int:
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.store.store import Store
    from semtools_tpu_torch.utils import tracing

    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    n, d = args.rows, D
    per = n // args.docs
    edited = f"/doc{min(EDITED_DOC, args.docs - 1):04}.txt"
    launches = {}

    def step(name: str, fn):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        launches[name] = {k: v for k, v in kernels.launch_counts().items() if v}
        return out, secs

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((CENTRES, d)).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="ann_incr_")
    s = Store(str(Path(tmp) / "ws"), dim=d, device=device)
    try:
        bulk = []
        for i in range(args.docs):
            cid = rng.integers(0, CENTRES, per)
            rows = centers[cid] + 0.15 * rng.standard_normal((per, d)).astype(np.float32)
            rows /= np.linalg.norm(rows, axis=1, keepdims=True)
            bulk.append((f"/doc{i:04}.txt", rows))
            if len(bulk) >= 100:
                s.upsert_documents_bulk(bulk)
                bulk = []
        if bulk:
            s.upsert_documents_bulk(bulk)
        paths = [f"/doc{i:04}.txt" for i in range(args.docs)]

        tracing.reset()
        _, build_s = step("build", lambda: s.build_ann_index(force=True))
        stages = {name: secs for name, secs, _ in tracing.timings()}

        mm = s._mmap("r")
        q = np.asarray(mm[min(QUERY_ROW, n - 1)]) + 0.05 * rng.standard_normal(d).astype(
            np.float32)
        q /= np.linalg.norm(q)
        del mm
        step("first_query", lambda: s.search_line_embeddings(q, paths, 10))
        _, warm_s = step("warm_query", lambda: s.search_line_embeddings(q, paths, 10))
        assert s.serving_tier() == "ivf-pq"
        before = _files_state(s)

        # one-doc edit: the tier must keep serving, no rebuild
        new_rows = centers[rng.integers(0, CENTRES, per)]
        new_rows = new_rows + 0.15 * rng.standard_normal((per, d)).astype(np.float32)
        new_rows /= np.linalg.norm(new_rows, axis=1, keepdims=True)

        def edit_and_query():
            s.upsert_document_lines(edited, new_rows)
            return s.search_line_embeddings(new_rows[7], paths, 1)

        hits, edit_query_s = step("edit_and_query", edit_and_query)
        assert (hits[0].path, hits[0].line_number) == (edited, 7), hits[0]
        assert hits[0].distance < 1e-4
        assert s.serving_tier() == "ivf-pq"
        _, warm_after_s = step("warm_query_after_edit",
                               lambda: s.search_line_embeddings(q, paths, 10))
        after = _files_state(s)
        assert after == before, f"the index was rebuilt: {before} -> {after}"
        changed, _, drift = s._ann_layout_diff(s._ann_meta_light()[1])
        delta_rows = len(s._ann_current()[4])
        assert [c[0] for c in changed] == [edited] and delta_rows == per, (changed, delta_rows)

        row = {
            "config": "ann_incremental",
            "metric": "edit_plus_query_seconds",
            "value": round(edit_query_s, 3),
            "n": n, "docs": args.docs, "doc_rows": per,
            "build_seconds": round(build_s, 1),
            "warm_query_s": round(warm_s, 3),
            "warm_query_after_edit_s": round(warm_after_s, 3),
            "speedup_vs_rebuild": round(build_s / max(edit_query_s, 1e-9), 1),
            "platform": device.type,
            # beside the JAX driver's keys
            "card": card, "edit_plus_query_s": edit_query_s, "build_s": build_s,
            "warm_query_seconds": warm_s, "warm_query_after_edit_seconds": warm_after_s,
            "build_stages_s": stages, "delta_rows": delta_rows, "drift_rows": drift,
            "rebuilt": False, "edited_distance": hits[0].distance, "launches": launches,
        }
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps([row], indent=1))
    finally:
        tracing.reset()
        s.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
