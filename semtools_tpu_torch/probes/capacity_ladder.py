"""The capacity ladder where the device budget binds: the real ``Store``
driven through its int8, int4, reduced-64d and reduced-32d rungs at corpus
sizes derived from the device budget B.

Counterpart of ``benchmarks/quantitative/bench_capacity_ladder.py``:

    python -m semtools_tpu_torch.probes.capacity_ladder [--budget BYTES]
        [--queries 32] [--k 10] [--reps 3] [--hops int8,int4,...]
        [--workdir DIR] [--skip-measure] [--skip-policy] [--device cpu] [--out PATH]

One clustered corpus (the JAX driver's generator: centres ~ N(0, I) from
``default_rng(0)``, one per 5,000 rows, doc j's rows from ``default_rng(10_000
+ j)`` with 0.15 noise, unit rows) grows through the rungs, doc_rows =
0.83 * (B / 256) / 14:

    14 docs  -> int8-mxu-scan             (0.83 B/256 rows)
    30 docs  -> int4-mxu-scan             (1.78 B/256: int8 blown, int4 fits)
    60 docs  -> int8-mxu-scan-reduced64d  (3.56 B/256: int4 blown)
    60 docs, SEMTOOLS_TPU_REDUCED_DIM=32 -> int8-mxu-scan-reduced32d
    73 docs  -> int8-mxu-scan-reduced32d  (the policy's own auto-halve)

The docs are made on worker threads (each has its own generator, so the
bytes are the JAX driver's) and upserted in order; the corpus grows only as
far as the last hop of ``--hops`` needs. Queries are perturbed
rows of doc 0 (``default_rng(99)`` picks them, ``default_rng(7)`` the 0.05
noise). Each hop checks the serving tier, recall@10 against an independent
truth pass over the store's own mmap (exact f32 products in 1M-row chunks
on the device, TF32 off; ties by distance, then slot),
the largest distance error by slot and threshold mode at a cut through the
neighbour shell, and times the cold build (``device_cache.invalidate()``
first), the warm batched search (median of ``--reps``) and five single
searches. Every record carries the JAX driver's keys; beside them the card
(``nvidia-smi``'s name and power limit), each step's kernel launches
(counts reset before it), and for the warm batched search the passes of the
quantized pool (the ``tier_pool`` stage's count a search: the int8 and
reduced rungs' growth loop, one for int4) and the host re-rank's seconds
(``tier_rerank``). The policy tables (single device, and an 8-shard mesh in
a CPU child with ``SEMTOOLS_TORCH_VIRTUAL_DEVICES=8``) print first. Records
also go to ``--out`` as one JSON list.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np

from semtools_tpu_torch.probes import common

DIM = 256
DOCS_INT8, DOCS_INT4, DOCS_RED = 14, 30, 60
# reduced-32 auto-halve rung: past rows * 65 > budget the policy halves the
# reduced dim to 32 on its own (73 docs: 4.34 B/256 rows)
DOCS_RED32 = 73
HOPS = ("int8", "int4", "reduced64", "reduced32", "reduced32auto")
# the docs each hop's store holds
HOP_DOCS = dict(zip(HOPS, (DOCS_INT8, DOCS_INT4, DOCS_RED, DOCS_RED, DOCS_RED32)))
TIERS = dict(zip(HOPS, ("int8-mxu-scan", "int4-mxu-scan", "int8-mxu-scan-reduced64d",
                        "int8-mxu-scan-reduced32d", "int8-mxu-scan-reduced32d")))
# the kernels a hop must launch on the card (the reduced rungs run the plain scan)
HOP_KERNELS = {"int8": ("int8_tilemax", "select_subtiles", "int8_rescan_topk"),
               "int4": ("int4_sims_max", "select_subtiles", "int4_cutoff_counts",
                        "int4_extract_above")}
MAX_DIST_ERR = 1e-5  # every rung serves exact f32 distances
TRUTH_CHUNK = 1 << 20  # rows a truth-pass step scores
WORKERS = min(8, os.cpu_count() or 1)  # threads making the docs
REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "chiprun_out" / "capacity_ladder.json"


def _gen_doc(doc_id: int, rows: int, centers: np.ndarray) -> np.ndarray:
    """Doc ``doc_id``'s clustered rows: the JAX driver's operations in its
    order, so the bytes are equal."""
    rng = np.random.default_rng(10_000 + doc_id)
    noise = rng.standard_normal((rows, DIM), dtype=np.float32)
    cid = rng.integers(0, len(centers), rows)
    buf = np.take(centers, cid, axis=0)
    np.multiply(noise, np.float32(0.15), out=noise)
    np.add(buf, noise, out=buf)
    nrm = np.sqrt(np.einsum("ij,ij->i", buf, buf))
    buf /= nrm[:, None]
    return buf


def _ordered(fn, items, workers: int):
    """``fn(item)`` for each item, in order, at most ``2 * workers`` ahead."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def exact_topk_mmap(mm, n_rows: int, q: np.ndarray, k: int, device):
    """Ground truth over the store's own mmap on ``device``: top-k by
    (distance, slot), the tie order every serving tier implements, exact f32
    distances ``1 - row . q``, in TRUTH_CHUNK-row steps (the image never
    materializes). Returns (slots [Q, k] int64, distances [Q, k] float64)."""
    import torch

    if device.type == "cuda" and (torch.get_float32_matmul_precision() != "highest"
                                  or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the truth pass needs exact f32 products: TF32 is on")
    qn = q.shape[0]
    q_dev = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)
    best_d = torch.full((qn, k), float("inf"), device=device)
    best_i = torch.zeros((qn, k), dtype=torch.int64, device=device)
    host = torch.empty((min(TRUTH_CHUNK, n_rows), DIM), dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    for start in range(0, n_rows, TRUTH_CHUNK):
        m = min(TRUTH_CHUNK, n_rows - start)
        np.copyto(host.numpy()[:m], mm[start : start + m])
        d = 1.0 - q_dev @ host[:m].to(device, non_blocking=True).T  # [Q, m]
        slots = torch.arange(start, start + m, device=device).expand(qn, m)
        # best holds lower slots than the chunk, each part in slot order:
        # a stable sort by distance is the (distance, slot) order
        v, pos = torch.sort(torch.cat([best_d, d], 1), dim=1, stable=True)
        best_d = v[:, :k]
        best_i = torch.cat([best_i, slots], 1).gather(1, pos[:, :k])
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the pinned buffer is refilled next
    return best_i.cpu().numpy(), best_d.cpu().numpy().astype(np.float64)


def _slot_of(store):
    """(path, line) -> global slot, from the store's committed layout."""
    layout = {p: int(s) for p, s in store.db.execute(
        "SELECT path, slot_start FROM docs WHERE slot_start IS NOT NULL")}
    return lambda path, line: layout[path] + line


def hop_launches(row: dict) -> Dict[str, int]:
    """A hop record's launches summed over its steps."""
    total: Dict[str, int] = {}
    steps = row["launches"]
    for counts in [steps["cold"], *steps["warm"], *steps["single"], steps["threshold"]]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def check_hop(row: dict) -> None:
    """The gates of a hop on the card: its tier, recall@10 1.0, distances
    within MAX_DIST_ERR, threshold mode exact, and its kernels launched."""
    hop = row["hop"]
    launched = hop_launches(row)
    missing = [k for k in HOP_KERNELS.get(hop, ()) if not launched.get(k)]
    if (row["serving_tier"] != TIERS[hop] or row["value"] != 1.0
            or not row["max_abs_dist_err"] <= MAX_DIST_ERR or not row["threshold_mode_exact"]
            or missing):
        raise AssertionError(f"capacity ladder hop {hop}: {row['serving_tier']}, recall "
                             f"{row['value']}, distance error {row['max_abs_dist_err']}, "
                             f"threshold exact {row['threshold_mode_exact']}, never launched "
                             f"{missing}")


class Step:
    """Host wall, launches (counts from zero) and the store's stage
    totals of one measured step."""

    def __init__(self, device):
        self.device = device
        self.launches: Dict[str, int] = {}
        self.stages: Dict[str, tuple] = {}
        self.seconds = 0.0

    def __enter__(self):
        from semtools_tpu_torch.ops import kernels
        from semtools_tpu_torch.utils import tracing

        kernels.reset_launch_counts()
        tracing.reset()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from semtools_tpu_torch.ops import kernels
        from semtools_tpu_torch.utils import tracing

        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self._t0
        self.launches = {k: v for k, v in kernels.launch_counts().items() if v}
        self.stages = {name: (secs, n) for name, secs, n in tracing.timings()}
        return False


def run_hop(store, paths, name: str, expect_tier: str, qs: np.ndarray, k: int, reps: int,
            device, card: str, extra=()) -> dict:
    from semtools_tpu_torch.store import device_cache

    n = store.count_line_embeddings()
    tier = store.serving_tier()
    print(f"[{name}] rows={n:,} serving_tier={tier}", flush=True)
    assert tier == expect_tier, f"policy picked {tier}, expected {expect_tier}"

    mm = store._mmap("r")
    t0 = time.perf_counter()
    gt_i, gt_d = exact_topk_mmap(mm, n, qs, k, device)
    truth_s = time.perf_counter() - t0
    del mm

    device_cache.invalidate()  # measure the cold build honestly
    with Step(device) as cold:
        res = store.search_line_embeddings_batched(qs, paths, top_k=k)

    warm = []
    for _ in range(reps):
        with Step(device) as step:
            res = store.search_line_embeddings_batched(qs, paths, top_k=k)
        warm.append(step)
    warm_s = float(np.median([s.seconds for s in warm]))

    single = []
    for r in range(min(5, len(qs))):
        with Step(device) as step:
            store.search_line_embeddings(qs[r], paths, top_k=k)
        single.append(step)

    slot_of = _slot_of(store)
    got = np.array([[slot_of(rl.path, rl.line_number) for rl in per] for per in res], np.int64)
    recall = float(np.mean([len(set(gt_i[r]) & set(got[r])) / k for r in range(len(qs))]))
    # distance exactness BY SLOT (a recall miss must not show up as a
    # distance error between two different rows)
    errs = [0.0]
    for r, per in enumerate(res):
        gt_map = {int(s): float(d) for s, d in zip(gt_i[r], gt_d[r])}
        errs += [abs(rl.distance - gt_map[int(g)]) for rl, g in zip(per, got[r])
                 if int(g) in gt_map]
    dist_err = float(np.max(errs))

    # threshold mode at a cut straddling the neighbour shell
    thr = float(np.median(gt_d[:, k // 2]))
    with Step(device) as thr_step:
        res_t = store.search_line_embeddings_batched(qs[:8], paths, top_k=k, max_distance=thr)
    thr_ok = True
    for r, per in enumerate(res_t):
        want = [int(s) for s, d in zip(gt_i[r], gt_d[r]) if d < thr][:k]
        thr_ok = thr_ok and [slot_of(rl.path, rl.line_number) for rl in per] == want

    def stage_total(step, stage):
        return step.stages.get(stage, (0.0, 0))

    def per_warm(stage, i):
        return float(np.median([stage_total(s, stage)[i] for s in warm]))

    row = {
        "config": "capacity_ladder", "hop": name, "metric": "recall_at_10",
        "value": recall, "n": n, "dim": DIM, "serving_tier": tier,
        "cold_build_and_query_s": round(cold.seconds, 3),
        "warm_batched_s": round(warm_s, 4), "batch_q": len(qs),
        "queries_per_sec": round(len(qs) / warm_s, 2),
        "warm_single_query_s": round(float(np.median([s.seconds for s in single])), 4),
        "max_abs_dist_err": dist_err, "threshold_mode_exact": thr_ok,
        "truth_pass_s": round(truth_s, 1),
        "budget_bytes": int(store._device_budget_bytes(n)),
        "build_mode": os.environ.get("SEMTOOLS_TPU_BUILD", "auto"),
        # beside the JAX driver's keys
        "device": device.type, "card": card,
        "slot_corpus_build_s": stage_total(cold, "slot_corpus_build")[0],
        "warm_pool_passes": per_warm("tier_pool", 1),
        "warm_pool_s": per_warm("tier_pool", 0),
        "warm_rerank_s": per_warm("tier_rerank", 0),
        "warm_rerank_share": per_warm("tier_rerank", 0) / warm_s,
        "cold_pool_passes": stage_total(cold, "tier_pool")[1],
        "threshold_pool_passes": stage_total(thr_step, "tier_pool")[1],
        "launches": {"cold": cold.launches, "warm": [s.launches for s in warm],
                     "single": [s.launches for s in single], "threshold": thr_step.launches},
    }
    row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def _store(path: str, device):
    from semtools_tpu_torch.store.store import Store

    return Store(path, dim=DIM, device=device)


def policy_table(budget: int, device) -> List[dict]:
    """Budget math executed on the production policy, single device."""
    td = tempfile.mkdtemp(prefix="ladder_policy_")
    s = _store(os.path.join(td, "ws"), device)
    rows = []
    unit = budget // 256  # rows at which int8 exactly fills the budget
    try:
        for label, n in [
            ("int8 rung", int(0.83 * unit)),
            ("int8 edge", unit),
            ("int4 rung", int(1.78 * unit)),
            ("int4 edge", 2 * unit),
            ("reduced-64 rung", int(3.56 * unit)),
            ("reduced-64 edge", 4 * unit),
            ("reduced-32 rung", int(4.3 * unit)),
            # 33 B/row (32 projected columns + the residual column)
            ("reduced-32 edge", int(7.7 * unit)),
            ("beyond device", 8 * unit),
        ]:
            kind, rd = s._device_kind(n)
            rows.append({
                "config": "capacity_ladder_policy", "label": label, "n": n,
                "device_kind": kind, "reduced_dim": rd,
                "use_ann_tier": bool(s._use_ann_tier(n)),
                "serving_tier": s.serving_tier(n),
                "int8_bytes": n * 256, "int4_bytes": n * 128,
                "reduced64_bytes": n * 64, "budget_bytes": budget,
            })
            print(json.dumps(rows[-1]), flush=True)
    finally:
        s.close()
        shutil.rmtree(td, ignore_errors=True)
    return rows


_MESH_POLICY_SNIPPET = r"""
import json, os, shutil, tempfile
from semtools_tpu_torch.store.store import Store
td = tempfile.mkdtemp()
s = Store(os.path.join(td, "ws"), dim=256)
unit = {budget} // 256
for label, n in [("sharded int8", int(3.56 * unit)),
                 ("sharded int4", int(8 * 1.78 * unit)),
                 ("sharded reduced-64", int(8 * 3.56 * unit)),
                 ("sharded reduced-32", int(8 * 4.3 * unit)),
                 ("beyond 8-device mesh", 8 * 8 * unit)]:
    print(json.dumps({{"config": "capacity_ladder_policy_mesh",
                       "label": label, "n": n, "devices": s._mesh_size(),
                       "serving_tier": s.serving_tier(n),
                       "use_ann_tier": bool(s._use_ann_tier(n))}}))
s.close()
shutil.rmtree(td, ignore_errors=True)
"""


def mesh_policy_table(budget: int) -> List[dict]:
    """The same budget math on a mesh of 8 CPU shards, which multiplies the
    budget: the sharded rungs' selection (policy only)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMTOOLS_")}
    env.update(SEMTOOLS_TORCH_DEVICE="cpu", SEMTOOLS_TORCH_VIRTUAL_DEVICES="8",
               SEMTOOLS_TPU_SHARDED="1", SEMTOOLS_TPU_DEVICE_CACHE_BYTES=str(budget),
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _MESH_POLICY_SNIPPET.format(budget=budget)],
                         env=env, capture_output=True, text=True, timeout=600,
                         stdin=subprocess.DEVNULL)
    print(out.stdout, end="", flush=True)
    if out.returncode != 0:
        print(out.stderr[-2000:], file=sys.stderr)
        raise RuntimeError("mesh policy subprocess failed")
    return [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=0,
                    help="device budget override (bytes); also exported")
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--workdir", default=None,
                    help="store dir (default: temp; deleted at exit). An existing store is "
                         "REUSED: docs already present are not regenerated, so a killed run "
                         "resumes.")
    ap.add_argument("--skip-measure", action="store_true", help="policy tables only")
    ap.add_argument("--hops", default=",".join(HOPS), help="comma list of hops to measure")
    ap.add_argument("--skip-policy", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="the records as one JSON list")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    env = {"SEMTOOLS_TPU_SCAN": os.environ.get("SEMTOOLS_TPU_SCAN", "device"),
           "SEMTOOLS_TPU_SHARDED": os.environ.get("SEMTOOLS_TPU_SHARDED", "0"),
           "SEMTOOLS_TPU_TIMINGS": "1"}  # the pool's passes and the re-rank's seconds
    if args.budget:
        env["SEMTOOLS_TPU_DEVICE_CACHE_BYTES"] = str(args.budget)
    with common.environ(**env):
        return run(args)


def run(args) -> int:
    from semtools_tpu_torch.store import device_cache
    from semtools_tpu_torch.utils import tracing

    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    budget = device_cache._max_bytes()
    records: List[dict] = []

    def emit(row: dict) -> None:
        print(json.dumps(row), flush=True)
        records.append(row)

    emit({"config": "capacity_ladder_meta", "budget_bytes": budget, "platform": device.type,
          "card": card})
    if not args.skip_policy:
        records += policy_table(budget, device)
        records += mesh_policy_table(budget)
    hops = set(args.hops.split(","))
    try:
        if not args.skip_measure:
            measure(args, hops, budget, device, card, emit, records)
    finally:
        tracing.reset()  # the stages were the records': no report at exit
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


def measure(args, hops, budget: int, device, card: str, emit, records: List[dict]) -> None:
    # doc size: 14 docs fill 83% of the int8 budget; 30 docs blow int8 but
    # fill 89% as int4; 60 docs blow int4 but fill 89% as reduced-64
    doc_rows = int(0.83 * (budget // 256) / DOCS_INT8)
    td = args.workdir or tempfile.mkdtemp(prefix="ladder_ws_")
    own_td = args.workdir is None
    store = _store(os.path.join(td, "ws"), device)
    try:
        # the corpus grows only as far as the last hop measured
        docs = max((HOP_DOCS[h] for h in hops), default=0)
        need, free = docs * doc_rows * (DIM * 4 + 8), shutil.disk_usage(td).free  # + hashes
        if free < need:
            raise SystemExit(f"capacity_ladder: {docs} docs of {doc_rows} rows need {need} "
                             f"bytes on disk; {td} has {free} free")
        have = {p for (p,) in store.db.execute(
            "SELECT path FROM docs WHERE slot_start IS NOT NULL")}
        total_rows = DOCS_RED * doc_rows
        centers = np.random.default_rng(0).standard_normal(
            (max(64, total_rows // 5000), DIM)).astype(np.float32)
        # queries: perturbed rows of doc 0 (present at every hop)
        d0 = _gen_doc(0, doc_rows, centers)
        qi = np.random.default_rng(99).integers(0, doc_rows, args.queries)
        qs = d0[qi] + 0.05 * np.random.default_rng(7).standard_normal(
            (args.queries, DIM)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        upserted = 0

        def grow_to(n_docs: int) -> None:
            nonlocal upserted
            t0 = time.perf_counter()
            todo = [j for j in range(upserted, n_docs) if f"/doc{j:03}.txt" not in have]
            gen = lambda j: (j, d0 if j == 0 else _gen_doc(j, doc_rows, centers))  # noqa: E731
            for j, rows in _ordered(gen, todo, WORKERS):
                store.upsert_document_lines(f"/doc{j:03}.txt", rows)
            upserted = n_docs
            emit({"config": "capacity_ladder_meta", "event": "grow", "docs": n_docs,
                  "rows": n_docs * doc_rows, "gen_upsert_s": round(time.perf_counter() - t0, 1)})

        def hop(name: str, extra=()) -> None:
            records.append(run_hop(store, [f"/doc{j:03}.txt" for j in range(upserted)], name,
                                   TIERS[name], qs, args.k, args.reps, device, card, extra))

        for n_docs, name in ((DOCS_INT8, "int8"), (DOCS_INT4, "int4"), (DOCS_RED, "reduced64")):
            if n_docs <= docs:
                grow_to(n_docs)
            if name in hops:
                hop(name)
        from semtools_tpu_torch.ops.reduce import reduced_oversample

        def oversample():
            return {"oversample": reduced_oversample(store.count_line_embeddings(), args.k)}

        # reduced-32d with the corpus-size-scaled oversample at a size where
        # the tier binds
        if "reduced32" in hops:
            with common.environ(SEMTOOLS_TPU_REDUCED_DIM="32"):
                hop("reduced32", oversample())
        # the natural reduced-32 rung: grow past the point where the 64d
        # corpus (65 B/row) blows the budget; the policy halves to 32 itself
        if "reduced32auto" in hops:
            grow_to(DOCS_RED32)
            hop("reduced32auto", oversample())
    finally:
        store.close()
        if own_td:
            shutil.rmtree(td, ignore_errors=True)
    emit({"config": "capacity_ladder_meta", "event": "done",
          "hops": sum(r.get("config") == "capacity_ladder" for r in records)})


if __name__ == "__main__":
    sys.exit(main())
