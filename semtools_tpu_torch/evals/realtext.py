"""The real-text evaluation on the port.

Counterpart of the repository's ``benchmarks/realtext/run_realtext_eval.py``,
with the same questions, metrics and JSON keys, over the committed corpus of
real prose (Python's own standard-library documentation, 89 documents,
31,619 lines), read-only from ``--corpus``. Per question:

- **doc-hit@10** (semantic questions): is any of the top-10 lines from a
  document known to answer the question? With the hashed fallback embedder
  it measures surface similarity only; ``model_acquisition`` says which
  model produced the results;
- **grep ground truth** (exact-match questions): the ask agent's grep tool
  (the native scanner behind the Unicode-safety router) must return exactly
  the files Python's own ``re`` finds;
- **tier recall@10 against the exact f32 scan** for every compressed serving
  tier (int8, PCA-reduced int8, forced IVF-PQ) on real-text embeddings;
- build time, warm single-query latency, batched throughput.

Beside the reference's keys the results hold ``device`` (the card's name and
power limit, or the CPU) and ``launches`` (the kernels' launch counts from
zero, in total and by pass). Run::

    python -m semtools_tpu_torch.evals realtext [--device cpu] [--corpus DIR] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from semtools_tpu_torch.evals import common

TOP_K = 10
DEFAULT_CORPUS = common.REPO / "benchmarks" / "realtext" / "corpus"

# (id, family, kind, query-or-pattern, expected answer documents)
QUESTIONS = [
    ("r1", "search_filter", "semantic",
     "parse command line arguments and flags", {"argparse"}),
    ("r2", "search_filter", "grep", r"fork", None),
    ("r3", "search_filter", "semantic",
     "serialize python objects to a json string", {"json"}),
    ("r4", "search_filter", "grep", r"RFC 2822", None),
    ("r5", "search_filter", "semantic",
     "open a tcp network socket connection", {"socket"}),
    ("r6", "cross_reference", "semantic",
     "create temporary files and directories", {"tempfile"}),
    ("r7", "cross_reference", "semantic",
     "regular expression pattern matching and groups", {"re"}),
    ("r8", "cross_reference", "grep", r"(?i)deprecated", None),
    ("r9", "cross_reference", "semantic",
     "spawn a child process and capture its output", {"subprocess"}),
    ("r10", "cross_reference", "semantic",
     "compress and decompress data streams",
     {"gzip", "zlib", "lzma", "zipfile", "tarfile"}),
    ("r11", "temporal", "semantic",
     "compute cryptographic hash digests of data", {"hashlib", "hmac"}),
    ("r12", "temporal", "grep", r"thread-safe", None),
    ("r13", "temporal", "semantic",
     "work with dates times and timezones", {"datetime", "time", "calendar"}),
    ("r14", "temporal", "semantic",
     "generate random numbers and choices", {"random", "secrets"}),
    ("r15", "temporal", "semantic",
     "manipulate filesystem paths portably", {"pathlib", "os"}),
]

# Compressed serving tiers measured against the exact f32 scan. Env is
# applied around a device-cache invalidation, which drops every slot corpus
# (their cache keys name the tier, so none could serve another tier anyway).
TIER_ENVS = {
    "int8": {"SEMTOOLS_TPU_STORE_INT8": "1"},
    "reduced_int8": {
        "SEMTOOLS_TPU_REDUCED_DIM": "64",
        "SEMTOOLS_TPU_STORE_INT8": "1",
        "SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(1 << 22),
    },
    "ivf_pq": {"SEMTOOLS_TPU_FORCE_ANN": "1"},
}
TIER_CLEAR = [
    "SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_REDUCED_DIM",
    "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_FORCE_ANN",
]
# The reference's "reduced_int8" budget (4 MiB) holds this corpus' int4 rung
# (31,619 rows x 128 B), which the ladder takes before the reduced one, so
# that row measures the int4 tier (``tiers`` in the results names it). The
# reduced-64d rung itself needs a budget under the int4 corpus and over its
# own (65 B a row): its recall goes to ``extra_tier_recall_at_10``.
EXTRA_TIER_ENVS = {
    "reduced64d": {
        "SEMTOOLS_TPU_REDUCED_DIM": "64",
        "SEMTOOLS_TPU_STORE_INT8": "1",
        "SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(3 << 20),
    },
}


def _set_tier(env: dict) -> None:
    for k in TIER_CLEAR:
        os.environ.pop(k, None)
    os.environ.update(env)


def run(dev, corpus: Path, out_dir: str) -> dict:
    from semtools_tpu_torch.ask.tools import grep_tool
    from semtools_tpu_torch.models.static_model import load_model
    from semtools_tpu_torch.search import (
        SearchConfig,
        search_with_workspace,
        search_with_workspace_batched,
    )
    from semtools_tpu_torch.store import Workspace, device_cache
    from semtools_tpu_torch.store.store import Store

    manifest = json.loads((corpus.parent / "MANIFEST.json").read_text())
    files = sorted(str(p) for p in corpus.glob("*.txt"))
    acquisition = common.attempt_model_acquisition()
    model = load_model(device=dev)
    common.warm_up(dev)
    launches = common.LaunchLog()

    os.environ["SEMTOOLS_WORKSPACE"] = "realtext-eval"
    ws = Workspace.open("realtext-eval")
    ws.save()
    cfg = SearchConfig(top_k=TOP_K, n_lines=0)

    t0 = time.perf_counter()
    with launches.measure("build"):
        search_with_workspace(files, "warmup query", model, cfg, "realtext-eval")
    build_s = time.perf_counter() - t0

    sem_queries = [q for _, _, kind, q, _ in QUESTIONS if kind == "semantic"]
    q_embs = {q: model.encode_single(q).cpu().numpy() for q in sem_queries}

    # Exact-scan baselines for every semantic query (the tier reference).
    exact = {}
    tiers = {}
    with Store(ws.config.root_dir) as store, launches.measure("exact"):
        device_cache.invalidate()
        tiers["exact"] = store.serving_tier()
        for q in sem_queries:
            exact[q] = store.search_line_embeddings(q_embs[q], files, TOP_K)

    # Tier sweep: one store pass per tier, all queries.
    tier_recalls = {name: {} for name in {**TIER_ENVS, **EXTRA_TIER_ENVS}}
    for name, env in {**TIER_ENVS, **EXTRA_TIER_ENVS}.items():
        _set_tier(env)
        device_cache.invalidate()
        with Store(ws.config.root_dir) as store, launches.measure(name):
            if name == "ivf_pq":
                store.build_ann_index(force=True)
            tiers[name] = store.serving_tier()
            for q in sem_queries:
                got = store.search_line_embeddings(q_embs[q], files, TOP_K)
                tier_recalls[name][q] = common.agree_at_k(exact[q], got)
    _set_tier({})
    device_cache.invalidate()

    results = []
    for qid, family, kind, query, expected in QUESTIONS:
        if kind == "grep":
            t0 = time.perf_counter()
            out = grep_tool(files, query, context_lines=0, is_regex=True)
            dt = time.perf_counter() - t0
            got = {Path(f).stem for f in common.chunk_files(out)}
            want = common.grep_truth(files, query)
            results.append({
                "question": qid, "family": family, "kind": "grep",
                "pattern": query, "files_matched": len(got),
                "exact_match_vs_python_re": got == want,
                "seconds": dt,
            })
            continue
        t0 = time.perf_counter()
        with launches.measure("product"):
            hits = search_with_workspace(files, query, model, cfg, "realtext-eval")
        dt = time.perf_counter() - t0
        hit_docs = [Path(h.path).stem for h in hits]
        results.append({
            "question": qid, "family": family, "kind": "semantic",
            "query": query,
            "doc_hit_at_10": float(bool(set(hit_docs) & expected)),
            "top_docs": sorted(set(hit_docs))[:10],
            "tier_recall_at_10": {
                name: tier_recalls[name][query] for name in TIER_ENVS
            },
            "seconds": dt,
        })

    # Batched throughput over the semantic questions (the -Q path).
    with launches.measure("batched"):
        search_with_workspace_batched(files, sem_queries, model, cfg, "realtext-eval")
        t0 = time.perf_counter()
        per_q = search_with_workspace_batched(
            files, sem_queries, model, cfg, "realtext-eval"
        )
        batch_s = time.perf_counter() - t0
    batch_agree = [
        common.agree_at_k(exact[q], rows) for q, rows in zip(sem_queries, per_q)
    ]

    sem = [r for r in results if r["kind"] == "semantic"]
    greps = [r for r in results if r["kind"] == "grep"]
    summary = {
        "semantic_questions": len(sem),
        "mean_doc_hit_at_10": sum(r["doc_hit_at_10"] for r in sem) / len(sem),
        "mean_tier_recall_at_10": {
            name: sum(tier_recalls[name].values()) / len(sem_queries) for name in TIER_ENVS
        },
        "grep_questions": len(greps),
        "grep_exact_vs_python_re": sum(
            r["exact_match_vs_python_re"] for r in greps
        ),
        "mean_semantic_seconds": sum(r["seconds"] for r in sem) / len(sem),
        "batched": {
            "queries": len(sem_queries),
            "seconds_total": batch_s,
            "queries_per_sec": len(sem_queries) / max(batch_s, 1e-9),
            "mean_agreement_with_exact": sum(batch_agree) / len(batch_agree),
        },
    }

    payload = {
        "corpus": {
            "documents": len(files),
            "lines": sum(manifest["documents"].values()),
            "source": manifest["source"],
            "license": manifest["license"],
            "python_version": manifest["python_version"],
        },
        "model": model.name,
        "model_acquisition": acquisition,
        "platform": str(dev),
        "device": common.device_block(dev),
        "workspace_build_seconds": build_s,
        "summary": summary,
        "per_question": results,
        "tiers": tiers,
        "extra_tier_recall_at_10": {
            name: {"mean": sum(tier_recalls[name].values()) / len(sem_queries),
                   "per_query": tier_recalls[name]}
            for name in EXTRA_TIER_ENVS
        },
        "launches": launches.report(),
        "note": (
            "doc-hit@10 with the hashed fallback embedder measures surface "
            "similarity, not semantics — see model_acquisition. The tier "
            "recall@10 rows are model-independent product evidence: each "
            "compressed tier vs the exact f32 scan on real-text embedding "
            "distributions."
        ),
    }
    path = common.write_results(out_dir, "RESULTS_REALTEXT.json", payload)
    print(json.dumps(summary, indent=1))
    print(f"wrote {path}")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m semtools_tpu_torch.evals realtext",
                                 description=__doc__.split("\n\n")[0])
    common.add_common_args(ap)
    ap.add_argument("--corpus", default=str(DEFAULT_CORPUS),
                    help="directory of the corpus' .txt files, its MANIFEST.json "
                         f"beside it (default {DEFAULT_CORPUS})")
    args = ap.parse_args(argv)
    corpus = Path(args.corpus)
    if not any(corpus.glob("*.txt")) or not (corpus.parent / "MANIFEST.json").is_file():
        print(f"error: no corpus at {corpus} (its .txt files, and MANIFEST.json beside "
              "it): the real-text corpus is committed under benchmarks/realtext/",
              file=sys.stderr)
        return 2
    dev = common.open_device(args.device)
    with common.eval_env("semtools_realtext_"):
        _set_tier({})
        run(dev, corpus.resolve(), args.out)
    return 0
