"""The retrieval evaluation on the port: the 15 arxiv questions' search stage.

Counterpart of the repository's ``benchmarks/arxiv/run_retrieval_eval.py``,
with the same questions, metrics and JSON keys, over the synthetic corpus of
:mod:`semtools_tpu_torch.evals.corpus` (``--papers``, seed 7). Semantic
questions go through workspace search, exact-match questions through the
ask agent's grep tool. Per question:

- doc-precision@10: the share of top-10 hits whose file is relevant to the
  question's topic (ground truth by construction);
- int8 agreement: the int8 tier's top-10 against the exact f32 scan's, as
  the reference defines it (multisets of distances rounded to 5 decimals);
- grep completeness (all planted probes found, no false files);
- wall latency per query (warm workspace), and the batched ``-Q`` path
  against the single-query one.

Beside the reference's keys the results hold ``tolerant_agreement_at_10``
(the same two comparisons by the real-text eval's metric: distances within
3e-4, matched one to one), ``tier`` (what the product searches were served
from), ``device`` and ``launches``. Run::

    python -m semtools_tpu_torch.evals retrieval [--device cpu] [--papers 400] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

from semtools_tpu_torch.evals import common

# (question id, family, kind, query-or-pattern, relevant topics)
QUESTIONS = [
    ("a1", "search_filter", "semantic", "attention mechanisms in neural networks", ["attention"]),
    ("a2", "search_filter", "grep", "Diffusion", None),  # titles probe
    ("a3", "search_filter", "semantic", "optimizer design for deep learning", ["optimizers"]),
    ("a4", "search_filter", "grep", "_v3", None),  # filename-revision probe
    ("a5", "search_filter", "semantic", "machine learning for medical imaging", ["medical-imaging"]),
    ("b1", "cross_reference", "semantic", "contrastive representation learning with positive pairs", ["contrastive"]),
    ("b2", "cross_reference", "semantic", "reinforcement learning for robotics control", ["rl-robotics"]),
    ("b3", "cross_reference", "grep", "contrastive learning", None),
    ("b4", "cross_reference", "semantic", "agents planning with tools", ["agents"]),
    ("b5", "cross_reference", "semantic", "vision models using language model techniques", ["vision-language"]),
    ("c1", "temporal", "semantic", "autonomous agent loop planning acting", ["agents"]),
    ("c2", "temporal", "grep", "State Space Model", None),
    ("c3", "temporal", "semantic", "structured state space sequence models", ["state-space"]),
    ("c4", "temporal", "semantic", "denoising diffusion generative models", ["diffusion"]),
    ("c5", "temporal", "semantic", "tumor segmentation radiology scans", ["medical-imaging"]),
]

TOP_K = 10
SEED = 7


def run(dev, n_papers: int, out_dir: str, corpus_root: Path) -> dict:
    from semtools_tpu_torch.ask.tools import grep_tool
    from semtools_tpu_torch.evals.corpus import gen
    from semtools_tpu_torch.models.static_model import load_model
    from semtools_tpu_torch.search import (
        SearchConfig,
        search_with_workspace,
        search_with_workspace_batched,
    )
    from semtools_tpu_torch.store import Workspace, device_cache
    from semtools_tpu_torch.store.store import Store

    truth = gen(corpus_root, n_papers=n_papers, seed=SEED)
    files = sorted(str(p) for p in (corpus_root / "full_text").glob("*.txt"))
    n_lines = sum(Path(f).read_text().count("\n") for f in files)
    acquisition = common.attempt_model_acquisition()
    model = load_model(device=dev)
    common.warm_up(dev)
    launches = common.LaunchLog()

    os.environ["SEMTOOLS_WORKSPACE"] = "retrieval-eval"
    ws = Workspace.open("retrieval-eval")
    ws.save()

    def _search(query, top_k=TOP_K):
        cfg = SearchConfig(top_k=top_k, n_lines=0)
        return search_with_workspace(files, query, model, cfg, "retrieval-eval")

    # Warm build: embeds the corpus once into the workspace store.
    t0 = time.perf_counter()
    with launches.measure("build"):
        _search("warmup query")
    build_s = time.perf_counter() - t0
    with Store(ws.config.root_dir) as store:
        tier = store.serving_tier()

    def _pid(path):
        return Path(path).stem

    results = []
    tolerant = {"int8": {}, "batched": {}}
    for qid, family, kind, query, topics in QUESTIONS:
        if kind == "grep":
            t0 = time.perf_counter()
            out = grep_tool(files, query, context_lines=0)
            dt = time.perf_counter() - t0
            hit_pids = {_pid(f) for f in common.chunk_files(out)}
            if query == "Diffusion":
                want = set(truth["_diffusion_titles"])
                # the word also appears in body text of diffusion papers;
                # completeness = all title-probe papers found
                complete = want <= hit_pids
            elif query == "_v3":
                want = set(truth["_v3_files"])
                complete = want <= hit_pids and all("_v3" in p for p in hit_pids)
            else:  # phrase probes: every hit must contain the phrase
                complete = bool(hit_pids)
            results.append({
                "question": qid, "family": family, "kind": "grep",
                "pattern": query, "files_matched": len(hit_pids),
                "complete": bool(complete), "seconds": dt,
            })
            continue

        # semantic: score the serving tier's top-k against ground truth
        t0 = time.perf_counter()
        with launches.measure("product"):
            hits = _search(query)
        dt = time.perf_counter() - t0
        relevant = set()
        for t in topics:
            relevant |= set(truth[t])
        hit_pids = [_pid(h.path) for h in hits]
        prec = sum(p in relevant for p in hit_pids) / max(len(hit_pids), 1)

        # tier agreement: int8 tier vs exact f32 on the same query
        q_emb = model.encode_single(query).cpu().numpy()
        with Store(ws.config.root_dir) as store:
            os.environ["SEMTOOLS_TPU_STORE_INT8"] = "0"
            device_cache.invalidate()
            with launches.measure("exact"):
                exact = store.search_line_embeddings(q_emb, files, TOP_K)
            os.environ["SEMTOOLS_TPU_STORE_INT8"] = "1"
            device_cache.invalidate()
            with launches.measure("int8"):
                got = store.search_line_embeddings(q_emb, files, TOP_K)
            os.environ.pop("SEMTOOLS_TPU_STORE_INT8", None)
        # Tie-aware agreement: sentences repeat in this corpus, so many
        # lines share one embedding and the exact top-10 is only defined
        # up to tie permutations. The tiers agree when they return the
        # same multiset of exact distances.
        tolerant["int8"][qid] = common.agree_at_k(exact, got)
        results.append({
            "question": qid, "family": family, "kind": "semantic",
            "query": query, "doc_precision_at_10": prec,
            "int8_tier_agreement_at_10": common.rounded_agreement(exact, got),
            "seconds": dt,
        })

    # Batched cross-check: all semantic questions through the
    # --queries-file serving path (one encode + one batched store scan);
    # tie-aware agreement with the single-query product path per question.
    sem = [(qid, q) for qid, _, kind, q, _ in QUESTIONS if kind == "semantic"]
    sem_queries = [q for _, q in sem]
    singles = {r["query"]: r for r in results if r["kind"] == "semantic"}
    cfg_b = SearchConfig(top_k=TOP_K, n_lines=0)
    with launches.measure("batched"):
        search_with_workspace_batched(
            files, sem_queries, model, cfg_b, "retrieval-eval"
        )  # the reference's warm-up of the batched path
        t0 = time.perf_counter()
        per_q = search_with_workspace_batched(
            files, sem_queries, model, cfg_b, "retrieval-eval"
        )
        batch_s = time.perf_counter() - t0
    with launches.measure("product"):
        single_again = {
            q: search_with_workspace(files, q, model, cfg_b, "retrieval-eval")
            for q in sem_queries
        }
    batch_agree = []
    for (qid, q), rows in zip(sem, per_q):
        batch_agree.append(common.rounded_agreement(single_again[q], rows))
        singles[q]["batched_agreement_at_10"] = batch_agree[-1]
        tolerant["batched"][qid] = common.agree_at_k(single_again[q], rows)
    batched_summary = {
        "queries": len(sem_queries),
        "seconds_total": batch_s,
        "queries_per_sec": len(sem_queries) / max(batch_s, 1e-9),
        "mean_agreement_with_single_query": sum(batch_agree) / len(batch_agree),
    }
    for name in ("int8", "batched"):
        vals = tolerant[name]
        tolerant[f"mean_{name}"] = sum(vals.values()) / len(vals)

    by_family: dict = {}
    for r in results:
        fam = by_family.setdefault(r["family"], {"n": 0, "seconds": 0.0})
        fam["n"] += 1
        fam["seconds"] += r["seconds"]
        if "doc_precision_at_10" in r:
            fam.setdefault("precisions", []).append(r["doc_precision_at_10"])
            fam.setdefault("agreements", []).append(r["int8_tier_agreement_at_10"])
    for fam in by_family.values():
        fam["mean_seconds"] = fam.pop("seconds") / fam["n"]
        if "precisions" in fam:
            precs = fam.pop("precisions")
            agrees = fam.pop("agreements")
            fam["semantic_questions"] = len(precs)
            fam["mean_doc_precision_at_10"] = sum(precs) / len(precs)
            fam["mean_int8_agreement_at_10"] = sum(agrees) / len(agrees)

    payload = {
        "corpus": {"papers": n_papers, "lines": n_lines,
                   "generator": "semtools_tpu_torch.evals.corpus", "seed": SEED},
        "model": model.name,
        "model_acquisition": acquisition,
        "platform": str(dev),
        "device": common.device_block(dev),
        "workspace_build_seconds": build_s,
        "tier": tier,
        "per_question": results,
        "per_family": by_family,
        "batched_queries_file": batched_summary,
        "tolerant_agreement_at_10": tolerant,
        "launches": launches.report(),
    }
    path = common.write_results(out_dir, "RESULTS_RETRIEVAL.json", payload)
    print(json.dumps(payload["per_family"], indent=1))
    print(f"wrote {path}")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m semtools_tpu_torch.evals retrieval",
                                 description=__doc__.split("\n\n")[0])
    common.add_common_args(ap)
    ap.add_argument("--papers", type=int, default=400,
                    help="papers the corpus generator writes (default 400)")
    args = ap.parse_args(argv)
    dev = common.open_device(args.device)
    with common.eval_env("semtools_eval_corpus_") as corpus_root:
        run(dev, args.papers, args.out, corpus_root)
    return 0
