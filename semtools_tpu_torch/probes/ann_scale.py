"""The IVF-PQ capacity tier at its serving scale: a 10M x 256 clustered
corpus indexed and searched with the store's own parameters.

Counterpart of ``benchmarks/quantitative/bench_ann_scale.py``:

    python -m semtools_tpu_torch.probes.ann_scale [--rows 10000000] [--dim 256]
        [--queries 50] [--k 10] [--clusters 2000] [--nprobe-sweep 128,256,512]
        [--device cpu] [--out PATH]

The corpus is the JAX driver's (``synth_clustered``: centres ~ N(0, I) and
1M-row chunks of centre + 0.15 noise, unit rows, all from ``default_rng(0)``),
written chunk by chunk to an on-disk memmap in a temp dir removed at exit.
Queries are sorted random rows (``default_rng(99)``) plus 0.05 noise. The
truth is an exact f32 scan in 1M-row chunks on the device (TF32 off), ties to
the lower row. The store's parameters: nlist the power of two of 4 sqrt(n)
capped at 4,096, nprobe nlist / 16 (at least 16), the ADC depth
``Store._ann_candidate_depth``, m 32, residual PQ. The build is
``IvfPqIndex.build`` on the device (host rows through its pinned buffers);
the probe is ``IvfPqIndex.search`` (``cpp/adcscan.cpp`` on the host) and the
re-rank the exact product of each query's candidates from the memmap.

One JSON record a line with the JAX driver's keys (``config`` ann_scale);
beside them the card's name and power limit, the build's stages
(``ann_train``, ``ann_encode``, ``ann_finalize``), the re-rank per query, the
queries under recall 1.0 with their hits, and the launches of the build and
of the search (IVF-PQ has no hand-written kernel: both are expected empty).
Records also go to ``--out`` as one JSON list.
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

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "ann_scale.json"
TRUTH_CHUNK = 1 << 20
MIN_RECALL = 0.98  # the card's k-means is not bit-equal to the CPU's: a margin under 1.0


def synth_clustered(path: str, n: int, d: int, n_clusters: int, seed: int = 0):
    """Unit-norm clustered rows written chunk-wise to an on-disk memmap (the
    JAX driver's generator, call for call)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, d))
    chunk = 1 << 20
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        cid = rng.integers(0, n_clusters, m)
        rows = centers[cid] + 0.15 * rng.standard_normal((m, d)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        mm[start:start + m] = rows
    mm.flush()
    return centers


def exact_topk(mm, q: np.ndarray, k: int, device) -> np.ndarray:
    """Brute-force ground truth over the memmap in chunks: the k largest
    exact f32 products, ties to the lower row. Returns rows [Q, k]."""
    import torch

    if device.type == "cuda" and (torch.get_float32_matmul_precision() != "highest"
                                  or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the truth needs exact f32 products: TF32 is on")
    qn, n = q.shape[0], mm.shape[0]
    q_dev = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)
    best_v = torch.full((qn, k), float("-inf"), device=device)
    best_i = torch.zeros((qn, k), dtype=torch.int64, device=device)
    host = torch.empty((min(TRUTH_CHUNK, n), mm.shape[1]), dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    for start in range(0, n, TRUTH_CHUNK):
        m = min(TRUTH_CHUNK, n - start)
        np.copyto(host.numpy()[:m], mm[start : start + m])
        sims = q_dev @ host[:m].to(device, non_blocking=True).T
        rows = torch.arange(start, start + m, device=device).expand(qn, m)
        v, pos = torch.sort(torch.cat([best_v, sims], 1), dim=1, descending=True, stable=True)
        best_v, best_i = v[:, :k], torch.cat([best_i, rows], 1).gather(1, pos[:, :k])
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the pinned buffer is refilled next
    return best_i.cpu().numpy()


def store_parameters(n: int, k: int):
    """(nlist, nprobe, candidate depth) as the store sets them."""
    from semtools_tpu_torch.store.store import Store

    nlist = int(min(4096, max(16, 1 << int(np.log2(max(4 * np.sqrt(n), 16))))))
    nprobe = max(16, nlist // 16)
    return nlist, nprobe, Store._ann_candidate_depth(k, n, nlist, nprobe)


def queries(mm, n: int, qn: int, d: int) -> np.ndarray:
    """Perturbed corpus rows, as the JAX driver draws them."""
    rng = np.random.default_rng(99)
    qrows = np.asarray(mm[np.sort(rng.integers(0, n, qn))])
    q = qrows + 0.05 * rng.standard_normal((qn, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=2000)
    ap.add_argument("--nprobe-sweep", default=None,
                    help="comma-separated probe depths to sweep on one build")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="the records as one JSON list")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    with common.environ(SEMTOOLS_TPU_TIMINGS="1"):  # the build's stages
        return run(args)


def run(args) -> int:
    from semtools_tpu_torch.index.ivf_pq import IvfPqIndex
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.utils import tracing

    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    n, d, k = args.rows, args.dim, args.k
    records = []
    td = tempfile.mkdtemp(prefix="semtools_ann_scale_")
    try:
        need, free = n * d * 4, shutil.disk_usage(td).free
        if free < need:
            raise SystemExit(f"ann_scale: the {n} x {d} corpus needs {need} bytes on disk; "
                             f"{td} has {free} free")
        corpus_path = os.path.join(td, "corpus.f32")
        t0 = time.perf_counter()
        synth_clustered(corpus_path, n, d, args.clusters)
        synth_s = time.perf_counter() - t0
        mm = np.memmap(corpus_path, dtype=np.float32, mode="r", shape=(n, d))
        q = queries(mm, n, args.queries, d)

        t0 = time.perf_counter()
        truth = exact_topk(mm, q, k, device)
        truth_s = time.perf_counter() - t0

        nlist, nprobe, oversample = store_parameters(n, k)
        tracing.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        index = IvfPqIndex.build(mm, nlist=nlist, m=32, keep_vectors=False, device=device)
        build_s = time.perf_counter() - t0
        stages = {name: secs for name, secs, _ in tracing.timings()}
        build_launches = {kk: v for kk, v in kernels.launch_counts().items() if v}

        # probe + the store's exact re-rank from the memmap, at one or more
        # probe depths on the one build
        sweep = ([int(x) for x in args.nprobe_sweep.split(",")] if args.nprobe_sweep
                 else [nprobe])
        for np_probe in sweep:
            np_probe = min(np_probe, nlist)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            _, ids = index.search(q, k=oversample, nprobe=np_probe)
            probe_s = time.perf_counter() - t0
            cand_hits = [len(set(truth[r]) & set(ids[r][ids[r] >= 0])) for r in range(len(q))]
            t0 = time.perf_counter()
            got = np.zeros((len(q), k), np.int64)
            for r in range(len(q)):
                cand = ids[r][ids[r] >= 0]
                exact = mm[cand] @ q[r]
                got[r] = cand[np.argsort(-exact, kind="stable")[:k]]
            rerank_s = time.perf_counter() - t0
            hits = [len(set(truth[r]) & set(got[r])) for r in range(len(q))]
            row = {
                "config": "ann_scale", "metric": "recall_at_10",
                "value": float(np.mean(hits) / k),
                "candidate_recall_at_10": float(np.mean(cand_hits) / k),
                "n": n, "dim": d, "clusters": args.clusters,
                "nlist": nlist, "nprobe": np_probe, "oversample": oversample,
                "build_seconds": build_s,
                "queries_per_sec": len(q) / (probe_s + rerank_s),
                "probe_seconds_per_query": probe_s / len(q),
                "synth_seconds": synth_s, "truth_seconds": truth_s,
                "platform": device.type,
                # beside the JAX driver's keys
                "card": card, "rerank_seconds_per_query": rerank_s / len(q),
                "build_stages_s": stages,
                "missed": [{"query": r, "hits": h, "candidate_hits": c}
                           for r, (h, c) in enumerate(zip(hits, cand_hits)) if h < k],
                "launches": {"build": build_launches,
                             "search": {kk: v for kk, v in kernels.launch_counts().items()
                                        if v}},
            }
            print(json.dumps(row), flush=True)
            records.append(row)
        del mm, index
    finally:
        tracing.reset()
        shutil.rmtree(td, ignore_errors=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
