"""BASELINE's configuration matrix on the port: one JSON record per config.

Counterpart of ``benchmarks/quantitative/run_bench.py``, over the same
seeded corpus (:mod:`semtools_tpu_torch.probes.gen_corpus`) and the same
seeded vectors:

    python -m semtools_tpu_torch.probes.run_bench [--files 100] [--lines 200]
        [--configs search_e2e,batched_scan,...] [--small] [--tier-n 200000]
        [--device cpu] [--out PATH] [--answers PATH]

- ``search_e2e``: ``search.search_files`` (read, embed, scan, context),
  one query, top 3, 3 context lines; seconds a query.
- ``batched_scan``: ``ops/scan.topk_scan`` of Q queries against a corpus
  on the device (k 10); queries a second.
- ``batched_threshold``: ``batched_threshold_scan`` at distance 0.85 on
  the same shapes; queries a second and the largest hit count.
- ``workspace_warm`` / ``workspace_batched`` / ``line_reuse``:
  ``search_with_workspace`` cold and warm, ``-Q``-style batches against a
  loop of single queries, and a one-line edit of a big file with the
  ``lines.h64`` sidecar and without it (record ``line_reuse_edit``).
- ``ivfpq_recall``: ``IvfPqIndex.build`` on the device (nlist the power of
  two of 4 sqrt(n), m 32, 8 training iterations) and its recall@10 against
  the exact scan, whose timed call takes the host corpus, as the JAX
  driver's does.
- ``sharded_scan``: ``parallel.scan.sharded_topk_fn`` over
  ``corpus_mesh()``. With one shard it prints ``skipped``, as the JAX
  driver does; under ``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` it runs on shards
  of one card (``virtual_shards_of_one_card``: not a mesh of cards), and
  its answer must equal the single-device scan.
- ``tier_recall``: recall@10 and single-query latency of the int8 tier
  (``int8_topk_scan``, depth 40), the reduced 64d and 32d int8 rungs
  (``fit_rotation``, ``reduced_oversample``) with the exact f32 re-rank on
  the host, and the IVF-PQ index without kept vectors.
- ``subset_warm``: a ``Store`` of ``n`` rows in 50 documents; a warm
  10% path subset masked on the whole-store corpus, the whole store, and
  the compact path (``SEMTOOLS_TPU_SUBSET_DEVICE`` 1 and 0).

The two batched configs also time ``cosine_distances`` alone
(``distances_events_ms``): the rest of a call is the selection.

Each record carries the JAX driver's keys, except ``extract_size`` of
``batched_threshold``: that is the JAX package's extract bucket, which the
port's threshold scan does not have. Beside them: the card's name and power
limit (``card``), the device, the launches of each hand-written kernel
during the config (``launches``; ``step_launches`` where a config has
steps) and, where the path has them, its ``SEMTOOLS_TPU_TIMINGS`` stages.
Times are host walls around work that ends in a synchronise; the device
scans also give CUDA-events milliseconds a call. Without ``--device cpu``
the driver needs the card. ``HOME`` is a temp dir (removed at exit), the
model is the cached one or ``SEMTOOLS_TPU_MODEL_DIR``'s, else the built-in
embedder: nothing is downloaded. ``--answers`` writes what the timed calls
returned (hits, indices, hit counts), for the parity tests.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from semtools_tpu_torch.probes import common
from semtools_tpu_torch.probes.gen_corpus import gen_corpus

ALL = [
    "search_e2e", "batched_scan", "batched_threshold", "workspace_warm",
    "workspace_batched", "line_reuse", "ivfpq_recall", "sharded_scan",
    "tier_recall", "subset_warm",
]


class Bench:
    """One run's device, card line, records and answers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.card = common.card_line(device)
        self.records = []
        self.answers = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wall(self, fn, reps: int = 1):
        """(last result, seconds a call): host clock around ``reps`` calls,
        each ended by a synchronise."""
        self.sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
            self.sync()
        return out, (time.perf_counter() - t0) / reps

    def events_ms(self, fn, reps: int):
        """CUDA-events milliseconds a call over ``reps`` calls; None off the card."""
        return common.timed(fn, self.device, reps)[2]

    def emit(self, record: dict, launches: dict, **extra) -> dict:
        record.update(card=self.card, device=self.device.type, launches=launches, **extra)
        print(json.dumps(record), flush=True)
        self.records.append(record)
        return record


@contextlib.contextmanager
def counted(into: dict, key: str):
    """Kernel launches and SEMTOOLS_TPU_TIMINGS stages of the block, into
    ``into[key]`` as {"launches": {...}, "stages_s": {...}}."""
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.utils import tracing

    kernels.reset_launch_counts()
    tracing.reset()
    try:
        yield
    finally:
        into[key] = {
            "launches": {k: v for k, v in kernels.launch_counts().items() if v},
            "stages_s": {name: secs for name, secs, _ in tracing.timings()},
        }


def total_launches(steps: dict) -> dict:
    out = {}
    for step in steps.values():
        for k, v in step["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _unit(rng, shape) -> np.ndarray:
    x = rng.standard_normal(shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def scan_inputs(n: int, q: int, d: int = 256):
    """The JAX driver's batched corpus (512-row aligned) and queries."""
    rng = np.random.default_rng(0)
    n_al = (n // 512) * 512
    e = _unit(rng, (n_al, d))
    return e, _unit(rng, (q, d))


def _clustered_corpus(n, d, n_queries, seed=1):
    """512 Gaussian centres, rows centre + 0.15 noise, queries perturbed
    rows: the JAX driver's ``_clustered_corpus`` (and ``bench_ivfpq``'s
    inline mixture), call for call."""
    rng = np.random.default_rng(seed)
    n_clusters = 512
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    e = centers[assign] + 0.15 * rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qq = e[rng.integers(0, n, n_queries)] + 0.05 * rng.standard_normal(
        (n_queries, d)
    ).astype(np.float32)
    qq /= np.linalg.norm(qq, axis=1, keepdims=True)
    return e, qq


def ivf_parameters(n: int):
    """(nlist, nprobe) as the JAX driver sets them."""
    nlist = int(min(4096, max(64, 1 << int(np.log2(max(4 * np.sqrt(n), 64))))))
    return nlist, max(16, nlist // 16)


def _recall(got, truth, n_queries: int, k: int) -> float:
    return float(sum(len(set(map(int, a)) & set(map(int, b)))
                     for a, b in zip(got, truth))) / (n_queries * k)


def _new_workspace(name: str) -> None:
    from semtools_tpu_torch.store import Workspace, WorkspaceConfig

    Workspace(WorkspaceConfig(name=name, root_dir=Workspace.root_path(name))).save()


def bench_search_e2e(b: Bench, paths, model, reps: int = 3):
    from semtools_tpu_torch.search import SearchConfig, search_files

    cfg = SearchConfig(top_k=3, n_lines=3)
    files = [str(p) for p in paths]
    query = "attention mechanisms in transformers"
    search_files(files, query, model, cfg)  # warm
    steps = {}
    with counted(steps, "timed"):
        out, dt = b.wall(lambda: search_files(files, query, model, cfg), reps)
    b.answers["search_e2e"] = [[r.filename, r.match_line, r.start, r.end, r.distance]
                               for r in out]
    b.emit({"config": "search_e2e", "metric": "seconds_per_query", "value": dt,
            "files": len(files), "hits": len(out)}, steps["timed"]["launches"],
           model=model.name,
           stages_s={k: v / reps for k, v in steps["timed"]["stages_s"].items()})


def bench_batched_scan(b: Bench, n=100_000, q=1_000, d=256, k=10, repeats=16):
    from semtools_tpu_torch.ops.scan import cosine_distances, topk_scan

    e, qq = scan_inputs(n, q, d)
    e_dev = torch.from_numpy(e).to(b.device)  # resident, as a serving corpus is
    q_dev = torch.from_numpy(qq).to(b.device)
    fn = lambda: topk_scan(q_dev, e_dev, k)  # noqa: E731
    fn()  # warm
    steps = {}
    with counted(steps, "timed"):
        (dist, idx), dt = b.wall(fn, repeats)
    b.answers["batched_scan"] = {"indices": idx.cpu().tolist(), "distances": dist.cpu().tolist()}
    b.emit({"config": "batched_scan", "metric": "queries_per_sec", "value": q / dt,
            "n_chunks": e.shape[0], "k": k,
            "note": "device-resident corpus; host wall of repeated calls, each "
                    "ended by a synchronise"}, steps["timed"]["launches"],
           events_ms_per_call=b.events_ms(fn, repeats), repeats=repeats,
           distances_events_ms=b.events_ms(lambda: cosine_distances(q_dev, e_dev), repeats))


def bench_batched_threshold(b: Bench, n=100_000, q=1_000, d=256, t=0.85, repeats=16):
    from semtools_tpu_torch.ops.scan import batched_threshold_scan, cosine_distances

    e, qq = scan_inputs(n, q, d)
    e_dev = torch.from_numpy(e).to(b.device)
    q_dev = torch.from_numpy(qq).to(b.device)
    fn = lambda: batched_threshold_scan(q_dev, e_dev, t)  # noqa: E731
    fn()  # warm
    steps = {}
    with counted(steps, "timed"):
        hits, dt = b.wall(fn, repeats)
    counts = [int(dd.shape[0]) for dd, _ in hits]
    b.answers["batched_threshold"] = counts
    b.emit({"config": "batched_threshold", "metric": "queries_per_sec", "value": q / dt,
            "n_chunks": e.shape[0], "max_distance": t, "max_hits": max(counts),
            "note": "device-resident corpus; host wall of repeated calls (each reads "
                    "the hit counts)"}, steps["timed"]["launches"],
           events_ms_per_call=b.events_ms(fn, repeats), repeats=repeats,
           distances_events_ms=b.events_ms(lambda: cosine_distances(q_dev, e_dev), repeats))


def bench_workspace_warm(b: Bench, paths, model):
    from semtools_tpu_torch.search import SearchConfig, search_with_workspace

    name = "bench_ws"
    _new_workspace(name)
    files = [str(p) for p in paths]
    cfg = SearchConfig(top_k=3, n_lines=3)
    query = "gradient descent convergence"
    steps = {}
    with counted(steps, "cold"):
        _, cold = b.wall(lambda: search_with_workspace(files, query, model, cfg,
                                                       workspace_name=name))
    with counted(steps, "warm"):
        hits, warm = b.wall(lambda: search_with_workspace(files, query, model, cfg,
                                                          workspace_name=name))
    b.answers["workspace_warm"] = [[h.path, h.line_number, h.distance] for h in hits]
    b.emit({"config": "workspace_warm", "metric": "seconds_per_query", "value": warm,
            "cold_seconds": cold, "files": len(files)}, total_launches(steps),
           step_launches={s: v["launches"] for s, v in steps.items()},
           stages_s={s: v["stages_s"] for s, v in steps.items()})


def bench_workspace_batched(b: Bench, paths, model, q=32):
    from semtools_tpu_torch.search import (
        SearchConfig,
        search_with_workspace,
        search_with_workspace_batched,
    )

    name = "bench_ws_batched"
    _new_workspace(name)
    files = [str(p) for p in paths]
    cfg = SearchConfig(top_k=3, n_lines=3)
    topics = [
        "gradient descent convergence", "attention mechanisms", "graph theory",
        "database index design", "reinforcement learning policies",
        "convex optimization", "protein folding", "compiler optimization",
    ]
    queries = [f"{topics[i % len(topics)]} variant {i}" for i in range(q)]
    search_with_workspace(files, queries[0], model, cfg, workspace_name=name)  # cold build
    search_with_workspace_batched(files, queries, model, cfg, workspace_name=name)  # warm
    steps = {}
    with counted(steps, "batched"):
        per, batched_s = b.wall(lambda: search_with_workspace_batched(
            files, queries, model, cfg, workspace_name=name))
    with counted(steps, "loop"):
        singles, loop_s = b.wall(lambda: [search_with_workspace(files, qq, model, cfg, name)
                                          for qq in queries])
    if [[(h.path, h.line_number) for h in hs] for hs in per] != \
            [[(h.path, h.line_number) for h in hs] for hs in singles]:
        raise AssertionError("workspace_batched: the batch and the loop disagree")
    b.answers["workspace_batched"] = [[[h.path, h.line_number, h.distance] for h in hs]
                                      for hs in per]
    b.emit({"config": "workspace_batched", "metric": "queries_per_sec",
            "value": q / batched_s, "q": q, "files": len(files),
            "single_query_loop_qps": q / loop_s,
            "speedup_vs_loop": loop_s / max(batched_s, 1e-9)}, total_launches(steps),
           step_launches={s: v["launches"] for s, v in steps.items()},
           stages_s={s: v["stages_s"] for s, v in steps.items()})


def bench_line_reuse(b: Bench, model, n_lines=50_000):
    """A one-line edit of a big file: update + query with the lines.h64
    sidecar, then with it removed (a full re-embed)."""
    from semtools_tpu_torch.search import SearchConfig, search_with_workspace
    from semtools_tpu_torch.store import Store, Workspace

    name = "bench_line_reuse"
    _new_workspace(name)
    f = Path(tempfile.mkdtemp(prefix="line_reuse_")) / "big.txt"
    lines = [f"stable piece of content number {i} with words" for i in range(n_lines)]
    f.write_text("\n".join(lines) + "\n")
    cfg = SearchConfig(top_k=3, n_lines=0)
    steps = {}
    try:
        with counted(steps, "cold"):
            _, cold = b.wall(lambda: search_with_workspace([str(f)], "content words", model,
                                                           cfg, name))

        def _edit(i, text, bump):
            # distinct text lengths and integer mtimes: change detection
            # compares size_bytes and int(mtime)
            lines[i] = text
            f.write_text("\n".join(lines) + "\n")
            st = f.stat()
            os.utime(f, (st.st_atime, st.st_mtime + bump))

        _edit(n_lines // 2, "the edited needle line", 7)
        with counted(steps, "with_reuse"):
            hits, with_reuse = b.wall(lambda: search_with_workspace(
                [str(f)], "edited needle", model, cfg, name))
        if not hits or hits[0].line_number != n_lines // 2:
            raise AssertionError(f"line_reuse: the edited line is not first: {hits[:1]}")

        with Store(Workspace.root_path(name), dim=model.dim, device=b.device) as s:
            s.hash_path.unlink()  # no sidecar: a full re-embed
        _edit(n_lines // 2, "the edited needle line but longer now", 14)
        with counted(steps, "without_reuse"):
            hits2, without_reuse = b.wall(lambda: search_with_workspace(
                [str(f)], "edited needle", model, cfg, name))
    finally:
        shutil.rmtree(f.parent, ignore_errors=True)
    b.answers["line_reuse"] = [[[h.line_number, h.distance] for h in hs] for hs in (hits, hits2)]
    b.emit({"config": "line_reuse_edit", "metric": "update_plus_query_seconds",
            "value": with_reuse, "without_reuse_s": without_reuse,
            "speedup": without_reuse / max(with_reuse, 1e-9),
            "total_lines": n_lines, "cold_build_s": cold}, total_launches(steps),
           step_launches={s: v["launches"] for s, v in steps.items()},
           stages_s={s: v["stages_s"] for s, v in steps.items()})


def bench_ivfpq(b: Bench, n=200_000, d=256, n_queries=100, k=10):
    from semtools_tpu_torch.index.ivf_pq import IvfPqIndex
    from semtools_tpu_torch.ops.scan import topk_scan

    # clustered rows: isotropic 256-d vectors have no neighbourhoods, and
    # real line embeddings cluster
    e, qq = _clustered_corpus(n, d, n_queries)
    nlist, nprobe = ivf_parameters(n)
    steps = {}
    with counted(steps, "build"):
        index, build_s = b.wall(lambda: IvfPqIndex.build(e, nlist=nlist, m=32, train_iters=8,
                                                         device=b.device))

    def exact():  # the host corpus, uploaded by the call, as the JAX driver's
        dist, idx = topk_scan(torch.from_numpy(qq).to(b.device),
                              torch.from_numpy(e).to(b.device), k)
        return idx.cpu().numpy()

    i_exact = exact()  # warm
    index.search(qq, k=k, nprobe=nprobe)  # warm
    with counted(steps, "search"):
        (_, i_ann), ann_s = b.wall(lambda: index.search(qq, k=k, nprobe=nprobe))
    with counted(steps, "exact"):
        _, exact_s = b.wall(exact)
    recall = _recall(i_ann, i_exact, n_queries, k)
    b.emit({"config": "ivfpq_recall", "metric": "recall_at_10", "value": recall,
            "build_seconds": build_s, "speedup_vs_exact": exact_s / max(ann_s, 1e-9),
            "n": n}, total_launches(steps),
           step_launches={s: v["launches"] for s, v in steps.items()},
           nlist=nlist, nprobe=nprobe, build_stages_s=steps["build"]["stages_s"])


def bench_sharded(b: Bench, n=1 << 18, d=256, q=8, k=10):
    from semtools_tpu_torch.ops.scan import topk_scan
    from semtools_tpu_torch.parallel.mesh import (
        corpus_mesh,
        shard_corpus,
        virtual_devices,
    )
    from semtools_tpu_torch.parallel.scan import sharded_topk_fn

    mesh = corpus_mesh(device=b.device)
    nd = mesh.size
    if nd < 2:
        # one shard measures nothing distributed (run with
        # SEMTOOLS_TORCH_VIRTUAL_DEVICES=4, or on several cards)
        print(json.dumps({"config": "sharded_scan", "skipped": "single device"}), flush=True)
        return
    rng = np.random.default_rng(2)
    e = _unit(rng, (n, d))
    qq = _unit(rng, (q, d))
    e_sharded, _ = shard_corpus(e, mesh)  # placed once, as a serving corpus is
    fn_sharded = sharded_topk_fn(mesh, k, e_sharded.n_local)
    q_dev = torch.from_numpy(qq).to(mesh.first)
    fn = lambda: fn_sharded(q_dev, e_sharded, n)  # noqa: E731
    fn()  # warm
    steps = {}
    with counted(steps, "timed"):
        (_, idx), dt = b.wall(fn)
    single = topk_scan(q_dev, torch.from_numpy(e).to(mesh.first), k)[1]
    if not torch.equal(idx.cpu(), single.cpu()):
        raise AssertionError("sharded_scan: the sharded top-k differs from the single-device scan")
    b.emit({"config": "sharded_scan", "metric": "chunk_vectors_per_ms",
            "value": n / (dt * 1e3), "devices": nd, "queries": q}, steps["timed"]["launches"],
           virtual_shards_of_one_card=virtual_devices() > 1 and nd == virtual_devices(),
           matches_single_device=True, events_ms_per_call=b.events_ms(fn, 20))


def bench_tier_recall(b: Bench, n=200_000, d=256, n_queries=50, k=10):
    """recall@10 against the exact scan and single-query latency of each
    candidate tier: the int8 tier with the exact f32 re-rank, the reduced
    int8 rungs at 64 and 32 dims with the re-rank, and the IVF-PQ index
    without kept vectors (the store's build)."""
    from semtools_tpu_torch.index.ivf_pq import IvfPqIndex
    from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
    from semtools_tpu_torch.ops.reduce import fit_rotation, project, reduced_oversample
    from semtools_tpu_torch.ops.scan import topk_scan

    dev = b.device
    e, qq = _clustered_corpus(n, d, n_queries)
    i_exact = topk_scan(torch.from_numpy(qq).to(dev), torch.from_numpy(e).to(dev), k)[1]
    i_exact = i_exact.cpu().numpy()

    def run_int8_tier(corpus_scan, rotation, label, oversample):
        """The store's int8 serving: the int8 kernels for the full-dim
        tier, the plain scan for the reduced rungs; the exact f32 re-rank
        from the originals in both."""
        e8, scale = quantize_global(corpus_scan)
        e8_dev = torch.from_numpy(e8).to(dev)
        got = np.zeros((n_queries, k), np.int64)
        lat = []
        steps = {}
        with counted(steps, label):
            for qi in range(n_queries):
                q1 = qq[qi : qi + 1]
                t0 = time.perf_counter()
                if rotation is not None:
                    _, idx = topk_scan(torch.from_numpy(q1 @ rotation).to(dev), e8_dev,
                                       oversample, n_true=n)
                else:
                    _, idx = int8_topk_scan(q1, e8_dev, scale, oversample, n_true=n)
                cand = idx[0].cpu().numpy()
                exact_d = 1.0 - e[cand] @ q1[0]  # exact re-rank from the f32 originals
                order = np.argsort(exact_d, kind="stable")[:k]
                lat.append(time.perf_counter() - t0)
                got[qi] = cand[order]
        recall = _recall(got, i_exact, n_queries, k)
        b.emit({"config": "tier_recall", "tier": label, "metric": "recall_at_10",
                "value": recall, "n": n, "oversample": oversample,
                "seconds_per_query": float(np.median(lat)),
                "bytes_per_row": corpus_scan.shape[1]}, steps[label]["launches"])

    # warm the int8 path once (the kernel library's first load)
    e8_w, s_w = quantize_global(e[:4096])
    int8_topk_scan(qq[:1], torch.from_numpy(e8_w).to(dev), s_w, 64, n_true=4096)

    run_int8_tier(e, None, "int8-full", oversample=max(4 * k, 16))
    for rd in (64, 32):
        rot = fit_rotation(e, rd)
        run_int8_tier(project(e, rot), rot, f"reduced-int8-{rd}d",
                      oversample=reduced_oversample(n, k))

    nlist, nprobe = ivf_parameters(n)
    steps = {}
    # keep_vectors=False, as the store's build: the capacity tier cannot
    # afford a second f32 copy of the corpus
    with counted(steps, "build"):
        index, build_s = b.wall(lambda: IvfPqIndex.build(e, nlist=nlist, m=32, train_iters=8,
                                                         keep_vectors=False, device=dev))
    index.search(qq[:1], k=k, nprobe=nprobe)  # warm
    got = np.zeros((n_queries, k), np.int64)
    lat = []
    with counted(steps, "search"):
        for qi in range(n_queries):
            t0 = time.perf_counter()
            _, idx = index.search(qq[qi : qi + 1], k=k, nprobe=nprobe)
            lat.append(time.perf_counter() - t0)
            got[qi] = idx[0]
    recall = _recall(got, i_exact, n_queries, k)
    b.emit({"config": "tier_recall", "tier": "ivf-pq-host", "metric": "recall_at_10",
            "value": recall, "n": n, "seconds_per_query": float(np.median(lat)),
            "bytes_per_row": 32}, total_launches(steps), nlist=nlist, nprobe=nprobe,
           build_seconds=build_s)


def bench_subset_warm(b: Bench, n=500_000, d=256, docs=50, k=10, repeats=5):
    """Warm path-subset serving against warm whole-store serving at n rows:
    the subset masked on the warm whole-store corpus, against the compact
    path, which gathers and uploads the subset's rows every call. Median
    warm latency of each."""
    from semtools_tpu_torch.store.store import Store

    tmp = tempfile.mkdtemp(prefix="semtools_bench_subset_")
    steps = {}
    try:
        s = Store(tmp + "/ws", dim=d, device=b.device)
        rng = np.random.default_rng(0)
        per = n // docs
        items = []
        for i in range(docs):
            items.append((f"/doc{i:03d}.txt", _unit(rng, (per, d))))
        s.upsert_documents_bulk(items)
        paths = [p for p, _ in items]
        subset = paths[:: max(docs // 10, 1)]  # ~10% of the corpus
        q = rng.standard_normal((1, d)).astype(np.float32)
        q /= np.linalg.norm(q)

        def med(fn):
            ts = [b.wall(fn)[1] for _ in range(repeats)]
            return float(sorted(ts)[len(ts) // 2])

        with common.environ(SEMTOOLS_TPU_SUBSET_DEVICE="1"):
            with counted(steps, "full"):
                s.search_line_embeddings_batched(q, paths, k)  # warm build
                full_s = med(lambda: s.search_line_embeddings_batched(q, paths, k))
            with counted(steps, "subset"):
                s.search_line_embeddings_batched(q, subset, k)  # mask upload
                sub_s = med(lambda: s.search_line_embeddings_batched(q, subset, k))
                sub_hits = s.search_line_embeddings_batched(q, subset, k)
        with common.environ(SEMTOOLS_TPU_SUBSET_DEVICE="0"):
            with counted(steps, "compact"):
                s.search_line_embeddings_batched(q, subset, k)
                compact_s = med(lambda: s.search_line_embeddings_batched(q, subset, k))
                compact_hits = s.search_line_embeddings_batched(q, subset, k)
        if [(h.path, h.line_number) for h in sub_hits[0]] != \
                [(h.path, h.line_number) for h in compact_hits[0]]:
            raise AssertionError("subset_warm: the masked subset and the compact path disagree")
        tier = s.serving_tier(n)
        s.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b.emit({"config": "subset_warm", "metric": "seconds_per_query",
            "value": sub_s, "n": n, "subset_rows": per * len(subset),
            "warm_full_store_seconds": full_s,
            "compact_subset_seconds": compact_s,
            "subset_vs_full": sub_s / max(full_s, 1e-9),
            "speedup_vs_compact": compact_s / max(sub_s, 1e-9),
            "tier": tier}, total_launches(steps),
           step_launches={s: v["launches"] for s, v in steps.items()},
           stages_s={s: v["stages_s"] for s, v in steps.items()})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=100)
    ap.add_argument("--lines", type=int, default=200)
    ap.add_argument("--configs", default=",".join(ALL))
    ap.add_argument("--out", default=None, help="the records, one JSON object a line")
    ap.add_argument("--small", action="store_true", help="CPU-smoke sizes (seconds)")
    ap.add_argument("--tier-n", type=int, default=200_000,
                    help="corpus rows for the tier_recall config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--answers", default=None,
                    help="what the timed calls returned, as one JSON object")
    return ap


def run(args, b: Bench) -> None:
    from semtools_tpu_torch.models.static_model import load_model

    configs = args.configs.split(",")
    unknown = sorted(set(configs) - set(ALL))
    if unknown:
        raise SystemExit(f"run_bench: unknown configs {unknown}; known: {ALL}")
    small = args.small
    with tempfile.TemporaryDirectory(prefix="semtools_bench_corpus_") as td:
        paths = gen_corpus(Path(td), args.files, args.lines, seed=0)
        model = load_model(device=b.device)
        if "search_e2e" in configs:
            bench_search_e2e(b, paths, model)
        if "batched_scan" in configs:
            bench_batched_scan(b, **(dict(n=20_000, q=100) if small else {}))
        if "batched_threshold" in configs:
            bench_batched_threshold(b, **(dict(n=20_000, q=100) if small else {}))
        if "workspace_warm" in configs:
            bench_workspace_warm(b, paths, model)
        if "workspace_batched" in configs:
            bench_workspace_batched(b, paths, model, q=8 if small else 32)
        if "line_reuse" in configs:
            bench_line_reuse(b, model, n_lines=5_000 if small else 50_000)
        if "ivfpq_recall" in configs:
            bench_ivfpq(b, **(dict(n=20_000, n_queries=20) if small else {}))
        if "sharded_scan" in configs:
            bench_sharded(b, n=1 << 14 if small else 1 << 18)
        if "tier_recall" in configs:
            bench_tier_recall(b, **(dict(n=20_000, n_queries=10) if small
                                    else dict(n=args.tier_n)))
        if "subset_warm" in configs:
            bench_subset_warm(b, **(dict(n=20_000, docs=20, repeats=3) if small else {}))


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.small:
        args.files = min(args.files, 20)
        args.lines = min(args.lines, 50)
    from semtools_tpu_torch.utils import tracing
    from semtools_tpu_torch.utils.platform import resolve_device

    b = Bench(resolve_device(args.device))
    print(b.card, flush=True)
    home = tempfile.mkdtemp(prefix="semtools_bench_home_")
    try:
        # workspace state in a temp HOME; no model download; stage timings on
        with common.environ(HOME=home, SEMTOOLS_TPU_NO_FETCH="1",
                            SEMTOOLS_TPU_ALLOW_FALLBACK="1", SEMTOOLS_TPU_TIMINGS="1"):
            run(args, b)
    finally:
        tracing.reset()  # the stages went into the records
        shutil.rmtree(home, ignore_errors=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in b.records))
        if args.answers:
            Path(args.answers).parent.mkdir(parents=True, exist_ok=True)
            Path(args.answers).write_text(json.dumps(b.answers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
