"""Multi-shard dry run: the sharded k-means step and the sharded scans on an
n-shard mesh, each checked against one device.

Counterpart of ``__graft_entry__.py dryrun_multichip``. Run it alone:

    SEMTOOLS_TORCH_VIRTUAL_DEVICES=4 python -m semtools_tpu_torch.parallel.dryrun 4
    SEMTOOLS_TORCH_VIRTUAL_DEVICES=8 python -m semtools_tpu_torch.parallel.dryrun 8 --device cpu

(the first on one card cut into four shards; without the variable the mesh
is every card, once each). Raises on the first disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch


def _check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _hits(per):
    return [(h.path, h.line_number) for h in per]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Build an ``n_devices``-shard mesh on ``device`` (default: the
    platform's, see ``utils.platform.resolve_device``) and check on it, each
    against the single-device path: one data-parallel Lloyd step (same
    assignments, centroids within 1e-5), the f32 top-k (kernel route and
    forced fused route: same rows, distances within 1e-5), the int8 top-k
    (equal rows and distances), the int4 deep candidates (equal sets, holding
    the exact top-5), the threshold scan (same rows), and a workspace store
    served on the mesh (f32, int8 and int4 tiers, a path subset: the exact
    tier's hits). Returns what it served."""
    from semtools_tpu_torch.index.kmeans import kmeans_fit, kmeans_step, make_sharded_kmeans_step
    from semtools_tpu_torch.ops.int4_scan import (
        PACKED_ZERO_BYTE, int4_deep_candidates, quantize_pack_global)
    from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
    from semtools_tpu_torch.ops.scan import threshold_scan, topk_scan
    from semtools_tpu_torch.parallel.mesh import ShardedRows, corpus_mesh, shard_corpus
    from semtools_tpu_torch.parallel import scan as sharded
    from semtools_tpu_torch.store import device_cache
    from semtools_tpu_torch.store.store import Store

    mesh = corpus_mesh(n_devices, device)
    dev = mesh.first
    rng = np.random.Generator(np.random.Philox(7))
    n, d = 64 * n_devices + 37, 64  # ragged: the last shard is partly padding
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q_np = corpus[:4] + 0.01
    e, q = torch.from_numpy(corpus).to(dev), torch.from_numpy(q_np).to(dev)

    # 1. the data-parallel Lloyd step against the single-device step
    rows = n - n % n_devices
    xs = ShardedRows(mesh, rows // n_devices, (d,), torch.float32)
    xs.narrow(0, 0, rows).copy_(e[:rows])
    c0 = e[:8].clone()
    c_s, a_s = make_sharded_kmeans_step(mesh, 8)(xs, c0)
    c_1, a_1 = kmeans_step(e[:rows], c0, 8)
    _check(torch.equal(a_s, a_1), "sharded Lloyd step: assignments differ")
    _check(float((c_s - c_1).abs().max()) <= 1e-5, "sharded Lloyd step: centroids differ")
    centroids, assign = kmeans_fit(e, 8, iters=2, seed=0, mesh=mesh)
    _check(centroids.shape == (8, d) and assign.shape == (n,), "sharded k-means: shapes")

    # 2. the f32 top-k, on the kernel route and with the fused route forced
    d_want, i_want = topk_scan(q, e, 5)
    d_got, i_got = sharded.sharded_topk_scan(q, e, 5, mesh)
    _check(torch.equal(i_got, i_want), "sharded top-k: rows differ")
    _check(float((d_got - d_want).abs().max()) <= 1e-5, "sharded top-k: distances differ")
    es, _ = shard_corpus(e, mesh)
    d_f, i_f = sharded.sharded_topk_scan_device(q, es, n, 5, mesh, fused=True)
    _check(torch.equal(i_f, i_want), "sharded fused top-k: rows differ")

    # 3. the int8 top-k: integer merge, equal to one device's
    e8, scale = quantize_global(e)
    d8, i8 = sharded.sharded_int8_topk_scan(q, e8, scale, 5, mesh)
    d8_1, i8_1 = int8_topk_scan(q, e8, scale, 5)
    _check(torch.equal(i8, i8_1), "sharded int8 top-k: rows differ")
    _check(torch.equal(d8, d8_1), "sharded int8: distances differ")

    # 4. the int4 deep candidates: the same set, holding the exact top-5
    p4, _ = quantize_pack_global(corpus)
    p4s, _ = shard_corpus(torch.from_numpy(p4).to(dev), mesh, fill=PACKED_ZERO_BYTE)
    ids_s = sharded.sharded_int4_deep_candidates_device(q, p4s, n, mesh).cpu()
    ids_1 = int4_deep_candidates(q, torch.from_numpy(p4).to(dev)).cpu()
    for r in range(len(q)):
        got = {int(x) for x in ids_s[r] if x < n}
        _check(got == {int(x) for x in ids_1[r] if x < n}, f"int4 candidates differ (q{r})")
        _check(set(i_want[r].tolist()) <= got, f"int4 candidates miss the top-5 (q{r})")

    # 5. threshold mode
    d_t, i_t = sharded.sharded_threshold_scan(q[:1], e, 0.5, mesh)
    _check(torch.equal(i_t.cpu(), threshold_scan(q[:1], e, 0.5)[1].cpu()),
           "sharded threshold: rows differ")

    # 6. a workspace store served on the mesh against its single-device tier
    tiers = {}
    saved = {k: os.environ.get(k) for k in (
        "SEMTOOLS_TPU_SHARDED", "SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_STORE_INT4",
        "SEMTOOLS_TPU_SUBSET_DEVICE")}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            store = Store(tmp + "/ws", dim=d, device=dev)
            per_doc = n // 4
            paths = [f"/doc{i}.txt" for i in range(4)]
            for i, p in enumerate(paths):
                store.upsert_document_lines(p, corpus[i * per_doc:(i + 1) * per_doc])
            os.environ.update(SEMTOOLS_TPU_SHARDED="0", SEMTOOLS_TPU_STORE_INT8="0",
                              SEMTOOLS_TPU_STORE_INT4="0")
            device_cache.invalidate()
            exact = store.search_line_embeddings(q_np[0], paths, top_k=5)
            os.environ["SEMTOOLS_TPU_SUBSET_DEVICE"] = "0"
            subset_ref = store.search_line_embeddings(q_np[0], paths[:2], top_k=5)
            os.environ["SEMTOOLS_TPU_SHARDED"] = "1"
            os.environ["SEMTOOLS_TPU_SUBSET_DEVICE"] = "1"
            for int8, int4 in (("0", "0"), ("1", "0"), ("0", "1")):
                os.environ.update(SEMTOOLS_TPU_STORE_INT8=int8, SEMTOOLS_TPU_STORE_INT4=int4)
                device_cache.invalidate()
                tier = store.serving_tier()
                _check(tier.startswith("sharded-"), tier)
                whole = store.search_line_embeddings(q_np[0], paths, top_k=5)
                _check(_hits(whole) == _hits(exact), f"{tier}: whole store")
                subset = store.search_line_embeddings(q_np[0], paths[:2], top_k=5)
                _check(_hits(subset) == _hits(subset_ref), f"{tier}: subset")
                tiers[tier] = True
            store.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        device_cache.invalidate()
    return {"shards": mesh.size, "device": str(dev), "rows": n, "store_tiers": sorted(tiers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n_devices, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
