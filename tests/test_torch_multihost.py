"""Two processes form one mesh: ``torch.distributed`` over ``gloo``, each
process holding 4 virtual CPU shards of an 8-shard mesh, bootstrapped from
the coordinator environment the JAX package reads (``JAX_COORDINATOR_ADDRESS``
et al., joined by ``utils.platform.resolve_device``), as
``test_multihost.py`` runs the JAX package's.

Each rank serves the sharded scans (top-k, threshold, int8, int4
candidates), one data-parallel Lloyd step and a workspace store search
(whole store and a masked path subset, on a ``sharded-`` tier), and must
return the JAX package's single-device answer.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(os.name != "posix", reason="gloo bootstrap is POSIX-only here")

REPO = Path(__file__).resolve().parents[1]
N, D = 4096, 64

_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch

    rank, store_dir = int(sys.argv[1]), sys.argv[2]
    from semtools_tpu_torch.utils.platform import resolve_device

    resolve_device("cpu")  # joins the process group from the environment
    import torch.distributed as dist
    from semtools_tpu_torch.index.kmeans import make_sharded_kmeans_step
    from semtools_tpu_torch.ops.int4_scan import PACKED_ZERO_BYTE, quantize_pack_global
    from semtools_tpu_torch.ops.int8_scan import quantize_global
    from semtools_tpu_torch.parallel import scan
    from semtools_tpu_torch.parallel.mesh import ShardedRows, corpus_mesh, shard_corpus
    from semtools_tpu_torch.store.store import Store

    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = corpus_mesh(device="cpu")
    assert (mesh.size, mesh.local, mesh.rank) == (8, 4, rank)
    rng = np.random.default_rng(123)
    e = rng.standard_normal(({n}, {d})).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = e[:2] + 0.01
    es, n = shard_corpus(e, mesh)
    assert len(es.shards) == 4 and es.parts[0][0] == rank * 4 * es.n_local
    out = {{"rank": rank}}
    out["topk"] = scan.sharded_topk_scan_device(q, es, n, 5)[1].tolist()
    out["threshold"] = scan.sharded_threshold_scan(q[:1], e, 0.4, mesh)[1].tolist()
    e8, s8 = quantize_global(e)
    out["int8"] = scan.sharded_int8_topk_scan(q, e8, s8, 5, mesh)[1].tolist()
    p4, _ = quantize_pack_global(e)
    p4s, _ = shard_corpus(p4, mesh, fill=PACKED_ZERO_BYTE)
    ids = scan.sharded_int4_deep_candidates_device(q, p4s, n)
    out["int4"] = [sorted({{int(x) for x in r if x < n}}) for r in ids.tolist()]
    xs = ShardedRows(mesh, n // 8, ({d},), torch.float32)
    xs.narrow(0, 0, n).copy_(torch.from_numpy(e))
    c, a = make_sharded_kmeans_step(mesh, 8)(xs, torch.from_numpy(e[:8].copy()))
    out["kmeans"] = [a.tolist(), c.tolist()]
    os.environ["SEMTOOLS_TPU_SHARDED"] = "1"
    store = Store(store_dir, dim={d}, device="cpu")
    out["tier"] = store.serving_tier()
    out["store"] = [(h.path, h.line_number)
                    for h in store.search_line_embeddings(e[777], ["/docA.txt", "/docB.txt"], 3)]
    os.environ["SEMTOOLS_TPU_SUBSET_DEVICE"] = "1"
    out["subset"] = [(h.path, h.line_number)
                     for h in store.search_line_embeddings(e[777], ["/docA.txt"], 3)]
    store.close()
    print(json.dumps(out))
""").format(n=N, d=D)


def test_two_process_mesh_serves_the_single_device_answer(tmp_path):
    import jax.numpy as jnp

    from semtools_tpu.index.kmeans import kmeans_step
    from semtools_tpu.ops.int4_scan import int4_deep_candidates, quantize_pack_global
    from semtools_tpu.ops.int8_scan import int8_topk_scan, quantize_global
    from semtools_tpu.ops.scan import threshold_scan, topk_scan
    from semtools_tpu_torch.store.store import Store

    rng = np.random.default_rng(123)
    e = rng.standard_normal((N, D)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = e[:2] + 0.01
    store_dir = tmp_path / "mh_ws"
    with Store(str(store_dir), dim=D, device="cpu") as s:
        s.upsert_documents_bulk([("/docA.txt", e[: N // 2]), ("/docB.txt", e[N // 2:])])

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "SEMTOOLS_TPU_SHARDED", "SEMTOOLS_TPU_SUBSET"))}
    env.update(PYTHONPATH=str(REPO), SEMTOOLS_TORCH_VIRTUAL_DEVICES="4",
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(store_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**env, "JAX_PROCESS_ID": str(r)}) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    _, i_top = topk_scan(q, e, 5)
    _, i_thr = threshold_scan(q[:1], e, 0.4)
    e8, s8 = quantize_global(e)
    _, i8 = int8_topk_scan(q, e8, s8, 5, interpret=True)
    p4, _ = quantize_pack_global(e)
    ids4 = np.asarray(int4_deep_candidates(q, p4, interpret=True))
    c1, a1 = kmeans_step(jnp.asarray(e), jnp.asarray(e[:8]), k=8)
    sims = e @ e[777]
    for o in outs:
        assert o["topk"] == np.asarray(i_top).tolist()
        assert o["threshold"] == np.asarray(i_thr).tolist()
        assert o["int8"] == np.asarray(i8).tolist()
        assert o["int4"] == [sorted({int(x) for x in r if x < N}) for r in ids4]
        assert o["kmeans"][0] == np.asarray(a1).tolist()
        np.testing.assert_allclose(o["kmeans"][1], np.asarray(c1), atol=1e-5)
        assert o["tier"] == "sharded-exact-scan[8]"
        want = [int(r) for r in np.argsort(-sims, kind="stable")[:3]]
        assert o["store"] == [["/docA.txt" if r < N // 2 else "/docB.txt", r % (N // 2)]
                              for r in want]
        want_a = [int(r) for r in np.argsort(-sims[: N // 2], kind="stable")[:3]]
        assert o["subset"] == [["/docA.txt", r] for r in want_a]
    assert [o["rank"] for o in outs] == [0, 1]
