"""The port's mesh-sharded scans (semtools_tpu_torch.parallel) against the JAX
package's (semtools_tpu.parallel), on the same seeded numpy inputs.

The JAX side runs on the 8 virtual CPU devices of this test session
(``tests/conftest.py``), its Pallas kernels in interpret mode; the port on a
mesh of 8 CPU shards (``SEMTOOLS_TORCH_VIRTUAL_DEVICES=8``, its kernels'
wrappers running their plain versions on CPU tensors). Top-k: the same rows
in the same order, distances within 1e-5; int8: rows and distances equal;
int4 deep candidates: equal sets; threshold scans: the same rows. Ragged
corpora leave the last shard partly (or wholly) padding, and all-negative
similarities check that padding never displaces a real row.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from semtools_tpu.parallel import mesh as jax_mesh
from semtools_tpu.parallel import scan as jax_scan
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.parallel import multihost
from semtools_tpu_torch.parallel import scan as torch_scan

ATOL = 1e-5


@pytest.fixture(autouse=True)
def eight_shards(monkeypatch):
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "8")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _meshes(n_dev):
    return jax_mesh.corpus_mesh(n_dev), torch_mesh.corpus_mesh(n_dev, "cpu")


def _negative_corpus(rng, n, d):
    """Every row anti-aligned with the query but the last, which is the
    least negative: zero padding would outrank every real row."""
    q = _unit(rng, 1, d)
    e = -q + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    ortho = rng.standard_normal(d).astype(np.float32)
    ortho -= (ortho @ q[0]) * q[0]
    ortho /= np.linalg.norm(ortho)
    e[n - 1] = 0.999 * ortho - 0.045 * q[0]
    e[n - 1] /= np.linalg.norm(e[n - 1])
    return q, e


def test_mesh_shape_and_fixed_count(monkeypatch):
    mesh = torch_mesh.corpus_mesh(device="cpu")
    assert mesh.size == len(jax.devices()) == 8 and torch_mesh.mesh_size("cpu") == 8
    assert torch_mesh.corpus_mesh(4, "cpu").size == 4
    with pytest.raises(ValueError, match="9 shards"):
        torch_mesh.corpus_mesh(9, "cpu")
    # read once per process: a later value of the variable changes nothing
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "3")
    assert torch_mesh.corpus_mesh(device="cpu").size == 8


@pytest.mark.parametrize("n", [1, 100, 2048, 100_000, 100_500, 1_000_000])
@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_bucket_rows(n, n_dev):
    b = torch_mesh.bucket_rows(n, n_dev)
    assert b == jax_mesh.bucket_rows(n, n_dev)
    assert b >= n and b % n_dev == 0


def test_shard_corpus_views_share_one_buffer():
    rng = np.random.default_rng(3)
    e = _unit(rng, 1001, 16)
    es, n = torch_mesh.shard_corpus(e, torch_mesh.corpus_mesh(device="cpu"))
    assert n == 1001 and es.shape[0] == torch_mesh.bucket_rows(1001, 8)
    assert len(es.parts) == 1 and len(es.shards) == 8
    buf = es.parts[0][1]
    assert all(s.data_ptr() == buf[j * es.n_local:].data_ptr() for j, s in enumerate(es.shards))
    np.testing.assert_array_equal(buf[:n].numpy(), e)
    assert not buf[n:].any()


@pytest.mark.parametrize("n,d,qn,k,n_dev", [
    (1000, 32, 3, 10, 8),
    (1001, 16, 2, 5, 8),  # ragged: padding on the last shards
    (3, 8, 1, 5, 8),  # fewer rows than shards: all-padding shards
    (64, 16, 1, 3, 4),  # a 4-shard mesh of the 8
    (2400, 64, 40, 64, 8),  # more queries than one kernel launch takes
])
def test_sharded_topk_matches_jax(n, d, qn, k, n_dev):
    rng = np.random.default_rng(n + d)
    e, q = _unit(rng, n, d), _unit(rng, qn, d)
    e[n // 2] = e[0]  # a duplicate across shards: the lower row first
    jm, tm = _meshes(n_dev)
    d_j, i_j = jax_scan.sharded_topk_scan(q, e, k, jm)
    d_t, i_t = torch_scan.sharded_topk_scan(q, e, k, tm)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=ATOL, rtol=0)
    es, _ = torch_mesh.shard_corpus(e, tm)  # the fused route's plain phases
    d_f, i_f = torch_scan.sharded_topk_scan_device(q, es, n, k, fused=True)
    np.testing.assert_array_equal(i_f.numpy(), i_j)
    np.testing.assert_allclose(d_f.numpy(), d_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_pad_rows_cannot_crowd_out_negative_sims(fused):
    rng = np.random.default_rng(77)
    n = 4 * 600 + 11
    q, e = _negative_corpus(rng, n, 32)
    jm, tm = _meshes(4)
    d_j, i_j = jax_scan.sharded_topk_scan(q, e, 3, jm)
    es, _ = torch_mesh.shard_corpus(e, tm)
    assert es.shape[0] > n
    d_t, i_t = torch_scan.sharded_topk_scan_device(q, es, n, 3, fused=fused)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    assert int(i_t[0, 0]) == n - 1 and float(d_t[0, 0]) > 1.0


def test_masked_topk_matches_jax():
    rng = np.random.default_rng(11)
    n = 8 * 70 + 5
    e, q = _unit(rng, n, 32), _unit(rng, 3, 32)
    keep = (rng.random(n) < 0.4).astype(np.int8)
    jm, tm = _meshes(8)
    ej, _ = jax_mesh.shard_corpus(e, jm)
    mj = jax.device_put(np.concatenate([keep, np.zeros(ej.shape[0] - n, np.int8)]),
                        NamedSharding(jm, P(jax_mesh.SHARD_AXIS)))
    et, _ = torch_mesh.shard_corpus(e, tm)
    mt = torch_mesh.shard_rows(keep.astype(np.uint8), tm)
    for k in (5, 300):  # 300: wider than the kept rows of some shards
        d_j, i_j = jax_scan.sharded_topk_scan_device(q, ej, n, k, jm, mask=mj)
        d_t, i_t = torch_scan.sharded_topk_scan_device(q, et, n, k, mask=mt)
        np.testing.assert_array_equal(i_t.numpy(), i_j)
        np.testing.assert_allclose(d_t.numpy(), d_j, atol=ATOL, rtol=0)
        assert keep[i_t.numpy().ravel()].all()


@pytest.mark.parametrize("n,qn,k,negative", [
    (4 * 2048, 2, 5, False),
    (4 * 300 + 7, 1, 3, True),  # padding against all-negative sims
    (8 * 500 + 3, 33, 64, False),  # two query launches per shard
])
def test_sharded_int8_matches_jax(n, qn, k, negative):
    from semtools_tpu.ops.int8_scan import quantize_global

    rng = np.random.default_rng(n)
    if negative:
        q, e = _negative_corpus(rng, n, 32)
    else:
        e = _unit(rng, n, 64)
        q = e[:qn] + 0.01
    e8, scale = quantize_global(e)
    jm, tm = _meshes(4)
    d_j, i_j = jax_scan.sharded_int8_topk_scan(q, e8, scale, k, jm, interpret=True)
    d_t, i_t = torch_scan.sharded_int8_topk_scan(q, e8, scale, k, tm)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    if negative:
        assert int(i_t[0, 0]) == n - 1


@pytest.mark.parametrize("masked", [False, True])
def test_int4_deep_candidates_match_jax(masked):
    from semtools_tpu.ops.int4_scan import quantize_pack_global
    from semtools_tpu_torch.ops.int4_scan import PACKED_ZERO_BYTE, int4_deep_candidates

    rng = np.random.default_rng(21)
    d = 64
    centers = _unit(rng, 8, d)
    rows = np.repeat(centers, 300, axis=0) + 0.08 * rng.standard_normal((2400, d)).astype(
        np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows = rows[:2393]  # ragged
    n = len(rows)
    p4, _ = quantize_pack_global(rows)
    q = centers[:3]
    keep = (rng.random(n) < 0.5).astype(np.int8) if masked else None
    jm, tm = _meshes(4)
    pj, _ = jax_mesh.shard_corpus(p4, jm)
    pt, _ = torch_mesh.shard_corpus(p4, tm, fill=PACKED_ZERO_BYTE)
    mj = mt = mask1 = None
    if masked:
        mj = jax.device_put(np.concatenate([keep, np.zeros(pj.shape[0] - n, np.int8)]),
                            NamedSharding(jm, P(jax_mesh.SHARD_AXIS)))
        mt = torch_mesh.shard_rows(keep.astype(np.uint8), tm)
        mask1 = torch.from_numpy(keep.astype(np.uint8))
    ids_j = jax_scan.sharded_int4_deep_candidates_device(q, pj, n, jm, mask=mj, interpret=True)
    ids_t = torch_scan.sharded_int4_deep_candidates_device(q, pt, n, mask=mt).numpy()
    ids_1 = int4_deep_candidates(q, torch.from_numpy(p4), mask=mask1).numpy()
    sims = rows @ q.T
    for r in range(3):
        got = {int(x) for x in ids_t[r] if x < n}
        assert got == {int(x) for x in ids_j[r] if x < n} == {int(x) for x in ids_1[r] if x < n}
        s = sims[:, r] if keep is None else np.where(keep == 1, sims[:, r], -np.inf)
        assert set(np.argsort(-s, kind="stable")[:10].tolist()) <= got


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [0.4, -0.5])  # -0.5: no hits
def test_threshold_scans_match_jax(masked, t):
    from semtools_tpu.ops.scan import batched_threshold_scan

    rng = np.random.default_rng(41)
    n = 4 * 800 + 53
    e = _unit(rng, n, 32)
    e[300] = e[700] = e[5]  # duplicates: ties to the lower row
    q = np.stack([e[5], e[n - 2], e[1234]])
    keep = (rng.random(n) < 0.6).astype(np.int8)
    keep[[5, 300]] = 1
    jm, tm = _meshes(4)
    ej, _ = jax_mesh.shard_corpus(e, jm)
    et, _ = torch_mesh.shard_corpus(e, tm)
    mj = mt = None
    if masked:
        mj = jax.device_put(np.concatenate([keep, np.zeros(ej.shape[0] - n, np.int8)]),
                            NamedSharding(jm, P(jax_mesh.SHARD_AXIS)))
        mt = torch_mesh.shard_rows(keep.astype(np.uint8), tm)
    want = jax_scan.sharded_batched_threshold_scan_device(q, ej, n, t, jm, mask=mj)
    got = torch_scan.sharded_batched_threshold_scan_device(q, et, n, t, mask=mt)
    assert len(got) == len(want) == 3
    for (d_t, i_t), (d_j, i_j) in zip(got, want):
        np.testing.assert_array_equal(i_t.numpy(), i_j)
        np.testing.assert_allclose(d_t.numpy(), d_j, atol=ATOL, rtol=0)
    if not masked:
        ref = batched_threshold_scan(q, e, t)
        for (_, i_t), (_, i_r) in zip(got, ref):
            np.testing.assert_array_equal(i_t.numpy(), i_r)
        d1, i1 = torch_scan.sharded_threshold_scan(q[:1], e, t, tm)
        np.testing.assert_array_equal(i1.numpy(), want[0][1])


def test_sharded_kmeans_step_matches_jax_and_one_device():
    import jax.numpy as jnp

    from semtools_tpu.index import kmeans as jax_kmeans
    from semtools_tpu_torch.index import kmeans as torch_kmeans

    rng = np.random.default_rng(5)
    n, d, k = 8 * 40, 16, 6
    x = _unit(rng, n, d)
    c0 = x[:k].copy()
    jm, tm = _meshes(8)
    c_j, a_j = jax_kmeans.make_sharded_kmeans_step(jm, k)(jnp.asarray(x), jnp.asarray(c0))
    xs = torch_mesh.ShardedRows(tm, n // 8, (d,), torch.float32)
    xs.narrow(0, 0, n).copy_(torch.from_numpy(x))
    c_t, a_t = torch_kmeans.make_sharded_kmeans_step(tm, k)(xs, torch.from_numpy(c0))
    c_1, a_1 = torch_kmeans.kmeans_step(torch.from_numpy(x), torch.from_numpy(c0), k)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert torch.equal(a_t, a_1)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), c_1.numpy(), atol=ATOL, rtol=0)
    # the fit pads with copies of the first row to a multiple of the mesh
    x = x[:n - 3]
    cf_j, af_j = jax_kmeans.kmeans_fit(x, k, iters=3, seed=1, mesh=jm)
    cf_t, af_t = torch_kmeans.kmeans_fit(x, k, iters=3, seed=1, mesh=tm)
    np.testing.assert_array_equal(af_t.numpy(), af_j)
    np.testing.assert_allclose(cf_t.numpy(), cf_j, atol=ATOL, rtol=0)



def test_sharded_kmeans_fit_with_no_steps_gives_the_init_assignment():
    from semtools_tpu_torch.index import kmeans as torch_kmeans

    x = torch.from_numpy(_unit(np.random.default_rng(6), 8 * 40 - 3, 16))
    _, tm = _meshes(8)
    c_t, a_t = torch_kmeans.kmeans_fit(x, 6, iters=0, seed=1, mesh=tm)
    c_1, a_1 = torch_kmeans.kmeans_fit(x, 6, iters=0, seed=1)
    assert torch.equal(c_t, c_1) and torch.equal(a_t, a_1)

def test_ivf_pq_build_on_a_mesh():
    from semtools_tpu_torch.index.ivf_pq import IvfPqIndex

    rng = np.random.default_rng(9)
    x = _unit(rng, 3000, 32)
    one = IvfPqIndex.build(x, nlist=16, m=8, train_iters=3, device="cpu")
    mesh = IvfPqIndex.build(x, nlist=16, m=8, train_iters=3, device="cpu",
                            mesh=torch_mesh.corpus_mesh(device="cpu"))
    np.testing.assert_allclose(np.asarray(mesh.centroids), np.asarray(one.centroids), atol=ATOL)


def test_multihost_initialize_noop_on_single_host(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    t = torch.arange(3)
    assert multihost.all_gather(t, 0) is t and multihost.all_max(t) is t


def test_dryrun_multichip():
    from semtools_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, "cpu")
    assert out["shards"] == 8
    assert out["store_tiers"] == ["sharded-exact-scan[8]", "sharded-int4-scan[8]",
                                  "sharded-int8-scan[8]"]
