"""``tests/test_parallel_fused.py`` on the port: the sharded scans on a mesh
of 4 CPU shards (``SEMTOOLS_TORCH_VIRTUAL_DEVICES``). ``sharded_topk_fn``
with ``fused=True`` (each shard through the fused kernels' plain versions)
must equal ``fused=False`` and the single-device scan; a shard that is not
tile-aligned keeps its tail; pad rows never crowd out negative similarities;
the sharded threshold scans equal the single-device ones; the int8 scan and
the int4 deep candidates equal their single-device answers, masked too.

The same seeded numpy inputs also go through the JAX package's sharded
scans on its 4-device CPU mesh (Pallas in interpret mode, as its suite runs
them): indices equal, distances within 1e-5 (the JAX suite's f32
tolerance), candidate sets equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semtools_tpu.ops.pallas_scan import TILE_N
from semtools_tpu.parallel import mesh as jax_mesh
from semtools_tpu.parallel import scan as jax_pscan
from semtools_tpu_torch.ops.scan import topk_scan
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.parallel.mesh import corpus_mesh, shard_corpus
from semtools_tpu_torch.parallel.scan import sharded_topk_fn

ATOL = 1e-5


@pytest.fixture(autouse=True)
def four_shards(monkeypatch):
    if len(jax.devices()) < 4:
        pytest.skip("needs jax's multi-device (virtual) CPU mesh from conftest.py")
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "4")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_fn(e, k, fused, n):
    """The JAX package's sharded_topk_fn answer on its 4-device mesh."""
    mesh = jax_mesh.corpus_mesh(4)
    e_sharded, _ = jax_mesh.shard_corpus(e, mesh)
    n_local = e_sharded.shape[0] // 4
    fn = jax_pscan.sharded_topk_fn(mesh, k, n_local, fused=fused, interpret=fused)
    return lambda q: fn(jnp.asarray(q), e_sharded, jnp.int32(n))


def test_fused_local_matches_xla_path():
    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(0)
    n_local = 2 * TILE_N + 2048  # not required to be tile-aligned
    n = n_dev * n_local
    e = rng.standard_normal((n, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((2, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    e_sharded, _ = shard_corpus(_t(e), mesh)
    k = 5
    n_local = e_sharded.n_local  # shard_corpus may bucket-pad
    fn_fused = sharded_topk_fn(mesh, k, n_local, fused=True)
    fn_plain = sharded_topk_fn(mesh, k, n_local, fused=False)
    d_f, i_f = fn_fused(_t(q), e_sharded, n)
    d_p, i_p = fn_plain(_t(q), e_sharded, n)
    np.testing.assert_array_equal(_np(i_f), _np(i_p))
    np.testing.assert_allclose(_np(d_f), _np(d_p), atol=1e-5)

    d_ref, i_ref = topk_scan(_t(q), _t(e), k)
    np.testing.assert_array_equal(_np(i_f), _np(i_ref))
    np.testing.assert_allclose(_np(d_f), _np(d_ref), atol=1e-5)

    d_j, i_j = _jax_fn(e, k, True, n)(q)
    np.testing.assert_array_equal(_np(i_f), _np(i_j))
    np.testing.assert_allclose(_np(d_f), _np(d_j), atol=ATOL)


def test_int8_sharded_matches_single_device():
    from semtools_tpu.ops.int8_scan import int8_topk_scan as jax_int8_topk
    from semtools_tpu.ops.int8_scan import quantize_global as jax_quantize
    from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
    from semtools_tpu_torch.parallel.scan import sharded_int8_topk_scan

    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(5)
    n = n_dev * (TILE_N // 2)  # per-shard below the fused threshold is fine
    e = rng.standard_normal((n, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = e[:2] + 0.01
    e8, es = quantize_global(e)
    d_s, i_s = sharded_int8_topk_scan(q, _t(e8), es, 5, mesh)
    d_1, i_1 = int8_topk_scan(q, _t(e8), es, 5)
    np.testing.assert_array_equal(_np(i_s), _np(i_1))
    np.testing.assert_allclose(_np(d_s), _np(d_1), atol=1e-5)

    je8, jes = jax_quantize(e)
    np.testing.assert_array_equal(np.asarray(e8), np.asarray(je8))
    d_j, i_j = jax_int8_topk(q, je8, jes, 5, interpret=True)
    np.testing.assert_array_equal(_np(i_s), _np(i_j))
    np.testing.assert_allclose(_np(d_s), _np(d_j), atol=ATOL)


def test_fused_local_non_tile_aligned_shard_keeps_tail():
    # The fused branch must not floor at tile boundaries and skip each
    # shard's ragged tail rows.
    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(9)
    n_local = 2 * TILE_N + 100  # NOT a multiple of the tile
    n = n_dev * n_local
    e = rng.standard_normal((n, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((1, 32)).astype(np.float32)
    q /= np.linalg.norm(q)
    # plant the best match in the ragged tail of the last shard
    target = n - 5
    e[target] = 0.98 * q[0] + 0.02 * e[0]
    e[target] /= np.linalg.norm(e[target])

    e_sharded, _ = shard_corpus(_t(e), mesh)
    fn = sharded_topk_fn(mesh, 3, e_sharded.n_local, fused=True)
    d, i = fn(_t(q), e_sharded, n)
    assert int(_np(i)[0, 0]) == target
    d_j, i_j = _jax_fn(e, 3, True, n)(q)
    np.testing.assert_array_equal(_np(i), _np(i_j))


def test_sharded_threshold_matches_single_device():
    from semtools_tpu_torch.ops.scan import threshold_scan
    from semtools_tpu_torch.parallel.scan import (
        sharded_threshold_scan,
        sharded_threshold_scan_device,
    )

    mesh = corpus_mesh(4, device="cpu")
    rng = np.random.default_rng(31)
    n = 4 * 1000 + 37  # ragged: shards get zero padding
    e = rng.standard_normal((n, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = e[5:6].copy()
    e[n - 2] = q[0]  # hit near the padded tail
    d_s, i_s = sharded_threshold_scan(q, e, 0.4, mesh)
    d_1, i_1 = threshold_scan(_t(q), _t(e), 0.4)
    np.testing.assert_array_equal(_np(i_s), _np(i_1))
    np.testing.assert_allclose(_np(d_s), _np(d_1), atol=1e-5)
    assert {5, n - 2} <= set(map(int, _np(i_s)))
    e_sharded, n_true = shard_corpus(_t(e), mesh)
    d_d, i_d = sharded_threshold_scan_device(_t(q), e_sharded, n_true, 0.4, mesh)
    np.testing.assert_array_equal(_np(i_d), _np(i_s))

    d_j, i_j = jax_pscan.sharded_threshold_scan(q, e, 0.4, jax_mesh.corpus_mesh(4))
    np.testing.assert_array_equal(_np(i_s), _np(i_j))
    np.testing.assert_allclose(_np(d_s), _np(d_j), atol=ATOL)


def test_sharded_threshold_no_hits():
    from semtools_tpu_torch.parallel.scan import sharded_threshold_scan

    mesh = corpus_mesh(4, device="cpu")
    rng = np.random.default_rng(32)
    e = rng.standard_normal((4096, 16)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    q /= np.linalg.norm(q)
    d, i = sharded_threshold_scan(q, e, 1e-9, mesh)
    assert tuple(d.shape) == (0,) and tuple(i.shape) == (0,)
    d_j, i_j = jax_pscan.sharded_threshold_scan(q, e, 1e-9, jax_mesh.corpus_mesh(4))
    assert d_j.shape == (0,) and i_j.shape == (0,)


def test_sharded_batched_threshold_matches_single_query():
    from semtools_tpu_torch.ops.scan import batched_threshold_scan
    from semtools_tpu_torch.parallel.scan import (
        sharded_batched_threshold_scan,
        sharded_threshold_scan,
    )

    mesh = corpus_mesh(4, device="cpu")
    rng = np.random.default_rng(41)
    n = 4 * 800 + 53  # ragged: shards get zero padding
    e = rng.standard_normal((n, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[300] = e[700] = e[5]  # duplicates: tie-break by corpus order
    q = np.stack([e[5], e[n - 2], e[1234]]) + 0.0
    got = sharded_batched_threshold_scan(q, e, 0.4, mesh)
    assert len(got) == 3
    ref = batched_threshold_scan(_t(q), _t(e), 0.4)
    for (d_b, i_b), (d_r, i_r) in zip(got, ref):
        np.testing.assert_array_equal(_np(i_b), _np(i_r))
        np.testing.assert_allclose(_np(d_b), _np(d_r), atol=1e-5)
    # also agrees with the single-query sharded path row by row
    for row in range(3):
        d_1, i_1 = sharded_threshold_scan(q[row : row + 1], e, 0.4, mesh)
        np.testing.assert_array_equal(_np(got[row][1]), _np(i_1))
        np.testing.assert_allclose(_np(got[row][0]), _np(d_1), atol=1e-5)
    jax_got = jax_pscan.sharded_batched_threshold_scan(q, e, 0.4, jax_mesh.corpus_mesh(4))
    for (d_b, i_b), (d_j, i_j) in zip(got, jax_got):
        np.testing.assert_array_equal(_np(i_b), _np(i_j))
        np.testing.assert_allclose(_np(d_b), _np(d_j), atol=ATOL)


def test_sharded_batched_threshold_no_hits():
    from semtools_tpu_torch.parallel.scan import sharded_batched_threshold_scan

    mesh = corpus_mesh(4, device="cpu")
    rng = np.random.default_rng(42)
    e = rng.standard_normal((4096, 16)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = sharded_batched_threshold_scan(q, e, 1e-9, mesh)
    assert len(got) == 2
    for d, i in got:
        assert tuple(d.shape) == (0,) and tuple(i.shape) == (0,)
    jax_got = jax_pscan.sharded_batched_threshold_scan(q, e, 1e-9, jax_mesh.corpus_mesh(4))
    assert [tuple(np.asarray(i).shape) for _, i in jax_got] == [(0,), (0,)]


def _anti_aligned(rng, n):
    """Every row anti-aligned with q (all sims negative), the least negative
    one last: zero pads would outrank every real row if they were read."""
    q = rng.standard_normal((1, 32)).astype(np.float32)
    q /= np.linalg.norm(q)
    e = -q + 0.05 * rng.standard_normal((n, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    ortho = rng.standard_normal(32).astype(np.float32)
    ortho -= (ortho @ q[0]) * q[0]
    ortho /= np.linalg.norm(ortho)
    e[n - 1] = 0.999 * ortho - 0.045 * q[0]
    e[n - 1] /= np.linalg.norm(e[n - 1])
    return q, e


def test_fused_pad_rows_cannot_crowd_out_negative_sims():
    """With zero padding on the tail shard and a corpus whose similarities
    are all NEGATIVE, pad rows (sim 0.0) must not crowd the true best match
    out of the tail shard's candidates: each shard reads only its real
    rows."""
    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(77)
    n = 4 * 600 + 11  # ragged; bucketing pads the tail shard heavily
    q, e = _anti_aligned(rng, n)
    target = n - 1

    d_ref, i_ref = topk_scan(_t(q), _t(e), 3)

    e_sharded, _ = shard_corpus(_t(e), mesh)
    n_local = e_sharded.n_local
    assert n_local * n_dev > n  # the scenario really has pad rows
    fn = sharded_topk_fn(mesh, 3, n_local, fused=True)
    d, i = fn(_t(q), e_sharded, n)
    np.testing.assert_array_equal(_np(i), _np(i_ref))
    assert int(_np(i)[0, 0]) == target
    assert float(_np(d)[0, 0]) > 1.0  # negative sim, not a pad
    d_j, i_j = _jax_fn(e, 3, True, n)(q)
    np.testing.assert_array_equal(_np(i), _np(i_j))
    np.testing.assert_allclose(_np(d), _np(d_j), atol=ATOL)


def test_int8_sharded_pad_rows_cannot_crowd_out_negative_sims():
    from semtools_tpu.ops.int8_scan import quantize_global as jax_quantize
    from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
    from semtools_tpu_torch.parallel.scan import sharded_int8_topk_scan

    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(78)
    n = 4 * 300 + 7
    q, e = _anti_aligned(rng, n)
    e8, es = quantize_global(e)

    d_s, i_s = sharded_int8_topk_scan(q, _t(e8), es, 3, mesh)
    d_1, i_1 = int8_topk_scan(q, _t(e8), es, 3)
    np.testing.assert_array_equal(_np(i_s), _np(i_1))
    assert int(_np(i_s)[0, 0]) == n - 1
    je8, jes = jax_quantize(e)
    d_j, i_j = jax_pscan.sharded_int8_topk_scan(q, je8, jes, 3, jax_mesh.corpus_mesh(4),
                                                interpret=True)
    np.testing.assert_array_equal(_np(i_s), _np(i_j))
    np.testing.assert_allclose(_np(d_s), _np(d_j), atol=ATOL)


def test_int4_sharded_deep_candidates_match_single_device():
    """The sharded extraction's cutoff is the exact global k_cut-th-best
    biased sim, so the candidate SET must match ``int4_deep_candidates`` and
    contain the f32 top-10."""
    from semtools_tpu.ops.int4_scan import quantize_pack_global as jax_pack
    from semtools_tpu_torch.ops.int4_scan import int4_deep_candidates, quantize_pack_global
    from semtools_tpu_torch.parallel.scan import sharded_int4_deep_candidates_device

    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(21)
    d = 64
    centers = rng.standard_normal((8, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = np.repeat(centers, 300, axis=0) + 0.08 * rng.standard_normal(
        (8 * 300, d)
    ).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    n = len(rows)
    p4, es = quantize_pack_global(rows)
    q = centers[:3]

    p4_sharded, _ = shard_corpus(_t(p4), mesh)
    ids_s = _np(sharded_int4_deep_candidates_device(q, p4_sharded, n, mesh))
    ids_1 = _np(int4_deep_candidates(q, _t(p4)))

    _, i_exact = topk_scan(_t(q), _t(rows), 10)
    jp4, _ = jax_pack(rows)
    jmesh = jax_mesh.corpus_mesh(4)
    jp4_sharded, _ = jax_mesh.shard_corpus(jp4, jmesh)
    ids_j = _np(jax_pscan.sharded_int4_deep_candidates_device(q, jp4_sharded, n, jmesh,
                                                              interpret=True))
    for r in range(3):
        got_s = set(int(x) for x in ids_s[r] if x < n)
        got_1 = set(int(x) for x in ids_1[r] if x < n)
        assert got_s == got_1, f"query {r}: sharded candidate set diverged"
        assert set(_np(i_exact)[r].tolist()) <= got_s
        assert got_s == set(int(x) for x in ids_j[r] if x < n)


def test_int4_sharded_deep_candidates_masked():
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from semtools_tpu.ops.int4_scan import quantize_pack_global as jax_pack
    from semtools_tpu_torch.ops.int4_scan import quantize_pack_global
    from semtools_tpu_torch.parallel.mesh import shard_rows
    from semtools_tpu_torch.parallel.scan import sharded_int4_deep_candidates_device

    n_dev = 4
    mesh = corpus_mesh(n_dev, device="cpu")
    rng = np.random.default_rng(22)
    d = 64
    rows = rng.standard_normal((1600, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    n = len(rows)
    p4, es = quantize_pack_global(rows)
    q = rows[:2] + 0.01

    p4_sharded, _ = shard_corpus(_t(p4), mesh)
    mask_np = (rng.random(n) < 0.5).astype(np.uint8)
    mask_np[:10] = 1
    mask = shard_rows(_t(mask_np), mesh)
    ids = _np(sharded_int4_deep_candidates_device(q, p4_sharded, n, mesh, mask=mask))
    sims = rows @ q.T

    jmesh = jax_mesh.corpus_mesh(4)
    jp4, _ = jax_pack(rows)
    jp4_sharded, _ = jax_mesh.shard_corpus(jp4, jmesh)
    mask_pad = np.concatenate(
        [mask_np.astype(np.int8), np.zeros(jp4_sharded.shape[0] - n, np.int8)])
    mask_dev = jax.device_put(mask_pad, NamedSharding(jmesh, P(jax_mesh.SHARD_AXIS)))
    ids_j = _np(jax_pscan.sharded_int4_deep_candidates_device(
        q, jp4_sharded, n, jmesh, mask=mask_dev, interpret=True))
    for r in range(2):
        got = [int(x) for x in ids[r] if x < n]
        assert got and all(mask_np[g] == 1 for g in got), "masked row leaked"
        s = sims[:, r].copy()
        s[mask_np == 0] = -np.inf
        exact = np.argsort(-s, kind="stable")[:10]
        assert set(exact.tolist()) <= set(got)
        assert set(got) == set(int(x) for x in ids_j[r] if x < n)
