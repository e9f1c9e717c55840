"""The port's IVF-PQ index (``semtools_tpu_torch/index``) against the JAX
package's (``semtools_tpu/index``).

The same numpy inputs, made from a seed, go through both on the CPU:
k-means starts from the same rows and ends with identical assignments and
centroids within 1e-5; PQ codebooks within 1e-5 and identical codes; ADC
tables and scans within 1e-5; a whole build (the port's fused pass) with
identical lists, permutation and codes. An index saved by either package
serves in the other with equal ids and distances within 1e-6. The fused
pass equals the separate passes byte for byte, the native probe equals its
numpy version, two builds of the same rows are byte-equal, and a 30-row
dim-256 build (the JAX package pads it to a 2,097,152-row chunk and runs
out of memory) succeeds without a chunk larger than the corpus. JAX-side
builds stay at dim 32, as in ``tests/test_index.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu.index import IvfPqIndex as JaxIndex
from semtools_tpu.index import kmeans_fit as jax_kmeans_fit
from semtools_tpu.index import pq_encode as jax_pq_encode
from semtools_tpu.index import pq_fit as jax_pq_fit
from semtools_tpu.index.pq import adc_scan as jax_adc_scan
from semtools_tpu.index.pq import adc_tables as jax_adc_tables
from semtools_tpu_torch.index import IvfPqIndex, PQCodebook, adc_scan, adc_tables, kmeans_fit
from semtools_tpu_torch.index import ivf_pq, kmeans, pq_encode, pq_fit

CPU = torch.device("cpu")
ATOL = 1e-5


def _clustered(seed, n_clusters=16, per=64, d=32, spread=0.05):
    rng = np.random.Generator(np.random.Philox(seed))
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = np.repeat(centers, per, axis=0) + spread * rng.standard_normal(
        (n_clusters * per, d)).astype(np.float32)
    return (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)


def _queries(x, seed, n=6):
    rng = np.random.default_rng(seed)
    q = x[rng.choice(len(x), n, replace=False)] + 0.02 * rng.standard_normal(
        (n, x.shape[1])).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _clustered(7, n_clusters=16, per=64)


@pytest.fixture(scope="module")
def builds(data):
    """(JAX index, port index) of the same rows: 16 lists, m = 8."""
    kw = dict(nlist=16, m=8, train_iters=6, seed=3)
    return JaxIndex.build(data, **kw), IvfPqIndex.build(data, device=CPU, **kw)


@pytest.mark.parametrize("n,k,seed", [(1024, 16, 0), (500, 256, 1), (300, 300, 9)])
def test_kmeans_init_is_the_jax_draw(n, k, seed):
    x = _clustered(seed, n_clusters=4, per=n // 4 + 1)[:n]
    c_jax, _ = jax_kmeans_fit(x, k, iters=0, seed=seed)
    c, _ = kmeans_fit(torch.from_numpy(x), k, iters=0, seed=seed)
    np.testing.assert_array_equal(c.numpy(), c_jax)
    np.testing.assert_array_equal(x[kmeans.init_indices(n, k, seed)], c_jax)


@pytest.mark.parametrize("seed,k,iters", [(0, 16, 8), (5, 12, 10)])
def test_kmeans_fit_matches_jax(data, seed, k, iters):
    c_jax, a_jax = jax_kmeans_fit(data, k, iters=iters, seed=seed)
    c, a = kmeans_fit(torch.from_numpy(data), k, iters=iters, seed=seed)
    np.testing.assert_array_equal(a.numpy(), a_jax)
    np.testing.assert_allclose(c.numpy(), c_jax, atol=ATOL, rtol=0)


def test_kmeans_keeps_empty_clusters():
    """A centroid that wins no row keeps its value (the JAX rule)."""
    x = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-5.0, -5.0]])
    new, assign = kmeans.kmeans_step(x, cents, 3)
    assert assign.tolist() == [0, 0, 1]
    np.testing.assert_array_equal(new.numpy(), cents.numpy())


@pytest.mark.parametrize("m", [8, 4])
def test_pq_fit_and_encode_match_jax(data, m):
    pq_jax = jax_pq_fit(data, m=m, iters=5, seed=2)
    pq = pq_fit(torch.from_numpy(data), m=m, iters=5, seed=2)
    np.testing.assert_allclose(pq.codebooks, pq_jax.codebooks, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pq_encode(data, pq), jax_pq_encode(data, pq_jax))
    np.testing.assert_array_equal(pq_encode(data, pq_jax), jax_pq_encode(data, pq_jax))


def test_pq_fit_pads_small_samples_to_256_rows(data):
    pq_jax = jax_pq_fit(data[:40], m=8, iters=4)
    pq = pq_fit(data[:40], m=8, iters=4)
    assert pq.codebooks.shape == pq_jax.codebooks.shape == (8, 256, 4)
    np.testing.assert_allclose(pq.codebooks, pq_jax.codebooks, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pq.codebooks[:, 40:], np.repeat(pq.codebooks[:, :1], 216, 1))


def test_adc_tables_and_scan_match_jax(data, builds):
    q = _queries(data, 1)
    books = builds[0].pq.codebooks
    np.testing.assert_allclose(adc_tables(q, books), np.asarray(jax_adc_tables(q, books)),
                               atol=ATOL, rtol=0)
    pq = PQCodebook(books)
    codes = jax_pq_encode(data, pq)
    np.testing.assert_allclose(adc_scan(q, codes, pq), jax_adc_scan(q, codes, pq),
                               atol=ATOL, rtol=0)
    d, i = adc_scan(q, codes, pq, k=10)
    d_jax, i_jax = jax_adc_scan(q, codes, pq, k=10)
    np.testing.assert_allclose(d, d_jax, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(i, i_jax)


def test_build_matches_jax(builds):
    jax_idx, idx = builds
    np.testing.assert_allclose(idx.centroids, jax_idx.centroids, atol=ATOL, rtol=0)
    np.testing.assert_allclose(idx.pq.codebooks, jax_idx.pq.codebooks, atol=ATOL, rtol=0)
    for name in ("codes", "perm", "list_offsets", "vectors"):
        np.testing.assert_array_equal(getattr(idx, name), getattr(jax_idx, name), err_msg=name)
    assert idx.codes.dtype == np.uint8 and idx.perm.dtype == idx.list_offsets.dtype == np.int64


def test_fused_pass_matches_separate_passes():
    """The one-pass build step equals kmeans._assign + residual +
    pq_encode, byte for byte (the port's counterpart of
    ``tests/test_index.py::test_fused_assign_encode_matches_separate_passes``)."""
    rng = np.random.default_rng(4)
    d, m = 64, 8
    x = rng.standard_normal((4096, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    xt = torch.from_numpy(x)
    centroids, _ = kmeans_fit(xt[:1024], 32, iters=5)
    pq = pq_fit(xt[:1024] - centroids[kmeans._assign(xt[:1024], centroids)], m=m, iters=3)
    books = torch.from_numpy(pq.codebooks)
    a_f, c_f = ivf_pq._fused_assign_encode(
        xt, centroids, 0.5 * (centroids * centroids).sum(1), books, 0.5 * (books * books).sum(2))
    a_ref = kmeans._assign(xt, centroids)
    c_ref = pq_encode(xt - centroids[a_ref], pq)
    assert torch.equal(a_f, a_ref)
    np.testing.assert_array_equal(c_f.numpy(), c_ref)


def test_native_probe_matches_numpy(builds, data, monkeypatch):
    from semtools_tpu_torch.utils import native

    if native.adc_lib() is None:
        pytest.skip("native library unavailable on this host")
    idx = builds[1]
    q = _queries(data, 2, n=4)
    coarse = q @ idx.centroids.T
    tables = adc_tables(q, idx.pq.codebooks)
    lists = np.array([0, 3, 5, 11], np.int64)
    rows_nat, approx_nat = idx._probe(lists, coarse[0], tables[0])
    want = coarse[0][np.searchsorted(idx.list_offsets, rows_nat, side="right") - 1] \
        + IvfPqIndex._adc_sum_numpy(idx.codes[rows_nat], tables[0])
    monkeypatch.setattr(native, "adc_lib", lambda: None)
    rows_np, approx_np = idx._probe(lists, coarse[0], tables[0])
    np.testing.assert_array_equal(rows_nat, rows_np)
    np.testing.assert_allclose(approx_nat, approx_np, atol=ATOL, rtol=0)
    np.testing.assert_allclose(approx_np, want, atol=ATOL, rtol=0)
    d_np, i_np = idx.search(q, k=5, nprobe=4, rerank=4)
    monkeypatch.undo()
    d_nat, i_nat = idx.search(q, k=5, nprobe=4, rerank=4)
    np.testing.assert_array_equal(i_nat, i_np)
    np.testing.assert_allclose(d_nat, d_np, atol=ATOL, rtol=0)


@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_saved_index_serves_in_the_other_package(builds, data, tmp_path, saved_by):
    jax_idx, idx = builds
    path = str(tmp_path / "idx.npz")
    (jax_idx if saved_by == "jax" else idx).save(path, extra={"build_token": np.int64(7)})
    other = (IvfPqIndex if saved_by == "jax" else JaxIndex).load(path)
    mine = jax_idx if saved_by == "jax" else idx
    for name in ("centroids", "codes", "perm", "list_offsets", "vectors"):
        np.testing.assert_array_equal(getattr(other, name), getattr(mine, name))
    q = _queries(data, 3, n=8)
    for kw in (dict(k=5, nprobe=16), dict(k=10, nprobe=4, rerank=8)):
        d_o, i_o = other.search(q, **kw)
        d_m, i_m = mine.search(q, **kw)
        np.testing.assert_array_equal(i_o, i_m)
        np.testing.assert_allclose(d_o, d_m, atol=1e-6, rtol=0)


def test_builds_are_byte_equal_and_input_forms_agree(data, tmp_path):
    """Two builds of the same rows are byte-equal, from a numpy array, an
    mmap, a lazy row view and a tensor alike."""
    kw = dict(nlist=8, m=4, train_iters=4, seed=1, device=CPU)
    mm_path = tmp_path / "rows.f32"
    data.tofile(mm_path)
    mm = np.memmap(mm_path, dtype=np.float32, mode="r", shape=data.shape)

    class Lazy:
        shape = data.shape

        def __getitem__(self, idx):
            return np.asarray(mm[idx])

    ref = IvfPqIndex.build(data, **kw)
    for x in (data, mm, Lazy(), torch.from_numpy(data.copy())):
        got = IvfPqIndex.build(x, **kw)
        for name in ("centroids", "codes", "perm", "list_offsets", "vectors"):
            assert getattr(got, name).tobytes() == getattr(ref, name).tobytes(), name
        assert got.pq.codebooks.tobytes() == ref.pq.codebooks.tobytes()


@pytest.mark.parametrize("n,nlist,m,want", [
    (30, 16, 32, 30),                   # a 30-row corpus: one chunk of 30 rows
    (10_000_000, 4096, 32, 4096),       # [chunk, 32, 256] bounds it
    (10_000_000, 16384, 8, 2048),       # [chunk, nlist] bounds it
    (1, 1, 1, 1),
])
def test_chunk_rows(n, nlist, m, want):
    assert ivf_pq._chunk_rows(n, nlist, m) == want


def test_small_dim256_build_never_pads(monkeypatch):
    """30 rows at dim 256, nlist 16, m 32: the JAX package pads its chunk to
    2,097,152 rows and runs out of memory; the port's chunks never exceed
    the corpus, and the build serves."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((30, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    seen = []
    real = ivf_pq._fused_assign_encode

    def spy(chunk, *args):
        seen.append(chunk.shape[0])
        return real(chunk, *args)

    monkeypatch.setattr(ivf_pq, "_fused_assign_encode", spy)
    idx = IvfPqIndex.build(x, nlist=16, m=32, device=CPU)
    assert seen == [30]
    assert idx.codes.shape == (30, 32) and idx.nlist == 16
    d, i = idx.search(x[:4], k=3, nprobe=16)
    np.testing.assert_array_equal(i[:, 0], np.arange(4))
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-6)
