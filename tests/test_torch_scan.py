"""The port's plain scan (semtools_tpu_torch.ops.scan) against the JAX
package's (semtools_tpu.ops.scan), on the same numpy inputs.

Indices must be equal (ties toward the lower corpus index, pinned with
duplicate rows); distances agree within 1e-5 (f32 matmul summation order
differs between XLA and PyTorch, ~1e-7 on unit rows).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu.ops import scan as jax_scan
from semtools_tpu_torch.ops import scan

ATOL = 1e-5


def _data(seed, n, d, qn):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((qn, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # duplicates of the first query's nearest neighbour, and a zero row
    q[0] = e[3]
    if n > 11:
        for dup in (11, n // 2, n - 1):
            e[dup] = e[3]
        e[7] = 0.0
    return q, e


@pytest.mark.parametrize("n,qn,k,n_true,chunk", [
    (50, 1, 5, None, None),
    (300, 3, 10, 250, None),       # n_true < rows
    (1000, 40, 7, None, None),     # Q > 32
    (1000, 2, 12, 990, 128),       # chunked running merge
    (5, 1, 10, None, None),        # k > n
])
def test_topk_scan_matches_jax(monkeypatch, n, qn, k, n_true, chunk):
    q, e = _data(n + qn, n, 32, qn)
    if chunk is not None:
        monkeypatch.setattr(scan, "SCAN_CHUNK", chunk)
    d_ref, i_ref = jax_scan.topk_scan(q, e, k, n_true=n_true)
    d, i = scan.topk_scan(torch.from_numpy(q), torch.from_numpy(e), k, n_true=n_true)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=ATOL)
    nt = n if n_true is None else n_true
    if k >= 3 and nt == n > 11:
        assert i[0, :3].tolist() == [3, 11, n // 2]


@pytest.mark.parametrize("n,qn,t,n_true", [
    (400, 4, 0.9, None),
    (400, 2, 1.0, 390),            # zero row sits exactly at 1.0: excluded
    (70_000, 1, 0.5, None),        # the JAX package's device-compaction size
])
def test_threshold_scans_match_jax(n, qn, t, n_true):
    q, e = _data(n * 3 + qn, n, 16, qn)
    per_ref = jax_scan.batched_threshold_scan(q, e, t, n_true=n_true)
    per = scan.batched_threshold_scan(torch.from_numpy(q), torch.from_numpy(e), t,
                                      n_true=n_true)
    assert len(per) == len(per_ref) == qn
    for (d, i), (d_ref, i_ref) in zip(per, per_ref):
        np.testing.assert_array_equal(i.numpy(), i_ref)
        np.testing.assert_allclose(d.numpy(), d_ref, atol=ATOL)
    d_ref, i_ref = jax_scan.threshold_scan(q[:1], e, t, n_true=n_true)
    d, i = scan.threshold_scan(torch.from_numpy(q[:1]), torch.from_numpy(e), t, n_true=n_true)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=ATOL)


def test_cosine_distances_and_empty_corpus():
    q, e = _data(1, 20, 8, 2)
    np.testing.assert_allclose(
        scan.cosine_distances(torch.from_numpy(q), torch.from_numpy(e)).numpy(),
        np.asarray(jax_scan.cosine_distances(q, e)), atol=ATOL,
    )
    empty = torch.zeros((0, 8))
    d, i = scan.topk_scan(torch.from_numpy(q), empty, 3)
    assert d.shape == (2, 0) and i.shape == (2, 0)
    assert [x.numel() for pair in scan.batched_threshold_scan(torch.from_numpy(q), empty, 1.0)
            for x in pair] == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        scan.threshold_scan(torch.from_numpy(q), torch.from_numpy(e), 1.0)


def test_routing_keeps_cpu_corpora_on_the_plain_path():
    """The fused kernels are for CUDA corpora; CPU tensors take the plain
    scan (as the JAX package keeps non-TPU backends on XLA)."""
    assert not scan._use_fused(1 << 20, 10, 8, torch.device("cpu"))
    assert scan._use_fused(1 << 20, 10, 8, torch.device("cuda"))
    assert not scan._use_fused(1 << 20, 65, 8, torch.device("cuda"))
    assert not scan._use_fused(1 << 20, 10, 33, torch.device("cuda"))
    assert not scan._use_fused(100, 10, 1, torch.device("cuda"))


@pytest.mark.parametrize("n,qn,k,n_true,chunk", [
    (400, 3, 10, None, None),
    (1000, 2, 50, 990, 128),       # chunked running merge
    (300, 1, 40, None, None),      # fewer kept rows than k: +inf filler
])
def test_masked_scans_match_jax(monkeypatch, n, qn, k, n_true, chunk):
    """The ``mask=`` operand (subset serving on the slot corpus): masked
    rows are never selected, counted or returned."""
    q, e = _data(n + k, n, 16, qn)
    rng = np.random.default_rng(n)
    mask = rng.random(n) < (0.5 if k < 40 else 0.1)
    if chunk is not None:
        monkeypatch.setattr(scan, "SCAN_CHUNK", chunk)
    d_ref, i_ref = jax_scan.topk_scan(q, e, k, n_true=n_true, mask=mask)
    d, i = scan.topk_scan(torch.from_numpy(q), torch.from_numpy(e), k, n_true=n_true,
                          mask=torch.from_numpy(mask.astype(np.uint8)))
    fin = np.isfinite(d_ref)
    np.testing.assert_array_equal(np.isfinite(d.numpy()), fin)
    np.testing.assert_array_equal(i.numpy()[fin], i_ref[fin])
    np.testing.assert_allclose(d.numpy()[fin], d_ref[fin], atol=ATOL)
    assert mask[i.numpy()[fin]].all()
    per_ref = jax_scan.batched_threshold_scan(q, e, 0.95, n_true=n_true, mask=mask)
    per = scan.batched_threshold_scan(torch.from_numpy(q), torch.from_numpy(e), 0.95,
                                      n_true=n_true, mask=torch.from_numpy(mask))
    for (dt, it), (dj, ij) in zip(per, per_ref):
        np.testing.assert_array_equal(it.numpy(), ij)
        np.testing.assert_allclose(dt.numpy(), dj, atol=ATOL)
