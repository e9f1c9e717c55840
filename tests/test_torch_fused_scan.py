"""The port's fused top-k scan against the JAX package's Pallas kernels.

On the CPU the wrappers in ``semtools_tpu_torch.ops.fused_scan`` run their
plain PyTorch versions; here they are held against the Pallas kernels run
in interpret mode (as tests/test_pallas_scan.py runs them), on the same
numpy inputs. Indices must be exact (ties go to the lower corpus index);
distances and sims agree within 1e-5 (f32 summation order differs between
XLA's and PyTorch's matmuls, ~1e-7 on unit rows).

The kernels themselves run only on a CUDA card; they are held against
their plain versions in tests/test_torch_fused_scan_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semtools_tpu.ops.pallas_scan import (
    _merge,
    _pallas_candidates,
    _two_phase_topk,
    pad_rows,
    pallas_topk_scan,
)
from semtools_tpu_torch.ops import fused_scan as fs

ATOL = 1e-5


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed, n, d, qn):
    """Unit rows with planted exact duplicates of a query's best row inside
    one sub-tile, across a sub-tile boundary and across tiles."""
    rng = np.random.default_rng(seed)
    e = _unit_rows(rng, n, d)
    q = _unit_rows(rng, qn, d)
    q[0] = e[5]
    for dup in (9, fs.SUB_ROWS + 3, 3 * fs.SUB_ROWS - 1, n - 2):
        if dup < n:
            e[dup] = e[5]
    return q, e


def _jax_two_phase(q, e, n_true, k, tile_n):
    d, i = _two_phase_topk(jnp.asarray(q), jnp.asarray(pad_rows(e, tile_n)), n_true,
                           k=k, interpret=True, tile_n=tile_n)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("n,n_true,qn,k,tile_n", [
    (6 * 2048 + 77, None, 1, 3, 2048),   # ragged n, the JAX package's sizes
    (4096, 3001, 8, 10, 128),            # n_true < rows, several queries
    (3000, None, 32, 64, 128),           # the routing limits Q = 32, k = 64
])
def test_two_phase_matches_pallas(n, n_true, qn, k, tile_n):
    q, e = _corpus(n + k, n, 32, qn)
    nt = n if n_true is None else n_true
    d_ref, i_ref = _jax_two_phase(q, e, nt, k, tile_n)
    d, i = fs._two_phase_topk(torch.from_numpy(q), torch.from_numpy(e), nt, k)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=ATOL)
    assert list(i[0, :3]) == [5, 9, fs.SUB_ROWS + 3]  # duplicates: lower index first


@pytest.mark.parametrize("n,n_true,qn,k", [
    (1000, None, 1, 5),
    (2 * fs.SUB_ROWS + 7, 2 * fs.SUB_ROWS + 1, 8, 10),
    (900, 899, 32, 64),
])
def test_scan_candidates_match_pallas(n, n_true, qn, k):
    """K2 plain version == _scan_kernel's per-tile candidates (128-row
    tiles on both sides), and the merged top-k == _pallas_candidates + _merge."""
    q, e = _corpus(n * 7 + k, n, 32, qn)
    nt = n if n_true is None else n_true
    e_pad = jnp.asarray(pad_rows(e, fs.SUB_ROWS))
    cv_ref, ci_ref = _pallas_candidates(jnp.asarray(q), e_pad, nt, k=k, interpret=True,
                                        tile_n=fs.SUB_ROWS)
    cv, ci = fs.scan_candidates(torch.from_numpy(q), torch.from_numpy(e), nt, k)
    t = cv.shape[0]
    cv_ref, ci_ref = np.asarray(cv_ref), np.asarray(ci_ref)
    np.testing.assert_allclose(cv.numpy(), cv_ref[:t], atol=ATOL)
    # Slots past a tile's valid rows are -inf on both sides; the Pallas
    # extraction repeats one index there, so only finite slots carry rows.
    finite = np.isfinite(cv_ref[:t])
    np.testing.assert_array_equal(ci.numpy()[finite], ci_ref[:t][finite])
    d_ref, i_ref = _merge(cv_ref, ci_ref, k=k)
    d, i = fs._single_phase_topk(torch.from_numpy(q), torch.from_numpy(e), nt, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=ATOL)


def test_tilemax_and_rescan_plain_versions():
    """K1's plain versions against numpy brute force, ragged n_true."""
    q, e = _corpus(5, 1000, 16, 4)
    nt = 999
    sims = q @ e[:nt].T
    s = -(-nt // fs.SUB_ROWS)
    padded = np.full((4, s * fs.SUB_ROWS), -np.inf, np.float32)
    padded[:, :nt] = sims
    want_max = padded.reshape(4, s, fs.SUB_ROWS).max(axis=2)
    sub_max = fs.tilemax(torch.from_numpy(q), torch.from_numpy(e), nt)
    np.testing.assert_allclose(sub_max.numpy(), want_max, atol=ATOL)

    ids = fs.select_subtiles(sub_max, 3)
    # ties in sub-tile maxima go to the lower sub-tile (duplicates of e[5]
    # sit in sub-tiles 0, 1 and 2 for query 0)
    assert ids[0].tolist() == [0, 1, 2]
    k = 4
    vals, idx = fs.rescan_reference(torch.from_numpy(q), torch.from_numpy(e), nt, ids, k)
    best, best_idx = fs.rescan_topk(torch.from_numpy(q), torch.from_numpy(e), nt, ids, k)
    for j in range(4):
        chosen = []
        for t, sid in enumerate(ids[j].tolist()):
            rows = np.arange(sid * fs.SUB_ROWS, min((sid + 1) * fs.SUB_ROWS, nt))
            chosen.extend(rows)
            order = sorted(rows, key=lambda r: (-padded[j, r], r))[:k]
            assert idx[j, t].tolist() == order
            np.testing.assert_allclose(vals[j, t].numpy(), padded[j, order], atol=ATOL)
        # the merged top-k over every row of the chosen sub-tiles
        order = sorted(chosen, key=lambda r: (-padded[j, r], r))[:k]
        assert best_idx[j].tolist() == order
        np.testing.assert_allclose(best[j].numpy(), padded[j, order], atol=ATOL)


@pytest.mark.parametrize("n,qn,k", [
    (10, 1, 3),      # a single short tile
    (2000, 2, 64),   # single phase (16 tiles <= 2*Q*k)
    (9000, 1, 4),    # two phase (71 tiles > 8)
    (7, 1, 50),      # k larger than n
])
def test_fused_topk_scan_matches_pallas_topk_scan(n, qn, k):
    q, e = _corpus(n + qn, n, 32, qn)
    d_ref, i_ref = pallas_topk_scan(q, e, k, interpret=True)
    d, i = fs.fused_topk_scan(torch.from_numpy(q), torch.from_numpy(e), k)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=ATOL)


def test_fused_topk_scan_limits():
    q, e = _corpus(1, 500, 16, 33)
    with pytest.raises(ValueError):
        fs.fused_topk_scan(torch.from_numpy(q), torch.from_numpy(e), 4)
    d, i = fs.fused_topk_scan(torch.zeros(1, 16), torch.zeros(0, 16), 3)
    assert d.shape == (1, 0) and i.shape == (1, 0)


def test_merge_candidates_two_key_rule():
    vals = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]])
    idx = torch.tensor([[4, 30, 7, 1, 12]])
    best, ids = fs.merge_candidates(vals, idx, 4)
    assert ids.tolist() == [[7, 12, 30, 4]]
    assert best[0].tolist() == pytest.approx([0.9, 0.9, 0.9, 0.5])


def test_cuda_operands_are_validated_before_any_launch():
    """A tensor on another device type is refused, never moved."""
    e = torch.zeros(256, 16)
    with pytest.raises(ValueError):
        fs.tilemax(torch.zeros(1, 16, device="meta"), e, 256)
