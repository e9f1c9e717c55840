"""Phase 2 of the port's two-phase scans against the JAX package's.

Between phase 1's [Q, S] sub-tile maxima and the [Q, k] answer, the port
runs the sub-tile selection (``fused_scan.top_subtiles``, kernel
``select_subtiles``) and the rescan-and-merge (``rescan_topk`` of the f32,
int8 and int4 scans). On the CPU the wrappers run their plain versions
(today's stable sort, ``rescan_reference`` + ``merge_candidates``); here they
are held against ``jax.lax.top_k`` and the JAX package's two-phase scans,
Pallas in interpret mode (as tests/test_pallas_scan.py runs them), on the
same numpy inputs. The kernels themselves are held against these plain
versions on a card (tests/test_torch_*_cuda.py, chip_smoke.py).

Tolerances: selected sub-tile ids equal; integer sims and indices equal
(indices wherever the sims are finite: the Pallas extraction repeats one
index in its -inf filler); f32 distances within 1e-5 (XLA's and PyTorch's
matmuls sum in another order, ~1e-7 on unit rows) with equal indices.
Exact duplicates of each query's best row sit in 12 sub-tiles, so sub-tile
maxima tie across sub-tiles, at the selection cut too for k = 1 and 10:
the lower sub-tile must win.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semtools_tpu.ops import int4_scan as jax_int4
from semtools_tpu.ops import int8_scan as jax_int8
from semtools_tpu.ops.pallas_scan import _two_phase_topk as jax_two_phase
from semtools_tpu.ops.pallas_scan import pad_rows
from semtools_tpu_torch.ops import fused_scan as fs
from semtools_tpu_torch.ops import int4_scan, int8_scan

SUB = fs.SUB_ROWS
D = 32
# rows holding a copy of each query's best row: 12 sub-tiles, two of them
# twice (rows 5 and 40 share sub-tile 0)
DUP_ROWS = (5, 40) + tuple(SUB * t + 3 * t for t in range(1, 11)) + (11 * SUB + 127,)
ATOL = 1e-5


def _maxima(seed, qn, s):
    """[qn, s] f32 sub-tile maxima: each row's best value in several
    sub-tiles, integer-valued rows full of ties, runs of -inf (empty or
    masked sub-tiles), one row all -inf."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((qn, s)).astype(np.float32)
    top = m.max(axis=1) + 1.0
    for t in (3, s // 2, s - 1, 7):
        m[:, t] = top
    m[:, 9 : 9 + s // 4] = -np.inf
    if qn > 1:
        m[1] = np.round(m[1] * 2) / 2
        m[1, s // 3 :] = -np.inf
    if qn > 2:
        m[2] = -np.inf
    return m


@pytest.mark.parametrize("qn,s,kt", [
    (3, 40, 1),
    (3, 40, 10),
    (4, 300, 64),
    (3, 90, 90),   # every sub-tile
    (1, 5000, 10),  # more than one chunk of the selection kernel
])
def test_selection_matches_lax_top_k(qn, s, kt):
    m = _maxima(s + kt, qn, s)
    _, want = jax.lax.top_k(jnp.asarray(m), kt)
    got = fs.top_subtiles(torch.from_numpy(m), kt)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(fs.select_subtiles(torch.from_numpy(m), kt).numpy(),
                                  np.asarray(want))


def test_selection_refuses_other_devices():
    with pytest.raises(TypeError):
        fs.top_subtiles(torch.zeros((2, 50), device="meta"), 3)


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed, n, qn):
    """Unit rows and queries; every query's best row copied into DUP_ROWS."""
    rng = np.random.default_rng(seed)
    e = _unit(rng, n)
    q = _unit(rng, qn)
    for j in range(qn):
        best = int(np.argmax(e @ q[j]))
        e[[r + j for r in DUP_ROWS]] = e[best]
    return q, e


def _mask(kind, n, seed):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    m = np.zeros(n, np.int8)
    if kind == "random":
        m[:] = rng.random(n) < 0.5
        m[list(DUP_ROWS)] = 1
    else:  # "few": fewer kept rows than k (filler in the answer)
        m[rng.choice(n, size=3, replace=False)] = 1
    return m


def _padded_mask(mask, n_pad):
    m = np.zeros(n_pad, np.int8)
    m[: len(mask)] = mask
    return jnp.asarray(m)


def _assert_int_equal(sims, idx, want_sims, want_idx):
    want_sims, want_idx = np.asarray(want_sims), np.asarray(want_idx)
    np.testing.assert_array_equal(sims.numpy(), want_sims)  # -inf filler on both sides
    fin = np.isfinite(want_sims)
    np.testing.assert_array_equal(idx.numpy()[fin], want_idx[fin])


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("n,n_true,qn", [(10_000, 9_901, 2), (2_000, 2_000, 1)])
def test_f32_two_phase_matches_jax(n, n_true, qn, k):
    q, e = _corpus(n + k, n, qn)
    d_ref, i_ref = jax_two_phase(jnp.asarray(q), jnp.asarray(pad_rows(e, SUB)), n_true, k=k,
                                 interpret=True, tile_n=SUB)
    d, i = fs._two_phase_topk(torch.from_numpy(q), torch.from_numpy(e), n_true, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=ATOL, rtol=0)
    # query 0's best row and its copies: ties go to the lowest sub-tile and row
    want = np.flatnonzero((e[:n_true] == e[DUP_ROWS[0]]).all(axis=1))[:k].tolist()
    assert len(want) >= min(k, len(DUP_ROWS)) and i[0, : len(want)].tolist() == want


@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_int8_two_phase_matches_jax(k, mask_kind):
    n, n_true, qn = 10_000, 9_950, 2
    q, e = _corpus(k + 8, n, qn)
    e8, _ = jax_int8.quantize_global(e)
    q8, _ = jax_int8.quantize_global(q)
    e8p = jnp.asarray(pad_rows(jnp.asarray(e8), SUB))
    mask = _mask(mask_kind, n, k)
    if mask is None:
        want = jax_int8._int8_two_phase(jnp.asarray(q8), e8p, n_true, k=k, interpret=True,
                                        tile_n=SUB)
    else:
        want = jax_int8._int8_two_phase_masked(jnp.asarray(q8), e8p, n_true,
                                               _padded_mask(mask, e8p.shape[0]), k=k,
                                               interpret=True, tile_n=SUB)
    sims, idx = int8_scan.int8_two_phase(
        torch.from_numpy(q8), torch.from_numpy(e8), n_true, k,
        None if mask is None else torch.from_numpy(mask.astype(np.uint8)))
    _assert_int_equal(sims, idx, *want)


@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("k,tile_n", [(1, SUB), (10, SUB), (64, SUB), (200, 512)])
def test_int4_two_phase_matches_jax(k, tile_n, mask_kind):
    """k = 200 is above the port's 128-row sub-tile (whole sub-tiles are
    taken, the merge emits k) and below the JAX kernel's 512."""
    n, n_true, qn = 12_000, 11_999, 2
    q, e = _corpus(k + 4, n, qn)
    p4, _ = jax_int4.quantize_pack_global(e)
    q8, _ = jax_int8.quantize_global(q)
    p4p = jnp.asarray(pad_rows(jnp.asarray(p4), tile_n))
    mask = _mask(mask_kind, n, k)
    if mask is None:
        want = jax_int4._int4_two_phase(jnp.asarray(q8), p4p, n_true, k=k, interpret=True,
                                        tile_n=tile_n)
    else:
        want = jax_int4._int4_two_phase_masked(jnp.asarray(q8), p4p, n_true,
                                               _padded_mask(mask, p4p.shape[0]), k=k,
                                               interpret=True, tile_n=tile_n)
    sims, idx = int4_scan.int4_two_phase(
        torch.from_numpy(q8), torch.from_numpy(p4), n_true, k,
        None if mask is None else torch.from_numpy(mask.astype(np.uint8)))
    _assert_int_equal(sims, idx, *want)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_rescan_topk_filler_keeps_its_rows(fmt):
    """With fewer kept rows than k, the -inf filler is the lowest rows of
    the chosen sub-tiles that are not kept, after the kept ones: the rows
    the per-sub-tile rescan and the two-key merge give (and the kernel must
    give too)."""
    q, e = _corpus(3, 2000, 1)
    q8, _ = int8_scan.quantize_global(torch.from_numpy(q))
    if fmt == "int8":
        rows, _ = int8_scan.quantize_global(torch.from_numpy(e))
        mod = int8_scan
    else:
        rows = torch.from_numpy(int4_scan.quantize_pack_global(e)[0])
        mod = int4_scan
    mask = torch.zeros(2000, dtype=torch.uint8)
    mask[[700, 130]] = 1
    sub_ids = torch.tensor([[5, 1, 0]])
    sims, idx = mod.rescan_topk(q8, rows, 1999, sub_ids, 6, mask)
    assert torch.isfinite(sims[0, :2]).all() and sorted(idx[0, :2].tolist()) == [130, 700]
    assert not torch.isfinite(sims[0, 2:]).any()
    assert idx[0, 2:].tolist() == [0, 1, 2, 3]
