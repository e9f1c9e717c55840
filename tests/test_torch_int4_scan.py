"""The port's int4 scans (semtools_tpu_torch.ops.int4_scan) against the JAX
package's (semtools_tpu.ops.int4_scan, Pallas in interpret mode on the CPU),
on the same numpy inputs.

Packing is byte-equal (it is an on-disk contract between the packages). The
similarities are exact integers, so every tolerance here is zero: the deep
candidate sweep gives each query the same set of valid rows (also past the
candidate cap, where only the tie order decides which rows stay), the exact
top-k gives equal indices wherever the distance is finite, and the
distances, computed in float64 and then rounded to f32 on both sides, are
bit-equal. Duplicate rows planted across the 128- and 512-row boundaries pin
the lower-index tie rule.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semtools_tpu.ops import int4_scan as jax_int4
from semtools_tpu.ops.int8_scan import quantize_global as jax_quantize
from semtools_tpu.ops.pallas_scan import bucket_pad_rows
from semtools_tpu_torch.ops import int4_scan, int8_scan

DUPS = (5, 127, 128, 511, 512)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed, n, qn, d):
    """(queries, packed corpus, scale): planted duplicates of row 3 inside a
    sub-tile and across the 128- and 512-row boundaries (the first query
    sits on them), and one zero row."""
    rng = np.random.default_rng(seed)
    e = _unit(rng, n, d)
    q = _unit(rng, qn, d)
    for dup in DUPS + (n // 2, n - 1):
        if dup < n:
            e[dup] = e[3]
    q[0] = e[3]
    e[7] = 0.0
    p4, scale = jax_int4.quantize_pack_global(e)
    return q, p4, scale


def _mask(kind, n, rng):
    if kind is None:
        return None
    m = np.zeros(n, np.int8)
    if kind == "random":
        m[:] = rng.random(n) < 0.5
        m[3] = 1
    elif kind == "few":  # fewer kept rows than k_cut / k
        m[rng.choice(n, size=4, replace=False)] = 1
    return m


def _masks(mask):
    """The same keep vector for both packages."""
    if mask is None:
        return None, None
    return jnp.asarray(mask), torch.from_numpy(mask.astype(np.uint8))


@pytest.mark.parametrize("kind", ["random", "zeros", "edge", "chunked"])
def test_packing_is_byte_equal(kind, monkeypatch):
    rng = np.random.default_rng(3)
    if kind == "edge":  # the full nibble range through pack_int4 itself
        q = rng.integers(-8, 8, size=(40, 64)).astype(np.int8)
        q[0, :16] = [-8, -7, -1, 0, 1, 7, -8, 7, 0, 0, 0, 0, -8, -8, 7, 7]
        got = int4_scan.pack_int4(q)
        np.testing.assert_array_equal(got, jax_int4.pack_int4(q))
        np.testing.assert_array_equal(int4_scan.unpack_int4(got), q)
        return
    if kind == "chunked":  # past the chunk size: the chunked amax and pack
        monkeypatch.setattr(int4_scan, "_QUANT_CHUNK_ELEMS", 1000)
        monkeypatch.setattr(jax_int4, "_QUANT_CHUNK_ELEMS", 1000)
    x = np.zeros((5, 32), np.float32) if kind == "zeros" else _unit(rng, 300, 64)
    want, want_s = jax_int4.quantize_pack_global(x)
    got, got_s = int4_scan.quantize_pack_global(x)
    assert got_s == want_s and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    if kind == "zeros":  # zero vectors pack to 0x08, not 0x00
        assert got_s == 0.0 and (got == int4_scan.PACKED_ZERO_BYTE).all()
    # the plain versions' operand: biased low nibbles, signed high nibbles
    un = jax_int4.unpack_int4(got).astype(np.float32)
    un[:, : un.shape[1] // 2] += 8
    np.testing.assert_array_equal(int4_scan.unpack_f32(torch.from_numpy(got)).numpy(), un)


def _jax_cutoff_counts(q, p4, n_true, mask, k_cut):
    """The JAX package's (sims, block maxima, cutoff, count, n_blocks) as
    int4_deep_candidates computes them (queries padded to 8, tile padding)."""
    q8, _ = jax_quantize(q)
    qn = q8.shape[0]
    q8 = np.concatenate([q8, np.zeros(((-qn) % 8, q8.shape[1]), np.int8)])
    tile_n = jax_int4._clamp_tile_to_padding(
        jax_int4.tile_for_rows(n_true, q8.shape[0]), p4.shape[0], n_true)
    p4j = bucket_pad_rows(jnp.asarray(p4), tile_n, n_true=n_true)
    if mask is None:
        mask2d = jnp.zeros((1, 1), jnp.int8)
    else:
        m = np.zeros(p4j.shape[0], np.int8)
        m[: len(mask)] = mask
        mask2d = jnp.asarray(m.reshape(-1, min(512, tile_n)))
    sigma = float(np.max(np.linalg.norm(q8[:qn].astype(np.float64), axis=1))) / np.sqrt(12.0)
    out = jax_int4._int4_cutoff_counts(
        jnp.asarray(q8), p4j, n_true, mask2d, jnp.float32(6.0 * sigma), k_cut=k_cut,
        interpret=True, tile_n=tile_n, masked=mask is not None)
    return [np.asarray(x)[:qn] for x in out]


@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("d,n,n_true,qn,k_cut", [
    (32, 1500, 1500, 3, 10),
    (64, 2000, 1301, 2, 12),
])
def test_sweep_and_cutoff_match_jax(d, n, n_true, qn, k_cut, mask_kind, monkeypatch):
    """The deep-candidate sweep's sims and 512-row block maxima, and the f32
    cutoff, counts and block counts, are bit-equal to the JAX package's."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    q, p4, _ = _corpus(n + qn, n, qn, d)
    mask = _mask(mask_kind, n, np.random.default_rng(n))
    sims_j, max_j, cut_j, count_j, nb_j = _jax_cutoff_counts(q, p4, n_true, mask, k_cut)
    q8, _ = int8_scan.quantize_global(torch.from_numpy(q))
    mask_t = _masks(mask)[1]
    sims, bmax = int4_scan.sims_max(q8, torch.from_numpy(p4), n_true, mask_t)
    assert sims.shape[1] % int4_scan.SIMS_ROWS == 0 and sims.shape[1] >= n_true
    np.testing.assert_array_equal(sims.numpy(), sims_j[:, : sims.shape[1]])
    np.testing.assert_array_equal(bmax.numpy(), max_j[:, : bmax.shape[1]])
    sigma = float(np.max(np.linalg.norm(q8.numpy().astype(np.float64), axis=1))) / np.sqrt(12.0)
    cutoff, count, n_blocks = int4_scan.cutoff_counts(
        sims, bmax, torch.tensor(np.float32(6.0 * sigma)), k_cut)
    np.testing.assert_array_equal(cutoff.numpy(), cut_j)
    np.testing.assert_array_equal(count.numpy(), count_j)
    np.testing.assert_array_equal(n_blocks.numpy(), nb_j)
    if mask_kind == "few":
        assert (cutoff.numpy() == np.float32(-3e38)).all()  # fewer than k_cut rows


def _valid_sets(ids, n):
    return [set(int(x) for x in row if x < n) for row in np.asarray(ids)]


@pytest.mark.parametrize("case", ["plain", "masked", "ragged", "few", "over_cap",
                                  "over_cap_masked", "tiny"])
@pytest.mark.parametrize("d", [32, 64])
def test_deep_candidates_match_jax(case, d, monkeypatch):
    """The same per-query set of valid candidate rows, and the same cap."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    n, qn, k_cut = 2100, 4, 10
    n_true = 1999 if case in ("ragged", "over_cap_masked") else None
    if case == "tiny":
        n, n_true = 40, 6  # fewer rows than k_cut
    q, p4, _ = _corpus(7 + d, n, qn, d)
    mask_kind = {"masked": "random", "over_cap_masked": "random", "few": "few"}.get(case)
    mask_j, mask_t = _masks(_mask(mask_kind, n, np.random.default_rng(d)))
    if case.startswith("over_cap"):
        # far fewer than the rows within the margin: the tie rule decides
        monkeypatch.setenv("SEMTOOLS_TPU_INT4_CAP", "48")
    want = jax_int4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask_j, k_cut=k_cut,
                                         interpret=True)
    got = int4_scan.int4_deep_candidates(q, torch.from_numpy(p4), n_true=n_true, mask=mask_t,
                                         k_cut=k_cut)
    assert got.dtype == torch.int64 and got.shape == want.shape
    rows = n if n_true is None else n_true
    assert _valid_sets(got, rows) == _valid_sets(want, rows)
    if case.startswith("over_cap"):
        # most queries have more rows within the margin than the cap
        assert want.shape[1] == 48
        assert sum(len(s) == 48 for s in _valid_sets(got, rows)) >= qn // 2
    if case in ("few", "tiny"):  # every selectable row is a candidate
        keep = np.arange(rows) if mask_t is None else np.flatnonzero(mask_t.numpy()[:rows])
        assert all(s == set(keep.tolist()) for s in _valid_sets(got, rows))


def test_deep_candidates_sweep_queries_in_chunks(monkeypatch):
    """A batch above 32 queries sweeps in chunks into one buffer; margin, cap
    and block count still come from the whole batch."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    q, p4, _ = _corpus(40, 1200, 40, 32)
    want = jax_int4.int4_deep_candidates(q, p4, interpret=True)
    got = int4_scan.int4_deep_candidates(q, torch.from_numpy(p4))
    assert got.shape == want.shape
    assert _valid_sets(got, 1200) == _valid_sets(want, 1200)


@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("d,n,n_true,qn,k", [
    (32, 1500, 1500, 1, 10),
    (64, 1500, 1419, 3, 64),
    (32, 700, 700, 2, 200),  # k above the kernels' 128-row sub-tile
    (32, 200, 190, 1, 500),  # k above the rows
    (64, 900, 900, 40, 3),  # more queries than one kernel launch takes
])
def test_int4_topk_scan_matches_jax(d, n, n_true, qn, k, mask_kind):
    q, p4, scale = _corpus(n + qn + k, n, qn, d)
    mask_j, mask_t = _masks(_mask(mask_kind, n, np.random.default_rng(k)))
    d_ref, i_ref = jax_int4.int4_topk_scan(q, p4, scale, k, n_true=n_true, mask=mask_j,
                                           interpret=True)
    dist, idx = int4_scan.int4_topk_scan(q, torch.from_numpy(p4), scale, k, n_true=n_true,
                                         mask=mask_t)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int64
    np.testing.assert_array_equal(dist.numpy(), d_ref)  # +inf filler on both sides
    fin = np.isfinite(d_ref)
    np.testing.assert_array_equal(idx.numpy()[fin], np.asarray(i_ref)[fin])
    if mask_kind is None:
        want = sorted({x for x in (3, n // 2, n - 1) + DUPS if x < n})[: min(k, 3)]
        assert idx[0, : len(want)].tolist() == want  # planted duplicates, lowest first


def test_phases_agree_with_a_full_sort():
    """The plain phases compose to the exact top-k of the biased sims, also
    for k above the sub-tile (every chosen sub-tile taken whole)."""
    q, p4, _ = _corpus(3, 3000, 4, 64)
    q8, _ = int8_scan.quantize_global(torch.from_numpy(q))
    p4 = torch.from_numpy(p4)
    mask = torch.from_numpy((np.random.default_rng(0).random(3000) < 0.5).astype(np.uint8))
    full = (q8.float() @ int4_scan.unpack_f32(p4[:2990]).T).masked_fill(
        mask[:2990] == 0, float("-inf"))
    want_v, want_i = torch.sort(full, dim=1, descending=True, stable=True)
    for k in (10, 300):
        sims, idx = int4_scan.int4_two_phase(q8, p4, 2990, k, mask)
        assert torch.equal(sims, want_v[:, :k])
        assert torch.equal(idx, want_i[:, :k])


def test_cuda_operands_are_checked():
    """A wrapper given a CPU/CUDA mix refuses it (no silent plain run)."""
    q8 = torch.zeros((1, 64), dtype=torch.int8)
    p4 = torch.zeros((600, 32), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="share one CUDA device"):
        int4_scan.sims_max(q8, p4, 600)
    with pytest.raises(ValueError, match="share one CUDA device"):
        int4_scan.tilemax(q8, p4, 600)
