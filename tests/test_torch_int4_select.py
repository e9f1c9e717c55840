"""The port's int4 deep-candidate selection (semtools_tpu_torch.ops.int4_scan:
the query quantization and the margin kept on the device, the single-read
sizing, the cutoff, counts, the count pass's marks and extraction and the
sharded twin's pieces) against the JAX package's (semtools_tpu.ops.int4_scan ``_int4_cutoff_counts``
/ ``int4_deep_candidates`` and semtools_tpu.parallel.scan, Pallas in
interpret mode on the CPU), on the same numpy inputs.

On CPU tensors every wrapper runs its plain version. All tolerances are
zero: the quantized queries, the margins, the cutoffs and the counts are
bit-equal, and the candidate sets are equal, also past the cap, where the
tie order alone decides. The corpus plants duplicate rows across 512-row
blocks of different maxima, so the over-cap boundary falls inside a tie
that JAX's ``lax.top_k`` breaks by the block's rank (max desc, then id),
not by row.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from semtools_tpu.ops import int4_scan as jax_int4
from semtools_tpu.ops.int8_scan import quantize_global as jax_quantize
from semtools_tpu.ops.pallas_scan import bucket_pad_rows
from semtools_tpu.parallel import mesh as jax_mesh
from semtools_tpu.parallel import scan as jax_scan
from semtools_tpu_torch.ops import int4_scan, int8_scan
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.parallel import scan as torch_scan

N, D = 2100, 32
TOP = 1600  # the first query's best row: 1.3 x its direction, in block 3
DUPS = (3, 5, 600, 1601, 1602)  # its direction, in blocks 0, 0, 1, 3, 3


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed, qn, n=N):
    """(queries, packed corpus): query 0 is row 3's direction; its equal
    rows lie in blocks 0, 1 and 3, and block 3 also holds a row scoring
    higher (its max outranks blocks 0 and 1)."""
    rng = np.random.default_rng(seed)
    e = _unit(rng, n, D)
    q = _unit(rng, qn, D)
    for dup in DUPS[1:]:
        e[dup] = e[3]
    e[TOP] = 1.3 * e[3]
    q[0] = e[3]
    return q, jax_int4.quantize_pack_global(e)[0]


def _mask(kind, n, seed):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    m = np.zeros(n, np.int8)
    if kind == "random":
        m[:] = rng.random(n) < 0.5
        m[[TOP, *DUPS]] = 1
    else:  # "few": fewer kept rows than k_cut
        m[rng.choice(n, size=4, replace=False)] = 1
    return m


def _sets(ids, n):
    return [set(int(x) for x in row if x < n) for row in np.asarray(ids)]


def _bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


@pytest.mark.parametrize("kind", ["random", "zero_row", "zeros", "chunked"])
def test_quantize_on_device_is_bit_equal(kind, monkeypatch):
    """The quantization that keeps its amax and scale on the device gives
    the numpy version's int8 rows and scale."""
    rng = np.random.default_rng(11)
    x = 3.0 * rng.standard_normal((40, 64)).astype(np.float32)
    if kind == "zero_row":
        x[7] = 0.0
    elif kind == "zeros":
        x[:] = 0.0
    elif kind == "chunked":  # more elements than one chunk: several divisions
        monkeypatch.setattr(int8_scan, "_QUANT_CHUNK", 300)
    want, want_scale = jax_quantize(x)
    got, scale = int8_scan.quantize_on_device(torch.from_numpy(x))
    assert got.dtype == torch.int8 and scale.dtype == torch.float64 and scale.dim() == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(scale) == want_scale


@pytest.mark.parametrize("sigmas", [6.0, 2.5, 0.0])
@pytest.mark.parametrize("qn,zero", [(1, False), (8, True), (40, False), (3, "all")])
def test_margin_on_device_is_bit_equal(qn, zero, sigmas):
    """The margin computed on the device (float64 squared norms, sqrt, a
    tensor division) has the numpy margin's bits, also with a zero query."""
    rng = np.random.default_rng(qn)
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(qn, 256)).astype(np.int8))
    if zero == "all":
        q8[:] = 0
    elif zero:
        q8[0] = 0
    got = int4_scan.margin_on_device(q8, sigmas)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _bits(got.item()) == _bits(int4_scan.cutoff_margin(q8, sigmas))
    sigma = float(np.max(np.linalg.norm(q8.numpy()[:qn].astype(np.float64), axis=1))) / np.sqrt(12)
    assert _bits(got.item()) == _bits(np.float32(sigmas * sigma))  # the JAX package's formula


def _jax_tile(qn, p4, n_true):
    """The JAX package's sweep tile for qn queries (padded to 8)."""
    return jax_int4._clamp_tile_to_padding(
        jax_int4.tile_for_rows(n_true, qn + (-qn) % 8), p4.shape[0], n_true)


def _jax_selection(q, p4, n_true, mask, k_cut):
    """The JAX package's (sims, block maxima, cutoff, count, n_blocks) and its
    (cap, n_b), as int4_deep_candidates computes them."""
    q8, _ = jax_quantize(q)
    qn = q8.shape[0]
    q8 = np.concatenate([q8, np.zeros(((-qn) % 8, q8.shape[1]), np.int8)])
    tile_n = _jax_tile(qn, p4, n_true)
    p4j = bucket_pad_rows(jnp.asarray(p4), tile_n, n_true=n_true)
    if mask is None:
        mask2d = jnp.zeros((1, 1), jnp.int8)
    else:
        m = np.zeros(p4j.shape[0], np.int8)
        m[: len(mask)] = mask
        mask2d = jnp.asarray(m.reshape(-1, min(512, tile_n)))
    sigma = float(np.max(np.linalg.norm(q8[:qn].astype(np.float64), axis=1))) / np.sqrt(12.0)
    out = [np.asarray(x)[:qn] for x in jax_int4._int4_cutoff_counts(
        jnp.asarray(q8), p4j, n_true, mask2d, jnp.float32(6.0 * sigma), k_cut=k_cut,
        interpret=True, tile_n=tile_n, masked=mask is not None)]
    count, n_blocks = out[3], out[4]
    cap = min(1 << max(int(count.max() - 1).bit_length(), 4),
              jax_int4.int4_candidate_cap(n_true), p4j.shape[0])
    n_b = min(1 << max(int(n_blocks.max() - 1).bit_length(), 2),
              p4j.shape[0] // min(512, tile_n))
    return out, cap, n_b


def _port_sweep(q, p4, n_true, mask):
    q8 = int8_scan.quantize_on_device(torch.from_numpy(q))[0]
    m = None if mask is None else torch.from_numpy(mask.astype(np.uint8))
    return q8, *int4_scan.sims_max(q8, torch.from_numpy(p4), n_true, m)


@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("n_true,qn,k_cut", [(N, 8, 10), (1999, 3, 12), (N, 1, 40)])
def test_selection_pieces_and_sizing_match_jax(n_true, qn, k_cut, mask_kind, monkeypatch):
    """The cutoffs, counts and block counts of the selection and of the
    sharded twin's pieces (one shard's tops, the cutoff of the tops, the
    counts against it) are bit-equal to the JAX package's, and the single
    host read sizes the extraction with the same cap and n_b."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    q, p4 = _corpus(qn + k_cut, qn)
    mask = _mask(mask_kind, N, k_cut)
    (_, _, cut_j, count_j, nb_j), cap_j, n_b_j = _jax_selection(q, p4, n_true, mask, k_cut)
    q8, sims, bmax = _port_sweep(q, p4, n_true, mask)
    margin = torch.tensor(int4_scan.cutoff_margin(q8))
    cutoff, count, n_blocks, _ = int4_scan.select_cutoff(sims, bmax, margin, k_cut)
    np.testing.assert_array_equal(cutoff.numpy().view(np.uint32), cut_j.view(np.uint32))
    np.testing.assert_array_equal(count.numpy(), count_j)
    np.testing.assert_array_equal(n_blocks.numpy(), nb_j)
    maxima = int4_scan.batch_maxima(count, n_blocks)
    assert maxima == (int(count_j.max()), int(nb_j.max()))
    cap, n_b = int4_scan.candidate_sizes(*maxima, n_true, bmax.shape[1])
    assert cap == cap_j and n_b == min(n_b_j, bmax.shape[1])
    # one shard holding every row: its tops' cutoff is the single-device one
    tops = int4_scan.block_tops(sims, bmax, k_cut)
    assert tops.shape == (qn, k_cut)
    got = int4_scan.tops_cutoff(torch.cat([tops, torch.full_like(tops, -np.inf)], dim=1),
                                margin, k_cut)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), cut_j.view(np.uint32))
    c2, nb2, _ = int4_scan.counts_above(sims, bmax, got)
    np.testing.assert_array_equal(c2.numpy(), count_j)
    np.testing.assert_array_equal(nb2.numpy(), nb_j)
    if mask_kind == "few":
        assert (cutoff.numpy() == np.float32(-3e38)).all()  # fewer than k_cut rows


def _jax_extract(out, p4, n_true, n_b, cap):
    """The JAX package's _extract_above on its own selection's outputs."""
    sims, flat_max, cutoff = (jnp.asarray(x) for x in out[:3])
    sub_n = min(jax_int4.SUB_N, _jax_tile(sims.shape[0], p4, n_true))
    return np.asarray(jax_int4._extract_above(sims, flat_max, cutoff, n_b=n_b, cap=cap,
                                              sub_n=sub_n))


def _popcount(masks):
    return sum((masks >> b) & 1 for b in range(32)).sum(dim=-1)


@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("n_true,qn,k_cut", [(N, 8, 10), (1999, 3, 12), (N, 1, 40)])
def test_marks_match_jax_counts_and_extraction(n_true, qn, k_cut, mask_kind, monkeypatch):
    """The marks the count pass hands the extraction (plain versions, on the
    port's sweep, from select_cutoff and from counts_above): the per-block
    counts sum to JAX's counts, per group too; the blocks with a count are
    JAX's blocks at or above the cutoff; each mask holds its block's count
    of bits; and the rows the masks mark, in block and row order, are the
    set JAX's extraction returns under its cap, ascending, then n_pad."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    q, p4 = _corpus(qn + k_cut, qn)
    mask = _mask(mask_kind, N, k_cut)
    out, cap_j, n_b_j = _jax_selection(q, p4, n_true, mask, k_cut)
    count_j, nb_j = out[3], out[4]
    assert count_j.max() <= cap_j  # every query under the cap
    want = _jax_extract(out, p4, n_true, n_b_j, cap_j)
    q8, sims, bmax = _port_sweep(q, p4, n_true, mask)
    cutoff, _, _, marks = int4_scan.select_cutoff(
        sims, bmax, torch.tensor(int4_scan.cutoff_margin(q8)), k_cut)
    n_pad = sims.shape[1]
    assert marks.counts.shape == (qn, n_pad // int4_scan.SIMS_ROWS)
    np.testing.assert_array_equal(marks.counts.sum(dim=1).numpy(), count_j)
    np.testing.assert_array_equal(marks.groups.sum(dim=1).numpy(), count_j)
    np.testing.assert_array_equal((marks.counts > 0).sum(dim=1).numpy(), nb_j)
    assert torch.equal(_popcount(marks.masks), marks.counts)
    rows = int4_scan.marked_rows_reference(marks, cap_j)
    assert rows.shape == (qn, cap_j)
    assert _sets(rows, n_true) == _sets(want, n_true)
    for r, c in zip(rows, count_j):
        assert torch.equal(r[:c], r[:c].sort().values) and bool((r[:c] < n_true).all())
        assert bool((r[c:] == n_pad).all())
    again = int4_scan.counts_above(sims, bmax, cutoff)[2]
    assert all(torch.equal(a, b) for a, b in zip(again, marks))


@pytest.mark.parametrize("cap", [1, 4, 5, 6])
@pytest.mark.parametrize("mask_kind", [None, "random"])
def test_rows_kept_past_the_cap_are_marked(cap, mask_kind, monkeypatch):
    """Past the cap the extraction chooses among the marked rows only: JAX's
    cap rows of each query past it are all marked (its cap-th best is at or
    above the cutoff), and the port's plain extraction keeps the same set."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    q, p4 = _corpus(5, 4)
    mask = _mask(mask_kind, N, 9)
    out, _, n_b_j = _jax_selection(q, p4, N, mask, 10)
    want = _jax_extract(out, p4, N, n_b_j, cap)
    q8, sims, bmax = _port_sweep(q, p4, N, mask)
    cutoff, count, _, marks = int4_scan.select_cutoff(
        sims, bmax, torch.tensor(int4_scan.cutoff_margin(q8)), 10)
    assert bool((count > cap).all())
    marked = _sets(int4_scan.marked_rows_reference(marks, N), N)
    kept = _sets(want, N)
    assert all(len(k) == cap and k <= m for k, m in zip(kept, marked))
    got = int4_scan.extract_above(sims, bmax, cutoff, n_b=n_b_j, cap=cap)
    assert _sets(got, N) == kept


@pytest.mark.parametrize("cap", ["1", "4", "5", "6"])
@pytest.mark.parametrize("mask_kind", [None, "random"])
def test_over_cap_boundary_ties_match_jax(cap, mask_kind, monkeypatch):
    """Past the cap the kept rows are JAX's: the boundary splits query 0's
    equal rows, and block 3 (its max is the top row's) outranks blocks 0
    and 1 though its id is higher."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_INT4_CAP", cap)
    q, p4 = _corpus(5, 4)
    mask = _mask(mask_kind, N, 9)
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask.astype(np.uint8))
    want = jax_int4.int4_deep_candidates(q, p4, mask=mj, interpret=True)
    got = int4_scan.int4_deep_candidates(q, torch.from_numpy(p4), mask=mt)
    assert got.shape == want.shape == (4, int(cap))
    assert _sets(got, N) == _sets(want, N)
    assert _sets(got, N)[0] == set([TOP, 1601, 1602, 3, 5, 600][: int(cap)])


@pytest.mark.parametrize("case", ["plain", "masked", "few"])
@pytest.mark.parametrize("qn", [1, 8, 40])
def test_deep_candidates_by_batch_match_jax(qn, case, monkeypatch):
    """Q = 1, 8 and 40 (two sweeps into one buffer), plain, masked and with
    fewer selectable rows than k_cut: the same sets and the same cap."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    q, p4 = _corpus(qn, qn, n=N)
    mask = _mask({"masked": "random", "few": "few"}.get(case), N, qn)
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask.astype(np.uint8))
    want = jax_int4.int4_deep_candidates(q, p4, n_true=N - 1, mask=mj, interpret=True)
    got = int4_scan.int4_deep_candidates(q, torch.from_numpy(p4), n_true=N - 1, mask=mt)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert _sets(got, N - 1) == _sets(want, N - 1)
    if case == "few":  # every kept row is a candidate
        keep = set(np.flatnonzero(mask[:N - 1]).tolist())
        assert all(s == keep for s in _sets(got, N - 1))


@pytest.mark.parametrize("cap", [None, "4"])
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_selection_matches_jax(masked, cap, monkeypatch):
    """On 4 CPU shards (the last partly padding): the sharded twin's sets
    equal the JAX package's sharded ones and the single device's, also past
    the cap, where each shard keeps its cap best."""
    monkeypatch.delenv("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", raising=False)
    if cap:
        monkeypatch.setenv("SEMTOOLS_TPU_INT4_CAP", cap)
    else:
        monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "4")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    n = N - 7
    q, p4 = _corpus(17, 3, n=n)
    keep = _mask("random", n, 3) if masked else None
    jm, tm = jax_mesh.corpus_mesh(4), torch_mesh.corpus_mesh(4, "cpu")
    pj, _ = jax_mesh.shard_corpus(p4, jm)
    pt, _ = torch_mesh.shard_corpus(p4, tm, fill=int4_scan.PACKED_ZERO_BYTE)
    mj = mt = None
    if masked:
        mj = jax.device_put(np.concatenate([keep, np.zeros(pj.shape[0] - n, np.int8)]),
                            NamedSharding(jm, P(jax_mesh.SHARD_AXIS)))
        mt = torch_mesh.shard_rows(keep.astype(np.uint8), tm)
    ids_j = jax_scan.sharded_int4_deep_candidates_device(q, pj, n, jm, mask=mj, interpret=True)
    ids_t = torch_scan.sharded_int4_deep_candidates_device(q, pt, n, mask=mt)
    assert _sets(ids_t, n) == _sets(ids_j, n)
    if not cap:  # under the cap the sharded set is the single device's
        one = int4_scan.int4_deep_candidates(
            q, torch.from_numpy(p4), mask=None if keep is None else torch.from_numpy(
                keep.astype(np.uint8)))
        assert _sets(ids_t, n) == _sets(one, n)
