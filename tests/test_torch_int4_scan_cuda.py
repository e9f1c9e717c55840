"""The int4 scan kernels against their plain PyTorch versions, on a card.

Needs a CUDA card (the kernels have no CPU mode) and skips without one.
This file imports neither jax nor tests/conftest.py's jax setup, so it runs
on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_int4_scan_cuda.py -q

The arithmetic is integer, so every tolerance is zero: the sweep's sims and
block maxima are bit-equal, the two-phase sims equal rank by rank and the
indices equal wherever the sims are finite; the deep-candidate sets of the
kernel path equal those of the plain path, and planted duplicate rows
resolve to the lower index.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu_torch.ops import int4_scan as i4
from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops.fused_scan import select_subtiles, top_subtiles


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int4 kernels have no CPU mode")
    from semtools_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")


def _data(gen, n, qn, device, d=256):
    """Random packed bytes with row 3 planted across the 128- and 512-row
    boundaries; int8 queries, the first one on row 3."""
    p4 = torch.randint(-128, 128, (n, d // 2), generator=gen, dtype=torch.int8)
    for dup in (5, 127, 128, 511, 512, n // 2, n - 2):
        p4[dup] = p4[3]
    q8 = torch.randint(-127, 128, (qn, d), generator=gen, dtype=torch.int8)
    row3 = i4.unpack_f32(p4[3])
    row3[: d // 2] -= 8
    q8[0] = (row3 * 15).to(torch.int8)
    return q8.to(device), p4.to(device)


def _mask(kind, n, gen, device):
    if kind is None:
        return None
    if kind == "random":
        return (torch.rand(n, generator=gen) < 0.5).to(torch.uint8).to(device)
    m = torch.zeros(n, dtype=torch.uint8)
    m[torch.randperm(n, generator=gen)[:2]] = 1
    return m.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("n,n_true,qn,k,d", [
    (5000, 5000, 1, 10, 256),
    (4000, 3999, 8, 3, 256),
    (3000, 2901, 32, 64, 256),
    (2000, 1950, 3, 200, 64),
])
def test_kernels_match_plain_versions(cuda_device, n, n_true, qn, k, d, mask_kind):
    gen = torch.Generator().manual_seed(n + qn + k)
    q8, p4 = _data(gen, n, qn, cuda_device, d)
    mask = _mask(mask_kind, n, gen, cuda_device)
    sfx = "" if mask is None else "_masked"
    before = kernels.launch_counts()
    sims, bmax = i4.sims_max(q8, p4, n_true, mask)
    want_sims, want_max = i4.sims_max_reference(q8, p4, n_true, mask)
    assert torch.equal(sims, want_sims) and torch.equal(bmax, want_max)
    sub_max = i4.tilemax(q8, p4, n_true, mask)
    assert torch.equal(sub_max, i4.tilemax_reference(q8, p4, n_true, mask))
    kt = min(k, sub_max.shape[1])
    ids = top_subtiles(sub_max, kt)
    assert torch.equal(ids, select_subtiles(sub_max, kt))
    v, i = i4.rescan_topk(q8, p4, n_true, ids, k, mask)
    vr, ir = i4.rescan_topk_reference(q8, p4, n_true, ids, k, mask)
    assert torch.equal(v, vr) and torch.equal(i, ir)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("sims_max", "tilemax", "rescan_topk"):
        assert after[f"int4_{name}{sfx}"] == before[f"int4_{name}{sfx}"] + 1
    assert after["select_subtiles"] == before["select_subtiles"] + 1
    if mask is None:
        _, idx = i4.int4_topk_scan(q8.float(), p4, 1.0, k, n_true=n_true)
        assert idx[0, :3].tolist() == [3, 5, 127]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, "40"])
def test_deep_candidates_match_the_plain_path(cuda_device, monkeypatch, cap):
    """The kernel path and the plain path (CPU) give the same candidate
    sets, also past the cap, and a 40-query batch sweeps in chunks."""
    if cap:
        monkeypatch.setenv("SEMTOOLS_TPU_INT4_CAP", cap)
    gen = torch.Generator().manual_seed(7)
    q8, p4 = _data(gen, 6000, 40, cuda_device)
    mask = _mask("random", 6000, gen, cuda_device)
    q = q8.float()
    for m in (None, mask):
        got = i4.int4_deep_candidates(q, p4, n_true=5900, mask=m)
        want = i4.int4_deep_candidates(q.cpu(), p4.cpu(), n_true=5900,
                                       mask=None if m is None else m.cpu())
        assert got.shape == want.shape
        for g, w in zip(got.cpu().numpy(), want.numpy()):
            assert set(g[g < 5900].tolist()) == set(w[w < 5900].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("qn,k", [(8, 10), (32, 200)])
def test_phase2_at_chip_smoke_shapes(cuda_device, qn, k, mask_kind):
    """2M x 256 packed rows (chip_smoke.py phase 4), k up to 200 (whole
    sub-tiles taken): the selection and the rescan-and-merge kernels equal
    their plain versions bit for bit."""
    gen = torch.Generator().manual_seed(qn * k)
    n, n_true = 2_000_000, 1_999_223
    q8, p4 = _data(gen, n, qn, cuda_device)
    mask = _mask(mask_kind, n, gen, cuda_device)
    sub_max = i4.tilemax(q8, p4, n_true, mask)
    ids = top_subtiles(sub_max, k)
    assert torch.equal(ids, select_subtiles(sub_max, k))
    v, i = i4.rescan_topk(q8, p4, n_true, ids, k, mask)
    vr, ir = i4.rescan_topk_reference(q8, p4, n_true, ids, k, mask)
    assert torch.equal(v, vr) and torch.equal(i, ir)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    p4 = torch.zeros((600, 128), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="queries"):
        i4.sims_max(torch.zeros((33, 256), dtype=torch.int8, device=cuda_device), p4, 600)
    with pytest.raises(ValueError, match="shape mismatch"):
        i4.tilemax(torch.zeros((1, 128), dtype=torch.int8, device=cuda_device), p4, 600)
    with pytest.raises(ValueError, match="aligned"):
        i4.tilemax(torch.zeros((1, 48), dtype=torch.int8, device=cuda_device),
                   torch.zeros((600, 24), dtype=torch.int8, device=cuda_device), 600)
    np.testing.assert_equal(kernels.library().semtools_int4_sims_rows(), i4.SIMS_ROWS)


def _sweep(q8, p4, n_true, mask):
    from semtools_tpu_torch.ops.fused_scan import MAX_QUERIES

    nb = -(-n_true // i4.SIMS_ROWS)
    sims = torch.empty((q8.shape[0], nb * i4.SIMS_ROWS), device=p4.device)
    bmax = torch.empty((q8.shape[0], nb), device=p4.device)
    for q0 in range(0, q8.shape[0], MAX_QUERIES):
        sl = slice(q0, q0 + MAX_QUERIES)
        i4.sims_max(q8[sl].contiguous(), p4, n_true, mask, out=(sims[sl], bmax[sl]))
    return sims, bmax


def _same_sets(got, want, n):
    assert got.shape == want.shape
    for g, w in zip(got.cpu(), want.cpu()):
        assert torch.equal(g[g < n].sort().values, w[w < n].sort().values)


def _same_marks(got, want):
    """Equal counts and group totals, and equal masks wherever a block has a
    count (the kernel writes no other)."""
    assert torch.equal(got.counts, want.counts) and torch.equal(got.groups, want.groups)
    hit = want.counts > 0
    assert torch.equal(got.masks[hit], want.masks[hit])


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("qn,k_cut,cap", [(1, 10, None), (8, 10, 6), (40, 30, 3), (3, 12, 1)])
def test_selection_kernels_match_plain_versions(cuda_device, qn, k_cut, cap, mask_kind):
    """int4_cutoff_counts (every mode) and int4_extract_above against their
    plain versions on the same sweep: cutoffs bit-equal, counts and marks
    equal, under the cap the rows the marks give, row for row, past it
    (query 0's seven equal rows straddle it) the same candidate sets, the
    same tensor from a second call."""
    gen = torch.Generator().manual_seed(qn * k_cut)
    n, n_true = 6000, 5900
    q8, p4 = _data(gen, n, qn, cuda_device)
    mask = _mask(mask_kind, n, gen, cuda_device)
    sims, bmax = _sweep(q8, p4, n_true, mask)
    margin = i4.margin_on_device(q8)
    assert margin.item() == float(i4.cutoff_margin(q8))
    before = kernels.launch_counts()
    cutoff, count, n_blocks, marks = i4.select_cutoff(sims, bmax, margin, k_cut)
    want_c, want_n, want_b = i4.cutoff_counts(sims, bmax, margin, k_cut)
    assert torch.equal(cutoff.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(count, want_n) and torch.equal(n_blocks, want_b)
    _same_marks(marks, i4.marks_reference(sims, bmax, want_c))
    max_count, max_nb = i4.batch_maxima(count, n_blocks)
    size, n_b = i4.candidate_sizes(max_count, max_nb, n_true, bmax.shape[1])
    for c in (size, cap or size):
        got = i4.select_above(sims, bmax, cutoff, count, marks, n_b=n_b, cap=c,
                              max_count=max_count)
        _same_sets(got, i4.extract_above(sims, bmax, cutoff, n_b=n_b, cap=c), n_true)
        under = count <= c
        assert torch.equal(got[under], i4.marked_rows_reference(marks, c)[under])
        assert torch.equal(got, i4.select_above(sims, bmax, cutoff, count, marks, n_b=n_b,
                                                cap=c, max_count=max_count))
    tops = i4.block_tops(sims, bmax, k_cut)
    assert torch.equal(tops.sort(dim=1, descending=True).values,
                       i4.block_tops_reference(sims, bmax, k_cut))
    merged = torch.cat([tops, tops.flip(0)], dim=1)
    assert torch.equal(i4.tops_cutoff(merged, margin, k_cut),
                       i4.tops_cutoff_reference(merged, margin, k_cut))
    got_n, got_b, got_marks = i4.counts_above(sims, bmax, want_c)
    assert torch.equal(got_n, want_n) and torch.equal(got_b, want_b)
    _same_marks(got_marks, marks)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["int4_cutoff_counts"] == before["int4_cutoff_counts"] + 4
    assert after["int4_extract_above"] == before["int4_extract_above"] + 4


@pytest.mark.cuda
def test_quantization_and_margin_stay_on_the_card(cuda_device):
    """The device quantization and margin equal the numpy ones bit for bit
    on the card, and a deep-candidate call with its queries on the card
    synchronises once (the counts' maxima) and sorts nothing."""
    from semtools_tpu_torch.ops import int8_scan as i8

    gen = torch.Generator().manual_seed(3)
    q = torch.randn((8, 256), generator=gen)
    q[5] = 0.0
    q8, scale = i8.quantize_on_device(q.to(cuda_device))
    want, want_scale = i8.quantize_global(q.numpy())
    assert torch.equal(q8.cpu(), torch.from_numpy(want)) and scale.item() == want_scale
    assert i4.margin_on_device(q8).item() == float(i4.cutoff_margin(q8))
    _, p4 = _data(gen, 20000, 1, cuda_device)
    q = q.to(cuda_device)
    i4.int4_deep_candidates(q, p4)
    torch.cuda.synchronize()
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            i4.int4_deep_candidates(q, p4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, "4"])
@pytest.mark.parametrize("masked", [False, True])
def test_sharded_selection_on_four_shards(cuda_device, monkeypatch, masked, cap):
    """The sharded twin on 4 shards of the card, each shard running the
    selection kernels, gives the sets of the same twin on 4 CPU shards (the
    plain versions), under the cap and past it, and under it the single
    device's."""
    from semtools_tpu_torch.parallel import mesh as torch_mesh
    from semtools_tpu_torch.parallel import scan as sh

    if cap:
        monkeypatch.setenv("SEMTOOLS_TPU_INT4_CAP", cap)
    else:
        monkeypatch.delenv("SEMTOOLS_TPU_INT4_CAP", raising=False)
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "4")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    gen = torch.Generator().manual_seed(11)
    n = 9000
    q8, p4 = _data(gen, n, 8, cuda_device)
    mask = _mask("random", n, gen, cuda_device) if masked else None
    ids = {}
    for dev in ("cuda", "cpu"):
        mesh = torch_mesh.corpus_mesh(4, dev)
        p4s, _ = torch_mesh.shard_corpus(p4.to(dev), mesh, fill=i4.PACKED_ZERO_BYTE)
        ms = None if mask is None else torch_mesh.shard_rows(mask.to(dev), mesh)
        before = kernels.launch_counts()
        ids[dev] = sh.sharded_int4_deep_candidates_device(q8.float().to(dev), p4s, n, mask=ms)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        if dev == "cuda":
            assert after["int4_extract_above"] - before["int4_extract_above"] == 4
            # 4 tops, 1 merge, 4 counts
            assert after["int4_cutoff_counts"] - before["int4_cutoff_counts"] == 9
    assert ids["cuda"].shape == ids["cpu"].shape
    for g, w in zip(ids["cuda"].cpu(), ids["cpu"]):
        assert set(g[g < n].tolist()) == set(w[w < n].tolist())
    if cap is None:
        want = i4.int4_deep_candidates(q8.float(), p4, mask=mask)
        for g, w in zip(ids["cuda"].cpu(), want.cpu()):
            assert set(g[g < n].tolist()) == set(w[w < n].tolist())
