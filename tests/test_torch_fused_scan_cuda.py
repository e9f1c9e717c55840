"""The fused scan kernels against their plain PyTorch versions, on a card.

Needs a CUDA card (the kernels have no CPU mode) and skips without one.
This file imports neither jax nor tests/conftest.py's jax setup, so it runs
on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_scan_cuda.py -q

Sims agree rank by rank within 1e-5; indices must be equal except at ranks
where the plain version's neighbouring sims lie within 1e-5 (near-ties of
summation order; the last rank's neighbour is the plain version's k+1-th
value); planted duplicate rows resolve to the lower index.
"""

from __future__ import annotations

import pytest
import torch

from semtools_tpu_torch.ops import fused_scan as fs
from semtools_tpu_torch.ops import kernels

ATOL = 1e-5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernels have no CPU mode")
    from semtools_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")


def _unit(gen, n, d, device):
    x = torch.randn((n, d), generator=gen).to(device)
    return x / x.norm(dim=1, keepdim=True)


def _assert_ranks(got_v, got_i, want_v, want_i):
    """``want`` is the plain version at k + 1 ranks: its last value is the
    k-th rank's neighbour across the cut."""
    k = got_v.shape[-1]
    torch.testing.assert_close(got_v, want_v[..., :k], atol=ATOL, rtol=0)
    gap = (want_v[..., 1:] - want_v[..., :-1]).abs() <= ATOL
    near = torch.zeros_like(want_i, dtype=torch.bool)
    near[..., 1:] |= gap
    near[..., :-1] |= gap
    ok = (got_i == want_i[..., :k]) | near[..., :k] | ~torch.isfinite(want_v[..., :k])
    assert bool(ok.all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,n_true,qn,k", [
    (200_003, 200_003, 1, 10),
    (100_000, 99_777, 8, 10),
    (40_000, 39_001, 32, 64),
    (3000, 2999, 8, 3),
])
def test_kernels_match_plain_versions(cuda_device, dtype, n, n_true, qn, k):
    gen = torch.Generator().manual_seed(n + qn + k)
    e = _unit(gen, n, 256, cuda_device)
    dups = [5, fs.SUB_ROWS - 1, fs.SUB_ROWS, n_true - 1]
    e[dups[1:]] = e[5].clone()
    e = e.to(dtype)
    q = _unit(gen, qn, 256, cuda_device)
    q[0] = e[5].float()
    before = kernels.launch_counts()

    ref_max = fs.tilemax_reference(q, e, n_true)
    torch.testing.assert_close(fs.tilemax(q, e, n_true), ref_max, atol=ATOL, rtol=0)
    kt = min(k, ref_max.shape[1])
    ids = fs.top_subtiles(ref_max, kt)
    assert torch.equal(ids, fs.select_subtiles(ref_max, kt))
    _assert_ranks(*fs.rescan_topk(q, e, n_true, ids, k),
                  *fs.rescan_topk_reference(q, e, n_true, ids, k + 1))
    _assert_ranks(*fs.scan_candidates(q, e, n_true, k),
                  *fs.scan_candidates_reference(q, e, n_true, k + 1))
    after = kernels.launch_counts()
    assert all(after[name] == before[name] + 1 for name in (
        "fused_tilemax", "select_subtiles", "fused_rescan_topk", "fused_scan_candidates"))

    d, i = fs.fused_topk_scan(q, e, k, n_true=n_true)
    want = dups[: min(k, len(dups))]
    assert i[0, : len(want)].tolist() == want


def _tied_maxima(gen, qn, s, device):
    """Sub-tile maxima as phase 1 gives them at s sub-tiles, with each
    query's best value in 12 sub-tiles, integer-valued rows and -inf runs."""
    m = torch.randn((qn, s), generator=gen)
    m[:, torch.randperm(s, generator=gen)[:12]] = m.max() + 1
    m[qn // 2] = m[qn // 2].round()
    m[:, 100:900] = float("-inf")
    return m.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("qn,s,kt", [
    (1, 15_625, 10),    # 2M rows of 128, chip_smoke.py phase 2
    (8, 78_125, 10),    # 10M rows, phases 3-4
    (32, 78_125, 64),
    (40 - 32, 78_125, 200),  # the second launch of int4's Q = 40, k = 200
    (3, 3000, 3000),    # every sub-tile
])
def test_selection_kernel_matches_its_plain_version(cuda_device, qn, s, kt):
    m = _tied_maxima(torch.Generator().manual_seed(s + kt), qn, s, cuda_device)
    before = kernels.launch_counts()["select_subtiles"]
    got = fs.top_subtiles(m, kt)
    assert torch.equal(got, fs.select_subtiles(m, kt))
    assert kernels.launch_counts()["select_subtiles"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qn,k", [(1, 10), (8, 10), (32, 64), (8, 128)])
def test_rescan_topk_at_chip_smoke_shapes(cuda_device, dtype, qn, k):
    """2M x 256 rows (chip_smoke.py phase 2) with duplicates of query 0's
    best row in several sub-tiles: the kernel's [Q, k] against the plain
    rescan and merge on the same sub-tiles, ranks as above."""
    gen = torch.Generator().manual_seed(qn + k)
    n, n_true = 2_000_000, 1_999_223
    e = _unit(gen, n, 256, cuda_device)
    dups = [5, 127, 128, 70_000, n_true - 1]
    e[dups[1:]] = e[5].clone()
    e = e.to(dtype)
    q = _unit(gen, qn, 256, cuda_device)
    q[0] = e[5].float()
    sub_max = fs.tilemax(q, e, n_true)
    ids = fs.top_subtiles(sub_max, k)
    _assert_ranks(*fs.rescan_topk(q, e, n_true, ids, k),
                  *fs.rescan_topk_reference(q, e, n_true, ids, k + 1))
    d, i = fs._two_phase_topk(q, e, n_true, min(k, 5))
    assert i[0].tolist()[:5] == dups[: min(k, 5)]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    e = torch.zeros((512, 256), device=cuda_device)
    q = torch.zeros((2, 256), device=cuda_device)
    with pytest.raises(TypeError):
        fs.tilemax(q.double(), e, 512)
    with pytest.raises(ValueError):  # 254 f32 = 1016-byte rows: not 16-byte aligned
        fs.tilemax(q[:, :254].contiguous(), e[:, :254].contiguous(), 512)
    with pytest.raises(ValueError):  # not contiguous
        fs.tilemax(q, torch.zeros((256, 512), device=cuda_device).t(), 512)
    with pytest.raises(ValueError):
        fs.tilemax(torch.zeros((33, 256), device=cuda_device), e, 512)
    with pytest.raises(ValueError):
        fs.scan_candidates(q, e, 513, 3)
    with pytest.raises(ValueError):
        fs.tilemax(q, e.cpu(), 512)
