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
