"""The int8 scan kernels against their plain PyTorch versions, on a card.

Needs a CUDA card (the kernels have no CPU mode) and skips without one.
This file imports neither jax nor tests/conftest.py's jax setup, so it runs
on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_scan_cuda.py -q

The arithmetic is integer, so sims must be equal rank by rank and indices
equal wherever the sims are finite (no near-tie allowance); planted
duplicate rows resolve to the lower index.
"""

from __future__ import annotations

import pytest
import torch

from semtools_tpu_torch.ops import int8_scan as i8
from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops.fused_scan import select_subtiles, top_subtiles


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 kernels have no CPU mode")
    from semtools_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")


def _data(gen, n, qn, device):
    e = torch.randn((n, 256), generator=gen).to(device)
    e /= e.norm(dim=1, keepdim=True)
    for dup in (5, 127, 128, n // 2, n - 2):
        e[dup] = e[3]
    q = torch.randn((qn, 256), generator=gen).to(device)
    q[0] = e[3]
    return i8.quantize_global(q)[0], i8.quantize_global(e)[0]


def _mask(kind, n, k, gen, device):
    if kind is None:
        return None
    if kind == "random":
        return (torch.rand(n, generator=gen) < 0.5).to(torch.uint8).to(device)
    m = torch.zeros(n, dtype=torch.uint8)
    m[torch.randperm(n, generator=gen)[: k // 2]] = 1
    return m.to(device)


def _assert_equal(got_v, got_i, want_v, want_i):
    assert torch.equal(got_v, want_v)
    fin = torch.isfinite(want_v)
    assert torch.equal(got_i[fin], want_i[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("n,n_true,qn,k", [
    (5000, 5000, 1, 10),
    (4000, 3999, 8, 3),
    (3000, 2901, 32, 64),
])
def test_kernels_match_plain_versions(cuda_device, n, n_true, qn, k, mask_kind):
    gen = torch.Generator().manual_seed(n + qn + k)
    q8, e8 = _data(gen, n, qn, cuda_device)
    mask = _mask(mask_kind, n, k, gen, cuda_device)
    before = kernels.launch_counts()
    sub_max = i8.tilemax(q8, e8, n_true, mask)
    assert torch.equal(sub_max, i8.tilemax_reference(q8, e8, n_true, mask))
    ids = top_subtiles(sub_max, min(k, sub_max.shape[1]))
    assert torch.equal(ids, select_subtiles(sub_max, min(k, sub_max.shape[1])))
    v, i = i8.rescan_topk(q8, e8, n_true, ids, k, mask)
    vr, ir = i8.rescan_topk_reference(q8, e8, n_true, ids, k, mask)
    _assert_equal(v, i, vr, ir)
    assert torch.equal(i, ir)  # -inf filler too: the rows not kept, lowest first
    torch.cuda.synchronize()
    suffix = "" if mask is None else "_masked"
    after = kernels.launch_counts()
    assert after[f"int8_tilemax{suffix}"] == before[f"int8_tilemax{suffix}"] + 1
    assert after[f"int8_rescan_topk{suffix}"] == before[f"int8_rescan_topk{suffix}"] + 1
    assert after["select_subtiles"] == before["select_subtiles"] + 1
    d, idx = i8.int8_topk_scan(q8.float(), e8, 1.0, k, n_true=n_true, mask=mask)
    if mask is None and k >= 3:
        assert idx[0, :3].tolist() == [3, 5, 127]


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "random", "few"])
@pytest.mark.parametrize("qn,k", [(1, 3), (8, 10), (32, 64)])
def test_phase2_at_chip_smoke_shapes(cuda_device, qn, k, mask_kind):
    """2M x 256 int8 rows (chip_smoke.py phase 3): the selection and the
    rescan-and-merge kernels equal their plain versions bit for bit, and the
    whole two-phase scan runs phase 1 and then exactly those two launches."""
    gen = torch.Generator().manual_seed(qn * k)
    n, n_true = 2_000_000, 1_999_223
    q8, e8 = _data(gen, n, qn, cuda_device)
    mask = _mask(mask_kind, n, k, gen, cuda_device)
    sub_max = i8.tilemax(q8, e8, n_true, mask)
    ids = top_subtiles(sub_max, k)
    assert torch.equal(ids, select_subtiles(sub_max, k))
    v, i = i8.rescan_topk(q8, e8, n_true, ids, k, mask)
    vr, ir = i8.rescan_topk_reference(q8, e8, n_true, ids, k, mask)
    assert torch.equal(v, vr) and torch.equal(i, ir)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    sims, idx = i8.int8_two_phase(q8, e8, n_true, k, mask)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert sum(after.values()) - sum(before.values()) == 3
    assert torch.equal(sims, vr) and torch.equal(idx, ir)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    e8 = torch.zeros((300, 256), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="queries"):
        i8.tilemax(torch.zeros((33, 256), dtype=torch.int8, device=cuda_device), e8, 300)
    with pytest.raises(TypeError, match="int8"):
        i8.tilemax(torch.zeros((1, 256), dtype=torch.float32, device=cuda_device), e8, 300)
    with pytest.raises(ValueError, match="aligned"):
        i8.tilemax(torch.zeros((1, 40), dtype=torch.int8, device=cuda_device),
                   torch.zeros((300, 40), dtype=torch.int8, device=cuda_device), 300)
