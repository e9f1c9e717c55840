"""The probe kernels (``csrc/stream.cu``, ``csrc/probe_tilemax.cu``) against
their plain PyTorch versions, on a card.

Needs a CUDA card (the kernels have no CPU mode) and skips without one.
This file imports neither jax nor tests/conftest.py's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_probes_cuda.py -q

Sizes are small and ragged: the last tile is partial, and masked runs cut
it shorter still; int4 rows hold every byte value. Integer-valued variants
must be bit-equal to the plain version (exact products, sums below 2^24);
bf16 rows agree within 1e-5 (summation order).
"""

from __future__ import annotations

import zlib

import pytest
import torch

from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops import probes as pr

BF16_TOL = 1e-5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernels have no CPU mode")
    from semtools_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")


def _rows(storage, n, gen):
    """Stored rows of ``storage``, made on the CPU from ``gen``."""
    dtype, width = pr.STORAGES[storage]
    if storage == "bf16":
        e = torch.randn((n, pr.DIM), generator=gen)
        return (e / e.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    if storage == "int8":
        return torch.randint(-127, 128, (n, width), generator=gen, dtype=torch.int8)
    e = torch.randint(0, 256, (n, width), generator=gen, dtype=torch.uint8)
    # every byte value at every byte of a word: nibbles -8 and +7 in both
    # halves, in every shift of P4's and P5 native's unpack
    e[:256] = (torch.arange(width)[None, :] + torch.arange(256)[:, None]) % 256
    return e.view(dtype)


def _queries(storage, e, qn, gen):
    if storage == "bf16":
        return e[:qn].clone()
    return torch.randint(-127, 128, (qn, pr.DIM), generator=gen, dtype=torch.int8)


def _close(got, want, storage):
    assert got.shape == want.shape and got.dtype == want.dtype
    if storage == "bf16":
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert (got[fin] - want[fin]).abs().max().item() <= BF16_TOL
    else:
        assert torch.equal(got, want)


# (tile, sub_rows): a whole-tile max (two atomic spans a tile), 512-row
# sub-tiles (one store each), every row's sims; a column sum is per tile
SHAPES = [(4096, 4096), (1024, 512), (512, 1)]
PROBES = [(v, tile, sub) for v in sorted(pr.VARIANTS) for tile, sub in SHAPES
          if v[2] == "max" or sub == tile]
# the f32 dot also at P3's tile, in the three output shapes; P4 and P5
# native at their probes' own tiles (whole-tile maxima of 2,048 rows; 512-row
# sub-tiles of 8,192)
PROBES += [(("int8", "f32_dot", "max"), 8192, sub) for sub in (8192, 512, 1)]
PROBES += [(("int4_u8", "convert_bf16", "max"), 2048, 2048),
           (("int4_native", "convert_bf16", "max"), 8192, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,tile,sub_rows", PROBES,
                         ids=[f"{'-'.join(v)}-{t}-{s}" for v, t, s in PROBES])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("qn", [8, 3, 1])
def test_tilemax_probe_matches_plain(cuda_device, variant, tile, sub_rows, masked, qn):
    storage, recipe, reduce = variant
    gen = torch.Generator().manual_seed(zlib.crc32(repr((variant, tile, sub_rows, masked, qn))
                                                   .encode()))
    n = 3 * tile + 333  # ragged last tile
    e = _rows(storage, n, gen).to(cuda_device)
    q = _queries(storage, e, qn, gen).to(cuda_device)
    n_true = n - 400 if masked else None  # cuts into the third tile
    kw = dict(tile=tile, storage=storage, masked=masked, reduce=reduce, sub_rows=sub_rows)
    got = pr.tilemax_probe(q, e, n_true, recipe=recipe, **kw)
    torch.cuda.synchronize()
    want = pr.tilemax_probe_reference(q, e, n_true, **kw)
    _close(got, want, storage)


@pytest.mark.cuda
def test_floor_full_sims_at_the_probe_shape(cuda_device):
    """The floor scheme's full sims at the probe's own shape (8,192 rows,
    one tile, every row stored), against the plain version and the
    integer oracle."""
    from semtools_tpu_torch.probes import common, int4_unpack

    gen = common.generator(cuda_device)
    qv = int4_unpack.values(int4_unpack.CHECK_ROWS, gen, cuda_device)
    q8 = int4_unpack.queries(gen, cuda_device)
    case = int4_unpack.floor_case(qv, q8)
    assert torch.equal(case.fn(), case.plain())
    assert int4_unpack.floor_oracle_err(case, qv, q8) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sub_rows", [1, 512, 8192])
@pytest.mark.parametrize("rows,queries", [(127, 127), (-127, 127), (127, -127), ("mixed", "mixed")])
def test_f32_dot_at_the_extremes(cuda_device, rows, queries, sub_rows):
    """Rows and queries of +-127 only: every sum is +-4,129,024 (256 * 127^2,
    the largest a dot reaches) where both are constant, or any sum of 256
    such products; the kernel equals the plain version and the exact sums."""
    gen = torch.Generator().manual_seed(zlib.crc32(repr((rows, queries, sub_rows)).encode()))
    n = 2 * 8192 + 333

    def signs(value, shape):
        if value == "mixed":
            return (torch.randint(0, 2, shape, generator=gen, dtype=torch.int8) * 2 - 1) * 127
        return torch.full(shape, value, dtype=torch.int8)

    e = signs(rows, (n, pr.DIM)).to(cuda_device)
    q = signs(queries, (8, pr.DIM)).to(cuda_device)
    kw = dict(tile=8192, storage="int8", sub_rows=sub_rows)
    got = pr.tilemax_probe(q, e, recipe="f32_dot", **kw)
    torch.cuda.synchronize()
    _close(got, pr.tilemax_probe_reference(q, e, **kw), "int8")
    if sub_rows == 1:
        sims = (q.cpu().long() @ e.cpu().long().T).float()  # [Q, n], exact
        assert torch.equal(got.cpu().transpose(0, 1).reshape(8, -1)[:, :n], sims)
        if rows != "mixed":
            assert sims.abs().max().item() == 256 * 127 ** 2


@pytest.mark.cuda
def test_floor_full_sims_masked(cuda_device):
    """The floor scheme's full sims of 8,192 rows with the last 333 masked:
    bit-equal to the plain version and, on the kept rows, to the integer
    oracle (the masked ones -inf)."""
    from semtools_tpu_torch.probes import common, int4_unpack

    gen = common.generator(cuda_device)
    n = int4_unpack.CHECK_ROWS
    qv = int4_unpack.values(n, gen, cuda_device)
    q8 = int4_unpack.queries(gen, cuda_device)
    e = pr.pack_split_half(qv, biased=True)
    n_true = n - 333
    kw = dict(tile=n, storage="int4_floor", sub_rows=1, masked=True)
    got = pr.tilemax_probe(q8, e, n_true, recipe="convert_bf16", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, pr.tilemax_probe_reference(q8, e, n_true, **kw))
    qd, vd = q8.double(), qv.double()
    oracle = qd[:, : pr.HALF] @ (vd[:, : pr.HALF] + 8).T + qd[:, pr.HALF:] @ vd[:, pr.HALF:].T
    assert torch.equal(got[0, :, :n_true].double(), oracle[:, :n_true])
    assert torch.isneginf(got[0, :, n_true:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 1000, 2048])
def test_stream_tiles_matches_plain(cuda_device, tile):
    gen = torch.Generator().manual_seed(tile)
    e = _rows("int8", 5 * tile + 17, gen).to(cuda_device)  # rows past the last tile dropped
    got = pr.stream_tiles(e, tile, salt=-3)
    torch.cuda.synchronize()
    assert torch.equal(got, pr.stream_tiles_reference(e, tile, -3))


@pytest.mark.cuda
@pytest.mark.parametrize("stages", pr.RING_STAGES)
@pytest.mark.parametrize("stage_rows,n_use", [(16, 20_000), (64, 20_000), (48, 12_345)])
def test_stream_ring_matches_plain(cuda_device, stages, stage_rows, n_use):
    gen = torch.Generator().manual_seed(stages * 1000 + stage_rows)
    e = _rows("int8", 20_000, gen).to(cuda_device)
    got = pr.stream_ring(e, 11, stage_rows=stage_rows, stages=stages, n_use=n_use)
    torch.cuda.synchronize()
    assert torch.equal(got, pr.stream_ring_reference(e, 11, n_use))


@pytest.mark.cuda
def test_cuda_tensors_never_reach_a_plain_version(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("stream_tiles_reference", "stream_ring_reference", "tilemax_probe_reference"):
        monkeypatch.setattr(pr, name, refuse)
    gen = torch.Generator().manual_seed(0)
    e = _rows("int8", 4096, gen).to(cuda_device)
    q = _queries("int8", e, 8, gen).to(cuda_device)
    kernels.reset_launch_counts()
    pr.stream_tiles(e, 1024)
    pr.stream_ring(e, stage_rows=64, stages=2)
    for (storage, recipe, reduce), (_, counter) in pr.VARIANTS.items():
        rows = _rows(storage, 4096, gen).to(cuda_device)
        qs = _queries(storage, rows, 8, gen).to(cuda_device)
        pr.tilemax_probe(qs, rows, tile=1024, storage=storage, recipe=recipe, reduce=reduce)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["stream_tiles"] == 1 and counts["stream_ring"] == 1
    for _, counter in pr.VARIANTS.values():
        assert counts[counter] == 1, counter
    with pytest.raises(ValueError):  # mixed devices raise; nothing falls back
        pr.tilemax_probe(q.cpu(), e, tile=1024, storage="int8", recipe="int_dot")
