"""The int4 tier probe's kernels against their plain versions, on a card.

``semtools_tpu_torch.probes.int4_tier`` runs K5 (``int4_tilemax``,
``select_subtiles``, ``int4_rescan_topk``) at depths up to 1,024 and the
deep-candidate path (``int4_sims_max``, ``select_subtiles``,
``int4_cutoff_counts``, ``int4_extract_above``) at 4 and 6 sigmas on its
clustered corpus; here both run on that corpus at 262,144 rows, 8 queries.
Needs a CUDA card (the kernels have no CPU mode) and skips without one;
imports neither jax nor tests/conftest.py's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_int4_tier_cuda.py -q

The arithmetic is integer, so every tolerance is zero: K5's sims and rows
equal the plain phases' rank by rank, the candidate sets equal the plain
selection's, and the corpus and its oracle are made alike twice.
"""

from __future__ import annotations

import pytest
import torch

from semtools_tpu_torch.ops import int4_scan as i4
from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops.fused_scan import select_subtiles
from semtools_tpu_torch.ops.int8_scan import quantize_global
from semtools_tpu_torch.probes import int4_tier

N = 1 << 18


@pytest.fixture(scope="module")
def tier():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int4 kernels have no CPU mode")
    from semtools_tpu_torch.utils.platform import resolve_device

    corpus = int4_tier.build(N, resolve_device("cuda"))
    q8 = quantize_global(corpus.qs[:8])[0].contiguous()
    return corpus, q8, i4.tilemax_reference(q8, corpus.p4, N)


@pytest.mark.cuda
def test_build_is_made_alike_twice(tier):
    corpus = tier[0]
    again = int4_tier.build(N, corpus.p4.device)
    assert torch.equal(again.p4, corpus.p4) and torch.equal(again.qs, corpus.qs)
    assert again.scale == corpus.scale and (again.oracle == corpus.oracle).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 256, 1024])
def test_two_phase_at_depth(tier, k):
    corpus, q8, sub = tier
    kernels.reset_launch_counts()
    sims, idx = i4.int4_two_phase(q8, corpus.p4, N, k)
    launched = kernels.launch_counts()
    assert all(launched.get(name) for name in ("int4_tilemax", "select_subtiles",
                                               "int4_rescan_topk")), launched
    want_s, want_i = i4.rescan_topk_reference(
        q8, corpus.p4, N, select_subtiles(sub, min(k, sub.shape[1])), k)
    assert torch.equal(sims, want_s) and torch.equal(idx, want_i)
    _, rows = i4.int4_topk_scan(corpus.qs[:8], corpus.p4, corpus.scale, k, n_true=N)
    assert torch.equal(rows, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", int4_tier.SIGMAS)
def test_deep_candidates(tier, sigma):
    corpus, q8, _ = tier
    kernels.reset_launch_counts()
    got = i4.int4_deep_candidates(corpus.qs[:8], corpus.p4, n_true=N, margin_sigmas=sigma)
    launched = kernels.launch_counts()
    assert all(launched.get(name) for name in ("int4_sims_max", "select_subtiles",
                                               "int4_cutoff_counts", "int4_extract_above"))
    want = i4.select_candidates_reference(q8, *i4.sims_max_reference(q8, corpus.p4, N), N,
                                          margin_sigmas=sigma)
    assert got.shape == want.shape
    for r in range(got.shape[0]):
        g, w = got[r][got[r] < N].sort().values, want[r][want[r] < N].sort().values
        assert torch.equal(g, w), r
