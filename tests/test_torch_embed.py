"""The port's tokenizers and embed op against the JAX package's.

Same numpy table and token lists through both packages'
``embed_token_lists`` and the JAX package's numpy reference: atol 1e-6
(f32 sums of a few dozen rows in another order; observed ~1e-7). Token ids
of the copied HashTokenizer must be identical, ASCII (native C++ fast path)
and non-ASCII (Python path) alike.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from semtools_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from semtools_tpu.ops.embed import embed_token_lists as jax_embed
from semtools_tpu.ops.embed import embed_token_lists_reference
from semtools_tpu_torch.models.tokenizer import HashTokenizer
from semtools_tpu_torch.ops import embed

FIXTURE = Path(__file__).parent / "fixtures" / "potion_mini"
ATOL = 1e-6

TEXTS = [
    "the quick brown fox",
    "",
    "An essay about DATABASES, indexes & query planners!",
    "naïve café résumé — ünïcödé 東京",
    "x",
    "   ",
    "tabs\tand\r\nnewlines",
]


def test_hash_tokenizer_ids_match_jax_package():
    ours, theirs = HashTokenizer(vocab_size=1 << 16), JaxHashTokenizer(vocab_size=1 << 16)
    got = [list(map(int, ids)) for ids in ours.encode_batch(TEXTS)]
    want = [list(map(int, ids)) for ids in theirs.encode_batch(TEXTS)]
    assert got == want
    assert [ours.encode(t) for t in TEXTS] == [theirs.encode(t) for t in TEXTS]
    assert got[1] == [] and len(got[3]) > 0


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("max_length", [2048, 3])
def test_embed_matches_jax_and_reference(normalize, max_length):
    rng = np.random.default_rng(7)
    table = rng.standard_normal((512, 24)).astype(np.float32)
    lists = [list(rng.integers(0, 512, size=n)) for n in (5, 0, 1, 17, 0, 40, 3)]
    want = embed_token_lists_reference(table, lists, max_length=max_length, normalize=normalize)
    jax_out = np.asarray(jax_embed(table, lists, max_length=max_length, normalize=normalize))
    got = embed.embed_token_lists(torch.from_numpy(table), lists, max_length=max_length,
                                  normalize=normalize).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, jax_out, atol=ATOL, rtol=0)
    assert not got[1].any() and not got[4].any()  # empty lines embed to zero


def test_embed_chunking_and_empty_inputs(monkeypatch):
    rng = np.random.default_rng(8)
    table = rng.standard_normal((100, 8)).astype(np.float32)
    lists = [rng.integers(0, 100, size=n).astype(np.int32) for n in rng.integers(0, 9, 50)]
    whole = embed.embed_token_lists(torch.from_numpy(table), lists)
    monkeypatch.setattr(embed, "MAX_TOKENS_PER_CALL", 16)
    monkeypatch.setattr(embed, "MAX_TEXTS_PER_CALL", 7)
    chunked = embed.embed_token_lists(torch.from_numpy(table), lists)
    torch.testing.assert_close(chunked, whole, atol=ATOL, rtol=0)
    assert embed.embed_token_lists(torch.from_numpy(table), []).shape == (0, 8)
    assert not embed.embed_token_lists(torch.from_numpy(table), [[], []]).any()


def test_fallback_model_encodes_like_jax_package(fallback_model):
    from semtools_tpu_torch.models.static_model import StaticModel

    ours = StaticModel.fallback(device="cpu")
    np.testing.assert_array_equal(ours.table.numpy(), fallback_model.table_np)
    got = ours.encode(TEXTS).numpy()
    np.testing.assert_allclose(got, np.asarray(fallback_model.encode(TEXTS)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours.encode_single(TEXTS[0]).numpy(), got[0], atol=ATOL, rtol=0)


def test_potion_fixture_goldens():
    pytest.importorskip("tokenizers")
    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.models.tokenizer import HFTokenizer

    goldens = np.load(FIXTURE / "goldens.npz", allow_pickle=True)
    texts = list(goldens["texts"])
    tok = HFTokenizer(str(FIXTURE / "tokenizer.json"))
    for i, ids in enumerate(tok.encode_batch(texts)):
        assert list(ids) == goldens["ids"][i][: goldens["lengths"][i]].tolist()
    model = StaticModel._from_pretrained_uncached(str(FIXTURE), device="cpu")
    assert isinstance(model.tokenizer, HFTokenizer) and model.dim == 64
    got = model.encode(texts, max_length=2048).numpy()
    # 3e-6, as tests/test_model_golden.py: the goldens were pooled by numpy
    np.testing.assert_allclose(got, goldens["emb_norm"], rtol=0, atol=3e-6)
