"""``tests/test_model_golden.py`` on the port: the real-model path
(``tests/fixtures/potion_mini``, a model2vec artifact with a Unigram
tokenizer) against its committed goldens: token ids exact, embeddings within
3e-6 of the numpy goldens, the normalize override, truncation, a search
through the real model, the bf16 safetensors branch, and the CLI resolving
``SEMTOOLS_TPU_MODEL_DIR``.

The goldens are an exact oracle for ids and embeddings. Each case also runs
the JAX package's model on the same texts: ids equal, embeddings within 1e-6
(``test_torch_embed.py``'s tolerance), the search's lines equal, distances
within 1e-5, and the CLI's text equal once distances are set apart (as in
``test_torch_search_cli.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from semtools_tpu.models import static_model as jax_sm
from semtools_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer

FIXTURE = Path(__file__).parent / "fixtures" / "potion_mini"
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def goldens():
    return np.load(FIXTURE / "goldens.npz", allow_pickle=True)


@pytest.fixture(scope="module")
def model():
    from semtools_tpu_torch.models.static_model import StaticModel

    return StaticModel._from_pretrained_uncached(str(FIXTURE), device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    return jax_sm.StaticModel._from_pretrained_uncached(str(FIXTURE))


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def test_artifact_dir_resolves_real_model(model, jax_model):
    from semtools_tpu_torch.models.tokenizer import HFTokenizer

    assert isinstance(model.tokenizer, HFTokenizer)
    assert model.normalize is True  # from config.json
    assert model.dim == 64
    assert model.name == str(FIXTURE)
    assert (model.normalize, model.dim, model.name) == \
        (jax_model.normalize, jax_model.dim, jax_model.name)


def test_hf_tokenizer_ids_exact(goldens):
    from semtools_tpu_torch.models.tokenizer import HFTokenizer

    tok = HFTokenizer(str(FIXTURE / "tokenizer.json"))
    texts = list(goldens["texts"])
    ids = tok.encode_batch(texts)
    for i, got in enumerate(ids):
        want = goldens["ids"][i][: goldens["lengths"][i]].tolist()
        assert list(got) == want, f"ids diverge for line {i}: {texts[i]!r}"
    # single-encode agrees with batch
    assert tok.encode(texts[0]) == list(ids[0])
    # <unk> handling: fully OOV soup still produces ids within the vocab
    oov = ids[texts.index("zzzzqqqq xxxyyy unseen-token-soup")]
    assert len(oov) > 0
    assert all(0 <= t < tok.vocab_size for t in oov)
    jax_ids = JaxHFTokenizer(str(FIXTURE / "tokenizer.json")).encode_batch(texts)
    assert [list(map(int, x)) for x in ids] == [list(map(int, x)) for x in jax_ids]


def test_encode_matches_goldens_normalized(model, jax_model, goldens):
    texts = list(goldens["texts"])
    got = _np(model.encode(texts, max_length=2048))
    np.testing.assert_allclose(got, goldens["emb_norm"], rtol=0, atol=3e-6)
    # normalized rows are unit (or zero for the empty line)
    norms = np.linalg.norm(got, axis=1)
    empty_i = texts.index("")
    assert norms[empty_i] == 0.0
    keep = np.ones(len(texts), bool)
    keep[empty_i] = False
    np.testing.assert_allclose(norms[keep], 1.0, atol=1e-5)
    np.testing.assert_allclose(got, _np(jax_model.encode(texts, max_length=2048)), atol=ATOL)


def test_encode_single_matches_batch(model, jax_model, goldens):
    texts = list(goldens["texts"])
    single = _np(model.encode_single(texts[1]))
    np.testing.assert_allclose(single, goldens["emb_norm"][1], atol=1e-6)
    np.testing.assert_allclose(single, _np(jax_model.encode_single(texts[1])), atol=ATOL)


def test_normalize_override_false(goldens):
    from semtools_tpu_torch.models.static_model import StaticModel

    raw_model = StaticModel._from_pretrained_uncached(
        str(FIXTURE), normalize_override=False, device="cpu"
    )
    texts = list(goldens["texts"])
    got = _np(raw_model.encode(texts, max_length=2048))
    np.testing.assert_allclose(got, goldens["emb_raw"], rtol=0, atol=1e-6)
    jax_raw = jax_sm.StaticModel._from_pretrained_uncached(str(FIXTURE), normalize_override=False)
    np.testing.assert_allclose(got, _np(jax_raw.encode(texts, max_length=2048)), atol=ATOL)


def test_truncation_at_max_length(model, jax_model, goldens):
    text = str(goldens["trunc_text"][0])
    limit = int(goldens["trunc_max_length"])
    assert int(goldens["trunc_len"]) == limit  # the line exceeds the limit

    got = _np(model.encode([text], max_length=limit))
    np.testing.assert_allclose(got, goldens["emb_trunc"], atol=1e-6)
    # and differs from the untruncated embedding (so the limit is real)
    full = _np(model.encode([text], max_length=2048))
    assert not np.allclose(got, full, atol=1e-4)
    np.testing.assert_allclose(got, _np(jax_model.encode([text], max_length=limit)), atol=ATOL)


def test_search_pipeline_with_real_model(model, jax_model):
    """End-to-end: the real-artifact model drives the search core and the
    nearest line is the exact-match line (distance ~0)."""
    from semtools_tpu import search as jax_search
    from semtools_tpu_torch import search as torch_search

    lines = [
        "the quick brown fox jumps over the lazy dog",
        "attention mechanisms in transformer models",
        "semantic search over large document corpora",
    ]

    def run(S, m):
        embs = m.encode(lines, max_length=2048)
        doc = S.Document(filename="f.txt", lines=lines, embeddings=embs)
        q = m.encode_single("attention mechanisms in transformer models")
        return S.search_documents([doc], q, S.SearchConfig(top_k=1, n_lines=0))

    results = run(torch_search, model)
    assert results[0].start == 1
    assert results[0].distance < 1e-5
    want = run(jax_search, jax_model)
    assert [(r.start, r.end, r.lines) for r in results] == [(r.start, r.end, r.lines) for r in want]
    np.testing.assert_allclose([r.distance for r in results], [r.distance for r in want],
                               atol=1e-5)


def test_bf16_safetensors_roundtrip(tmp_path):
    """_read_safetensors' BF16 branch against a real torch-written file."""
    import torch
    from safetensors.torch import save_file

    from semtools_tpu_torch.models.static_model import _read_safetensors

    t = torch.randn(17, 8, dtype=torch.float32)
    save_file({"embeddings": t.to(torch.bfloat16)}, str(tmp_path / "m.safetensors"))
    got = _read_safetensors(str(tmp_path / "m.safetensors"))["embeddings"]
    want = t.to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_sm._read_safetensors(str(tmp_path / "m.safetensors"))["embeddings"])


def test_cli_resolves_model_dir_env(tmp_path, monkeypatch, capsys):
    """SEMTOOLS_TPU_MODEL_DIR drives the full CLI with the real-artifact
    model: no fallback notice, real tokenizer ids behind the search."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_TPU_MODEL_DIR", str(FIXTURE))
    # fresh resolution (the memo may hold the fallback from other tests)
    from semtools_tpu_torch.models import static_model

    monkeypatch.setattr(static_model, "_MODEL_CACHE", {})
    monkeypatch.setattr(jax_sm, "_MODEL_CACHE", {})
    f = tmp_path / "a.txt"
    f.write_text(
        "the quick brown fox jumps over the lazy dog\n"
        "attention mechanisms in transformer models\n"
    )
    from semtools_tpu.cli import main as jax_main
    from semtools_tpu_torch.cli import main

    argv = ["search", "attention mechanisms", str(f), "--top-k", "1", "-n", "0"]
    capsys.readouterr()
    assert main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "attention mechanisms in transformer models" in out.out
    assert "built-in deterministic embedder" not in out.err
    assert jax_main(argv) == 0
    jax_out = capsys.readouterr().out

    def split(text):
        head, _, rest = text.partition(" (")
        dist, _, body = rest.partition(")")
        return head, float(dist), body

    (h, d, b), (hj, dj, bj) = split(out.out), split(jax_out)
    assert (h, b) == (hj, bj)
    assert abs(d - dj) < 1e-5
