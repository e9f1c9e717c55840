"""``tests/test_model.py`` on the port: the fallback embedder, batch and
single encodes, the hash tokenizer, model2vec artifacts (safetensors,
word-level tokenizer, ``normalize``), the hub fetch and the fallback notice.

Every case also runs the JAX package's model on the same inputs: token ids
must be equal and embeddings within 1e-6 (``test_torch_embed.py``'s
tolerance), and the hub cases must make the same ``snapshot_download`` calls
and print the same notices. The hub is a stub module; nothing is fetched.
"""

import json
import struct

import numpy as np
import pytest

from semtools_tpu.models import static_model as jax_sm
from semtools_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from semtools_tpu_torch.models import static_model as sm
from semtools_tpu_torch.models.static_model import StaticModel
from semtools_tpu_torch.models.tokenizer import HashTokenizer

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def model():
    return StaticModel.fallback(device="cpu")


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def test_fallback_model_is_deterministic(fallback_model):
    m1 = StaticModel.fallback(device="cpu")
    m2 = StaticModel.fallback(device="cpu")
    v1 = m1.encode_single("the quick brown fox")
    v2 = m2.encode_single("the quick brown fox")
    np.testing.assert_array_equal(_np(v1), _np(v2))
    np.testing.assert_allclose(_np(v1), _np(fallback_model.encode_single("the quick brown fox")),
                               atol=ATOL)


def test_encode_batch_matches_single(model, fallback_model):
    texts = ["alpha", "beta gamma", "delta"]
    batch = _np(model.encode(texts))
    singles = np.stack([_np(model.encode_single(t)) for t in texts])
    np.testing.assert_allclose(batch, singles, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(batch, _np(fallback_model.encode(texts)), atol=ATOL)


def test_identical_texts_identical_embeddings(model, fallback_model):
    a, b = _np(model.encode(["same text here", "same text here"]))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, _np(fallback_model.encode(["same text here"]))[0], atol=ATOL)


def test_similar_words_closer_than_unrelated(model, fallback_model):
    # n-gram hashing makes morphological variants nearby
    def dists(m):
        q = _np(m.encode_single("database"))
        near = _np(m.encode_single("databases"))
        far = _np(m.encode_single("xylophone"))
        return 1 - float(q @ near), 1 - float(q @ far)

    d_near, d_far = dists(model)
    assert d_near < d_far
    np.testing.assert_allclose([d_near, d_far], dists(fallback_model), atol=1e-5)


def test_hash_tokenizer_bounds():
    tok = HashTokenizer(vocab_size=1024)
    ids = tok.encode("Hello, World! café 123")
    assert ids
    assert all(0 <= i < 1024 for i in ids)
    assert ids == JaxHashTokenizer(vocab_size=1024).encode("Hello, World! café 123")


def test_empty_text_embeds_to_zero(model, fallback_model):
    v = _np(model.encode_single(""))
    np.testing.assert_array_equal(v, np.zeros_like(v))
    np.testing.assert_array_equal(v, _np(fallback_model.encode_single("")))


def _write_safetensors(path, arrays):
    header = {}
    offset = 0
    blobs = []
    for name, arr in arrays.items():
        raw = arr.tobytes()
        header[name] = {
            "dtype": {"float32": "F32"}[str(arr.dtype)],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        offset += len(raw)
        blobs.append(raw)
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for b in blobs:
            f.write(b)


def _write_word_level_tokenizer(path, vocab):
    tok_json = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": {"type": "Lowercase"},
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None,
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "[UNK]"},
    }
    path.write_text(json.dumps(tok_json))


def test_model2vec_artifact_loading(tmp_path):
    """Load a synthetic model2vec-format artifact dir and verify the full
    tokenize->gather->mean->normalize pipeline against a hand computation."""
    vocab = {"[UNK]": 0, "hello": 1, "world": 2, "foo": 3}
    table = np.arange(4 * 8, dtype=np.float32).reshape(4, 8) + 1.0

    _write_safetensors(tmp_path / "model.safetensors", {"embeddings": table})
    _write_word_level_tokenizer(tmp_path / "tokenizer.json", vocab)
    (tmp_path / "config.json").write_text(json.dumps({"normalize": True}))

    model = StaticModel.from_pretrained(str(tmp_path))
    assert model.dim == 8
    got = _np(model.encode_single("Hello world"))
    want = (table[1] + table[2]) / 2.0
    want = want / np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jax_model = jax_sm.StaticModel.from_pretrained(str(tmp_path))
    assert jax_model.dim == model.dim
    np.testing.assert_allclose(got, _np(jax_model.encode_single("Hello world")), atol=ATOL)


def test_model2vec_normalize_false(tmp_path):
    vocab = {"[UNK]": 0, "x": 1}
    table = np.ones((2, 4), dtype=np.float32) * 3.0
    _write_safetensors(tmp_path / "model.safetensors", {"embeddings": table})
    _write_word_level_tokenizer(tmp_path / "tokenizer.json", vocab)
    (tmp_path / "config.json").write_text(json.dumps({"normalize": False}))

    model = StaticModel.from_pretrained(str(tmp_path))
    got = _np(model.encode_single("x"))
    np.testing.assert_allclose(got, table[1], rtol=1e-6)
    jax_got = _np(jax_sm.StaticModel.from_pretrained(str(tmp_path)).encode_single("x"))
    np.testing.assert_allclose(got, jax_got, atol=ATOL)


def test_missing_model_falls_back(tmp_path, capsys):
    model = StaticModel.from_pretrained("no/such-model-xyz")
    assert model.name.startswith("semtools-tpu/")
    assert "built-in deterministic embedder" in capsys.readouterr().err
    jax_model = jax_sm.StaticModel.from_pretrained("no/such-model-xyz")
    assert jax_model.name == model.name
    assert "built-in deterministic embedder" in capsys.readouterr().err


class TestHubFetch:
    """First-run hub download (model2vec's from_pretrained fetches the
    published model on first use) and the loud fallback notice, on both
    packages."""

    def _install_fake_hub(self, monkeypatch, tmp_path, fail=None, record=None):
        import sys
        import types

        tmp_path.mkdir(parents=True, exist_ok=True)
        snap = tmp_path / "snapshot"

        def snapshot_download(repo_id, token=None, allow_patterns=None, **kw):
            if record is not None:
                record.append({"repo_id": repo_id, "token": token,
                               "allow_patterns": allow_patterns})
            if fail is not None:
                raise fail
            snap.mkdir(exist_ok=True)
            vocab = {"[UNK]": 0, "hub": 1}
            table = np.zeros((2, 4), dtype=np.float32)
            table[1] = [1, 0, 0, 0]
            _write_safetensors(snap / "model.safetensors", {"embeddings": table})
            _write_word_level_tokenizer(snap / "tokenizer.json", vocab)
            return str(snap)

        mod = types.ModuleType("huggingface_hub")
        mod.snapshot_download = snapshot_download
        monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
        return snap

    def test_fetch_used_when_not_cached(self, monkeypatch, tmp_path, capsys):
        monkeypatch.delenv("SEMTOOLS_TPU_NO_FETCH", raising=False)
        monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_cache"))
        records = []
        for mod in (sm, jax_sm):
            record = []
            self._install_fake_hub(monkeypatch, tmp_path / mod.__name__, record=record)
            model = mod.StaticModel._from_pretrained_uncached(
                "acme/test-model", hf_token="tok-123"
            )
            assert model.name == "acme/test-model"
            got = _np(model.encode_single("hub"))
            np.testing.assert_allclose(got, [1, 0, 0, 0], atol=1e-6)
            assert record == [{
                "repo_id": "acme/test-model", "token": "tok-123",
                "allow_patterns": ["model.safetensors", "tokenizer.json", "config.json"],
            }]
            records.append(record)
        assert records[0] == records[1]

    def test_no_fetch_env_disables(self, monkeypatch, tmp_path, capsys):
        monkeypatch.setenv("SEMTOOLS_TPU_NO_FETCH", "1")
        for mod in (sm, jax_sm):
            record = []
            self._install_fake_hub(monkeypatch, tmp_path / mod.__name__, record=record)
            model = mod.StaticModel._from_pretrained_uncached("acme/test-model")
            assert model.name.startswith("semtools-tpu/")
            assert record == []

    def test_fetch_failure_falls_back_loudly(self, monkeypatch, tmp_path, capsys):
        monkeypatch.delenv("SEMTOOLS_TPU_NO_FETCH", raising=False)
        monkeypatch.delenv("SEMTOOLS_TPU_ALLOW_FALLBACK", raising=False)
        monkeypatch.setenv("HF_HOME", str(tmp_path / "empty_cache"))
        errs = []
        for mod in (sm, jax_sm):
            self._install_fake_hub(
                monkeypatch, tmp_path / mod.__name__, fail=ConnectionError("no route to host")
            )
            monkeypatch.setattr(mod, "_FALLBACK_WARNED", [False])
            capsys.readouterr()
            model = mod.StaticModel._from_pretrained_uncached("acme/test-model")
            assert model.name.startswith("semtools-tpu/")
            err = capsys.readouterr().err
            assert "no route to host" in err
            assert "WARNING" in err and "SURFACE similarity" in err
            # one-time: a second fallback in the same process stays quiet
            mod.StaticModel._from_pretrained_uncached("acme/test-model")
            assert "WARNING" not in capsys.readouterr().err
            errs.append(err)
        assert errs[0] == errs[1]

    def test_allow_fallback_acknowledges(self, monkeypatch, tmp_path, capsys):
        monkeypatch.setenv("SEMTOOLS_TPU_NO_FETCH", "1")
        monkeypatch.setenv("SEMTOOLS_TPU_ALLOW_FALLBACK", "1")
        errs = []
        for mod in (sm, jax_sm):
            monkeypatch.setattr(mod, "_FALLBACK_WARNED", [False])
            capsys.readouterr()
            model = mod.StaticModel._from_pretrained_uncached("no/such-model-xyz")
            assert model.name.startswith("semtools-tpu/")
            err = capsys.readouterr().err
            assert "WARNING" not in err
            assert "built-in deterministic embedder" in err
            errs.append(err)
        assert errs[0] == errs[1]

    def test_local_paths_never_fetch(self, monkeypatch, tmp_path):
        monkeypatch.delenv("SEMTOOLS_TPU_NO_FETCH", raising=False)
        for mod in (sm, jax_sm):
            record = []
            self._install_fake_hub(monkeypatch, tmp_path / mod.__name__, record=record)
            assert mod._fetch_from_hub(str(tmp_path / "some/dir"), None) is None
            assert mod._fetch_from_hub("bare-name", None) is None
            assert record == []
