"""Tokenizers for static embedding models.

A copy of ``semtools_tpu/models/tokenizer.py``: the port imports nothing of
the JAX package, and the ids must stay identical (pinned by
tests/test_torch_embed.py). The
native fast path loads through ``semtools_tpu_torch.utils.native``.

Two implementations share one interface (``encode_batch(texts) -> list of
id-lists``):

- :class:`HFTokenizer` wraps a HuggingFace ``tokenizers`` file
  (``tokenizer.json``) for model2vec-format artifacts such as
  minishlab/potion-multilingual-128M — the model the reference loads at
  src/search/mod.rs:16. Tokenization runs on host; only the integer ids
  cross to the device.
- :class:`HashTokenizer` is the hermetic fallback used when no model
  artifacts are on disk (this build environment has no network egress).
  It maps words and character n-grams onto a fixed hashed vocabulary,
  fastText-style, so the built-in model is fully deterministic and needs
  no downloaded files.
"""

from __future__ import annotations

import ctypes
import re
from typing import List, Sequence

from semtools_tpu_torch.utils.hashing import fnv1a_64

_WORD_RE = re.compile(r"[\w]+|[^\w\s]", re.UNICODE)


def _native_encode_ascii_batch(texts: Sequence[str], vocab_size: int,
                               ngram_min: int, ngram_max: int) -> List[List[int]]:
    """Encode ASCII-only texts via the C++ fast path (cpp/hashtok.cpp).

    Byte-for-byte parity with the Python implementation is unit-tested;
    non-ASCII texts must not reach this function (Unicode word/space
    classes differ from the ASCII ones the native scanner uses).
    """
    import numpy as np

    from semtools_tpu_torch.utils import native

    lib = native.load()
    assert lib is not None
    blob = "".join(texts).encode("ascii")
    offsets = (ctypes.c_longlong * (len(texts) + 1))()
    pos = 0
    for i, t in enumerate(texts):
        offsets[i] = pos
        pos += len(t)
    offsets[len(texts)] = pos

    out_offsets = (ctypes.c_longlong * (len(texts) + 1))()
    cap = max(1, pos * 4)  # ids per char is ~ngram count; grow on overflow
    while True:
        out_ids = (ctypes.c_uint32 * cap)()
        n = lib.hashtok_encode_batch(
            blob, offsets, len(texts), vocab_size, ngram_min, ngram_max,
            out_ids, cap, out_offsets,
        )
        if n < 0:
            raise RuntimeError(f"hashtok_encode_batch failed (code {n})")
        if n <= cap:
            break
        cap = n
    # One bulk copy out of the ctypes buffer, then per-text views — never
    # materialize millions of Python ints (the marshalling would cost more
    # than the tokenization itself).
    arr = np.frombuffer(out_ids, dtype=np.uint32, count=int(n)).astype(np.int32)
    return [
        arr[int(out_offsets[i]):int(out_offsets[i + 1])]
        for i in range(len(texts))
    ]


class HashTokenizer:
    """Deterministic hashed-vocabulary tokenizer.

    Every word contributes its own hash id plus ids for its character
    n-grams (with boundary markers), giving sub-word robustness to typos
    and morphology. Ids land in ``[0, vocab_size)`` via modulo.
    """

    def __init__(self, vocab_size: int = 1 << 16, ngram_min: int = 3, ngram_max: int = 4):
        self.vocab_size = vocab_size
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max

    def _word_ids(self, word: str) -> List[int]:
        ids = [fnv1a_64(word.encode("utf-8")) % self.vocab_size]
        if len(word) > self.ngram_min:
            marked = f"<{word}>"
            for n in range(self.ngram_min, self.ngram_max + 1):
                for i in range(len(marked) - n + 1):
                    gram = marked[i : i + n]
                    ids.append(fnv1a_64(("#" + gram).encode("utf-8")) % self.vocab_size)
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_RE.findall(text.lower()):
            ids.extend(self._word_ids(word))
        return ids

    def _encode_py_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Batch encode; ASCII texts take the native C++ path when built.

        Non-ASCII texts go through the Python implementation (its Unicode
        word/space classes are the source of truth), so ids are identical
        with or without the native library. Native results are int32
        numpy arrays (python fallback returns lists); downstream flatten
        code handles both.
        """
        from semtools_tpu_torch.utils import native

        if not texts or not native.available():
            return self._encode_py_batch(texts)
        ascii_idx = [i for i, t in enumerate(texts) if t.isascii()]
        if not ascii_idx:
            return self._encode_py_batch(texts)
        native_out = _native_encode_ascii_batch(
            [texts[i] for i in ascii_idx],
            self.vocab_size, self.ngram_min, self.ngram_max,
        )
        out: List[List[int]] = [None] * len(texts)  # type: ignore[list-item]
        for i, ids in zip(ascii_idx, native_out):
            out[i] = ids
        for i, t in enumerate(texts):
            if out[i] is None:
                out[i] = self.encode(t)
        return out


class HFTokenizer:
    """Wrapper around a HuggingFace ``tokenizers`` tokenizer.json file."""

    def __init__(self, tokenizer_file: str):
        from tokenizers import Tokenizer  # lazy: only needed for real artifacts

        self._tok = Tokenizer.from_file(tokenizer_file)
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        encodings = self._tok.encode_batch(list(texts), add_special_tokens=False)
        return [e.ids for e in encodings]
