"""``tests/test_native.py`` on the port: the native library the port builds
from ``cpp/`` into its own ``_build/`` (``grepscan.cpp``, ``hashtok.cpp``)
against the Python fallbacks it accelerates, on randomized and edge-case
inputs. The fallbacks are the exact oracle; every case also holds the
port's answers equal to the JAX package's native library on the same inputs
(line numbers and token ids equal). Skips when no C++ toolchain builds the
library (decided in a fixture, not at import).
"""

from __future__ import annotations

import random
import re
import string

import pytest

from semtools_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from semtools_tpu.utils import grepscan as jax_grepscan
from semtools_tpu_torch.models.tokenizer import HashTokenizer, _native_encode_ascii_batch
from semtools_tpu_torch.utils import grepscan, native
from semtools_tpu_torch.utils.text import read_file_text, split_lines


@pytest.fixture(autouse=True)
def built():
    if not native.available():
        pytest.skip("native library unavailable (no toolchain?)")


def _py_match_lines(path: str, pattern: str, ignore_case: bool):
    flags = re.IGNORECASE if ignore_case else 0
    compiled = re.compile(pattern, flags)
    return [
        i for i, line in enumerate(split_lines(read_file_text(path)))
        if compiled.search(line)
    ]


def _match(path, pattern, ignore_case):
    """The port's native answer, held equal to the JAX package's."""
    got = grepscan.match_lines(path, pattern, ignore_case)
    assert got == jax_grepscan.match_lines(path, pattern, ignore_case), (pattern, ignore_case)
    return got


CONTENT = (
    "Hello World\n"
    "hello world\n"
    "the quick brown fox\n"
    "line with (parens) and [brackets]\n"
    "tabs\tand\rcarriage\n"
    "numbers 12345 and under_scores\n"
    "last line no newline"
)


@pytest.fixture()
def sample_file(tmp_path):
    p = tmp_path / "sample.txt"
    p.write_text(CONTENT, encoding="utf-8")
    return str(p)


class TestGrepScan:
    def test_literal(self, sample_file):
        assert _match(sample_file, "hello", False) == [1]
        assert _match(sample_file, "hello", True) == [0, 1]

    def test_escaped_literal(self, sample_file):
        # re.escape()'d pattern, as the ask tool produces for non-regex input
        pat = re.escape("(parens)")
        assert _match(sample_file, pat, False) == _py_match_lines(sample_file, pat, False)

    def test_regex(self, sample_file):
        for pat in [r"\bworld\b", r"qu.ck", r"\d+", r"^last", r"newline$", r"a|b"]:
            assert _match(sample_file, pat, False) == \
                _py_match_lines(sample_file, pat, False), pat

    def test_ignore_case_regex(self, sample_file):
        pat = r"HELLO \w+"
        assert _match(sample_file, pat, True) == _py_match_lines(sample_file, pat, True)

    def test_crlf_and_trailing_newline(self, tmp_path):
        p = tmp_path / "crlf.txt"
        p.write_bytes(b"alpha\r\nbeta\r\ngamma\n")
        path = str(p)
        # '\r' is stripped before matching, no phantom last line
        assert _match(path, "beta$", False) == _py_match_lines(path, "beta$", False) == [1]
        assert _match(path, "a", False) == [0, 1, 2]

    def test_empty_file(self, tmp_path):
        p = tmp_path / "empty.txt"
        p.write_text("")
        assert _match(str(p), "x", False) == []

    def test_missing_file_errors(self, tmp_path):
        with pytest.raises(ValueError):
            grepscan.match_lines(str(tmp_path / "nope.txt"), "x", False)
        with pytest.raises(ValueError):
            jax_grepscan.match_lines(str(tmp_path / "nope.txt"), "x", False)

    def test_bad_regex_errors(self, sample_file):
        with pytest.raises(ValueError):
            grepscan.match_lines(sample_file, "(unclosed", False)
        with pytest.raises(ValueError):
            jax_grepscan.match_lines(sample_file, "(unclosed", False)

    def test_randomized_literals(self, tmp_path):
        rng = random.Random(7)
        lines = [
            "".join(rng.choices(string.ascii_letters + string.digits + " .,()[]",
                                k=rng.randint(0, 60)))
            for _ in range(200)
        ]
        p = tmp_path / "rand.txt"
        p.write_text("\n".join(lines) + "\n")
        path = str(p)
        for _ in range(30):
            needle = re.escape("".join(rng.choices(string.ascii_letters + " ().",
                                                   k=rng.randint(1, 5))))
            for ic in (False, True):
                assert _match(path, needle, ic) == _py_match_lines(path, needle, ic), \
                    (needle, ic)


class TestHashTok:
    def _parity(self, texts):
        tok = HashTokenizer()
        native_ids = _native_encode_ascii_batch(
            texts, tok.vocab_size, tok.ngram_min, tok.ngram_max
        )
        py_ids = tok._encode_py_batch(texts)
        assert [list(map(int, ids)) for ids in native_ids] == py_ids
        jax_ids = JaxHashTokenizer().encode_batch(texts)
        assert [list(map(int, ids)) for ids in tok.encode_batch(texts)] == \
            [list(map(int, ids)) for ids in jax_ids]

    def test_basic(self):
        self._parity(["hello world", "The QUICK brown-fox!", "", "   ", "a"])

    def test_punctuation_and_digits(self):
        self._parity(["x=1+2; print(x)", "a_b_c d3f", "...---...", "\t tab \t"])

    def test_word_length_boundaries(self):
        # ngram emission kicks in strictly above ngram_min chars
        self._parity(["abc", "abcd", "abcde", "ab", "_", "____________"])

    def test_control_char_whitespace(self):
        # \x1c-\x1f count as whitespace for Python's \s; parity must hold
        self._parity(["a\x1cb", "a\x1fb", "a\x0bb"])

    def test_long_word(self):
        self._parity(["x" * 10000, "y" * 3 + " " + "z" * 5000])

    def test_randomized(self):
        rng = random.Random(13)
        alphabet = string.ascii_letters + string.digits + string.punctuation + " \t"
        texts = [
            "".join(rng.choices(alphabet, k=rng.randint(0, 120)))
            for _ in range(100)
        ]
        self._parity(texts)

    def test_encode_batch_routes_non_ascii_to_python(self):
        tok = HashTokenizer()
        texts = ["plain ascii", "héllo wörld", "日本語のテキスト", "mixed é ascii"]
        got = tok.encode_batch(texts)
        assert [list(map(int, ids)) for ids in got] == tok._encode_py_batch(texts)
        assert [list(map(int, ids)) for ids in got] == \
            [list(map(int, ids)) for ids in JaxHashTokenizer().encode_batch(texts)]
