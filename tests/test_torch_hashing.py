"""``tests/test_hashing.py`` on the port: FNV-1a and the doc/line ids of
``semtools_tpu_torch.utils.hashing`` (the port's own copy). Each case also
holds the port's ids against the JAX package's on the same inputs: equal
integers, as both write them into the shared workspace format."""

from semtools_tpu.utils import hashing as jax_hashing
from semtools_tpu_torch.utils.hashing import doc_id, fnv1a_64, line_id

PATHS = ["a/b.txt", "a/c.txt", "p", "/tmp/ünïcode path.md", ""]


def test_fnv1a_known_vectors():
    # Standard FNV-1a 64-bit test vectors
    assert fnv1a_64(b"") == 0xCBF29CE484222325
    assert fnv1a_64(b"a") == 0xAF63DC4C8601EC8C
    assert fnv1a_64(b"foobar") == 0x85944171F73967E8
    for data in (b"", b"a", b"foobar", bytes(range(256))):
        assert fnv1a_64(data) == jax_hashing.fnv1a_64(data)


def test_doc_and_line_ids_are_stable_and_distinct():
    assert doc_id("a/b.txt") == doc_id("a/b.txt")
    assert doc_id("a/b.txt") != doc_id("a/c.txt")
    assert line_id("a/b.txt", 0) != line_id("a/b.txt", 1)
    assert line_id("a/b.txt", 3) == line_id("a/b.txt", 3)
    # line ids must differ from the bare doc id
    assert line_id("a/b.txt", 0) != doc_id("a/b.txt")
    for p in PATHS:
        assert doc_id(p) == jax_hashing.doc_id(p)
        for n in (0, 1, 3, 2**31 - 1):
            assert line_id(p, n) == jax_hashing.line_id(p, n)


def test_line_id_uses_signed_little_endian_line_number():
    # Layout parity with the reference (path bytes + i32 LE line number)
    expected = fnv1a_64(b"p" + (7).to_bytes(4, "little"))
    assert line_id("p", 7) == expected == jax_hashing.line_id("p", 7)
