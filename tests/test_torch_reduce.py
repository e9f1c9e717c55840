"""The port's ``ops/reduce.py`` against the JAX package's, on the same numpy
inputs: the rotation is bit-identical (same row sample, float64 moment,
``eigh`` and sign rule), so both packages store the same reduced bytes;
``project`` and ``reduced_oversample`` are equal too. Tolerance: none
(``assert_array_equal``)."""

from __future__ import annotations

import numpy as np
import pytest

from semtools_tpu.ops import reduce as jax_reduce
from semtools_tpu_torch.ops import reduce


def _rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[: n // 3] += 3.0 * rng.standard_normal(d).astype(np.float32)  # a dominant direction
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,out_dim,sample_rows", [
    (500, 32, 8, 1 << 17),   # every row fits the sample
    (3000, 64, 16, 1000),    # the seeded row sample
    (300, 16, 32, 1 << 17),  # out_dim capped at D
])
def test_fit_rotation_is_bit_identical(n, d, out_dim, sample_rows):
    x = _rows(n + d, n, d)
    want = jax_reduce.fit_rotation(x, out_dim, sample_rows=sample_rows, seed=3)
    got = reduce.fit_rotation(x, out_dim, sample_rows=sample_rows, seed=3)
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    # orthonormal columns, each direction's largest component positive
    np.testing.assert_allclose(got.T @ got, np.eye(got.shape[1]), atol=1e-5)
    assert np.all(got[np.argmax(np.abs(got), axis=0), np.arange(got.shape[1])] > 0)
    np.testing.assert_array_equal(reduce.project(x, got), jax_reduce.project(x, want))


def test_reduced_oversample_matches(monkeypatch):
    monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_OVERSAMPLE", raising=False)
    for n_rows in (10, 600, 2048, 5000, 1_000_000, 1_002_000, 20_000_000):
        for top_k in (1, 10, 600):
            assert (reduce.reduced_oversample(n_rows, top_k)
                    == jax_reduce.reduced_oversample(n_rows, top_k))
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_OVERSAMPLE", "300")
    for n_rows, top_k in ((10_000, 10), (10_000, 100), (200, 10)):
        assert (reduce.reduced_oversample(n_rows, top_k)
                == jax_reduce.reduced_oversample(n_rows, top_k))
