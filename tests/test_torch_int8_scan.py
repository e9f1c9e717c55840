"""The port's int8 scan (semtools_tpu_torch.ops.int8_scan) against the JAX
package's (semtools_tpu.ops.int8_scan, Pallas in interpret mode on the CPU),
on the same numpy inputs.

Quantization must be bit-equal. The top-k selection is exact integer
arithmetic, so on finite entries the indices are equal and the distances
agree within 1 ulp of f32 (only the final scale product may round
differently); filler entries (fewer kept rows than k) are +inf on both
sides. Duplicate rows planted across sub-tile boundaries (the port's 128
rows, the JAX package's 512) pin the lower-index tie rule.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu.ops import int8_scan as jax_int8
from semtools_tpu.ops import scan as jax_scan
from semtools_tpu_torch.ops import int8_scan, scan

D = 256


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed, n, qn):
    rng = np.random.default_rng(seed)
    e = _unit(rng, n)
    q = _unit(rng, qn)
    # duplicates of row 3 inside a sub-tile and across the 128- and
    # 512-row boundaries; the first query sits on them
    for dup in (5, 127, 128, 511, 512, n // 2, n - 1):
        e[dup] = e[3]
    q[0] = e[3]
    e[7] = 0.0
    return q, e


def _mask(kind, n, k, rng):
    if kind is None:
        return None
    m = np.zeros(n, np.int8)
    if kind == "random":
        m[:] = rng.random(n) < 0.5
    elif kind == "ranges":  # file-like contiguous slot ranges
        for start in range(0, n, 700):
            m[start : start + rng.integers(50, 400)] = 1
    elif kind == "few":  # fewer kept rows than k
        m[rng.choice(n, size=k // 2, replace=False)] = 1
    return m


@pytest.mark.parametrize("x_kind", ["random", "half_steps", "zeros", "large"])
def test_quantize_global_bit_equal(x_kind, monkeypatch):
    rng = np.random.default_rng(11)
    if x_kind == "random":
        x = _unit(rng, 300)
    elif x_kind == "half_steps":
        # scale = amax / 127 = 2^-7 exactly, and every value sits on an
        # exact half step k + 0.5 of it: rounding must be half to even
        steps = rng.integers(-126, 126, size=(64, 32)).astype(np.float32) + 0.5
        x = steps * np.float32(2.0 ** -7)
        x[0, 0] = np.float32(127 * 2.0 ** -7)
    elif x_kind == "zeros":
        x = np.zeros((4, 16), np.float32)
    else:  # past the chunk size: the chunked path
        monkeypatch.setattr(int8_scan, "_QUANT_CHUNK", 1000)
        monkeypatch.setattr(jax_int8, "_QUANT_CHUNK", 1000)
        x = _unit(rng, 50, 64)
    want_q, want_s = jax_int8.quantize_global(x)
    got_q, got_s = int8_scan.quantize_global(x)
    t_q, t_s = int8_scan.quantize_global(torch.from_numpy(x))
    assert got_s == want_s == t_s
    np.testing.assert_array_equal(got_q, want_q)
    assert t_q.dtype == torch.int8
    np.testing.assert_array_equal(t_q.numpy(), want_q)


def _assert_same(d, i, d_ref, i_ref):
    d, i = d.numpy(), i.numpy()
    assert d.shape == d_ref.shape and d.dtype == np.float32
    fin = np.isfinite(d_ref)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    assert (d_ref[~fin] == np.inf).all() and (d[~fin] == np.inf).all()
    np.testing.assert_array_equal(i[fin], np.asarray(i_ref)[fin])
    np.testing.assert_array_max_ulp(d[fin], np.asarray(d_ref, np.float32)[fin], maxulp=1)


@pytest.mark.parametrize("mask_kind", [None, "random", "ranges", "few"])
@pytest.mark.parametrize("n,n_true,qn,k", [
    (1000, 1000, 1, 1),
    (1000, 997, 3, 10),
    (1000, 900, 8, 64),
    (20_000, 20_000, 1, 64),
    (20_000, 19_001, 3, 1),
    (20_000, 19_999, 8, 10),
])
def test_int8_topk_scan_matches_jax(n, n_true, qn, k, mask_kind):
    q, e = _corpus(n + qn + k, n, qn)
    e8, e_scale = jax_int8.quantize_global(e)
    mask = _mask(mask_kind, n, k, np.random.default_rng(k))
    d_ref, i_ref = jax_int8.int8_topk_scan(q, e8, e_scale, k, n_true=n_true, mask=mask)
    d, i = int8_scan.int8_topk_scan(
        q, torch.from_numpy(e8), e_scale, k, n_true=n_true,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    _assert_same(d, i, d_ref, i_ref)
    if mask_kind is None and k >= 3:
        assert i[0, :3].tolist() == [3, 5, 127]  # planted duplicates, lowest first


def test_phases_agree_with_a_full_sort():
    """The plain phases compose to the exact top-k of the integer sims."""
    q, e = _corpus(3, 3000, 4)
    q8, _ = int8_scan.quantize_global(torch.from_numpy(q))
    e8, _ = int8_scan.quantize_global(torch.from_numpy(e))
    mask = torch.from_numpy(_mask("random", 3000, 10, np.random.default_rng(0)))
    sims, idx = int8_scan.int8_two_phase(q8, e8, 2990, 10, mask)
    full = (q8.float() @ e8[:2990].float().T).masked_fill(mask[:2990] == 0, float("-inf"))
    want_v, want_i = torch.sort(full, dim=1, descending=True, stable=True)
    assert torch.equal(sims, want_v[:, :10])
    assert torch.equal(idx, want_i[:, :10])


def test_int8_corpus_takes_the_plain_scan():
    """An int8 corpus never routes to the f32/bf16 fused kernels: topk_scan
    scores it unscaled on the plain path, as the JAX package's XLA path."""
    assert scan._use_fused(1 << 20, 10, 8, torch.device("cuda"), torch.float32)
    assert scan._use_fused(1 << 20, 10, 8, torch.device("cuda"), torch.bfloat16)
    assert not scan._use_fused(1 << 20, 10, 8, torch.device("cuda"), torch.int8)
    q, e = _corpus(5, 2000, 3)
    e8, _ = jax_int8.quantize_global(e)
    d_ref, i_ref = jax_scan.topk_scan(q, e8, 20, n_true=1990)
    d, i = scan.topk_scan(torch.from_numpy(q), torch.from_numpy(e8), 20, n_true=1990)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=1e-4)


def test_cuda_operands_are_checked():
    """A wrapper given a CPU/CUDA mix refuses it (no silent plain run)."""
    q8 = torch.zeros((1, D), dtype=torch.int8)
    e8 = torch.zeros((300, D), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="share one CUDA device"):
        int8_scan.tilemax(q8, e8, 300)
