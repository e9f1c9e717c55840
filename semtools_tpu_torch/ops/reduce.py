"""Dimensionality reduction for the reduced-dim capacity rungs.

A copy of ``semtools_tpu/ops/reduce.py`` (host numpy; the port imports
nothing of the JAX package). The store projects its corpus onto the top
principal directions of its rows and quantizes the projection to int8,
keeping each row's ceil-quantized residual NORM as one extra column
(64 dims = 65 B/row at D = 256, halving to 32 dims when the device budget
binds). Serving scores the query augmented with its own residual norm, so
one matmul yields a per-row OPTIMISTIC similarity bound; the store grows its
candidate pool until that bound certifies the top-k and re-ranks exactly
against the f32 rows, so reported distances stay exact.

The rotation is an UNCENTERED PCA (eigenvectors of the second-moment
matrix): cosine scoring needs q.x ~ (W^T q).(W^T x), which holds for an
orthonormal W spanning the data. Both packages fit it with the same row
sample, float64 moment, ``eigh`` and sign rule, so they store the same
reduced bytes for the same store.
"""

from __future__ import annotations

import numpy as np

from semtools_tpu_torch.utils.env import env_int


def fit_rotation(
    x: np.ndarray, out_dim: int, sample_rows: int = 1 << 17, seed: int = 0
) -> np.ndarray:
    """Top-``out_dim`` principal directions of ``x`` (uncentered).

    Returns an orthonormal [D, out_dim] float32 rotation, deterministic
    for a given (x, seed). Fitting uses a row sample: the 256x256 second
    moment converges long before 128k rows.
    """
    x = np.asarray(x, np.float32)
    n, d = x.shape
    out_dim = min(out_dim, d)
    if n > sample_rows:
        rng = np.random.default_rng(seed)
        x = x[rng.choice(n, sample_rows, replace=False)]
    # Second moment in float64 for a stable eigh on near-degenerate data.
    cov = (x.astype(np.float64).T @ x.astype(np.float64)) / max(len(x), 1)
    _, eigvecs = np.linalg.eigh(cov)  # ascending
    w = eigvecs[:, ::-1][:, :out_dim]
    # Deterministic sign: make the largest-|.| component of each direction
    # positive (eigh's sign is arbitrary).
    flip = np.sign(w[np.argmax(np.abs(w), axis=0), np.arange(w.shape[1])])
    flip[flip == 0] = 1.0
    return np.ascontiguousarray((w * flip), np.float32)


def project(x: np.ndarray, rotation: np.ndarray) -> np.ndarray:
    """[N, D] @ [D, d'] -> [N, d'] float32."""
    return np.asarray(np.asarray(x, np.float32) @ rotation, np.float32)


def reduced_oversample(n_rows: int, top_k: int = 10) -> int:
    """INITIAL candidate depth for the reduced tier's exact re-rank: a warm
    start for the margin-bounded completion loop
    (``Store._search_slot_cached_batched``), which grows the pool until the
    certificate holds, so it sets cost, not recall.

    n/512 rounded up to a power of two, floored at 2048 (and 4*k), capped at
    16384 and at the row count; ``SEMTOOLS_TPU_REDUCED_OVERSAMPLE``
    overrides (the JAX package's calibration, kept so both packages start
    from the same depth).
    """
    env = env_int("SEMTOOLS_TPU_REDUCED_OVERSAMPLE", 0)
    if env > 0:
        return min(max(env, 4 * top_k), n_rows)
    target = max(2048, n_rows >> 9, 4 * top_k)
    pow2 = 1 << (target - 1).bit_length()
    return min(pow2, 16384, n_rows)
