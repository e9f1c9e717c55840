"""Static-model embedding: token-row gather + segment mean + L2 normalize.

Counterpart of ``semtools_tpu/ops/embed.py``. Ragged token lists are
flattened into one id vector plus per-text offsets and pooled with one
``F.embedding_bag(mode="sum")`` per chunk; counts, mean and the ``norm > 0``
guard follow. PyTorch runs eagerly on ragged shapes, so the JAX package's
power-of-two buckets and trash segment (there for XLA's static shapes) are
not needed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# Upper bound on tokens per call: bounds the gathered [T, D] activation.
MAX_TOKENS_PER_CALL = 1 << 21
# Upper bound on texts per call.
MAX_TEXTS_PER_CALL = 65536


def _embed_chunk(table, token_lists, max_length: int, normalize: bool):
    clipped = [np.asarray(ids[:max_length], dtype=np.int64) for ids in token_lists]
    lengths = np.fromiter((len(ids) for ids in clipped), np.int64, count=len(clipped))
    offsets = np.zeros(len(clipped), np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    dev = table.device
    flat = torch.from_numpy(np.concatenate(clipped)).to(dev)
    sums = F.embedding_bag(
        flat, table, torch.from_numpy(offsets).to(dev), mode="sum"
    ).float()
    counts = torch.from_numpy(lengths).to(dev).float()
    mean = sums / counts.clamp(min=1.0)[:, None]
    if normalize:
        norm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
        mean = torch.where(norm > 0.0, mean / norm.clamp(min=1e-30), mean)
    return mean


def embed_token_lists(
    table: torch.Tensor,
    token_lists: Sequence[Sequence[int]],
    *,
    max_length: int = 2048,
    normalize: bool = True,
) -> torch.Tensor:
    """Embed ragged token-id lists -> ``[len(token_lists), D]`` float32 on
    the table's device, in calls bounded by MAX_TOKENS_PER_CALL /
    MAX_TEXTS_PER_CALL."""
    out = []
    start = 0
    tokens = 0
    for i, ids in enumerate(token_lists):
        n = min(len(ids), max_length)
        if i > start and (tokens + n > MAX_TOKENS_PER_CALL or i - start >= MAX_TEXTS_PER_CALL):
            out.append(_embed_chunk(table, token_lists[start:i], max_length, normalize))
            start, tokens = i, 0
        tokens += n
    if start < len(token_lists):
        out.append(_embed_chunk(table, token_lists[start:], max_length, normalize))
    if not out:
        return torch.zeros((0, table.shape[1]), dtype=torch.float32, device=table.device)
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)
