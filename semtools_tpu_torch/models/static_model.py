"""Static embedding model: tokenizer + embedding table on a torch device.

Counterpart of ``semtools_tpu/models/static_model.py`` (model2vec's
``StaticModel``; the reference loads minishlab/potion-multilingual-128M and
encodes with ``encode_with_args(lines, Some(2048), 16384)``). Embedding a
text is a token-row lookup + mean pool + optional L2 normalize
(:mod:`semtools_tpu_torch.ops.embed`).

Model resolution order for ``StaticModel.from_pretrained(name)``, as in the
JAX package:

1. ``name`` is a local directory with model2vec artifacts
   (``model.safetensors`` + ``tokenizer.json`` [+ ``config.json``]);
2. the ``SEMTOOLS_TPU_MODEL_DIR`` environment variable points at artifacts;
3. the HuggingFace hub cache (``~/.cache/huggingface/hub``) already holds a
   snapshot of ``name``;
4. first-run hub download via ``huggingface_hub`` when it is installed and
   the network is reachable. Disable with ``SEMTOOLS_TPU_NO_FETCH=1``;
5. fallback: the built-in deterministic hashed n-gram model (a seeded
   Gaussian 65,536 x 256 table), announced by a warning (acknowledge with
   ``SEMTOOLS_TPU_ALLOW_FALLBACK=1``).
"""

from __future__ import annotations

import glob
import json
import os
import struct
import sys
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from semtools_tpu_torch.models.tokenizer import HashTokenizer, HFTokenizer
from semtools_tpu_torch.ops.embed import embed_token_lists
from semtools_tpu_torch.utils.platform import resolve_device
from semtools_tpu_torch.utils.tracing import stage

MODEL_NAME = "minishlab/potion-multilingual-128M"

# Built-in fallback model parameters (identical to the JAX package's, so both
# packages embed identically).
FALLBACK_DIM = 256
FALLBACK_VOCAB = 1 << 16
FALLBACK_SEED = 0x5EED
FALLBACK_NAME = "semtools-tpu/hashed-ngram-256"


def _read_safetensors(path: str) -> dict:
    """Minimal safetensors reader returning {name: np.ndarray} (mmap-backed)."""
    dtypes = {
        "F64": np.float64,
        "F32": np.float32,
        "F16": np.float16,
        "BF16": None,  # handled specially below
        "I64": np.int64,
        "I32": np.int32,
        "I16": np.int16,
        "I8": np.int8,
        "U8": np.uint8,
        "BOOL": np.bool_,
    }
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    data_start = 8 + header_len
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = mm[data_start + begin : data_start + end]
        if info["dtype"] == "BF16":
            u16 = raw.view(np.uint16)
            u32 = u16.astype(np.uint32) << 16
            arr = u32.view(np.float32)
        else:
            arr = raw.view(dtypes[info["dtype"]])
        out[name] = np.asarray(arr).reshape(info["shape"])
    return out


def _find_artifact_dir(name_or_path: str) -> Optional[str]:
    """Locate a model2vec artifact directory without any network access."""
    candidates: List[str] = []
    p = Path(name_or_path).expanduser()
    if p.is_dir():
        candidates.append(str(p))

    env_dir = os.environ.get("SEMTOOLS_TPU_MODEL_DIR")
    if env_dir and Path(env_dir).is_dir():
        candidates.append(env_dir)

    hub = Path(
        os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")
    ) / "hub"
    cache_name = "models--" + name_or_path.replace("/", "--")
    snap_root = hub / cache_name / "snapshots"
    if snap_root.is_dir():
        candidates.extend(sorted(glob.glob(str(snap_root / "*"))))

    for cand in candidates:
        if (Path(cand) / "model.safetensors").exists() and (
            Path(cand) / "tokenizer.json"
        ).exists():
            return cand
    return None


def _fetch_from_hub(name: str, hf_token: Optional[str]) -> Optional[str]:
    """First-run hub download; None when disabled
    (``SEMTOOLS_TPU_NO_FETCH=1``), ``name`` is not a hub repo id,
    huggingface_hub is missing or the download fails (reported on stderr)."""
    if os.environ.get("SEMTOOLS_TPU_NO_FETCH") == "1":
        return None
    if "/" not in name or Path(name).expanduser().is_absolute():
        return None  # a path, not a hub repo id
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        print(
            f"semtools: '{name}' is not cached and huggingface_hub is not "
            "installed; skipping download",
            file=sys.stderr,
        )
        return None
    try:
        print(f"semtools: downloading '{name}' from the HuggingFace hub...",
              file=sys.stderr)
        return snapshot_download(
            repo_id=name,
            token=hf_token,
            allow_patterns=["model.safetensors", "tokenizer.json", "config.json"],
        )
    except Exception as exc:  # offline, auth, missing repo: fall back
        print(
            f"semtools: could not download '{name}' "
            f"({type(exc).__name__}: {exc})",
            file=sys.stderr,
        )
        return None


_FALLBACK_WARNED = [False]


def _warn_fallback(name: str) -> None:
    """One prominent per-process notice that search semantics degraded
    (one line under ``SEMTOOLS_TPU_ALLOW_FALLBACK=1``)."""
    if os.environ.get("SEMTOOLS_TPU_ALLOW_FALLBACK") == "1":
        print(
            f"semtools: model '{name}' unavailable; using built-in "
            f"deterministic embedder ({FALLBACK_NAME})",
            file=sys.stderr,
        )
        return
    if _FALLBACK_WARNED[0]:
        return
    _FALLBACK_WARNED[0] = True
    print(
        "\n".join([
            "semtools: " + "=" * 64,
            f"semtools: WARNING: embedding model '{name}' is unavailable.",
            f"semtools: Falling back to the built-in {FALLBACK_NAME}",
            "semtools: embedder: search will match SURFACE similarity",
            "semtools: (shared words/character n-grams), not meaning.",
            "semtools: To restore semantic search, connect to the network",
            "semtools: (the model downloads automatically) or point",
            "semtools: SEMTOOLS_TPU_MODEL_DIR at model2vec artifacts.",
            "semtools: Set SEMTOOLS_TPU_ALLOW_FALLBACK=1 to silence this.",
            "semtools: " + "=" * 64,
        ]),
        file=sys.stderr,
    )


def _fallback_table() -> np.ndarray:
    """Deterministic Gaussian embedding table for the hashed fallback model."""
    rng = np.random.Generator(np.random.Philox(FALLBACK_SEED))
    table = rng.standard_normal((FALLBACK_VOCAB, FALLBACK_DIM), dtype=np.float32)
    table /= np.sqrt(FALLBACK_DIM)
    return table


_MODEL_CACHE: dict = {}
_MODEL_CACHE_LOCK = threading.Lock()


class StaticModel(nn.Module):
    """Tokenize on the host, pool on the device.

    The embedding table is a buffer on ``device``; ``encode`` /
    ``encode_single`` return device tensors.
    """

    def __init__(self, table: torch.Tensor, tokenizer, *, normalize: bool = True,
                 name: str = ""):
        super().__init__()
        self.register_buffer("table", table.to(torch.float32).contiguous())
        self.tokenizer = tokenizer
        self.normalize = normalize
        self.name = name
        self.dim = int(table.shape[1])

    @property
    def device(self) -> torch.device:
        return self.table.device

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_numpy(cls, table: np.ndarray, tokenizer, *, normalize: bool = True,
                   name: str = "", device=None) -> "StaticModel":
        """A model over a host table, copied to ``device`` (default: see
        :func:`semtools_tpu_torch.utils.platform.resolve_device`)."""
        dev = resolve_device(device)
        t = torch.from_numpy(np.ascontiguousarray(table, dtype=np.float32)).to(dev)
        return cls(t, tokenizer, normalize=normalize, name=name)

    @classmethod
    def from_jax_model(cls, m, device=None) -> "StaticModel":
        """The same weights, tokenizer and settings as a JAX-package
        ``StaticModel`` (reads its host table ``table_np``)."""
        return cls.from_numpy(m.table_np, m.tokenizer, normalize=m.normalize,
                              name=m.name, device=device)

    @classmethod
    def from_pretrained(
        cls,
        name_or_path: str = MODEL_NAME,
        hf_token: Optional[str] = None,
        normalize_override: Optional[bool] = None,
        device=None,
    ) -> "StaticModel":
        """Resolve and load a model (memoized per process and device)."""
        dev = resolve_device(device)
        key = (name_or_path, normalize_override, str(dev))
        with _MODEL_CACHE_LOCK:
            cached = _MODEL_CACHE.get(key)
            if cached is None:
                cached = cls._from_pretrained_uncached(
                    name_or_path, hf_token=hf_token,
                    normalize_override=normalize_override, device=dev,
                )
                _MODEL_CACHE[key] = cached
            return cached

    @classmethod
    def _from_pretrained_uncached(
        cls,
        name_or_path: str,
        hf_token: Optional[str] = None,
        normalize_override: Optional[bool] = None,
        device=None,
    ) -> "StaticModel":
        art_dir = _find_artifact_dir(name_or_path)
        if art_dir is None:
            fetched = _fetch_from_hub(name_or_path, hf_token)
            if fetched is not None:
                art_dir = _find_artifact_dir(fetched)
        if art_dir is None:
            _warn_fallback(name_or_path)
            return cls.fallback(normalize_override=normalize_override, device=device)

        tensors = _read_safetensors(str(Path(art_dir) / "model.safetensors"))
        if "embeddings" in tensors:
            table = tensors["embeddings"]
        else:  # some exports name the single tensor differently
            table = next(iter(tensors.values()))
        tokenizer = HFTokenizer(str(Path(art_dir) / "tokenizer.json"))

        normalize = True
        cfg_path = Path(art_dir) / "config.json"
        if cfg_path.exists():
            cfg = json.loads(cfg_path.read_text())
            normalize = bool(cfg.get("normalize", True))
        if normalize_override is not None:
            normalize = normalize_override
        return cls.from_numpy(table, tokenizer, normalize=normalize,
                              name=name_or_path, device=device)

    @classmethod
    def fallback(cls, normalize_override: Optional[bool] = None,
                 device=None) -> "StaticModel":
        normalize = True if normalize_override is None else normalize_override
        return cls.from_numpy(
            _fallback_table(),
            HashTokenizer(vocab_size=FALLBACK_VOCAB),
            normalize=normalize,
            name=FALLBACK_NAME,
            device=device,
        )

    # -- encoding ----------------------------------------------------------

    def encode(self, texts: Sequence[str], max_length: Optional[int] = 2048) -> torch.Tensor:
        """Embed a batch of texts -> [N, dim] float32 on the model's device."""
        with stage("tokenize"):
            token_lists = self.tokenizer.encode_batch(texts) if len(texts) else []
        return embed_token_lists(
            self.table,
            token_lists,
            max_length=max_length if max_length is not None else 1 << 30,
            normalize=self.normalize,
        )

    def encode_single(self, text: str) -> torch.Tensor:
        """Embed one text -> [dim] float32."""
        return self.encode([text])[0]


def load_model(name_or_path: str = MODEL_NAME, device=None) -> StaticModel:
    """Convenience loader used by the CLI (memoized via from_pretrained)."""
    return StaticModel.from_pretrained(name_or_path, device=device)
