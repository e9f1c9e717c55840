"""Embedding model and tokenizers of the PyTorch port.

The JAX package's names, re-exported lazily (PEP 562): importing this
package loads no torch; the first use of a name imports its module.
"""

import importlib

_SOURCES = {
    "StaticModel": "semtools_tpu_torch.models.static_model",
    "load_model": "semtools_tpu_torch.models.static_model",
    "HashTokenizer": "semtools_tpu_torch.models.tokenizer",
    "HFTokenizer": "semtools_tpu_torch.models.tokenizer",
}

__all__ = ["StaticModel", "load_model", "HashTokenizer", "HFTokenizer"]


def __getattr__(name):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_SOURCES[name]), name)
    globals()[name] = value
    return value
