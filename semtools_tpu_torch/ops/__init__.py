"""Device ops of the PyTorch port: embed, scan, and the fused scan kernels.

The JAX package's names, re-exported lazily (PEP 562): importing this
package, or a light module of it such as ``ops.kernels``, loads nothing
more; the first use of a name imports its module.
"""

import importlib

_SOURCES = {
    "embed_token_lists": "semtools_tpu_torch.ops.embed",
    "cosine_distances": "semtools_tpu_torch.ops.scan",
    "topk_scan": "semtools_tpu_torch.ops.scan",
}

__all__ = ["embed_token_lists", "cosine_distances", "topk_scan"]


def __getattr__(name):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_SOURCES[name]), name)
    globals()[name] = value
    return value
