"""semtools_tpu_torch — the PyTorch/CUDA port of semtools_tpu.

``semtools search`` runs end to end on one NVIDIA GPU: host tokenization,
an embedding-bag embed, and an exact top-k cosine scan whose fused scan
kernels are hand-written CUDA for Hopper (``csrc/fused_scan.cu``). Module
names follow the JAX package ``semtools_tpu``, which stays the reference
the port is tested against. This package imports torch and never jax.
"""

__version__ = "0.4.0"


def __getattr__(name):
    """Lazy re-exports of the library surface (keeps ``import
    semtools_tpu_torch`` light)."""
    surface = {
        "StaticModel": ("semtools_tpu_torch.models.static_model", "StaticModel"),
        "load_model": ("semtools_tpu_torch.models.static_model", "load_model"),
        "SearchConfig": ("semtools_tpu_torch.search", "SearchConfig"),
        "SearchResult": ("semtools_tpu_torch.search", "SearchResult"),
        "search_files": ("semtools_tpu_torch.search", "search_files"),
        "search_documents": ("semtools_tpu_torch.search", "search_documents"),
        "resolve_device": ("semtools_tpu_torch.utils.platform", "resolve_device"),
    }
    if name in surface:
        import importlib

        module, attr = surface[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'semtools_tpu_torch' has no attribute {name!r}")


__all__ = [
    "StaticModel", "load_model", "__version__", "SearchConfig", "SearchResult",
    "search_files", "search_documents", "resolve_device",
]
