"""The workspace store of the PyTorch port (counterpart of
``semtools_tpu/store``): the same on-disk workspaces, served on a torch
device."""

from semtools_tpu_torch.store.store import (
    CURRENT_EMBEDDING_VERSION,
    DocMeta,
    DocumentInfo,
    DocumentState,
    LineEmbedding,
    RankedLine,
    Store,
    WorkspaceStats,
)
from semtools_tpu_torch.store.workspace import NoActiveWorkspace, Workspace, WorkspaceConfig

__all__ = [
    "NoActiveWorkspace",
    "Workspace",
    "WorkspaceConfig",
    "Store",
    "DocMeta",
    "DocumentInfo",
    "DocumentState",
    "LineEmbedding",
    "RankedLine",
    "WorkspaceStats",
    "CURRENT_EMBEDDING_VERSION",
]
