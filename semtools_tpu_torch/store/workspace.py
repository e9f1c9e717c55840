"""Workspace registry: named persistent stores under ``~/.semtools/workspaces``.

Contract parity with the reference (src/workspace/mod.rs:8-101):

- a workspace is selected by the ``SEMTOOLS_WORKSPACE`` env var or an
  explicit ``--workspace`` flag; neither set ⇒ error "No active workspace";
- per-workspace ``config.json`` holds name/root_dir/in_batch_size/
  oversample_factor (the last two are serialized-but-unused, matching the
  reference's vestigial fields);
- ``root_path(name)`` is ``~/.semtools/workspaces/<name>``.

A copy of ``semtools_tpu/store/workspace.py``: the same layout and the same
``SEMTOOLS_WORKSPACE`` rule, so both packages open the same workspaces.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional


class NoActiveWorkspace(RuntimeError):
    def __init__(self) -> None:
        super().__init__("No active workspace. Run: workspace use <name>")


@dataclass
class WorkspaceConfig:
    name: str = "default"
    root_dir: str = ""
    in_batch_size: int = 5_000
    oversample_factor: int = 3


class Workspace:
    def __init__(self, config: WorkspaceConfig):
        self.config = config

    # -- selection ---------------------------------------------------------

    @staticmethod
    def active(workspace_name: Optional[str] = None) -> str:
        name = workspace_name if workspace_name is not None else os.environ.get(
            "SEMTOOLS_WORKSPACE", ""
        )
        if not name:
            raise NoActiveWorkspace()
        return name

    @classmethod
    def open(cls, workspace_name: Optional[str] = None) -> "Workspace":
        name = cls.active(workspace_name)
        cfg_path = cls.config_path_for(name)
        config = WorkspaceConfig()
        try:
            data = json.loads(Path(cfg_path).read_text())
            config = WorkspaceConfig(
                name=data.get("name", "default"),
                root_dir=data.get("root_dir", ""),
                in_batch_size=data.get("in_batch_size", 5_000),
                oversample_factor=data.get("oversample_factor", 3),
            )
        except (OSError, ValueError):
            pass
        if not config.root_dir:
            config.root_dir = cls.root_path(name)
        if not config.name or config.name == "default":
            config.name = name
        return cls(config)

    def save(self) -> None:
        cfg_path = Path(self.config_path_for(self.config.name))
        cfg_path.parent.mkdir(parents=True, exist_ok=True)
        cfg_path.write_text(json.dumps(asdict(self.config), indent=2))

    # -- paths -------------------------------------------------------------

    @staticmethod
    def root_path(name: str) -> str:
        return str(Path.home() / ".semtools" / "workspaces" / name)

    @staticmethod
    def config_path_for(name: str) -> str:
        return str(Path.home() / ".semtools" / "workspaces" / name / "config.json")
