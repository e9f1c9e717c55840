"""Ask configuration.

Counterpart of ``semtools_tpu/ask/config.py`` (over the port's
``parse.config``).

Defaults mirror the reference's AskConfig (src/config.rs:53-63): model
``gpt-4o-mini``, 20 max agent iterations, Responses API mode, key from
``OPENAI_API_KEY``. Resolution priority: CLI arg > config file > env var >
builtin default (src/cmds/ask.rs:37-72).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Optional

from semtools_tpu_torch.parse.config import default_config_path


class ApiMode(str, Enum):
    CHAT = "chat"
    RESPONSES = "responses"


@dataclass
class AskConfig:
    api_key: Optional[str] = None
    base_url: Optional[str] = None
    model: str = "gpt-4o-mini"
    max_iterations: int = 20
    api_mode: ApiMode = ApiMode.RESPONSES

    def __post_init__(self) -> None:
        if self.api_key is None:
            self.api_key = os.environ.get("OPENAI_API_KEY")


def load_ask_config(config_path: Optional[str] = None) -> AskConfig:
    path = config_path or default_config_path()
    if not Path(path).exists():
        return AskConfig()
    data = json.loads(Path(path).read_text())
    section = data.get("ask") or {}
    cfg = AskConfig()
    if section.get("api_key"):
        cfg.api_key = section["api_key"]
    if section.get("base_url"):
        cfg.base_url = section["base_url"]
    if section.get("model"):
        cfg.model = section["model"]
    if section.get("max_iterations"):
        cfg.max_iterations = int(section["max_iterations"])
    if section.get("api_mode"):
        cfg.api_mode = ApiMode(section["api_mode"])
    return cfg
